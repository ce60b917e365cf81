"""Murmur64 minhash kernels (counterpart of
hashreadmapper_tpu/ops/minhash_pallas.py).

sigs_from_bases (fused k-mer build + hash + min from base codes) and
sig_min_murmur (the same minimum from precomputed k-mer low words) launch
the CUDA kernels of csrc/minhash.cu for CUDA tensors and run their
*_plain versions for CPU tensors.  sigs_from_bases returns [N, F] ('fwd',
'canon') or [N, 2F] ('both': forward rows, then reverse-complement k-mer
rows), sig_min_murmur [N, F]: u32 minima in int64, 0xFFFFFFFF where a row
has no valid position; the signature is the LOW word of the 64-bit
minimum.
"""

from __future__ import annotations

import torch

from . import u64
from .. import _build

MODES = {"fwd": 0, "both": 1, "canon": 2}
_NO_HIT = (1 << 63) - 1     # key of an invalid position: above every hash


def _check(bases, lengths, k, hash_ids, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if not 1 <= k <= 16:
        raise ValueError(f"k must be in [1, 16], got {k}")
    if bases.dim() != 2 or lengths.shape != (bases.shape[0],) \
            or hash_ids.dim() != 1:
        raise ValueError("expected bases [N, L], lengths [N], hash_ids [F]")


def _min_sig(kmers: torch.Tensor, valid: torch.Tensor, hid: torch.Tensor
             ) -> torch.Tensor:
    """[N, F] low words of the 64-bit min over valid positions of
    murmur64(kmer + hash id); kmers [N, P] u32 in int64, valid [N, 1, P],
    hid [1, F, 1]."""
    lo = kmers[:, None, :] + hid                              # < 2**33
    hi, lo = u64.murmur64(lo >> 32, lo & u64.MASK32)
    # (hi, lo) in unsigned order as one signed int64 key
    key = (hi - (1 << 31)) * (1 << 32) + lo
    key = torch.where(valid, key, torch.full_like(key, _NO_HIT))
    return key.amin(dim=2) & u64.MASK32


def sigs_from_bases_plain(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                          hash_ids: torch.Tensor, mode: str = "fwd"
                          ) -> torch.Tensor:
    """Plain PyTorch version: every k-mer materialised, hashed with the
    (hi, lo) u32-pair murmur of ops/u64.py, then a masked 64-bit min."""
    _check(bases, lengths, k, hash_ids, mode)
    n, maxlen = bases.shape
    dev = bases.device
    b = torch.zeros((n, maxlen + k), dtype=torch.int64, device=dev)
    b[:, :maxlen] = bases.to(torch.int64)
    fwd = torch.zeros((n, maxlen), dtype=torch.int64, device=dev)
    rcv = torch.zeros_like(fwd)
    for i in range(k):
        bi = b[:, i:i + maxlen]
        fwd |= bi << (2 * (k - 1 - i))
        rcv |= (3 - bi) << (2 * i)
    lens = lengths.to(torch.int64).clamp(max=maxlen)
    pos = torch.arange(maxlen, device=dev)[None, :]
    valid = (pos <= lens[:, None] - k)[:, None, :]            # [N, 1, L]
    hid = hash_ids.to(torch.int64)[None, :, None]             # [1, F, 1]
    if mode == "canon":
        return _min_sig(torch.where(rcv < fwd, rcv, fwd), valid, hid)
    if mode == "both":
        return torch.cat([_min_sig(fwd, valid, hid),
                          _min_sig(rcv, valid, hid)], dim=1)
    return _min_sig(fwd, valid, hid)


def sigs_from_bases(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                    hash_ids: torch.Tensor, mode: str = "fwd"
                    ) -> torch.Tensor:
    """Signature minima; CUDA tensors launch csrc/minhash.cu, CPU tensors
    take sigs_from_bases_plain.  bases int8 codes 0..3 [N, L], lengths [N]
    (clamped to L), hash_ids [F] (< 2**32)."""
    if bases.device.type == "cpu":
        return sigs_from_bases_plain(bases, lengths, k, hash_ids, mode)
    _check(bases, lengths, k, hash_ids, mode)
    n, maxlen = bases.shape
    f = hash_ids.shape[0]
    if n * f >= 2**31:
        raise ValueError(f"sigs_from_bases: N*F = {n * f} exceeds int32")
    bases = bases.to(torch.int8).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    hash_ids = hash_ids.to(device=bases.device, dtype=torch.int64).contiguous()
    rows = 2 * f if mode == "both" else f
    out = torch.empty((n, rows), dtype=torch.int64, device=bases.device)
    _build.check_cuda("sigs_from_bases", bases, lengths, hash_ids, out)
    _build.launch("hrm_minhash_sigs", bases.data_ptr(), lengths.data_ptr(),
                  hash_ids.data_ptr(), out.data_ptr(), n, maxlen, k, f,
                  MODES[mode], _build.stream(bases))
    sigs_from_bases.launches += 1
    return out


sigs_from_bases.launches = 0


def _check_kmers(kmer_lo, lengths, k, hash_ids):
    if not 1 <= k <= 16:
        raise ValueError(f"k must be in [1, 16], got {k}")
    if kmer_lo.dim() != 2 or kmer_lo.shape[1] < 1 \
            or lengths.shape != (kmer_lo.shape[0],) or hash_ids.dim() != 1:
        raise ValueError("expected kmer_lo [N, P >= 1], lengths [N], "
                         "hash_ids [F]")


def sig_min_murmur_plain(kmer_lo: torch.Tensor, lengths: torch.Tensor, k: int,
                         hash_ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of sig_min_murmur."""
    _check_kmers(kmer_lo, lengths, k, hash_ids)
    npos = kmer_lo.shape[1]
    lens = lengths.to(torch.int64).clamp(max=npos + k - 1)
    pos = torch.arange(npos, device=kmer_lo.device)[None, :]
    valid = (pos <= lens[:, None] - k)[:, None, :]
    return _min_sig(kmer_lo.to(torch.int64) & u64.MASK32, valid,
                    hash_ids.to(torch.int64)[None, :, None])


def sig_min_murmur(kmer_lo: torch.Tensor, lengths: torch.Tensor, k: int,
                   hash_ids: torch.Tensor) -> torch.Tensor:
    """sig[n, f] = low word of min over positions p <= length[n] - k of
    murmur64(kmer_lo[n, p] + hash_ids[f]) -> [N, F] u32 in int64,
    0xFFFFFFFF where no position is valid.  kmer_lo [N, P]: the k-mers'
    low words (k <= 16, high word zero) as u32 values in int64 (or their
    int32 bits); lengths are clamped to P + k - 1; any N.  No k-mer mask
    and no SENTINEL rows: ops/minhash.py's callers apply those.  CUDA
    tensors launch csrc/minhash.cu, CPU tensors take the plain version."""
    if kmer_lo.device.type == "cpu":
        return sig_min_murmur_plain(kmer_lo, lengths, k, hash_ids)
    _check_kmers(kmer_lo, lengths, k, hash_ids)
    n, npos = kmer_lo.shape
    f = hash_ids.shape[0]
    if n * f >= 2**31:
        raise ValueError(f"sig_min_murmur: N*F = {n * f} exceeds int32")
    # u32-in-int64 -> the same bits as int32 words, once
    kmers = ((kmer_lo.to(torch.int64) + 2**31) % 2**32 - 2**31).to(
        torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    hash_ids = hash_ids.to(device=kmers.device, dtype=torch.int64).contiguous()
    out = torch.empty((n, f), dtype=torch.int64, device=kmers.device)
    _build.check_cuda("sig_min_murmur", kmers, lengths, hash_ids, out)
    _build.launch("hrm_sig_min_murmur", kmers.data_ptr(), lengths.data_ptr(),
                  hash_ids.data_ptr(), out.data_ptr(), n, npos, k, f,
                  _build.stream(kmers))
    sig_min_murmur.launches += 1
    return out


sig_min_murmur.launches = 0
