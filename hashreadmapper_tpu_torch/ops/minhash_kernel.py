"""Murmur64 minhash kernels (counterpart of
hashreadmapper_tpu/ops/minhash_pallas.py).

signature_stage (the signature stage of ops/minhash.py in one launch: the
3N collapse, the k-mers, the hash minima, the k < 16 mask, the SENTINEL
rows and their validity, the mirrored halves), sigs_from_bases (the raw
minima from base codes, the direct counterpart of the Pallas kernel) and
sig_min_murmur (the same minimum from precomputed k-mer low words) launch
the CUDA kernels of csrc/minhash.cu for CUDA tensors and run their
*_plain versions for CPU tensors.  sigs_from_bases returns [N, F] ('fwd',
'canon') or [N, 2F] ('both': forward rows, then reverse-complement k-mer
rows), sig_min_murmur [N, F]: u32 minima in int64, 0xFFFFFFFF where a row
has no valid position; the signature is the LOW word of the 64-bit
minimum.  Hash ids must lie in [0, 2**32): every wrapper raises on
others, on the CPU as on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import encode, u64
from .. import _build

MODES = {"fwd": 0, "both": 1, "canon": 2}
# the stage's modes: 'pair' = forward k-mers of C->T(x), then of G->A(x)
STAGE_MODES = {**MODES, "pair": 3}
COLLAPSES = {None: 0, "ct": 1, "ga": 2}
SIG_SENTINEL = 0xFFFFFFFF
_NO_HIT = (1 << 63) - 1     # key of an invalid position: above every hash


def kmer_mask_py(k: int) -> int:
    return (1 << (2 * k)) - 1


def check_hash_ids(name: str, hash_ids: torch.Tensor) -> None:
    """Raise unless every hash id lies in [0, 2**32): the kernels' hash
    relies on kmer + hash id < 2**33.  A CUDA tensor is read back once per
    version of it, not at every call (the engine passes the same one)."""
    if hash_ids.dim() != 1 or hash_ids.dtype.is_floating_point \
            or hash_ids.dtype == torch.bool:
        raise ValueError(f"{name}: hash_ids must be a 1-D integer tensor")
    _build.check_range(name, "hash ids", hash_ids, 0, 2**32 - 1)


def _check(name, bases, lengths, k, hash_ids, mode, modes=MODES):
    if mode not in modes:
        raise ValueError(f"mode must be one of {sorted(modes)}, got {mode!r}")
    if not 1 <= k <= 16:
        raise ValueError(f"k must be in [1, 16], got {k}")
    if bases.dim() != 2 or lengths.shape != (bases.shape[0],) \
            or hash_ids.dim() != 1:
        raise ValueError("expected bases [N, L], lengths [N], hash_ids [F]")
    check_hash_ids(name, hash_ids)


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
    _check("sigs_from_bases", bases, lengths, k, hash_ids, mode)
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


def _launch_stage(name, bases, lengths, hash_ids, out, valid, k, mode,
                  collapse, finish, mirror):
    """Check and convert the inputs, then one launch of hrm_minhash_stage."""
    n, maxlen = bases.shape
    f = hash_ids.shape[0]
    if n * f >= 2**31:
        raise ValueError(f"{name}: N*F = {n * f} exceeds int32")
    bases = bases.to(torch.int8).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    hash_ids = hash_ids.to(device=bases.device, dtype=torch.int64).contiguous()
    _build.check_cuda(name, bases, lengths, hash_ids, out,
                      *(() if valid is None else (valid,)))
    _build.launch("hrm_minhash_stage", bases, bases.data_ptr(),
                  lengths.data_ptr(), hash_ids.data_ptr(), out.data_ptr(),
                  None if valid is None else valid.data_ptr(), n, maxlen, k,
                  f, STAGE_MODES[mode], COLLAPSES[collapse], int(finish),
                  int(mirror))


def sigs_from_bases(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                    hash_ids: torch.Tensor, mode: str = "fwd"
                    ) -> torch.Tensor:
    """Signature minima; CUDA tensors launch csrc/minhash.cu, CPU tensors
    take sigs_from_bases_plain.  bases int8 codes 0..3 [N, L], lengths [N]
    (clamped to L), hash_ids [F] (in [0, 2**32))."""
    if bases.device.type == "cpu":
        return sigs_from_bases_plain(bases, lengths, k, hash_ids, mode)
    _check("sigs_from_bases", bases, lengths, k, hash_ids, mode)
    f = hash_ids.shape[0]
    out = torch.empty((bases.shape[0], 2 * f if mode == "both" else f),
                      dtype=torch.int64, device=bases.device)
    _launch_stage("sigs_from_bases", bases, lengths, hash_ids, out, None, k,
                  mode, None, False, False)
    sigs_from_bases.launches += 1
    return out


sigs_from_bases.launches = 0


def finish_signatures(min_lo: torch.Tensor, lengths: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k < 16 mask and the SENTINEL rows of lengths < k
    (hashreadmapper_tpu minhash.py:165-171) -> (sig, valid [N])."""
    sig = min_lo if k == 16 else min_lo & kmer_mask_py(k)
    seq_valid = lengths >= k
    sig = torch.where(seq_valid[:, None], sig,
                      torch.full_like(sig, SIG_SENTINEL))
    return sig, seq_valid


_COLLAPSE_FNS = {None: lambda b: b, "ct": encode.three_n_c_to_t,
                 "ga": encode.three_n_g_to_a}


def _check_stage(bases, lengths, k, hash_ids, mode, collapse):
    _check("signature_stage", bases, lengths, k, hash_ids, mode, STAGE_MODES)
    if collapse not in COLLAPSES:
        raise ValueError(f"collapse must be one of {list(COLLAPSES)}, got "
                         f"{collapse!r}")


def signature_stage_plain(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                          hash_ids: torch.Tensor, mode: str = "both",
                          collapse: Optional[str] = None,
                          mirror: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain composition of the stage: collapse, sigs_from_bases_plain,
    finish_signatures, and the halves swapped under `mirror`."""
    _check_stage(bases, lengths, k, hash_ids, mode, collapse)
    if mode == "pair":
        min_lo = torch.cat([
            sigs_from_bases_plain(encode.three_n_c_to_t(bases), lengths, k,
                                  hash_ids, "fwd"),
            sigs_from_bases_plain(encode.three_n_g_to_a(bases), lengths, k,
                                  hash_ids, "fwd")], dim=1)
    else:
        min_lo = sigs_from_bases_plain(_COLLAPSE_FNS[collapse](bases),
                                       lengths, k, hash_ids, mode)
    sig, valid = finish_signatures(min_lo, lengths, k)
    if mirror and mode in ("both", "pair"):
        f = hash_ids.shape[0]
        sig = torch.cat([sig[:, f:], sig[:, :f]], dim=1)
    return sig, valid


def signature_stage(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                    hash_ids: torch.Tensor, mode: str = "both",
                    collapse: Optional[str] = None, mirror: bool = False,
                    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sig [N, F] or [N, 2F] u32 in int64, valid [N] bool) of N sequences:
    the bases collapsed (`collapse` None, 'ct' or 'ga'), hashed in `mode`
    ('fwd', 'both', 'canon', or 'pair': the forward k-mers of C->T(x)
    then of G->A(x)), the k < 16 mask and SENTINEL rows applied, and the
    two halves swapped under `mirror` (modes 'both' and 'pair').  `out`
    (sig, valid) receives the result in place (contiguous, int64 and bool).
    CUDA tensors: one launch of csrc/minhash.cu; CPU tensors:
    signature_stage_plain."""
    if bases.device.type == "cpu":
        sig, valid = signature_stage_plain(bases, lengths, k, hash_ids, mode,
                                           collapse, mirror)
        if out is None:
            return sig, valid
        out[0].copy_(sig)
        out[1].copy_(valid)
        return out
    _check_stage(bases, lengths, k, hash_ids, mode, collapse)
    n, f = bases.shape[0], hash_ids.shape[0]
    cols = 2 * f if mode in ("both", "pair") else f
    if out is None:
        out = (torch.empty((n, cols), dtype=torch.int64, device=bases.device),
               torch.empty((n,), dtype=torch.bool, device=bases.device))
    sig, valid = out
    if sig.shape != (n, cols) or sig.dtype != torch.int64 \
            or valid.shape != (n,) or valid.dtype != torch.bool:
        raise ValueError(f"signature_stage: out must be ([{n}, {cols}] "
                         f"int64, [{n}] bool)")
    _launch_stage("signature_stage", bases, lengths, hash_ids, sig, valid, k,
                  mode, collapse, True, mirror)
    signature_stage.launches += 1
    return sig, valid


signature_stage.launches = 0


def _check_kmers(kmer_lo, lengths, k, hash_ids):
    if not 1 <= k <= 16:
        raise ValueError(f"k must be in [1, 16], got {k}")
    if kmer_lo.dim() != 2 or kmer_lo.shape[1] < 1 \
            or lengths.shape != (kmer_lo.shape[0],) or hash_ids.dim() != 1:
        raise ValueError("expected kmer_lo [N, P >= 1], lengths [N], "
                         "hash_ids [F]")
    check_hash_ids("sig_min_murmur", hash_ids)


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
    low words (k <= 16, high word zero) as int64 (the kernel reads each
    element's low word) or as int32 / uint32 words, read as they come;
    lengths are clamped to P + k - 1; any N.  No k-mer mask and no
    SENTINEL rows: ops/minhash.py's callers apply those.  CUDA tensors
    launch csrc/minhash.cu, CPU tensors take the plain version."""
    if kmer_lo.device.type == "cpu":
        return sig_min_murmur_plain(kmer_lo, lengths, k, hash_ids)
    _check_kmers(kmer_lo, lengths, k, hash_ids)
    if kmer_lo.dtype not in (torch.int64, torch.int32, torch.uint32):
        raise ValueError("sig_min_murmur: kmer_lo must be int64, int32 or "
                         f"uint32, got {kmer_lo.dtype}")
    n, npos = kmer_lo.shape
    f = hash_ids.shape[0]
    if n * f >= 2**31:
        raise ValueError(f"sig_min_murmur: N*F = {n * f} exceeds int32")
    kmers = kmer_lo.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    hash_ids = hash_ids.to(device=kmers.device, dtype=torch.int64).contiguous()
    out = torch.empty((n, f), dtype=torch.int64, device=kmers.device)
    _build.check_cuda("sig_min_murmur", kmers, lengths, hash_ids, out)
    _build.launch("hrm_sig_min_murmur", kmers,
                  kmers.data_ptr(), kmers.element_size(),
                  lengths.data_ptr(), hash_ids.data_ptr(), out.data_ptr(), n,
                  npos, k, f)
    sig_min_murmur.launches += 1
    return out


sig_min_murmur.launches = 0
