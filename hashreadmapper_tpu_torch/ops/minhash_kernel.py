"""Fused k-mer build + murmur64 minhash from base codes (counterpart of
hashreadmapper_tpu/ops/minhash_pallas.py::sigs_from_bases).

sigs_from_bases launches the CUDA kernel csrc/minhash.cu for CUDA tensors
and runs sigs_from_bases_plain for CPU tensors.  Both return [N, F]
('fwd', 'canon') or [N, 2F] ('both': forward rows, then reverse-complement
k-mer rows) u32 minima in int64, 0xFFFFFFFF where a row has no valid
position; the signature is the LOW word of the 64-bit minimum.
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

    def min_sig(kmers):
        lo = kmers[:, None, :] + hid                          # < 2**33
        hi, lo = u64.murmur64(lo >> 32, lo & u64.MASK32)
        # (hi, lo) in unsigned order as one signed int64 key
        key = (hi - (1 << 31)) * (1 << 32) + lo
        key = torch.where(valid, key, torch.full_like(key, _NO_HIT))
        return key.amin(dim=2) & u64.MASK32

    if mode == "canon":
        return min_sig(torch.where(rcv < fwd, rcv, fwd))
    if mode == "both":
        return torch.cat([min_sig(fwd), min_sig(rcv)], dim=1)
    return min_sig(fwd)


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
