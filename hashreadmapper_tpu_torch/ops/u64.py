"""Unsigned 32/64-bit arithmetic on int64 tensors (counterpart of
hashreadmapper_tpu/ops/u64.py).

A u32 value is held in an int64 tensor in [0, 2**32); a u64 value as an
(hi, lo) pair of such tensors.  torch's int64 `>>` is arithmetic and its
multiply is signed, so every product here is split into 16-bit limbs that
cannot leave the int64 range and every result is masked back to 32 bits:
no step relies on signed overflow.  This is the plain-PyTorch side only;
the CUDA kernels use native uint64_t.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF

# MurmurHash3 fmix64 constants (hashreadmapper_tpu/ops/u64.py:128-131)
_C1 = 0xFF51AFD7ED558CCD
_C2 = 0xC4CEB9FE1A85EC53


def mul_lo32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for u32 x and a Python constant c < 2**32."""
    c0, c1 = c & 0xFFFF, c >> 16
    return (x * c0 + (((x * c1) & 0xFFFF) << 16)) & MASK32


def mul_wide32(x: torch.Tensor, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full 64-bit product of u32 x and a constant c < 2**32 as (hi, lo)."""
    c0, c1 = c & 0xFFFF, c >> 16
    p0 = x * c0                                  # < 2**48
    p1 = x * c1                                  # < 2**48
    t = p0 + ((p1 & 0xFFFF) << 16)               # < 2**49
    return ((p1 >> 16) + (t >> 32)) & MASK32, t & MASK32


def _mul_const(hi: torch.Tensor, lo: torch.Tensor, c: int):
    """(hi, lo) * c mod 2**64."""
    chi, clo = c >> 32, c & MASK32
    phi, plo = mul_wide32(lo, clo)
    phi = (phi + mul_lo32(lo, chi) + mul_lo32(hi, clo)) & MASK32
    return phi, plo


def murmur64(hi: torch.Tensor, lo: torch.Tensor):
    """MurmurHash3 fmix64 on (hi, lo) u32 pairs; bit-exact with
    hashreadmapper_tpu.ops.u64.murmur64."""
    lo = lo ^ (hi >> 1)                          # x ^= x >> 33
    hi, lo = _mul_const(hi, lo, _C1)
    lo = lo ^ (hi >> 1)
    hi, lo = _mul_const(hi, lo, _C2)
    lo = lo ^ (hi >> 1)
    return hi, lo
