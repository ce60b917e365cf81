"""Sequence encoding primitives (counterpart of
hashreadmapper_tpu/ops/encode.py:51-74).

Bases are int8 codes {0:A, 1:C, 2:G, 3:T} with a per-row length vector.
"""

from __future__ import annotations

import torch


def revcomp_bases(bases: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Length-aware reverse complement of padded base rows; positions at or
    past a row's length keep their value."""
    n, maxlen = bases.shape
    idx = torch.arange(maxlen, device=bases.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    src = (lens - 1 - idx).clamp(0, maxlen - 1)
    rc = 3 - torch.gather(bases, 1, src)
    return torch.where(idx < lens, rc, bases).to(bases.dtype)


def three_n_c_to_t(bases: torch.Tensor) -> torch.Tensor:
    """C(1) -> T(3); the forward-strand bisulfite collapse."""
    return torch.where(bases == 1, torch.full_like(bases, 3), bases)


def three_n_g_to_a(bases: torch.Tensor) -> torch.Tensor:
    """G(2) -> A(0); the reverse-strand bisulfite collapse."""
    return torch.where(bases == 2, torch.zeros_like(bases), bases)
