"""Minhash signatures (counterpart of hashreadmapper_tpu/ops/minhash.py).

sig[s, f] = (min over k-mer positions p of murmur64(kmer(s, p) + f))
            & (2**(2k) - 1), SIG_SENTINEL for sequences shorter than k.
Signatures are u32 values held in int64 tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import encode
from .minhash_kernel import sigs_from_bases

SIG_SENTINEL = 0xFFFFFFFF


def kmer_mask_py(k: int) -> int:
    return (1 << (2 * k)) - 1


def _finish(min_lo: torch.Tensor, lengths: torch.Tensor, k: int):
    """k < 16 mask and the SENTINEL rows (hashreadmapper_tpu minhash.py
    :165-171)."""
    sig = min_lo if k == 16 else min_lo & kmer_mask_py(k)
    seq_valid = lengths >= k
    sig = torch.where(seq_valid[:, None], sig,
                      torch.full_like(sig, SIG_SENTINEL))
    return sig, seq_valid


def minhash_signatures(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                       hash_ids: torch.Tensor, canonical: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sig [N, F] u32-in-int64, valid [N] bool); canonical=False hashes
    forward k-mers only (the 3N spaces)."""
    min_lo = sigs_from_bases(bases, lengths, k, hash_ids,
                             mode="canon" if canonical else "fwd")
    return _finish(min_lo, lengths, k)


def signatures_3n_pair(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                       hash_ids: torch.Tensor, mirror: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both 3N signature spaces of a read batch from one pass.

    mirror=False (directional): [N, 2F] = [sig_CT(x) | sig_GA(RC(x))] from
    CT(x), whose reverse-complement k-mers are the second space because
    GA(RC(x)) == RC(CT(x)).  mirror=True (the PBAT strands of
    --undirectional): [sig_CT(RC(x)) | sig_GA(x)] from GA(x), the halves
    swapped because its reverse-complement k-mers are CT(RC(x))."""
    collapse = encode.three_n_g_to_a if mirror else encode.three_n_c_to_t
    s, valid = _finish(sigs_from_bases(collapse(bases), lengths, k, hash_ids,
                                       mode="both"), lengths, k)
    if mirror:
        f = hash_ids.shape[0]
        s = torch.cat([s[:, f:], s[:, :f]], dim=1)
    return s, valid


def minhash_signatures_chunked(bases: torch.Tensor, lengths: torch.Tensor,
                               k: int, hash_ids: torch.Tensor, chunk: int,
                               canonical: bool = True
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """minhash_signatures over row chunks of `chunk` (bounds the plain
    version's [chunk, F, L] temporaries)."""
    parts = [minhash_signatures(bases[s:s + chunk], lengths[s:s + chunk], k,
                                hash_ids, canonical=canonical)
             for s in range(0, bases.shape[0], chunk)]
    if not parts:
        return minhash_signatures(bases, lengths, k, hash_ids, canonical)
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))
