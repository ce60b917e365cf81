"""Minhash signatures (counterpart of hashreadmapper_tpu/ops/minhash.py).

sig[s, f] = (min over k-mer positions p of murmur64(kmer(s, p) + f))
            & (2**(2k) - 1), 0xFFFFFFFF for sequences shorter than k.
Signatures are u32 values held in int64 tensors.  Each function is one
launch of minhash_kernel.signature_stage on the card (collapse, hash,
mask, SENTINEL rows and mirror inside) and its plain composition on the
CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .minhash_kernel import signature_stage


def minhash_signatures(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                       hash_ids: torch.Tensor, canonical: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sig [N, F] u32-in-int64, valid [N] bool); canonical=False hashes
    forward k-mers only (the 3N spaces)."""
    return signature_stage(bases, lengths, k, hash_ids,
                           "canon" if canonical else "fwd")


def signatures_3n_pair(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                       hash_ids: torch.Tensor, mirror: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both 3N signature spaces of a read batch from one pass.

    mirror=False (directional): [N, 2F] = [sig_CT(x) | sig_GA(RC(x))] from
    CT(x), whose reverse-complement k-mers are the second space because
    GA(RC(x)) == RC(CT(x)).  mirror=True (the PBAT strands of
    --undirectional): [sig_CT(RC(x)) | sig_GA(x)] from GA(x), the halves
    swapped because its reverse-complement k-mers are CT(RC(x))."""
    return signature_stage(bases, lengths, k, hash_ids, "both",
                           collapse="ga" if mirror else "ct", mirror=mirror)


def window_signatures(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                      hash_ids: torch.Tensor, three_n: bool, chunk: int,
                      out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The index build's signatures of W windows: 3N [W, 2F] = [forward
    k-mers of CT(x) | of GA(x)], parity [W, F] canonical k-mers; written
    into `out` (sig, valid) when given.  On the card one launch; on the
    CPU the plain composition in row chunks of `chunk`."""
    mode = "pair" if three_n else "canon"
    if bases.device.type != "cpu":
        return signature_stage(bases, lengths, k, hash_ids, mode, out=out)
    f = hash_ids.shape[0]
    if out is None:
        out = (torch.empty((bases.shape[0], 2 * f if three_n else f),
                           dtype=torch.int64),
               torch.empty((bases.shape[0],), dtype=torch.bool))
    for s in range(0, bases.shape[0], chunk):
        signature_stage(bases[s:s + chunk], lengths[s:s + chunk], k,
                        hash_ids, mode,
                        out=(out[0][s:s + chunk], out[1][s:s + chunk]))
    return out
