"""Batched on-device banded affine-gap traceback, STEP-2 CIGAR DP
(counterpart of hashreadmapper_tpu/ops/bandtb.py).

Per pair: the read and ref subregions are staged with shift_sub (two
launches), and traceback does the rest in one: fill passes whose band
doubles while best < score1 and 2*bw <= max_len, the directions and run
lengths of the final width, and the walk that consumes one whole CIGAR
run per step.  In the JAX package the band loop and the walk are
lax.scans around the Pallas fill; on the card they are loops inside the
CUDA kernel of ops/bandtb_kernel.py (its plain version, torch ops over
fill_pass_plain, runs for CPU tensors), so a traceback is three launches
and no direction array reaches device memory.

Pallas skips whole 128-pair blocks of done pairs, which is why the JAX
package sorts pairs by band width with one-hot matmuls; the port's
kernel takes pairs one by one from a queue, so no sort or permutation is
needed and the results are the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .bandtb_kernel import OP_D, OP_I, OP_M, shift_sub, traceback  # noqa: F401
from .swdev import require_device

N_ENTRIES = 64      # walk entries per pair; overflow -> host banded_cigar
FUSED_ENTRIES = 48  # fused-mode budget (uint8 entries, runs split at 63)


def _tb_core_t(read_tt, query_begin, query_end, ref_tt, ref_begin, ref_end,
               score1, m_max: int, n_entries: int,
               need: Optional[torch.Tensor] = None, run_cap: int = 0,
               entry_dtype: torch.dtype = torch.int16
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Transposed pairs (read_tt [LQ, P], ref_tt [NL, P], int8 or int32
    codes) -> (entries [P, n_entries] of entry_dtype: op | len << 2 in
    backward order, 0 past the end; status [P] int8: 0 ok, 1 traceback
    failed, 2 entry budget exceeded; final band width [P]).  need: pairs
    to run (None: all); run_cap > 0 splits runs at that length (uint8
    entries)."""
    NL = ref_tt.shape[0]
    i32 = torch.int32
    qb = query_begin.to(i32)
    m = (query_end - query_begin + 1).to(i32)
    rb = ref_begin.to(i32)
    r = (ref_end - ref_begin + 1).to(i32)
    read_s = shift_sub(read_tt, qb, m_max, pair_major=True)
    ref_s = shift_sub(ref_tt, rb, NL, pair_major=True)
    return traceback(read_s, ref_s, m, r, score1.to(i32), n_entries,
                     need=need, run_cap=run_cap, entry_dtype=entry_dtype)


def fused_traceback_t(pair_q_t, pair_ref_t, s10: torch.Tensor,
                      n_entries: int = FUSED_ENTRIES
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded traceback of one scored batch (bandtb.fused_traceback_t).

    s10: ssw_score_packed_t's [10, P] rows.  Pairs covered by the diag
    certificate, overflowed or degenerate are not walked (zero entries,
    status 0).  Returns (ops [P, n_entries] uint8, op in bits 0..1 and
    run length <= 63 in bits 2..7; status [P] int8)."""
    LQ = pair_q_t.shape[0]
    need = ~((s10[9] != 0) | (s10[8] != 0) | (s10[0] == 0) | (s10[1] < 0))
    # a pair not needed comes back with zero entries and status 0
    ents, status, _ = _tb_core_t(
        pair_q_t, s10[6], s10[2], pair_ref_t, s10[5], s10[1], s10[0],
        m_max=LQ, n_entries=n_entries, need=need, run_cap=63,
        entry_dtype=torch.uint8)
    return ents, status


def banded_traceback_dispatch(read_codes, query_begin, query_end, ref_codes,
                              ref_begin, ref_end, score1, device):
    """Upload numpy pairs (read_codes [P, LQ], ref_codes [P, NL]) to
    `device` and enqueue their traceback without synchronising; returns
    the device (ops [P, N_ENTRIES] int16, status [P] int8)."""
    device = require_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    lq = int(read_codes.shape[1])
    ops, status, _ = _tb_core_t(
        t(read_codes).T, t(query_begin), t(query_end), t(ref_codes).T,
        t(ref_begin), t(ref_end), t(score1), m_max=lq, n_entries=N_ENTRIES)
    return ops, status


def banded_traceback_collect(dev) -> Tuple[np.ndarray, np.ndarray]:
    ops, status = dev
    return ops.cpu().numpy(), status.cpu().numpy()


def banded_traceback_batch(read_codes, query_begin, query_end, ref_codes,
                           ref_begin, ref_end, score1, device="cuda"):
    """Traceback of numpy pairs on `device` (the card unless the caller
    asks for "cpu"; raises without one); numpy (ops, status): entries
    op | len << 2 in backward order (1 = M, 2 = I, 3 = D; 0 past the end)
    and status 0 ok, 1 traceback failed, 2 entry budget exceeded."""
    return banded_traceback_collect(banded_traceback_dispatch(
        read_codes, query_begin, query_end, ref_codes, ref_begin, ref_end,
        score1, device))
