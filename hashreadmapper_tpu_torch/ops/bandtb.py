"""Batched on-device banded affine-gap traceback, STEP-2 CIGAR DP
(counterpart of hashreadmapper_tpu/ops/bandtb.py).

Per pair: the read and ref subregions are staged with shift_sub, the band
doubles over a fixed number of score-only fill passes (double while
best < score1 and 2*bw <= max_len), one more pass emits per-cell
directions with precomputed run lengths, and a lock-step walk consumes
one whole CIGAR run per step.  shift_sub and fill_pass are the CUDA
kernels of ops/bandtb_kernel.py (plain versions for CPU tensors); the
walk is torch ops.

Pallas skips whole 128-pair blocks of done pairs, which is why the JAX
package sorts pairs by band width with one-hot matmuls; the port's fill
skips per pair, so no sort or permutation is needed and the results are
the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .bandtb_kernel import fill_pass, shift_sub

N_ENTRIES = 64      # walk entries per pair; overflow -> host banded_cigar
FUSED_ENTRIES = 48  # fused-mode budget (uint8 entries, runs split at 63)
OP_M, OP_I, OP_D = 1, 2, 3


def _tb_core_t(read_tt, query_begin, query_end, ref_tt, ref_begin, ref_end,
               score1, m_max: int, n_entries: int,
               need: Optional[torch.Tensor] = None, run_cap: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Transposed pairs (read_tt [LQ, P], ref_tt [NL, P]) -> (entries
    [P, n_entries] int16: op | len << 2 in backward order, 0 past the
    end; status [P] int8: 0 ok, 1 traceback failed, 2 entry budget
    exceeded; final band width [P]).  need: pairs to run (None: all);
    run_cap > 0 splits runs at that length (uint8 entries)."""
    P = read_tt.shape[1]
    NL = ref_tt.shape[0]
    dev = read_tt.device
    i32 = torch.int32
    qb = query_begin.to(i32)
    m = (query_end - query_begin + 1).to(i32)
    rb = ref_begin.to(i32)
    r = (ref_end - ref_begin + 1).to(i32)
    score1 = score1.to(i32)

    read_t = shift_sub(read_tt, qb, m_max)
    ref_t = shift_sub(ref_tt, rb, NL)
    max_len = torch.maximum(m, r)
    bw = (r - m).abs() + 1
    # band doubling as a fixed number of passes: bw doubles at most
    # ceil(log2(max_len)) + 1 times before 2*bw > max_len stops it
    n_passes = max(1, (max(m_max, NL) - 1).bit_length() + 1)
    done = (torch.zeros(P, dtype=torch.bool, device=dev) if need is None
            else ~need)
    dirs_done = done.to(i32)
    for _ in range(n_passes):
        best, _ = fill_pass(read_t, ref_t, m, r, bw, done.to(i32), m_max,
                            False)
        now = (best >= score1) | (2 * bw > max_len)
        bw = torch.where(done | now, bw, 2 * bw)
        done = done | now
    _, dirs = fill_pass(read_t, ref_t, m, r, bw, dirs_done, m_max, True)
    flat = dirs.reshape(-1)

    # run-length walk, all pairs in lock-step; a step consumes one run
    base = torch.arange(P, device=dev) * (m_max * NL)
    i = (m - 1).to(torch.int64)
    j = (r - 1).to(torch.int64)
    failed = torch.zeros(P, dtype=torch.bool, device=dev)
    ndone = ~((i >= 0) & (j > 0))
    if need is not None:
        ndone = ndone | ~need
    ents = []
    for _ in range(n_entries):
        active = ~ndone & ~failed
        g = flat[base + i.clamp(0, m_max - 1) * NL
                 + j.clamp(0, NL - 1)].to(torch.int64)
        dh = g & 7
        rl = g >> 3
        bad = active & ((dh == 0) | (dh > 5))
        mv = active & ~bad
        op = torch.where(dh == 1, OP_M, torch.where(dh <= 3, OP_I, OP_D))
        # the oracle's loop condition (i >= 0 && j > 0) before every step
        # caps how much of the run is consumed; a capped run ends the walk
        cap = torch.where(dh == 1, torch.minimum(i + 1, j),
                          torch.where(dh <= 3, i + 1, j))
        ln = torch.minimum(rl, cap)
        if run_cap:
            # run chains are suffix-closed: the next gather lands mid-run
            # with exactly the remainder precomputed
            ln = ln.clamp(max=run_cap)
        i = torch.where(mv & (op != OP_D), i - ln, i)
        j = torch.where(mv & (op != OP_I), j - ln, j)
        failed = failed | bad
        ndone = ndone | ~((i >= 0) & (j > 0)) | failed
        ents.append(torch.where(mv, op | (ln << 2), 0))
    status = torch.where(failed, 1, torch.where(~ndone, 2, 0)).to(torch.int8)
    return torch.stack(ents, dim=1).to(torch.int16), status, bw


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
    ents, status, _ = _tb_core_t(
        pair_q_t, s10[6], s10[2], pair_ref_t, s10[5], s10[1], s10[0],
        m_max=LQ, n_entries=n_entries, need=need, run_cap=63)
    return ents.to(torch.uint8), torch.where(need, status, 0).to(torch.int8)


def banded_traceback_dispatch(read_codes, query_begin, query_end, ref_codes,
                              ref_begin, ref_end, score1, device):
    """Upload numpy pairs (read_codes [P, LQ], ref_codes [P, NL]) to
    `device` and enqueue their traceback without synchronising; returns
    the device (ops [P, N_ENTRIES] int16, status [P] int8)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    lq = int(read_codes.shape[1])
    ops, status, _ = _tb_core_t(
        t(read_codes).to(torch.int32).T, t(query_begin), t(query_end),
        t(ref_codes).to(torch.int32).T, t(ref_begin), t(ref_end), t(score1),
        m_max=lq, n_entries=N_ENTRIES)
    return ops, status


def banded_traceback_collect(dev) -> Tuple[np.ndarray, np.ndarray]:
    ops, status = dev
    return ops.cpu().numpy(), status.cpu().numpy()


def banded_traceback_batch(read_codes, query_begin, query_end, ref_codes,
                           ref_begin, ref_end, score1, device="cpu"):
    """Traceback of numpy pairs on `device`; numpy (ops, status) (see
    bandtb.banded_traceback_batch for the entry encoding)."""
    return banded_traceback_collect(banded_traceback_dispatch(
        read_codes, query_begin, query_end, ref_codes, ref_begin, ref_end,
        score1, device))
