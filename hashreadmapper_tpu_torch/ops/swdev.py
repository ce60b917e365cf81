"""Batched on-device SSW score passes, STEP-2 fine alignment (counterpart
of hashreadmapper_tpu/ops/swdev.py).

Forward pass (score1, ref_end, query_end, and the second best from the
per-column maxima), reverse pass on the reversed read prefix (begins,
terminate = score1), and the all-M diagonal certificate, over pair
tensors in the JAX package's transposed [L, P] layout.  The striped pass
itself is ops/swdev_kernel.py::pass_batched (CUDA kernel for CUDA
tensors, its plain version for CPU tensors); everything around it is
torch ops on the pairs' device.

The JAX package's barrel shifts (select + roll per set bit) become one
index gather each, with the same rule: only the shift bits below the
array length are applied, so ref_end = -1 in the reverse pass shifts by
0, not past the end.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .swdev_kernel import LANES, MATCH, MISMATCH, SAT, pass_batched


def shift_bits_mask(n: int) -> int:
    """Shift bits a log-step barrel shift over n rows applies: steps 1, 2,
    4, ... below n (none for n <= 1)."""
    return (1 << (n - 1).bit_length()) - 1 if n > 1 else 0


def require_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises
    (nothing falls back to the CPU unless the caller asks for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: torch.cuda.is_available() "
                           "is False; pass device='cpu' to run the plain "
                           "PyTorch versions")
    return dev


def _striped_select(read_t, seg_len, S: int, lq: int):
    """read_at[j, k, p] = read_t[min(j + k*seg_len[p], lq-1), p]; 0 where
    seg_len is outside 1..S (swdev._striped_select)."""
    P = read_t.shape[1]
    dev = read_t.device
    j = torch.arange(S, device=dev)[:, None, None]
    k = torch.arange(LANES, device=dev)[None, :, None]
    seg = seg_len.to(torch.int64)
    idx = (j + k * seg).clamp(max=lq - 1).reshape(S * LANES, P)
    gat = read_t.to(torch.int32).gather(0, idx).reshape(S, LANES, P)
    ok = (seg >= 1) & (seg <= S)
    return torch.where(ok, gat, 0)


def _striped_layout_t(read_t, read_len, lq: int):
    """[LQ, P] reads -> (read_at [S, 16, P] with pads 4, seg_len [P])."""
    S = (lq + LANES - 1) // LANES
    seg_len = torch.div(read_len + LANES - 1, LANES,
                        rounding_mode="floor").to(torch.int32)
    read_at = _striped_select(read_t, seg_len, S, lq)
    j = torch.arange(S, device=read_t.device)[:, None, None]
    k = torch.arange(LANES, device=read_t.device)[None, :, None]
    pre_mask = j + k * seg_len < read_len
    return torch.where(pre_mask, read_at, 4), seg_len


def _shift_rows_up(x, sh, fill: int):
    """out[t] = x[t + (sh & mask)] below x's length, `fill` past it, with
    mask = shift_bits_mask(len(x)) (swdev._shift_rows_up)."""
    n, P = x.shape
    eff = sh.to(torch.int64) & shift_bits_mask(n)
    src = torch.arange(n, device=x.device)[:, None] + eff[None, :]
    got = x.gather(0, src.clamp(max=n - 1))
    return torch.where(src < n, got, fill)


def _forward_t(read_t, read_len, ref_tt, ref_len, mask_len, n_cols: int):
    """Forward byte-mode pass over [LQ, P] reads and [>= n_cols, P] refs."""
    read_len = read_len.to(torch.int32)
    ref_len = ref_len.to(torch.int32)
    mask_len = mask_len.to(torch.int32)
    lq, P = read_t.shape
    read_at, seg_len = _striped_layout_t(read_t, read_len, lq)
    best, end_ref, end_read, max_column, ovf = pass_batched(
        read_at, read_len, seg_len, ref_tt[:n_cols], ref_len,
        torch.full((P,), SAT, dtype=torch.int32, device=read_t.device),
        0, n_cols, True)
    # second best outside the masked window; the byte quirk starts the
    # second range one past the edge (ssw.c:367-381)
    i_idx = torch.arange(n_cols, device=read_t.device)[:, None]
    lo = (end_ref - mask_len).clamp(min=0)
    hi = torch.minimum(ref_len, end_ref + mask_len)
    allowed = ((i_idx < lo) | (i_idx >= hi + 1)) & (i_idx < ref_len)
    masked = torch.where(allowed, max_column, -1)
    s2 = masked.amax(dim=0)
    ref_end2 = torch.where(s2 > 0, masked.argmax(dim=0).to(torch.int32), 0)
    score2 = torch.where(mask_len >= 15, s2.clamp(min=0), 0)
    ref_end2 = torch.where(mask_len >= 15, ref_end2, -1)
    return {"score1": best, "ref_end": end_ref, "query_end": end_read,
            "score2": score2, "ref_end2": ref_end2, "overflowed": ovf}


def _reverse_t(read_t, ref_tt, score1, ref_end, query_end, n_cols: int):
    """Reverse byte-mode pass: the reversed read[:query_end+1] against
    ref[:ref_end+1], descending columns, terminate = score1."""
    score1 = score1.to(torch.int32)
    ref_end = ref_end.to(torch.int32)
    query_end = query_end.to(torch.int32)
    lq = read_t.shape[0]
    t_idx = torch.arange(lq, device=read_t.device)[:, None]
    flipped = read_t.to(torch.int32).flip(0)
    rev_t = _shift_rows_up(flipped, lq - 1 - query_end, 4)
    rev_t = torch.where(t_idx <= query_end, rev_t, 4)
    rl_rev = query_end + 1
    read_at, seg_len = _striped_layout_t(rev_t, rl_rev, lq)
    ref_flip = ref_tt[:n_cols].to(torch.int32).flip(0)
    ref_rev_t = _shift_rows_up(ref_flip, n_cols - 1 - ref_end, 4)
    best, end_ref, end_read, _, ovf = pass_batched(
        read_at, rl_rev, seg_len, ref_rev_t, ref_end + 1, score1, 1,
        n_cols, False)
    return {"ref_begin": end_ref, "query_begin": query_end - end_read,
            "flag2": score1 > best, "overflowed": ovf}


def _diag_fastpath_flag(read_t, ref_tt, score1, ref_begin, ref_end,
                        query_begin, query_end, overflowed, n_cols: int):
    """The all-M traceback certificate (swdev._diag_fastpath_flag): equal
    subregion lengths and a gapless diagonal score equal to score1.

    ref_at[a] = x[(a + (sh & mask)) mod len(x)], x = 4-pad ++ ref ++
    4-pad, sh = ref_begin - query_begin + lq: the JAX package's roll-based
    barrel shift, wraparound included."""
    lq, P = read_t.shape
    dev = read_t.device
    m = query_end - query_begin + 1
    r = ref_end - ref_begin + 1
    pad = torch.full((lq, P), 4, dtype=torch.int32, device=dev)
    x = torch.cat([pad, ref_tt[:n_cols].to(torch.int32), pad])
    size = x.shape[0]
    sh = (ref_begin - query_begin + lq).to(torch.int64) \
        & shift_bits_mask(size)
    a_idx = torch.arange(lq, device=dev)[:, None]
    ref_at = x.gather(0, (a_idx + sh[None, :]) % size)
    read_t = read_t.to(torch.int32)
    active = (a_idx >= query_begin) & (a_idx <= query_end)
    s = torch.where((read_t == ref_at) & (read_t < 4), MATCH, -MISMATCH)
    diag_sum = torch.where(active, s, 0).sum(dim=0)
    return ((m == r) & (diag_sum == score1) & ~overflowed & (score1 > 0)
            & (ref_end >= 0))


def ssw_score_packed_t(read_t, read_len, ref_tt, ref_len, mask_len,
                       n_cols: int) -> torch.Tensor:
    """Forward + reverse pass + diag certificate over transposed pairs
    (read_t [LQ, P], ref_tt [LR, P]).  One [10, P] int32 tensor; rows:
    score1, ref_end, query_end, score2, ref_end2, ref_begin, query_begin,
    flag2, overflowed (fwd | rev), diag."""
    fwd = _forward_t(read_t, read_len, ref_tt, ref_len, mask_len, n_cols)
    rev = _reverse_t(read_t, ref_tt, fwd["score1"], fwd["ref_end"],
                     fwd["query_end"], n_cols)
    ovf = fwd["overflowed"] | rev["overflowed"]
    diag = _diag_fastpath_flag(read_t, ref_tt, fwd["score1"],
                               rev["ref_begin"], fwd["ref_end"],
                               rev["query_begin"], fwd["query_end"], ovf,
                               n_cols)
    rows = (fwd["score1"], fwd["ref_end"], fwd["query_end"], fwd["score2"],
            fwd["ref_end2"], rev["ref_begin"], rev["query_begin"],
            rev["flag2"], ovf, diag)
    return torch.stack([x.to(torch.int32) for x in rows])


def ssw_score_packed(read_codes, read_len, ref_codes, ref_len, mask_len,
                     n_cols: int) -> torch.Tensor:
    """Row-major wrapper of ssw_score_packed_t ([P, LQ], [P, LR])."""
    return ssw_score_packed_t(read_codes.to(torch.int32).T, read_len,
                              ref_codes.to(torch.int32).T, ref_len,
                              mask_len, n_cols)


def ssw_score_dispatch(read_codes, read_len, ref_codes, ref_len, mask_len,
                       device) -> torch.Tensor:
    """Upload one chunk of numpy pairs to `device` and enqueue its score
    passes; returns the [10, P] tensor without synchronising."""
    device = require_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return ssw_score_packed(t(read_codes), t(read_len), t(ref_codes),
                            t(ref_len), t(mask_len),
                            int(ref_codes.shape[1]))


def unpack_scores(packed: np.ndarray) -> Dict[str, np.ndarray]:
    """[10, P] score rows -> named fields (swdev.ssw_score_collect)."""
    return {
        "score1": packed[0], "score2": packed[3],
        "ref_end": packed[1], "ref_end2": packed[4],
        "query_end": packed[2], "ref_begin": packed[5],
        "query_begin": packed[6],
        "flag": np.where(packed[7] != 0, 2, 0).astype(np.int32),
        "degenerate": (packed[0] == 0) | (packed[1] < 0),
        "host_fallback": packed[8].astype(bool),
        "diag": packed[9].astype(bool),
    }


def ssw_score_collect(packed_dev: torch.Tensor) -> Dict[str, np.ndarray]:
    """Fetch and unpack one dispatched chunk."""
    return unpack_scores(packed_dev.cpu().numpy())


def ssw_score_batch(read_codes, read_len, ref_codes, ref_len, mask_len,
                    device="cuda") -> Dict[str, np.ndarray]:
    """Forward + reverse over numpy pairs on `device` (the card unless the
    caller asks for "cpu"; raises without one), results as numpy."""
    return ssw_score_collect(ssw_score_dispatch(
        read_codes, read_len, ref_codes, ref_len, mask_len, device))
