"""Striped byte-mode Smith-Waterman score passes (counterpart of
hashreadmapper_tpu/ops/swdev_pallas.py::pass_batched_pallas and of the
forward and reverse passes that hashreadmapper_tpu/ops/swdev.py builds
around it).

pass_batched, sw_forward and sw_reverse launch csrc/swdev.cu for CUDA
tensors and run their plain versions for CPU tensors.  pass_batched_plain
is the JAX package's swdev._pass_batched (the lane-exact closed form of
ssw.c's byte-mode pass) written with torch ops, pairs-minor [S, 16, P];
the striped positions and the read mask come from eff_read_len and
seg_len, as in the Pallas kernel.  sw_forward_plain and sw_reverse_plain
are swdev._forward_t and swdev._reverse_t with torch ops: the striped
layout, the flip and barrel shifts of the reverse pass and the
second-best search, around pass_batched_plain.  The CUDA entries take the
pairs' [LQ, P] and [n_cols, P] codes (int8 or int32) as they are and do
all of that inside one launch each.

The JAX package's barrel shifts (select + roll per set bit) are one index
gather each in the plain versions, with the same rule: only the shift
bits below the array length are applied, so ref_end = -1 in the reverse
pass shifts by 0, not past the end.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import _build

LANES = 16          # byte-mode SSE lanes (ssw.c sw_sse2_byte)
GAP_OPEN = 3
GAP_EXTEND = 1
MATCH = 2
MISMATCH = 2
BIAS = MISMATCH     # byte-mode bias = -min(score_matrix)
SAT = 255
BIG = 0x3FFFFFFF
S_MAX = 8           # striped rows the CUDA kernel keeps in registers
N_SCORE_ROWS = 10   # rows of the packed score tensor (swdev.unpack_scores)

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
               Optional[torch.Tensor], torch.Tensor]


def _check(read_at, eff_read_len, seg_len, ref_t, ref_len, terminate,
           n_cols):
    if read_at.dim() != 3 or read_at.shape[1] != LANES:
        raise ValueError("pass_batched: expected read_at [S, 16, P]")
    p = read_at.shape[2]
    for name, t in (("eff_read_len", eff_read_len), ("seg_len", seg_len),
                    ("ref_len", ref_len), ("terminate", terminate)):
        if t.shape != (p,):
            raise ValueError(f"pass_batched: {name} must be [P], got "
                             f"{tuple(t.shape)}")
    if ref_t.dim() != 2 or ref_t.shape[0] < n_cols or ref_t.shape[1] != p:
        raise ValueError("pass_batched: expected ref_t [>= n_cols, P]")


def _codes(t: torch.Tensor) -> torch.Tensor:
    """Codes as the kernels read them: one-byte or int32 elements stay as
    they are (no copy when contiguous), anything else becomes int32."""
    if t.dtype not in (torch.int8, torch.uint8, torch.int32):
        t = t.to(torch.int32)
    return t.contiguous()


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def pass_batched_plain(read_at, eff_read_len, seg_len, ref_t, ref_len,
                       terminate, ref_dir: int, n_cols: int,
                       want_max_column: bool) -> Result:
    """Plain PyTorch version: one column of swdev._pass_batched per step
    over the [S, 16, P] state."""
    _check(read_at, eff_read_len, seg_len, ref_t, ref_len, terminate,
           n_cols)
    S, _, P = read_at.shape
    dev = read_at.device
    i32 = torch.int32
    read_at = read_at.to(i32)
    seg = seg_len.to(i32)
    rlen = eff_read_len.to(i32)
    ref_len = ref_len.to(i32)
    terminate = terminate.to(i32)
    ref_t = ref_t.to(i32)
    j_col = torch.arange(S, dtype=i32, device=dev)[:, None, None]
    kk = torch.arange(LANES, dtype=i32, device=dev)[:, None]
    pos = j_col + kk[None] * seg                               # [S, 16, P]
    pre_mask = pos < rlen
    arow = j_col < seg                                         # [S, 1, P]
    oh_last = j_col == (seg - 1).clamp(min=0)
    zero = torch.zeros((), dtype=i32, device=dev)

    h = torch.zeros((S, LANES, P), dtype=i32, device=dev)
    e = torch.zeros_like(h)
    snap = torch.full_like(h, -1)
    best = torch.zeros(P, dtype=i32, device=dev)
    end_ref = torch.full((P,), -1, dtype=i32, device=dev)
    stopped = torch.zeros(P, dtype=torch.bool, device=dev)
    overflowed = torch.zeros_like(stopped)
    mc = []
    for t in range(n_cols):
        ref_base = ref_t[t]
        i = (torch.full((P,), t, dtype=i32, device=dev) if ref_dir == 0
             else ref_len - 1 - t)
        active = (i >= 0) & (i < ref_len) & ~stopped
        match = (read_at == ref_base) & (ref_base < 4)
        p = torch.where(pre_mask, torch.where(match, MATCH + BIAS,
                                              -MISMATCH + BIAS).to(i32), BIAS)
        last = torch.where(oh_last, h, zero).amax(dim=0)          # [16, P]
        row0 = torch.cat([torch.zeros((1, P), dtype=i32, device=dev),
                          last[:-1]])
        vh_in = torch.cat([row0[None], h[:-1]])
        a = ((vh_in + p).clamp(max=SAT) - BIAS).clamp(min=0)
        pre = torch.where(arow, torch.maximum(a, e), zero)
        run = torch.cummax(pre + j_col, dim=0).values
        vf = torch.cat([torch.zeros((1, LANES, P), dtype=i32, device=dev),
                        run[:-1] - GAP_OPEN - (j_col[1:] - 1)]).clamp(min=0)
        h_main = torch.where(arow, torch.maximum(pre, vf), zero)
        e_new = torch.where(arow, torch.maximum(
            (e - GAP_EXTEND).clamp(min=0), (h_main - GAP_OPEN).clamp(min=0)),
            zero)
        run_last = torch.where(oh_last, run, zero).amax(dim=0)    # [16, P]
        vf_init = (run_last - GAP_OPEN - (seg - 1)).clamp(min=0)
        cmax = torch.cummax(vf_init + kk * seg, dim=0).values
        prev = torch.cat([torch.full((1, P), -BIG, dtype=i32, device=dev),
                          cmax[:-1]])
        corr = prev - (kk - 1) * seg
        h_fin = torch.where(arow, torch.maximum(
            h_main, (corr[None] - j_col).clamp(min=0)), zero)
        colmax = h_fin.amax(dim=(0, 1))

        improved = active & (colmax > best)
        ovf_now = improved & (colmax + BIAS >= SAT)
        take_end = improved & ~ovf_now
        best = torch.where(improved, colmax, best)
        end_ref = torch.where(take_end, i, end_ref)
        snap = torch.where(take_end, h_fin, snap)
        stopped = stopped | ovf_now | (active & (colmax == terminate))
        overflowed = overflowed | ovf_now
        h = torch.where(active, h_fin, h)
        e = torch.where(active, e_new, e)
        if want_max_column:
            mc.append(torch.where(active, colmax, zero))

    cand = torch.where(snap == best, pos, BIG).amin(dim=(0, 1))
    read_len_m1 = torch.where(pre_mask, pos, zero).amax(dim=(0, 1))
    end_read = torch.minimum(cand, read_len_m1)
    overflowed = overflowed | (best + BIAS >= SAT)
    best = torch.where(overflowed, SAT, best)
    max_column = (torch.stack(mc) if mc else
                  torch.zeros((0, P), dtype=i32, device=dev)) \
        if want_max_column else None
    return best, end_ref, end_read, max_column, overflowed


def pass_batched(read_at, eff_read_len, seg_len, ref_t, ref_len, terminate,
                 ref_dir: int, n_cols: int, want_max_column: bool) -> Result:
    """One striped pass over P pairs (swdev_pallas.pass_batched_pallas'
    arguments and returns).

    read_at [S, 16, P] striped codes 0..4 (pads 4; int8 or int32 go to the
    kernel as they are), eff_read_len [P] (the
    length the read mask tests against), seg_len [P], ref_t [n_cols, P]
    (pre-reversed per pair for the reverse pass), ref_len [P],
    terminate [P].  Returns (best, end_ref, end_read, max_column
    [n_cols, P] or None, overflowed bool), all int32 [P] otherwise."""
    if read_at.device.type == "cpu":
        return pass_batched_plain(read_at, eff_read_len, seg_len, ref_t,
                                  ref_len, terminate, ref_dir, n_cols,
                                  want_max_column)
    _check(read_at, eff_read_len, seg_len, ref_t, ref_len, terminate,
           n_cols)
    S, _, P = read_at.shape
    if not 1 <= S <= S_MAX:
        raise ValueError(f"pass_batched: S={S} outside the kernel's "
                         f"1..{S_MAX} striped rows (reads <= 128 bases)")
    read_at, ref_t = _codes(read_at), _codes(ref_t[:n_cols])
    vecs = [_i32(t) for t in (eff_read_len, seg_len, ref_len, terminate)]
    dev = read_at.device
    out = torch.empty((4, P), dtype=torch.int32, device=dev)
    mc = torch.empty((n_cols if want_max_column else 1, P),
                     dtype=torch.int32, device=dev)
    _build.check_cuda("pass_batched", read_at, ref_t, *vecs, out, mc)
    _build.launch("hrm_sw_pass", out,
                  read_at.data_ptr(), read_at.element_size(),
                  vecs[0].data_ptr(), vecs[1].data_ptr(), ref_t.data_ptr(),
                  ref_t.element_size(), vecs[2].data_ptr(),
                  vecs[3].data_ptr(), out.data_ptr(), mc.data_ptr(), S, P,
                  n_cols, ref_dir, int(want_max_column))
    pass_batched.launches += 1
    return (out[0], out[1], out[2], mc if want_max_column else None,
            out[3].bool())


pass_batched.launches = 0


def shift_bits_mask(n: int) -> int:
    """Shift bits a log-step barrel shift over n rows applies: steps 1, 2,
    4, ... below n (none for n <= 1)."""
    return (1 << (n - 1).bit_length()) - 1 if n > 1 else 0


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


def sw_forward_plain(read_t, read_len, ref_tt, ref_len, mask_len,
                     n_cols: int) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the forward byte-mode pass over [LQ, P]
    reads and [>= n_cols, P] refs (swdev._forward_t)."""
    read_len = read_len.to(torch.int32)
    ref_len = ref_len.to(torch.int32)
    mask_len = mask_len.to(torch.int32)
    lq, P = read_t.shape
    read_at, seg_len = _striped_layout_t(read_t, read_len, lq)
    best, end_ref, end_read, max_column, ovf = pass_batched_plain(
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


def sw_reverse_plain(read_t, ref_tt, score1, ref_end, query_end,
                     n_cols: int) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the reverse byte-mode pass: the reversed
    read[:query_end+1] against ref[:ref_end+1], descending columns,
    terminate = score1 (swdev._reverse_t)."""
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
    best, end_ref, end_read, _, ovf = pass_batched_plain(
        read_at, rl_rev, seg_len, ref_rev_t, ref_end + 1, score1, 1,
        n_cols, False)
    return {"ref_begin": end_ref, "query_begin": query_end - end_read,
            "flag2": score1 > best, "overflowed": ovf}


def diag_fastpath_plain(read_t, ref_tt, score1, ref_begin, ref_end,
                        query_begin, query_end, overflowed, n_cols: int):
    """Plain PyTorch version of the all-M traceback certificate
    (swdev._diag_fastpath_flag): equal subregion lengths and a gapless
    diagonal score equal to score1.

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


def _check_pairs(name, read_t, ref_tt, vectors, n_cols, out):
    if read_t.dim() != 2 or ref_tt.dim() != 2 \
            or ref_tt.shape[1] != read_t.shape[1] \
            or ref_tt.shape[0] < n_cols:
        raise ValueError(f"{name}: expected read_t [LQ, P] and ref_tt "
                         "[>= n_cols, P]")
    p = read_t.shape[1]
    for t in vectors:
        if t.shape != (p,):
            raise ValueError(f"{name}: per-pair vectors must be [P], got "
                             f"{tuple(t.shape)}")
    if out is not None and (out.shape != (N_SCORE_ROWS, p)
                            or out.dtype != torch.int32):
        raise ValueError(f"{name}: out must be [{N_SCORE_ROWS}, P] int32")


def _check_lq(name, lq):
    if (lq + LANES - 1) // LANES > S_MAX:
        raise ValueError(f"{name}: LQ={lq} exceeds the kernel's "
                         f"{S_MAX * LANES} bases a read")


def sw_forward(read_t, read_len, ref_tt, ref_len, mask_len, n_cols: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward pass of the pairs as the engine has them: read_t
    [LQ, P] and ref_tt [>= n_cols, P] codes 0..4 (int8 or int32 as they
    come), read_len, ref_len, mask_len [P].  Writes rows 0-4 (score1,
    ref_end, query_end, score2, ref_end2) and 8 (overflowed) of out
    [10, P] int32 (allocated when not given; its other rows are left as
    they are) and returns it."""
    _check_pairs("sw_forward", read_t, ref_tt, (read_len, ref_len, mask_len),
                 n_cols, out)
    lq, P = read_t.shape
    if out is None:
        out = torch.zeros((N_SCORE_ROWS, P), dtype=torch.int32,
                          device=read_t.device)
    if read_t.device.type == "cpu":
        res = sw_forward_plain(read_t, read_len, ref_tt, ref_len, mask_len,
                               n_cols)
        for row, key in ((0, "score1"), (1, "ref_end"), (2, "query_end"),
                         (3, "score2"), (4, "ref_end2"), (8, "overflowed")):
            out[row] = res[key]
        return out
    _check_lq("sw_forward", lq)
    read_t, ref_t = _codes(read_t), _codes(ref_tt[:n_cols])
    vecs = [_i32(t) for t in (read_len, ref_len, mask_len)]
    _build.check_cuda("sw_forward", read_t, ref_t, *vecs, out)
    _build.launch("hrm_sw_forward", out,
                  read_t.data_ptr(), read_t.element_size(),
                  vecs[0].data_ptr(), ref_t.data_ptr(), ref_t.element_size(),
                  vecs[1].data_ptr(), vecs[2].data_ptr(), out.data_ptr(), lq,
                  P, n_cols)
    sw_forward.launches += 1
    return out


sw_forward.launches = 0


def sw_reverse(read_t, ref_tt, score1, ref_end, query_end, n_cols: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reverse pass of the same pairs: score1, ref_end, query_end [P]
    of the forward pass (rows 0-2 of out will do).  Writes rows 5-7
    (ref_begin, query_begin, flag2) of out [10, P] int32, sets row 8
    where this pass overflowed, and writes row 9, the all-M certificate
    (swdev._diag_fastpath_flag) of the begins and ends, 0 where row 8 is
    set: give it the tensor sw_forward wrote, whose row 8 holds the
    forward pass's overflow (allocated as zeros when not given).  Returns
    out."""
    _check_pairs("sw_reverse", read_t, ref_tt, (score1, ref_end, query_end),
                 n_cols, out)
    lq, P = read_t.shape
    if out is None:
        out = torch.zeros((N_SCORE_ROWS, P), dtype=torch.int32,
                          device=read_t.device)
    if read_t.device.type == "cpu":
        res = sw_reverse_plain(read_t, ref_tt, score1, ref_end, query_end,
                               n_cols)
        for row, key in ((5, "ref_begin"), (6, "query_begin"), (7, "flag2")):
            out[row] = res[key]
        out[8] |= res["overflowed"]
        out[9] = diag_fastpath_plain(
            read_t, ref_tt, score1.to(torch.int32), res["ref_begin"],
            ref_end.to(torch.int32), res["query_begin"],
            query_end.to(torch.int32), out[8] != 0, n_cols)
        return out
    _check_lq("sw_reverse", lq)
    read_t, ref_t = _codes(read_t), _codes(ref_tt[:n_cols])
    vecs = [_i32(t) for t in (score1, ref_end, query_end)]
    _build.check_cuda("sw_reverse", read_t, ref_t, *vecs, out)
    _build.launch("hrm_sw_reverse", out,
                  read_t.data_ptr(), read_t.element_size(),
                  ref_t.data_ptr(), ref_t.element_size(), vecs[0].data_ptr(),
                  vecs[1].data_ptr(), vecs[2].data_ptr(), out.data_ptr(), lq,
                  P, n_cols, shift_bits_mask(lq), shift_bits_mask(n_cols),
                  shift_bits_mask(n_cols + 2 * lq))
    sw_reverse.launches += 1
    return out


sw_reverse.launches = 0
