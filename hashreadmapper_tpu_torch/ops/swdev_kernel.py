"""Striped byte-mode Smith-Waterman column pass (counterpart of
hashreadmapper_tpu/ops/swdev_pallas.py::pass_batched_pallas).

pass_batched launches csrc/swdev.cu for CUDA tensors and runs
pass_batched_plain for CPU tensors.  pass_batched_plain is the JAX
package's swdev._pass_batched (the lane-exact closed form of ssw.c's
byte-mode pass) written with torch ops, pairs-minor [S, 16, P]; the
striped positions and the read mask come from eff_read_len and seg_len,
as in the Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

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

    read_at [S, 16, P] striped codes (pads 4), eff_read_len [P] (the
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
    i32 = lambda t: t.to(torch.int32).contiguous()
    args = [i32(read_at), i32(eff_read_len), i32(seg_len),
            i32(ref_t[:n_cols]), i32(ref_len), i32(terminate)]
    dev = read_at.device
    out = torch.empty((4, P), dtype=torch.int32, device=dev)
    mc = torch.empty((n_cols if want_max_column else 1, P),
                     dtype=torch.int32, device=dev)
    _build.check_cuda("pass_batched", *args, out, mc)
    _build.launch("hrm_sw_pass", *[t.data_ptr() for t in args],
                  out.data_ptr(), mc.data_ptr(), S, P, n_cols, ref_dir,
                  int(want_max_column), _build.stream(out))
    pass_batched.launches += 1
    return (out[0], out[1], out[2], mc if want_max_column else None,
            out[3].bool())


pass_batched.launches = 0
