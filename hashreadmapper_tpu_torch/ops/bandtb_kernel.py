"""Banded-traceback kernels: the staging shift and one banded fill pass
(counterparts of hashreadmapper_tpu/ops/bandtb.py::_shift_sub_pallas and
::_fill_pallas).

shift_sub and fill_pass launch csrc/bandtb.cu for CUDA tensors and run
shift_sub_plain / fill_pass_plain for CPU tensors.  fill_pass_plain is
bandtb._row_core written with torch ops over [pairs, NL] rows.

Layouts: the inputs keep the JAX package's pairs-minor [L, P]; the
direction array is [P, m_max, NL] int16 (the Pallas kernel's is
[m_max, NL, P]), so a pair's row is contiguous for the kernel's stores
and the walk.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from .swdev import shift_bits_mask

GAP_OPEN = 3
GAP_EXTEND = 1
MATCH = 2
MISMATCH = 2
BIG = 0x3FFFFFFF
POISON = -4096      # run crossed the band -> the oracle's traceback fails
RUN_MAX = (1 << 12) - 1
NL_MAX = 256        # ref lanes the CUDA fill kernel holds in one warp


def shift_sub_plain(codes_t: torch.Tensor, begin: torch.Tensor, size: int
                    ) -> torch.Tensor:
    """Plain PyTorch version: one gather (see shift_sub)."""
    L, P = codes_t.shape
    eff = begin.to(torch.int64) & shift_bits_mask(L + size)
    src = torch.arange(size, device=codes_t.device)[:, None] + eff[None, :]
    got = codes_t.to(torch.int32).gather(0, src.clamp(max=L - 1))
    return torch.where(src < L, got, 4)


def shift_sub(codes_t: torch.Tensor, begin: torch.Tensor, size: int
              ) -> torch.Tensor:
    """codes_t [L, P] -> [size, P] int32, o[t, p] = codes[t + b, p] with
    b = begin[p] & (2^B - 1), B the log2 steps of the Pallas barrel shift
    over L + size rows; code 4 past the end."""
    if codes_t.dim() != 2 or begin.shape != (codes_t.shape[1],):
        raise ValueError("shift_sub: expected codes_t [L, P], begin [P]")
    if codes_t.device.type == "cpu":
        return shift_sub_plain(codes_t, begin, size)
    L, P = codes_t.shape
    x = codes_t.to(torch.int32).contiguous()
    sh = begin.to(torch.int32).contiguous()
    out = torch.empty((size, P), dtype=torch.int32, device=x.device)
    _build.check_cuda("shift_sub", x, sh, out)
    _build.launch("hrm_shift_sub", x.data_ptr(), sh.data_ptr(),
                  out.data_ptr(), L, P, size, shift_bits_mask(L + size),
                  _build.stream(out))
    shift_sub.launches += 1
    return out


shift_sub.launches = 0


def _left(x: torch.Tensor, fill: int) -> torch.Tensor:
    """out[:, j] = x[:, j-1], `fill` at j = 0 (bandtb._sdj_lanes, k=1)."""
    return torch.nn.functional.pad(x[:, :-1], (1, 0), value=fill)


def _row(h_up, e_up, d2_up, j_up, read_i, sub_ref, s_valid, i, m, r, bw,
         j_l, emit_dirs: bool):
    """bandtb._row_core for one row i over [Q, NL] lanes."""
    beg = (i - bw).clamp(min=0)
    inb = (j_l >= beg) & (j_l <= torch.minimum(r - 1, i + bw))
    in_up = j_l <= (i - 1 + bw)
    t1e = torch.where(in_up, h_up, 0) - GAP_OPEN
    t2e = torch.where(in_up, e_up, 0) - GAP_EXTEND
    e_cur = torch.maximum(t1e, t2e)
    e1 = e_cur.clamp(min=0)
    at_beg = j_l == beg
    hd = torch.where(at_beg, 0, _left(h_up, 0))
    s = torch.where((sub_ref == read_i) & s_valid, MATCH, -MISMATCH)
    t2 = hd + s.to(torch.int32)
    a = torch.maximum(e1, t2)
    am1 = torch.where(at_beg, 0, _left(a, 0))
    v = torch.where(inb, am1.clamp(min=0) - GAP_OPEN + j_l, -BIG)
    run = torch.cummax(v, dim=1).values
    f = torch.maximum(run - j_l, beg - 1 - j_l)
    f1 = f.clamp(min=0)
    h = torch.maximum(a, f1)
    ok = inb & (i < m)
    if not emit_dirs:
        zero = torch.zeros_like(h)
        return (torch.where(ok, h, 0), torch.where(ok, e_cur, 0), zero, zero,
                None)

    de = t1e > t2e
    hm1 = torch.where(at_beg, 0, _left(h, 0))
    fm1 = torch.where(at_beg, 0, _left(f, 0))
    df = (hm1 - GAP_OPEN) > (fm1 - GAP_EXTEND)
    t1h = torch.maximum(e1, f1)
    dh = torch.where(t1h <= t2, 1,
                     torch.where(e1 > f1, 2 + de.int(), 4 + df.int()))
    d2_diag = torch.where(at_beg, 0, _left(d2_up, 0))
    d2 = torch.where(dh == 1, 1 + d2_diag.clamp(min=0), 0)
    jj = torch.where(inb, torch.where(de, 1, 1 + j_up), POISON)
    w = torch.where(df, 2 * j_l, -BIG)
    w = torch.where(at_beg & ~df, torch.where(beg > 0, 2 * j_l - 1, 0), w)
    z = torch.cummax(torch.where(inb, w, -BIG), dim=1).values
    kk = torch.where((z & 1) == 1, POISON, j_l - (z >> 1) + 1)
    km1 = torch.where(at_beg, POISON, _left(kk, POISON))
    rl = torch.where(dh == 1, d2, torch.where(
        dh == 2, 1 + j_up, torch.where(dh == 4, 1 + km1, 1)))
    rl = rl.clamp(0, RUN_MAX)
    packed = torch.where(ok & (rl > 0), dh | (rl << 3), 0)
    return (torch.where(ok, h, 0), torch.where(ok, e_cur, 0),
            torch.where(ok, d2, 0), torch.where(ok, jj, POISON),
            packed.to(torch.int16))


def _check_fill(read_t, ref_t, m, r, bw, done, m_max):
    NL, P = ref_t.shape
    if read_t.dim() != 2 or read_t.shape[0] < m_max or read_t.shape[1] != P:
        raise ValueError("fill_pass: expected read_t [>= m_max, P], "
                         "ref_t [NL, P]")
    for name, t in (("m", m), ("r", r), ("bw", bw), ("done", done)):
        if t.shape != (P,):
            raise ValueError(f"fill_pass: {name} must be [P]")


FillResult = Tuple[torch.Tensor, Optional[torch.Tensor]]


def fill_pass_plain(read_t, ref_t, m, r, bw, done, m_max: int,
                    emit_dirs: bool) -> FillResult:
    """Plain PyTorch version: the rows of bandtb._fill_pass over the pairs
    not done (done pairs: best 0, directions 0)."""
    _check_fill(read_t, ref_t, m, r, bw, done, m_max)
    NL, P = ref_t.shape
    dev = ref_t.device
    i32 = torch.int32
    best = torch.zeros(P, dtype=i32, device=dev)
    dirs = (torch.zeros((P, m_max, NL), dtype=torch.int16, device=dev)
            if emit_dirs else None)
    sel = torch.nonzero(~done.bool()).flatten()
    if len(sel) == 0:
        return best, dirs
    sub_ref = ref_t[:, sel].T.to(i32)                      # [Q, NL]
    reads = read_t[:m_max, sel].to(i32)                    # [m_max, Q]
    col = lambda t: t[sel].to(i32)[:, None]
    mq, rq, bwq = col(m), col(r), col(bw)
    j_l = torch.arange(NL, dtype=i32, device=dev)[None, :]
    s_valid = sub_ref < 4
    h = torch.zeros((len(sel), NL), dtype=i32, device=dev)
    e, d2, jj = h.clone(), h.clone(), h.clone()
    bq = torch.zeros(len(sel), dtype=i32, device=dev)
    rows = []
    # rows at or past every selected pair's m are out of band everywhere
    for i in range(min(m_max, max(int(mq.max()), 0))):
        h, e, d2, jj, packed = _row(
            h, e, d2, jj, reads[i][:, None], sub_ref, s_valid, i, mq, rq,
            bwq, j_l, emit_dirs)
        bq = torch.maximum(bq, h.amax(dim=1))
        rows.append(packed)
    best[sel] = bq
    if emit_dirs and rows:
        dirs[sel, :len(rows)] = torch.stack(rows, dim=1)
    return best, dirs


def fill_pass(read_t, ref_t, m, r, bw, done, m_max: int, emit_dirs: bool
              ) -> FillResult:
    """One banded DP pass at band width bw per pair.

    read_t [>= m_max, P] and ref_t [NL, P] subregion codes; m, r, bw,
    done [P].  Returns (best [P] int32, 0 for done pairs; dirs
    [P, m_max, NL] int16 of dh | run << 3 when emit_dirs, else None).
    The kernel leaves a done pair's directions unwritten."""
    if ref_t.device.type == "cpu":
        return fill_pass_plain(read_t, ref_t, m, r, bw, done, m_max,
                               emit_dirs)
    _check_fill(read_t, ref_t, m, r, bw, done, m_max)
    NL, P = ref_t.shape
    if NL > NL_MAX:
        raise ValueError(f"fill_pass: NL={NL} exceeds the kernel's {NL_MAX}")
    i32 = lambda t: t.to(torch.int32).contiguous()
    args = [i32(read_t), i32(ref_t), i32(m), i32(r), i32(bw), i32(done)]
    dev = ref_t.device
    best = torch.empty(P, dtype=torch.int32, device=dev)
    dirs = torch.empty((P, m_max, NL) if emit_dirs else (1,),
                       dtype=torch.int16, device=dev)
    _build.check_cuda("fill_pass", *args, best, dirs)
    _build.launch("hrm_fill_pass", *[t.data_ptr() for t in args],
                  best.data_ptr(), dirs.data_ptr(), P, m_max, NL,
                  int(emit_dirs), _build.stream(best))
    fill_pass.launches += 1
    return best, (dirs if emit_dirs else None)


fill_pass.launches = 0
