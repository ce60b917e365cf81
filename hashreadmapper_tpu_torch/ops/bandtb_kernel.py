"""Banded-traceback kernels: the staging shift, one banded fill pass, and
the whole traceback in one launch (counterparts of
hashreadmapper_tpu/ops/bandtb.py::_shift_sub_pallas, ::_fill_pallas, and
of _fill_pallas with the band-doubling scan and the run-length walk that
bandtb._tb_core_t wraps around it).

shift_sub, fill_pass and traceback launch csrc/bandtb.cu for CUDA tensors
and run shift_sub_plain / fill_pass_plain / traceback_plain for CPU
tensors.  fill_pass_plain is bandtb._row_core written with torch ops over
[pairs, NL] rows; traceback_plain is the band loop over fill_pass_plain
and the lock-step walk in torch ops.

What bounds them on the card, and what the designs do about it (details
at the top of csrc/bandtb.cu): shift_sub is bound by memory, so a block
stages a tile of 32 pairs in shared memory and every byte moves once, in
whole sectors; the fill and the traceback are bound by the latency of the
row loop, so both narrow the lanes to the band; the fill kernel puts up
to four narrow pairs in a warp (8- and 16-lane segments) and stores each
row of directions in whole lines, and the traceback kernel keeps a pair
in one warp for all its passes and its walk, emits in every pass and
keeps the directions in shared memory.

Layouts: the inputs keep the JAX package's pairs-minor [L, P].  shift_sub
gives [size, P] int32 as the JAX functions do, or, with pair_major, the
[P, size] uint8 rows that traceback reads (a pair's codes contiguous).
fill_pass's direction array is [P, m_max, NL] int16 (the Pallas kernel's
is [m_max, NL, P]); traceback allocates no direction array.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from .swdev_kernel import shift_bits_mask

GAP_OPEN = 3
GAP_EXTEND = 1
MATCH = 2
MISMATCH = 2
BIG = 0x3FFFFFFF
POISON = -4096      # run crossed the band -> the oracle's traceback fails
RUN_MAX = (1 << 12) - 1
NL_MAX = 256        # ref lanes the CUDA fill kernels hold in one warp
OP_M, OP_I, OP_D = 1, 2, 3
# traceback launch shape: 4 warps a block (a pair each), TB_BLOCKS_PER_SM
# blocks resident on each multiprocessor, TB_SMEM_CELLS int16 direction
# cells of shared memory a warp (a multiple of 8; 4 blocks of 4 warps
# with 13 KB each fill a multiprocessor's 227 KB); a pair whose final
# band holds more cells uses its warp's row of the scratch buffer
TB_WARPS = 4
TB_BLOCKS_PER_SM = 4
TB_SMEM_CELLS = 6656
SMEM_MAX = 227 * 1024


def shift_sub_plain(codes_t: torch.Tensor, begin: torch.Tensor, size: int,
                    pair_major: bool = False) -> torch.Tensor:
    """Plain PyTorch version: one gather (see shift_sub)."""
    L, P = codes_t.shape
    eff = begin.to(torch.int64) & shift_bits_mask(L + size)
    src = torch.arange(size, device=codes_t.device)[:, None] + eff[None, :]
    got = codes_t.to(torch.int32).gather(0, src.clamp(max=L - 1))
    out = torch.where(src < L, got, 4)
    return out.T.to(torch.uint8).contiguous() if pair_major else out


def shift_sub(codes_t: torch.Tensor, begin: torch.Tensor, size: int,
              pair_major: bool = False) -> torch.Tensor:
    """codes_t [L, P] (int8 or int32 as they come) -> [size, P] int32,
    o[t, p] = codes[t + b, p] with b = begin[p] & (2^B - 1), B the log2
    steps of the Pallas barrel shift over L + size rows; code 4 past the
    end.  pair_major: the same values as [P, size] uint8."""
    if codes_t.dim() != 2 or begin.shape != (codes_t.shape[1],):
        raise ValueError("shift_sub: expected codes_t [L, P], begin [P]")
    if codes_t.device.type == "cpu":
        return shift_sub_plain(codes_t, begin, size, pair_major)
    L, P = codes_t.shape
    if codes_t.dtype not in (torch.int8, torch.int32):
        codes_t = codes_t.to(torch.int32)
    x = codes_t.contiguous()
    stride = 33 if pair_major else 32
    if L * stride * 4 > SMEM_MAX:
        raise ValueError(f"shift_sub: L={L} rows exceed the kernel's tile")
    sh = begin
    if sh.dtype != torch.int32 or not sh.is_contiguous():
        sh = sh.to(torch.int32).contiguous()
    out = (torch.empty((P, size), dtype=torch.uint8, device=x.device)
           if pair_major else
           torch.empty((size, P), dtype=torch.int32, device=x.device))
    _build.check_cuda("shift_sub", x, sh, out)
    _build.launch("hrm_shift_sub", out, x.data_ptr(), sh.data_ptr(),
                  out.data_ptr(), L, P, size, shift_bits_mask(L + size),
                  x.element_size(), int(pair_major))
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
    The kernel takes int8 or int32 codes as they come (rows of adjacent
    pairs, any row stride) and leaves a done pair's directions unwritten.
    It keeps codes in int8, so on a CUDA tensor codes of another dtype
    must lie in the int8 range (subregion codes are 0..4): it raises on
    others, where the plain version compares the values whole."""
    if ref_t.device.type == "cpu":
        return fill_pass_plain(read_t, ref_t, m, r, bw, done, m_max,
                               emit_dirs)
    _check_fill(read_t, ref_t, m, r, bw, done, m_max)
    NL, P = ref_t.shape
    if NL > NL_MAX:
        raise ValueError(f"fill_pass: NL={NL} exceeds the kernel's {NL_MAX}")
    for what, t in (("read codes", read_t), ("ref codes", ref_t)):
        if t.dtype != torch.int8:
            _build.check_range("fill_pass", what, t, -128, 127)
    codes = (read_t, ref_t)
    if read_t.dtype != ref_t.dtype or read_t.dtype not in (torch.int8,
                                                           torch.int32):
        codes = tuple(t.to(torch.int32) for t in codes)
    read_c, ref_c = (t if t.stride(1) == 1 or P == 1 else t.contiguous()
                     for t in codes)
    i32 = lambda t: t.to(torch.int32).contiguous()
    args = [i32(m), i32(r), i32(bw), i32(done)]
    dev = ref_t.device
    best = torch.empty(P, dtype=torch.int32, device=dev)
    dirs = torch.empty((P, m_max, NL) if emit_dirs else (1,),
                       dtype=torch.int16, device=dev)
    _build.check_cuda("fill_pass", *args, best, dirs)
    if read_c.device != dev:
        raise ValueError("fill_pass: all inputs must be on one CUDA device")
    _build.launch("hrm_fill_pass", best, read_c.data_ptr(), read_c.stride(0),
                  ref_c.data_ptr(), ref_c.stride(0), read_c.element_size(),
                  *[t.data_ptr() for t in args], best.data_ptr(),
                  dirs.data_ptr(), P, m_max, NL, int(emit_dirs))
    fill_pass.launches += 1
    return best, (dirs if emit_dirs else None)


fill_pass.launches = 0


def walk_plain(dirs: torch.Tensor, m, r, n_entries: int,
               need: Optional[torch.Tensor] = None, run_cap: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The run-length walk over dirs [P, m_max, NL], all pairs in
    lock-step, a step consuming one run: (entries [P, n_entries] int16,
    status [P] int8)."""
    P, m_max, NL = dirs.shape
    dev = dirs.device
    flat = dirs.reshape(-1)
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
    return torch.stack(ents, dim=1).to(torch.int16), status


def n_band_passes(m_max: int, nl: int) -> int:
    """Passes of the band doubling: bw doubles at most
    ceil(log2(max_len)) + 1 times before 2 * bw > max_len stops it."""
    return max(1, (max(m_max, nl) - 1).bit_length() + 1)


def _check_traceback(read_s, ref_s, m, r, score1, need, entry_dtype,
                     run_cap):
    P = ref_s.shape[0]
    if (read_s.dim() != 2 or ref_s.dim() != 2 or read_s.shape[0] != P
            or read_s.dtype != torch.uint8 or ref_s.dtype != torch.uint8):
        raise ValueError("traceback: expected uint8 read_s [P, m_max], "
                         "ref_s [P, NL] (shift_sub with pair_major)")
    for name, t in (("m", m), ("r", r), ("score1", score1), ("need", need)):
        if t is not None and t.shape != (P,):
            raise ValueError(f"traceback: {name} must be [P]")
    if need is not None and need.dtype != torch.bool:
        raise ValueError("traceback: need must be a bool mask")
    if entry_dtype not in (torch.int16, torch.uint8):
        raise ValueError("traceback: entries are int16 or uint8")
    if entry_dtype == torch.uint8 and not 0 < run_cap <= 63:
        raise ValueError("traceback: uint8 entries need 0 < run_cap <= 63")


TracebackResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def traceback_plain(read_s, ref_s, m, r, score1, n_entries: int,
                    need: Optional[torch.Tensor] = None, run_cap: int = 0,
                    entry_dtype: torch.dtype = torch.int16
                    ) -> TracebackResult:
    """Plain PyTorch version of traceback: the band loop over
    fill_pass_plain, its emitting pass and walk_plain."""
    _check_traceback(read_s, ref_s, m, r, score1, need, entry_dtype, run_cap)
    P, m_max = read_s.shape
    NL = ref_s.shape[1]
    i32 = torch.int32
    read_t = read_s.T.to(i32).contiguous()
    ref_t = ref_s.T.to(i32).contiguous()
    m, r, score1 = m.to(i32), r.to(i32), score1.to(i32)
    max_len = torch.maximum(m, r)
    bw = (r - m).abs() + 1
    done = (torch.zeros(P, dtype=torch.bool, device=ref_s.device)
            if need is None else ~need)
    dirs_done = done.to(i32)
    for _ in range(n_band_passes(m_max, NL)):
        best, _ = fill_pass_plain(read_t, ref_t, m, r, bw, done.to(i32),
                                  m_max, False)
        now = (best >= score1) | (2 * bw > max_len)
        bw = torch.where(done | now, bw, 2 * bw)
        done = done | now
    _, dirs = fill_pass_plain(read_t, ref_t, m, r, bw, dirs_done, m_max, True)
    ents, status = walk_plain(dirs, m, r, n_entries, need, run_cap)
    return ents.to(entry_dtype), status, bw


def traceback(read_s, ref_s, m, r, score1, n_entries: int,
              need: Optional[torch.Tensor] = None, run_cap: int = 0,
              entry_dtype: torch.dtype = torch.int16,
              return_spilled: bool = False):
    """The banded traceback of staged pairs, one launch.

    read_s [P, m_max] and ref_s [P, NL] uint8 subregion codes (shift_sub
    with pair_major); m, r, score1 [P].  Per pair: fill passes at band
    width |r - m| + 1, doubled while best < score1 and 2 * bw <= max(m,
    r); the directions at the final width; the run-length walk.  Returns
    (entries [P, n_entries] of entry_dtype: op | len << 2 in backward
    order, 0 past the end; status [P] int8: 0 ok, 1 traceback failed, 2
    entry budget exceeded; final band width [P] int32).  need: the pairs
    to run (None: all); the others get zero entries, status 0 and their
    first width.  run_cap > 0 splits runs at that length.
    return_spilled: also a 0-d int32 tensor, the pairs whose directions
    went to the scratch buffer in device memory instead of shared memory
    (0 for CPU tensors)."""
    if ref_s.device.type == "cpu":
        out = traceback_plain(read_s, ref_s, m, r, score1, n_entries, need,
                              run_cap, entry_dtype)
        return (*out, torch.zeros((), dtype=torch.int32)) \
            if return_spilled else out
    _check_traceback(read_s, ref_s, m, r, score1, need, entry_dtype, run_cap)
    P, m_max = read_s.shape
    NL = ref_s.shape[1]
    if NL > NL_MAX:
        raise ValueError(f"traceback: NL={NL} exceeds the kernel's {NL_MAX}")
    i32 = lambda t: t.to(torch.int32).contiguous()
    args = [read_s.contiguous(), ref_s.contiguous(), i32(m), i32(r),
            i32(score1)]
    dev = ref_s.device
    need_c = None if need is None else need.contiguous()
    entries = torch.empty((P, n_entries), dtype=entry_dtype, device=dev)
    status = torch.empty(P, dtype=torch.int8, device=dev)
    bw = torch.empty(P, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(-(-P // TB_WARPS), sms * TB_BLOCKS_PER_SM))
    # one [m_max, NL] row per warp of the grid, touched only by a pair
    # whose band outgrows the warp's shared memory
    scratch = torch.empty((blocks * TB_WARPS, m_max, NL), dtype=torch.int16,
                          device=dev)
    counters = torch.zeros(2, dtype=torch.int32, device=dev)
    outs = [entries, status, bw, scratch, counters]
    _build.check_cuda("traceback", *args, *outs,
                      *([] if need_c is None else [need_c]))
    _build.launch("hrm_traceback", entries, *[t.data_ptr() for t in args],
                  None if need_c is None else need_c.data_ptr(),
                  *[t.data_ptr() for t in outs], P, m_max, NL, n_entries,
                  run_cap, entries.element_size(), n_band_passes(m_max, NL),
                  TB_SMEM_CELLS, blocks)
    traceback.launches += 1
    out = (entries, status, bw)
    return (*out, counters[1]) if return_spilled else out


traceback.launches = 0
