"""The coarse mapper's pair stage around its SHD launch as two kernels
(counterpart of the XLA fusions of hashreadmapper_tpu/pipeline/engine.py::
coarse_pairs_best and the packing of _map_batch_impl; no pallas_call
stands behind them).

pair_select: from the voted ids [B, K] the valid (read, window) pairs,
compacted to B * budget slots in flat order with 0 < budget < K (pairs
beyond them dropped and counted), and per slot the read index and the
extended window (ops/shd.py::extended_window_location) with its start in
the staged genome: the inputs of ops/shd.py::shd_pairs_best.  read_best:
from the SHD results (and under --undirectional the mirrored ones) the
per-read best, min Hamming, then the earliest window: packed [B, 7] int32
rows, each grid pair's orientation [B, K] int8 and the batch's overflow
vector [5] int64 in OVERFLOW_KEYS order.

For CUDA tensors each wrapper launches its entry of csrc/pairs.cu, for CPU
tensors it runs its plain version, the port's torch code.  Nothing falls
back: a CUDA input the kernel cannot take raises ValueError.
compact_pairs, pair_spreader and best_of_spaces are the plain versions'
parts; the window stream's pair stage runs them as they are.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from . import shd

SENTINEL = 0xFFFFFFFF
_BIG = 0x3FFFFFFF


def compact_pairs(pair_valid: torch.Tensor, n_rows: int, kcap: int,
                  per_row_budget: int):
    """Pair compaction of a [n_rows * kcap] candidate grid: with 0 <
    per_row_budget < kcap the valid pairs are packed, in grid order, into
    n_rows * per_row_budget slots and pairs beyond them dropped.  Returns
    (pair_sel [P] grid index of each slot, sel_valid [P], pair_drops,
    compact)."""
    dev = pair_valid.device
    nk = n_rows * kcap
    if not 0 < per_row_budget < kcap:
        return (torch.arange(nk, device=dev), pair_valid,
                torch.zeros((), dtype=torch.int64, device=dev), False)
    budget = n_rows * per_row_budget
    rank = torch.cumsum(pair_valid.to(torch.int64), dim=0) - 1
    n_valid = pair_valid.sum()
    slot = torch.where(pair_valid & (rank < budget), rank,
                       torch.full_like(rank, budget))
    pair_sel = torch.zeros(budget + 1, dtype=torch.int64, device=dev).scatter_(
        0, slot, torch.arange(nk, device=dev))[:budget]
    sel_valid = torch.arange(budget, device=dev) < n_valid
    return pair_sel, sel_valid, (n_valid - budget).clamp(min=0), True


def pair_spreader(pair_sel, sel_valid, nk: int):
    """spread(x, fill): compact_pairs' slot values x back on the [nk]
    grid, `fill` where no slot landed."""
    tgt = torch.where(sel_valid, pair_sel, torch.full_like(pair_sel, nk))

    def spread(x: torch.Tensor, fill):
        buf = torch.full((nk + 1,), fill, dtype=x.dtype, device=x.device)
        buf[tgt] = x
        return buf[:nk]
    return spread


def best_of_spaces(eval_pairs, undirectional: bool):
    """(hamming, shift, orientation, strand) per pair: the directional
    evaluation, and under undirectional the mirrored (PBAT) one where it
    is not NONE and the directional one is NONE or has strictly larger
    Hamming (strand 1 there)."""
    res = eval_pairs(False)
    ham, shf, ori = res.hamming, res.shift, res.orientation
    strand = torch.zeros_like(ham)
    if undirectional:
        res_u = eval_pairs(True)
        better_u = (res_u.orientation != shd.NONE) & (
            (ori == shd.NONE) | (res_u.hamming < ham))
        ham = torch.where(better_u, res_u.hamming, ham)
        shf = torch.where(better_u, res_u.shift, shf)
        ori = torch.where(better_u, res_u.orientation, ori)
        strand = better_u.to(strand.dtype)
    return ham, shf, ori, strand


def pair_select_plain(ids, read_len, win_pos, win_chrom, chrom_offset,
                      chrom_len, window_size: int, per_row_budget: int):
    """Plain version of pair_select."""
    b, kcap = ids.shape
    gwin = ids.reshape(-1)
    pair_valid = gwin != SENTINEL
    gwin_full = torch.where(pair_valid, gwin, torch.zeros_like(gwin))
    pair_sel, sel_valid, pair_drops, _ = compact_pairs(
        pair_valid, b, kcap, per_row_budget)

    gwin_c = gwin_full[pair_sel]
    ridx = pair_sel // kcap
    pos = win_pos[gwin_c]
    chrom = win_chrom[gwin_c]
    rl_rep = read_len.to(torch.int64)[ridx]
    loc = shd.extended_window_location(pos, chrom_len[chrom], rl_rep,
                                       window_size)
    gstart = chrom_offset[chrom] + loc.start
    return (pair_sel, ridx, gstart, loc.length, loc.left, sel_valid,
            pair_drops)


def read_best_plain(res, res_u, pair_sel, sel_valid, ids, win_pos, win_chrom,
                    probe_stats, num_kept, pair_drops):
    """Plain version of read_best."""
    b, kcap = ids.shape
    dev = ids.device
    gwin = ids.reshape(-1)
    gwin_full = torch.where(gwin != SENTINEL, gwin, torch.zeros_like(gwin))
    nk = b * kcap
    res_ham, res_shf, res_ori, res_strand = best_of_spaces(
        lambda mirrored: res_u if mirrored else res, res_u is not None)
    if pair_sel.shape[0] != nk:
        spread = pair_spreader(pair_sel, sel_valid, nk)
        res_ham, res_shf = spread(res_ham, 0), spread(res_shf, 0)
        res_ori = spread(res_ori, shd.NONE)
        res_strand = spread(res_strand, 0)

    ham = res_ham.reshape(b, kcap)
    shf = res_shf.reshape(b, kcap)
    ori = res_ori.reshape(b, kcap)
    good = ori != shd.NONE
    # best per read: min hamming, then the earliest window (ids ascend in
    # genome order); first-index argmin over the masked window ids
    ham_m = torch.where(good, ham, torch.full_like(ham, _BIG))
    min_h = ham_m.amin(dim=1, keepdim=True)
    gw = gwin_full.reshape(b, kcap)
    slot_key = torch.where(good & (ham_m == min_h), gw,
                           torch.full_like(gw, _BIG))
    best_slot = slot_key.argmin(dim=1, keepdim=True)
    has = good.any(dim=1)

    def take(m):
        return torch.gather(m, 1, best_slot)[:, 0]
    zero = torch.zeros(b, dtype=torch.int64, device=dev)
    best_gwin = take(gw)
    out_ori = torch.where(has, take(ori).to(torch.int64),
                          torch.full_like(zero, shd.NONE))
    out_ham = torch.where(has, take(ham).to(torch.int64), zero)
    out_shift = torch.where(has, take(shf).to(torch.int64), zero)
    out_strand = torch.where(
        has, take(res_strand.reshape(b, kcap)).to(torch.int64), zero)
    out_chrom = torch.where(has, win_chrom[best_gwin], zero)
    out_pos = torch.where(has, win_pos[best_gwin], zero)
    out_gwin = torch.where(has, best_gwin, torch.full_like(best_gwin, -1))
    packed = torch.stack(
        [out_ori, out_ham, out_shift, out_chrom, out_pos, out_gwin,
         out_strand], dim=1).to(torch.int32)
    overflow = torch.stack([probe_stats[:, 0].sum(),
                            (num_kept > kcap).sum(), pair_drops,
                            probe_stats[:, 1].sum(), probe_stats[:, 2].sum()])
    return packed, ori, overflow


def _expect(name: str, t: torch.Tensor, shape, dtype) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t.to(dtype).contiguous()


def pair_select(ids, read_len, win_pos, win_chrom, chrom_offset, chrom_len,
                window_size: int, per_row_budget: int):
    """Voted ids [B, K] (u32 window ids in int64, SENTINEL where empty)
    and read lengths [B] -> the SHD stage's pairs: (pair_sel [P] grid
    index b * K + k of each slot, ridx [P] its read, gstart [P] the
    extended window's start in the staged genome, length [P], left [P],
    sel_valid [P], pair_drops [] int64), P = B * per_row_budget with 0 <
    per_row_budget < K (slots past the valid pairs hold pair 0, invalid),
    else P = B * K, every pair in its own slot."""
    if ids.device.type == "cpu":
        return pair_select_plain(ids, read_len, win_pos, win_chrom,
                                 chrom_offset, chrom_len, window_size,
                                 per_row_budget)
    if ids.dim() != 2 or ids.shape[1] < 1:
        raise ValueError(f"pair_select: expected ids [B, K], K >= 1, got "
                         f"{tuple(ids.shape)}")
    b, kcap = ids.shape
    n_win, n_chrom = win_pos.shape[0], chrom_len.shape[0]
    if n_win < 1 or n_chrom < 1:
        raise ValueError("pair_select: no windows or no chromosomes")
    ins = [_expect("pair_select ids", ids, (b, kcap), torch.int64),
           _expect("pair_select read_len", read_len, (b,), torch.int32),
           _expect("pair_select win_pos", win_pos, (n_win,), torch.int64),
           _expect("pair_select win_chrom", win_chrom, (n_win,),
                   torch.int64),
           _expect("pair_select chrom_offset", chrom_offset, (n_chrom,),
                   torch.int64),
           _expect("pair_select chrom_len", chrom_len, (n_chrom,),
                   torch.int64)]
    if ins[0].data_ptr() % 16:        # the kernel reads two ids a load
        ins[0] = ins[0].clone()
    p = b * per_row_budget if 0 < per_row_budget < kcap else b * kcap
    dev = ids.device
    outs = [torch.empty(p, dtype=torch.int64, device=dev) for _ in range(5)]
    outs.append(torch.empty(p, dtype=torch.bool, device=dev))
    outs.append(torch.empty((), dtype=torch.int64, device=dev))
    _build.check_cuda("pair_select", *ins, *outs)
    _build.launch("hrm_pair_select", ins[0],
                  *[t.data_ptr() for t in ins + outs], b, kcap, n_win,
                  n_chrom, window_size, per_row_budget)
    pair_select.launches += 1
    return tuple(outs)


pair_select.launches = 0


def read_best(res, res_u, pair_sel, sel_valid, ids, win_pos, win_chrom,
              probe_stats, num_kept, pair_drops
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SHD results over pair_select's slots -> (packed [B, 7] int32:
    orientation, Hamming, shift, chromosome, position, window id (-1
    unmapped), strand (1 where the mirrored space won); ori [B, K] int8
    every grid pair's orientation, NONE where rejected or not evaluated;
    overflow [5] int64 in OVERFLOW_KEYS order: probe_stats [S, 3] (the
    probes' over-cap counts, tail and head drops) summed over S, the reads
    with num_kept > K, pair_drops).  res and res_u are (hamming, shift,
    orientation) [P] int32, int32, int8: the directional SHD and under
    --undirectional the mirrored one (else None).  The slots are
    compacted when P != B * K."""
    if ids.device.type == "cpu":
        return read_best_plain(res, res_u, pair_sel, sel_valid, ids, win_pos,
                               win_chrom, probe_stats, num_kept, pair_drops)
    if ids.dim() != 2 or ids.shape[1] < 1:
        raise ValueError(f"read_best: expected ids [B, K], K >= 1, got "
                         f"{tuple(ids.shape)}")
    b, kcap = ids.shape
    p = pair_sel.shape[0]
    n_win = win_pos.shape[0]
    if n_win < 1 or probe_stats.dim() != 2 or probe_stats.shape[1] != 3:
        raise ValueError("read_best: no windows, or probe_stats not [S, 3]")
    spaces = [res] if res_u is None else [res, res_u]
    shd_in = [_expect(f"read_best SHD {what}", t, (p,), dtype)
              for r in spaces
              for what, t, dtype in zip(("hamming", "shift", "orientation"),
                                        r, (torch.int32, torch.int32,
                                            torch.int8))]
    ins = [_expect("read_best pair_sel", pair_sel, (p,), torch.int64),
           _expect("read_best sel_valid", sel_valid, (p,), torch.bool),
           _expect("read_best ids", ids, (b, kcap), torch.int64),
           _expect("read_best win_pos", win_pos, (n_win,), torch.int64),
           _expect("read_best win_chrom", win_chrom, (n_win,), torch.int64),
           _expect("read_best probe_stats", probe_stats,
                   tuple(probe_stats.shape), torch.int64),
           _expect("read_best num_kept", num_kept, (b,), torch.int32),
           _expect("read_best pair_drops", pair_drops.reshape(()), (),
                   torch.int64)]
    dev = ids.device
    outs = [torch.empty((b, 7), dtype=torch.int32, device=dev),
            torch.empty((b, kcap), dtype=torch.int8, device=dev),
            torch.empty((5,), dtype=torch.int64, device=dev)]
    _build.check_cuda("read_best", *shd_in, *ins, *outs)
    ptrs = [t.data_ptr() for t in shd_in] + [None] * (6 - len(shd_in))
    _build.launch("hrm_read_best", ins[0], *ptrs,
                  *[t.data_ptr() for t in ins + outs], p, b, kcap, n_win,
                  probe_stats.shape[0])
    read_best.launches += 1
    return tuple(outs)


read_best.launches = 0
