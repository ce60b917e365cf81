"""Fused candidate vote over probe output (counterpart of
hashreadmapper_tpu/ops/vote_pallas.py::vote_candidates_fnc).

Per read: merge the F candidate lists, count each distinct non-SENTINEL
id, keep ids seen in >= min_table_hits tables in ascending id order in
out_cap slots.  vote_candidates_fnc launches csrc/vote.cu for CUDA tensors
and runs vote_candidates_fnc_plain for CPU tensors.  On the card, F*C up
to WARP_MERGE (padded to a power of two) is a warp a read sorting every
slot as u32 keys in registers.  Above it (chr1 caps: C 128, F 32 or 64) a
warp reads its read's slots once and gathers the k ids that are there
into a scratch row, counting them into a sketch; past SIFT_FROM ids it
keeps only those whose sketch counter reaches min_table_hits (all that
can be kept, with every copy), then sorts and counts what is left: in
registers at the smallest width that holds it up to TILE ids, else in
tiles of TILE.  One launch a call either way.  Unlike the TPU kernel,
neither needs sorted lists, C a power of two or N a multiple of 128.

A tally (an int64 [1] tensor) counts the wide path's work: each call adds
its ids present below bit TALLY_TILED_SHIFT and its reads sorted in tiles
above it (the kernel with one atomic a block, the plain version the same
numbers); tally_counts reads the two back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build

SENTINEL = 0xFFFFFFFF
MAX_MERGE = 16384        # F*C the kernels take (tested on the card)
WARP_MERGE = 2048        # F*C padded up to this: vote_warp_kernel
TILE = 1024              # ids the wide kernel's warp sorts in registers
SKETCH_BITS = 11         # the wide kernel's sketch: 2**11 counters a read
SIFT_FROM = 32           # ids a read has before the wide kernel sifts them
TALLY_TILED_SHIFT = 40   # a tally word: ids present below, tiled reads above


def _m_pad(m: int) -> int:
    """F*C padded to a power of two, at least 32 (the kernels' m_pad)."""
    return max(32, 1 << (m - 1).bit_length())


def tally_counts(tally: torch.Tensor) -> Tuple[int, int]:
    """A vote tally word -> (ids present, reads sorted in tiles), summed
    over the wide-path calls that added to it since it was zeroed."""
    word = int(tally.item())
    return word & ((1 << TALLY_TILED_SHIFT) - 1), word >> TALLY_TILED_SHIFT


def _sketch_slots(ids: torch.Tensor) -> torch.Tensor:
    """Each u32 id's counter in the wide kernel's sketch: the top
    SKETCH_BITS bits of id * 0x9E3779B1 mod 2**32 (in int64 without
    overflow: the high half's product matters only in its low 16 bits)."""
    a = 0x9E3779B1
    lo, hi = ids & 0xFFFF, (ids >> 16) & 0xFFFF
    prod = (lo * a + (((hi * a) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return prod >> (32 - SKETCH_BITS)


def _add_tally(tally: torch.Tensor, flat: torch.Tensor, m: int,
               min_table_hits: int) -> None:
    """What the wide kernel adds to a tally: each read's non-SENTINEL
    ids, and the reads that it sorts in tiles: more than TILE ids left
    after its sift (none where F*C pads to WARP_MERGE or less).  With
    min_table_hits over 1, a read of more than SIFT_FROM ids keeps those
    whose sketch counter (the ids of the read in its slot) reaches it."""
    if _m_pad(m) <= WARP_MERGE:
        return
    valid = flat != SENTINEL
    k = valid.sum(dim=1)
    left = k
    if min_table_hits > 1:
        slot = _sketch_slots(flat)
        sketch = torch.zeros((flat.shape[0], 1 << SKETCH_BITS),
                             dtype=torch.int64, device=flat.device
                             ).scatter_add_(1, slot, valid.to(torch.int64))
        sifted = (valid & (sketch.gather(1, slot) >= min_table_hits)).sum(1)
        left = torch.where(k > SIFT_FROM, sifted, k)
    tally += k.sum() + ((left > TILE).sum() << TALLY_TILED_SHIFT)


def vote_candidates_fnc_plain(cand_fnc: torch.Tensor, min_table_hits: int,
                              out_cap: int,
                              tally: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version: sort, run lengths by a suffix min of run
    starts, cumsum ranks, scatter into out_cap (+1 dropped) slots.  With
    a tally, adds to it what the kernel adds."""
    f, n, c = cand_fnc.shape
    m = f * c
    dev = cand_fnc.device
    if m == 0:
        return (torch.full((n, out_cap), SENTINEL, dtype=torch.int64,
                           device=dev),
                torch.zeros((n, out_cap), dtype=torch.int32, device=dev),
                torch.zeros((n,), dtype=torch.int32, device=dev))
    flat = torch.sort(cand_fnc.permute(1, 0, 2).reshape(n, m).to(torch.int64),
                      dim=1).values
    if tally is not None:
        _add_tally(tally, flat, m, min_table_hits)
    prev = torch.cat([torch.full((n, 1), SENTINEL, dtype=torch.int64,
                                 device=dev), flat[:, :-1]], dim=1)
    iota = torch.arange(m, device=dev)[None, :]
    is_start = ((flat != prev) | (iota == 0)) & (flat != SENTINEL)
    start_pos = torch.where(is_start | (flat == SENTINEL), iota,
                            torch.full_like(iota, m))
    suffix_min = torch.cummin(start_pos.flip(1), dim=1).values.flip(1)
    nxt = torch.cat([suffix_min[:, 1:],
                     torch.full((n, 1), m, dtype=torch.int64, device=dev)],
                    dim=1)
    run_len = nxt - iota
    keep = is_start & (run_len >= min_table_hits) if min_table_hits > 1 \
        else is_start
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    num_kept = torch.where(keep, rank + 1, torch.zeros_like(rank)).amax(dim=1)
    slot = torch.where(keep & (rank < out_cap), rank,
                       torch.full_like(rank, out_cap))
    ids = torch.full((n, out_cap + 1), SENTINEL, dtype=torch.int64,
                     device=dev).scatter_(1, slot, flat)[:, :out_cap]
    cnt = torch.zeros((n, out_cap + 1), dtype=torch.int64,
                      device=dev).scatter_(1, slot, run_len)[:, :out_cap]
    return ids, cnt.to(torch.int32), num_kept.to(torch.int32)


def vote_candidates_fnc(cand_fnc: torch.Tensor, min_table_hits: int,
                        out_cap: int, tally: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vote over probe output in its native [F, N, C] layout (u32 ids in
    int64, each list SENTINEL-padded).  Returns (ids [N, out_cap] int64,
    counts [N, out_cap] int32, num_kept [N] int32; num_kept may exceed
    out_cap).  tally: an int64 [1] tensor on the same device, or None;
    where F*C pads above WARP_MERGE the call adds its ids present and
    its reads sorted in tiles to it (tally_counts reads it back)."""
    if cand_fnc.device.type == "cpu":
        return vote_candidates_fnc_plain(cand_fnc, min_table_hits, out_cap,
                                         tally)
    if cand_fnc.dim() != 3 or out_cap < 0:
        raise ValueError("expected cand_fnc [F, N, C] and out_cap >= 0")
    f, n, c = cand_fnc.shape
    if f * c > MAX_MERGE:
        raise ValueError(f"vote_candidates_fnc: F*C = {f * c} exceeds the "
                         f"kernels' {MAX_MERGE}-id merge")
    cand = cand_fnc.to(torch.int64).contiguous()
    dev = cand.device
    ids = torch.empty((n, out_cap), dtype=torch.int64, device=dev)
    cnt = torch.empty((n, out_cap), dtype=torch.int32, device=dev)
    num_kept = torch.empty((n,), dtype=torch.int32, device=dev)
    # the wide kernel's rows of gathered ids (u32)
    m_pad = _m_pad(f * c)
    scratch = (torch.empty((n, m_pad), dtype=torch.int32, device=dev)
               if m_pad > WARP_MERGE else None)
    _build.check_cuda("vote_candidates_fnc", cand, ids, cnt, num_kept,
                      *([] if tally is None else [tally]))
    if tally is not None and (tally.dtype != torch.int64
                              or tally.numel() != 1):
        raise ValueError("vote_candidates_fnc: tally must be int64 [1]")
    _build.launch("hrm_vote", cand,
                  cand.data_ptr(), ids.data_ptr(), cnt.data_ptr(),
                  num_kept.data_ptr(),
                  None if scratch is None else scratch.data_ptr(),
                  None if tally is None else tally.data_ptr(),
                  f, n, c, min_table_hits, out_cap)
    vote_candidates_fnc.launches += 1
    return ids, cnt, num_kept


vote_candidates_fnc.launches = 0
