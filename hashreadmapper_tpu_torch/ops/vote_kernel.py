"""Fused candidate vote over probe output (counterpart of
hashreadmapper_tpu/ops/vote_pallas.py::vote_candidates_fnc).

Per read: merge the F candidate lists, count each distinct non-SENTINEL
id, keep ids seen in >= min_table_hits tables in ascending id order in
out_cap slots.  vote_candidates_fnc launches csrc/vote.cu for CUDA tensors
(a warp a read sorting u32 keys in registers up to 2,048 ids, a block a
read in shared memory above) and runs vote_candidates_fnc_plain for CPU
tensors.  Unlike the TPU kernel, neither needs sorted lists, C a power of
two or N a multiple of 128.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build

SENTINEL = 0xFFFFFFFF
MAX_MERGE = 16384        # F*C padded to a power of two: 64 KB of u32 keys


def vote_candidates_fnc_plain(cand_fnc: torch.Tensor, min_table_hits: int,
                              out_cap: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version: sort, run lengths by a suffix min of run
    starts, cumsum ranks, scatter into out_cap (+1 dropped) slots."""
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
                        out_cap: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vote over probe output in its native [F, N, C] layout (u32 ids in
    int64, each list SENTINEL-padded).  Returns (ids [N, out_cap] int64,
    counts [N, out_cap] int32, num_kept [N] int32; num_kept may exceed
    out_cap)."""
    if cand_fnc.device.type == "cpu":
        return vote_candidates_fnc_plain(cand_fnc, min_table_hits, out_cap)
    if cand_fnc.dim() != 3 or out_cap < 0:
        raise ValueError("expected cand_fnc [F, N, C] and out_cap >= 0")
    f, n, c = cand_fnc.shape
    if f * c > MAX_MERGE:
        raise ValueError(f"vote_candidates_fnc: F*C = {f * c} exceeds the "
                         f"kernel's {MAX_MERGE}-id shared-memory merge")
    cand = cand_fnc.to(torch.int64).contiguous()
    dev = cand.device
    ids = torch.empty((n, out_cap), dtype=torch.int64, device=dev)
    cnt = torch.empty((n, out_cap), dtype=torch.int32, device=dev)
    num_kept = torch.empty((n,), dtype=torch.int32, device=dev)
    _build.check_cuda("vote_candidates_fnc", cand, ids, cnt, num_kept)
    _build.launch("hrm_vote", cand,
                  cand.data_ptr(), ids.data_ptr(), cnt.data_ptr(),
                  num_kept.data_ptr(), f, n, c, min_table_hits, out_cap)
    vote_candidates_fnc.launches += 1
    return ids, cnt, num_kept


vote_candidates_fnc.launches = 0
