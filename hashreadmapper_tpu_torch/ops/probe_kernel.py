"""The capped CSR probe of a read batch as two kernels (counterpart of the
XLA fusions of hashreadmapper_tpu/index/minhash_index.py::probe_tables;
no pallas_call stands behind it).

probe_lookup: per (table, query) the match count and first value offset
(cuckoo slot table, bucketed binary search or a plain searchsorted), with
max_values_per_key, the dropped-key search, sig_valid and the SENTINEL
query, and per block of THREADS probes in flat f * N + n order the
tallies of the head tier (counts > 0), the tail tier (counts > c1) and the
overflow counter (counts > probe_cap).  probe_gather: the tiers' ranks from
the tallies, the head slots [0, c1) (dense, or the first head_budget found
probes) and the tail slots [c1, probe_cap) (the first tail_budget probes
with counts > c1) into one [F, N, probe_cap] cand, and stats [3] int64
(probes over the cap, tail drops, head drops).

For CUDA tensors each wrapper launches its entry of csrc/probe.cu, for CPU
tensors it runs its plain version: the port's probe code as torch
operations (plus the tallies, which the kernel's gather reads).  Nothing
falls back: a CUDA input the kernel cannot take raises ValueError.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from . import u64

SENTINEL = 0xFFFFFFFF
THREADS = 256             # probes a block of csrc/probe.cu: a tally's unit
# lookup modes, as csrc/probe.cu numbers them
CUCKOO, BUCKETED, SEARCHSORTED = 0, 1, 2


def _bucketed_lower_bound(keys, bucket_start, queries, steps: int):
    """Branchless lower_bound per (table, query) from a radix head start."""
    bits = int(bucket_start.shape[1] - 1).bit_length() - 1
    b = queries >> (32 - bits)
    lo = torch.gather(bucket_start, 1, b)
    hi = torch.gather(bucket_start, 1, b + 1)
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        kmid = torch.gather(keys, 1, mid.clamp(max=keys.shape[1] - 1))
        go_right = active & (kmid < queries)
        lo, hi = (torch.where(go_right, mid + 1, lo),
                  torch.where(active & ~go_right, mid, hi))
    return lo


def _dropped_hit(dropped_keys, sigs_t):
    dkeys, dnum = dropped_keys
    didx = torch.searchsorted(dkeys, sigs_t)
    found = torch.gather(dkeys, 1, didx.clamp(max=dkeys.shape[1] - 1))
    return (found == sigs_t) & (didx < dnum[:, None])


def _compact_gather(flat_sel_mask, budget, off0, cap_eff, values, n, c_lo,
                    c_hi):
    """Gather value slots [c_lo, c_hi) of the first `budget` (f, n) probes
    whose flat_sel_mask is set, scattered back to a dense [F, N, c_hi-c_lo]
    block (SENTINEL elsewhere).  Returns (block, dropped probe count)."""
    f, v_cols = values.shape
    dev = values.device
    fn = flat_sel_mask.shape[0]
    rank = torch.cumsum(flat_sel_mask.to(torch.int64), dim=0) - 1
    n_sel = flat_sel_mask.sum()
    slot = torch.where(flat_sel_mask & (rank < budget), rank,
                       torch.full_like(rank, budget))
    sel = torch.zeros(budget + 1, dtype=torch.int64, device=dev).scatter_(
        0, slot, torch.arange(fn, device=dev))[:budget]
    sel_valid = torch.arange(budget, device=dev) < n_sel
    cols = torch.arange(c_lo, c_hi, device=dev)[None, :]
    g = (sel // n)[:, None] * v_cols + off0.reshape(-1)[sel][:, None] + cols
    inside = (cols < cap_eff.reshape(-1)[sel][:, None]) & sel_valid[:, None]
    v = values.reshape(-1)[g.clamp(0, f * v_cols - 1)]
    v = torch.where(inside, v, torch.full_like(v, SENTINEL))
    block = torch.full((fn + 1, c_hi - c_lo), SENTINEL, dtype=torch.int64,
                       device=dev)
    block[torch.where(sel_valid, sel, torch.full_like(sel, fn))] = v
    return (block[:fn].reshape(f, n, c_hi - c_lo),
            (n_sel - budget).clamp(min=0))


def tallies_of(counts: torch.Tensor, c1: int, probe_cap: int
               ) -> torch.Tensor:
    """[3, ceil(F * N / THREADS)] int32: per block of THREADS probes in
    flat order, the probes with counts > 0, > c1 and > probe_cap."""
    flat = counts.reshape(-1)
    nblk = max(1, -(-flat.shape[0] // THREADS))
    pad = torch.zeros(nblk * THREADS - flat.shape[0], dtype=flat.dtype,
                      device=flat.device)
    blocks = torch.cat([flat, pad]).reshape(nblk, THREADS)
    return torch.stack([(blocks > t).sum(dim=1)
                        for t in (0, c1, probe_cap)]).to(torch.int32)


def probe_lookup_plain(sigs, sig_valid, index_keys, index_offsets,
                       index_num_keys, probe_cap: int, c1: int,
                       dropped_keys=None, bucket_start=None,
                       probe_steps: int = 0, cuckoo=None,
                       cuckoo_bits: int = 0, cuckoo_seeds=(0, 0),
                       max_values_per_key: int = 0):
    """Plain version of probe_lookup."""
    sigs_t = sigs.T.contiguous()                                  # [F, N]
    if cuckoo is not None:
        c_keys, c_payload = cuckoo
        sh = 32 - cuckoo_bits
        p1 = u64.mul_lo32(sigs_t ^ cuckoo_seeds[0], 0x9E3779B1) >> sh
        p2 = u64.mul_lo32(sigs_t ^ cuckoo_seeds[1], 0x85EBCA77) >> sh
        hit1 = torch.gather(c_keys, 1, p1) == sigs_t
        hit2 = torch.gather(c_keys, 1, p2) == sigs_t
        found = (hit1 | hit2) & sig_valid[None, :] & (sigs_t != SENTINEL)
        pay = torch.gather(c_payload, 1, torch.where(hit1, p1, p2))
        off0 = torch.where(found, pay >> 10, torch.zeros_like(pay))
        cnt = pay & 1023
    else:
        if bucket_start is not None:
            idx = _bucketed_lower_bound(index_keys, bucket_start, sigs_t,
                                        probe_steps)
        else:
            idx = torch.searchsorted(index_keys, sigs_t)
        idx_c = idx.clamp(max=index_keys.shape[1] - 1)
        found = ((torch.gather(index_keys, 1, idx_c) == sigs_t)
                 & (idx < index_num_keys[:, None]) & sig_valid[None, :])
        off0 = torch.gather(index_offsets, 1, idx_c)
        cnt = torch.gather(index_offsets, 1, idx_c + 1) - off0
        if max_values_per_key > 0:
            found = found & (cnt <= max_values_per_key)
    if dropped_keys is not None:
        found = found & ~_dropped_hit(dropped_keys, sigs_t)
    counts = torch.where(found, cnt, torch.zeros_like(cnt))        # [F, N]
    return counts, off0, tallies_of(counts, c1, probe_cap)


def probe_gather_plain(counts, off0, tallies, index_values, probe_cap: int,
                       c1: int, tail_budget: int, head_budget: int):
    """Plain version of probe_gather (the tallies are the kernel's; the
    plain version ranks from counts)."""
    f, n = counts.shape
    v_cols = index_values.shape[1]
    dev = counts.device
    cap_eff = counts.clamp(max=probe_cap)
    two_tier = c1 < probe_cap
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    head_drops = zero
    if head_budget > 0 and two_tier:
        head, head_drops = _compact_gather(
            (counts > 0).reshape(-1), head_budget, off0, cap_eff,
            index_values, n, 0, c1)
    else:
        slot = torch.arange(c1, device=dev)
        gidx = (off0[:, :, None] + slot).clamp(0, v_cols - 1)
        vals = torch.gather(index_values, 1, gidx.reshape(f, -1))
        head = torch.where(slot < cap_eff[:, :, None],
                           vals.reshape(f, n, c1),
                           torch.full((), SENTINEL, device=dev))

    tail_drops = zero
    cand = head
    if two_tier:
        tail, tail_drops = _compact_gather(
            (counts > c1).reshape(-1), tail_budget, off0, cap_eff,
            index_values, n, c1, probe_cap)
        cand = torch.cat([head, tail], dim=2)
    stats = torch.stack([(counts > probe_cap).sum(), tail_drops,
                         head_drops])
    return cand, stats


def _table(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    """An index table as the kernels read it: int64, row-major.  Raises
    rather than copy it: a copy of a table at every batch would cost more
    than the probe itself at chr1 scale."""
    if t.dim() != len(shape) or any(s is not None and d != s
                                    for d, s in zip(t.shape, shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.dtype != torch.int64 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int64 table, got "
                         f"{t.dtype} with strides {t.stride()}")
    return t


def probe_lookup(sigs, sig_valid, index_keys, index_offsets,
                 index_num_keys, probe_cap: int, c1: int, dropped_keys=None,
                 bucket_start=None, probe_steps: int = 0, cuckoo=None,
                 cuckoo_bits: int = 0, cuckoo_seeds=(0, 0),
                 max_values_per_key: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[N, F] query signatures (u32 in int64) and sig_valid [N] against
    the F tables: (counts [F, N] int64 true match counts, off0 [F, N]
    int64 first value offsets, tallies [3, ceil(F * N / THREADS)] int32).
    cuckoo=(keys, payload) probes the slot table, else bucket_start the
    bucketed search of probe_steps halvings, else a searchsorted over the
    whole padded key row."""
    if sigs.device.type == "cpu":
        return probe_lookup_plain(
            sigs, sig_valid, index_keys, index_offsets, index_num_keys,
            probe_cap, c1, dropped_keys, bucket_start, probe_steps, cuckoo,
            cuckoo_bits, cuckoo_seeds, max_values_per_key)
    if sigs.dim() != 2:
        raise ValueError(f"probe_lookup: expected sigs [N, F], got "
                         f"{tuple(sigs.shape)}")
    n, f = sigs.shape
    if f * n >= 2**31:
        raise ValueError(f"probe_lookup: F*N = {f * n} probes, the kernel "
                         "indexes them in 32 bits")
    if sigs.dtype != torch.int64 or sigs.stride(1) != 1 or sigs.stride(0) < f:
        sigs = sigs.to(torch.int64).contiguous()
    valid = sig_valid.to(torch.bool).contiguous()
    if valid.shape != (n,):
        raise ValueError(f"probe_lookup: sig_valid must be [{n}], got "
                         f"{tuple(valid.shape)}")
    keys = _table("probe_lookup keys", index_keys, (f, None))
    u = keys.shape[1]
    offsets = _table("probe_lookup offsets", index_offsets, (f, u + 1))
    num_keys = _table("probe_lookup num_keys", index_num_keys, (f,))
    ins = [sigs, valid, keys, offsets, num_keys]
    bstart = ck = cp = dk = dn = None
    bits = cbits = d_cols = 0
    if cuckoo is not None:
        mode = CUCKOO
        if not 0 <= cuckoo_bits <= 32:
            raise ValueError(f"probe_lookup: cuckoo_bits {cuckoo_bits} "
                             "outside [0, 32]")
        slots = (f, 1 << cuckoo_bits)
        ck = _table("probe_lookup cuckoo keys", cuckoo[0], slots)
        cp = _table("probe_lookup cuckoo payload", cuckoo[1], slots)
        cbits = cuckoo_bits
        ins += [ck, cp]
    elif bucket_start is not None:
        mode = BUCKETED
        bits = int(bucket_start.shape[1] - 1).bit_length() - 1
        if bucket_start.shape[1] != (1 << bits) + 1 or not 1 <= bits <= 32:
            raise ValueError("probe_lookup: bucket_start must be "
                             "[F, 2**bits + 1], 1 <= bits <= 32")
        bstart = _table("probe_lookup bucket_start", bucket_start,
                        (f, (1 << bits) + 1))
        ins.append(bstart)
    else:
        mode = SEARCHSORTED
    if mode != CUCKOO and u < 1:
        raise ValueError("probe_lookup: empty key rows")
    if dropped_keys is not None:
        dk = _table("probe_lookup dropped keys", dropped_keys[0], (f, None))
        dn = _table("probe_lookup dropped counts", dropped_keys[1], (f,))
        d_cols = dk.shape[1]
        if d_cols < 1:
            raise ValueError("probe_lookup: dropped-key rows must be at "
                             "least one wide (the empty table is one "
                             "SENTINEL column)")
        ins += [dk, dn]
    if not 0 <= c1 <= probe_cap:
        raise ValueError(f"probe_lookup: c1 {c1} outside [0, probe_cap "
                         f"{probe_cap}]")
    dev = valid.device
    nblk = max(1, -(-(f * n) // THREADS))
    counts = torch.empty((f, n), dtype=torch.int64, device=dev)
    off0 = torch.empty((f, n), dtype=torch.int64, device=dev)
    tallies = torch.empty((3, nblk), dtype=torch.int32, device=dev)
    # sigs may be a column block of wider rows (the mesh's table shards)
    _build.check_cuda("probe_lookup", *ins[1:], counts, off0, tallies)
    if sigs.device != dev:
        raise ValueError(f"probe_lookup: sigs on {sigs.device}, the other "
                         f"inputs on {dev}")
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.launch("hrm_probe_lookup", sigs, sigs.data_ptr(), sigs.stride(0),
                  valid.data_ptr(), keys.data_ptr(), offsets.data_ptr(),
                  num_keys.data_ptr(), u, ptr(bstart), bits, probe_steps,
                  ptr(ck), ptr(cp), cbits, int(cuckoo_seeds[0]),
                  int(cuckoo_seeds[1]), ptr(dk), ptr(dn), d_cols,
                  counts.data_ptr(), off0.data_ptr(), tallies.data_ptr(), f,
                  n, mode, max_values_per_key, probe_cap, c1, nblk)
    probe_lookup.launches += 1
    return counts, off0, tallies


probe_lookup.launches = 0


def probe_gather(counts, off0, tallies, index_values, probe_cap: int,
                 c1: int, tail_budget: int, head_budget: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """probe_lookup's outputs -> (cand [F, N, probe_cap] int64 value ids,
    ascending within a probe, SENTINEL where empty; stats [3] int64:
    probes with counts > probe_cap, tail drops, head drops).  With c1 <
    probe_cap (the two tiers) the tail slots [c1, probe_cap) are gathered
    for the first tail_budget probes with counts > c1 and, with
    head_budget > 0, the head slots [0, c1) for the first head_budget
    probes with counts > 0 only."""
    if counts.device.type == "cpu":
        return probe_gather_plain(counts, off0, tallies, index_values,
                                  probe_cap, c1, tail_budget, head_budget)
    if counts.dim() != 2:
        raise ValueError(f"probe_gather: expected counts [F, N], got "
                         f"{tuple(counts.shape)}")
    f, n = counts.shape
    if f * n >= 2**31 or THREADS * probe_cap >= 2**31:
        raise ValueError(f"probe_gather: F*N = {f * n} probes or a block's "
                         f"{THREADS} x probe_cap {probe_cap} slots, the "
                         "kernel indexes them in 32 bits")
    nblk = max(1, -(-(f * n) // THREADS))
    counts = _table("probe_gather counts", counts, (f, n))
    off0 = _table("probe_gather off0", off0, (f, n))
    values = _table("probe_gather values", index_values, (f, None))
    if tallies.shape != (3, nblk) or tallies.dtype != torch.int32:
        raise ValueError(f"probe_gather: tallies must be [3, {nblk}] int32 "
                         "(probe_lookup's)")
    tallies = tallies.contiguous()
    if values.shape[1] < 1:
        raise ValueError("probe_gather: empty value rows")
    if not 0 <= c1 <= probe_cap:
        raise ValueError(f"probe_gather: c1 {c1} outside [0, probe_cap "
                         f"{probe_cap}]")
    cand = torch.empty((f, n, probe_cap), dtype=torch.int64,
                       device=counts.device)
    stats = torch.empty((3,), dtype=torch.int64, device=counts.device)
    _build.check_cuda("probe_gather", counts, off0, tallies, values, cand,
                      stats)
    _build.launch("hrm_probe_gather", counts, counts.data_ptr(),
                  off0.data_ptr(), tallies.data_ptr(), values.data_ptr(),
                  values.shape[1], cand.data_ptr(), stats.data_ptr(), f, n,
                  probe_cap, c1, tail_budget, head_budget, nblk)
    probe_gather.launches += 1
    return cand, stats


probe_gather.launches = 0
