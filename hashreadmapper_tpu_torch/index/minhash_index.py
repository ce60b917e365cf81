"""Static CSR minhash index in device memory, its probe and the vote
(counterpart of hashreadmapper_tpu/index/minhash_index.py).

One CSR table per hash function maps a signature to the ascending ids of
the genome windows that carry it; read signatures probe it with a
bucketed binary search or a two-choice cuckoo slot table, capped per
(table, read), and the vote keeps windows hit in >= min_table_hits
tables.  All u32 quantities (keys, ids, payloads) are int64 tensors in
[0, 2**32); the .npz artifact keeps the JAX package's keys and dtypes, so
an index saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from ..ops import u64
from ..ops.vote_kernel import vote_candidates_fnc

SENTINEL = 0xFFFFFFFF


@dataclasses.dataclass
class CsrIndex:
    """keys [F, U] ascending + SENTINEL pad; offsets [F, U+1]; values
    [F, V] ids grouped by key, ascending within a key; num_keys [F]."""
    keys: torch.Tensor
    offsets: torch.Tensor
    values: torch.Tensor
    num_keys: torch.Tensor
    kmer_length: int
    hash_ids: np.ndarray
    bucket_start: Optional[torch.Tensor] = None    # [F, 2^bits + 1]
    probe_steps: int = 0
    bucket_bits: int = 16
    cuckoo_keys: Optional[torch.Tensor] = None     # [F, 2^bits]
    cuckoo_payload: Optional[torch.Tensor] = None  # [F, 2^bits] off<<10|cnt
    cuckoo_bits: int = 0
    cuckoo_seeds: Tuple[int, int] = (0, 0)
    cuckoo_fallback_reason: Optional[str] = None

    def build_buckets(self) -> None:
        """Radix directory sized so buckets average ~2 keys (12..22 bits)."""
        n_keys = max(1, int(self.num_keys.max()))
        self.bucket_bits = int(np.clip(np.ceil(np.log2(n_keys)), 12, 22))
        self.bucket_start = build_probe_buckets(self.keys, self.num_keys,
                                                self.bucket_bits)
        sizes = self.bucket_start[:, 1:] - self.bucket_start[:, :-1]
        max_bucket = int(sizes.max())
        self.probe_steps = max(1, int(np.ceil(np.log2(max_bucket + 1))))

    def build_cuckoo(self) -> bool:
        """Host-built two-choice cuckoo slot table (native/cuckoo.cpp);
        False (binary search stays) when it cannot be built, with the
        reason in cuckoo_fallback_reason."""
        built, reason = build_cuckoo_arrays(
            self.keys.cpu().numpy().astype(np.uint32),
            self.offsets.cpu().numpy(), self.num_keys.cpu().numpy(),
            int(self.values.shape[1]))
        if built is None:
            self.cuckoo_fallback_reason = reason
            return False
        self.cuckoo_fallback_reason = None
        ck, payload, bits, seeds = built
        dev = self.keys.device
        self.cuckoo_keys = torch.from_numpy(ck.astype(np.int64)).to(dev)
        self.cuckoo_payload = torch.from_numpy(
            payload.astype(np.int64)).to(dev)
        self.cuckoo_bits = bits
        self.cuckoo_seeds = seeds
        return True

    @property
    def num_tables(self) -> int:
        return int(self.keys.shape[0])

    def memory_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.keys, self.offsets, self.values,
                             self.num_keys, self.bucket_start,
                             self.cuckoo_keys, self.cuckoo_payload)
                   if t is not None)

    def save(self, path: str) -> None:
        """The JAX package's .npz artifact: same keys and dtypes."""
        np.savez_compressed(
            path, keys=self.keys.cpu().numpy().astype(np.uint32),
            offsets=self.offsets.cpu().numpy().astype(np.int32),
            values=self.values.cpu().numpy().astype(np.uint32),
            num_keys=self.num_keys.cpu().numpy().astype(np.int32),
            kmer_length=self.kmer_length, hash_ids=self.hash_ids)

    @classmethod
    def load(cls, path: str, device) -> "CsrIndex":
        d = np.load(path)
        t = lambda a: torch.from_numpy(a.astype(np.int64)).to(device)
        return cls(t(d["keys"]), t(d["offsets"]), t(d["values"]),
                   t(d["num_keys"]), int(d["kmer_length"]),
                   np.asarray(d["hash_ids"], dtype=np.uint32))


def build_cuckoo_arrays(keys_np: np.ndarray, offs_np: np.ndarray,
                        nk: np.ndarray, v_cols: int):
    """((keys [F, 2^bits] uint32, payload [F, 2^bits] uint32, bits,
    (seed1, seed2)), None) or (None, reason); the same seeds, sizes and
    payload packing as the JAX package, through native/cuckoo.cpp
    (which raises when the native library cannot be built)."""
    if v_cols >= (1 << 22):
        return None, (f"value array width {v_cols} exceeds the 22-bit "
                      "payload offset field")
    max_keys = int(nk.max()) if len(nk) else 0
    if max_keys == 0:
        return None, "empty index"
    f = keys_np.shape[0]
    base_bits = max(10, int(np.ceil(np.log2(max(2 * max_keys, 2)))))
    for attempt in range(4):
        bits = min(base_bits + (attempt + 1) // 2, 26)
        seed1 = 0x5D588B65 * (attempt + 1) & 0xFFFFFFFF
        seed2 = 0x2545F491 * (attempt + 1) & 0xFFFFFFFF
        ck = np.full((f, 1 << bits), SENTINEL, dtype=np.uint32)
        payload = np.zeros((f, 1 << bits), dtype=np.uint32)
        ok = True
        for t in range(f):
            kt = keys_np[t, :nk[t]]
            if (kt == SENTINEL).any():
                return None, "a key equals the SENTINEL/empty marker"
            slots = native.cuckoo_build(kt, bits, seed1, seed2)
            if slots is None:
                ok = False
                break
            off0 = offs_np[t, :nk[t]].astype(np.int64)
            cnt = offs_np[t, 1:nk[t] + 1].astype(np.int64) - off0
            ck[t, slots] = kt
            payload[t, slots] = ((off0.astype(np.uint32) << 10)
                                 | np.minimum(cnt, 1023).astype(np.uint32))
        if ok:
            return (ck, payload, bits, (seed1, seed2)), None
    return None, "cuckoo insertion failed after 4 seed attempts"


def build_dropped_keys(signatures: np.ndarray, valid: np.ndarray,
                       max_values_per_key: int):
    """Per-table sorted arrays of the read-signature keys carried by more
    than max_values_per_key reads (hashreadmapper_tpu minhash_index.py
    :238): a (read, table) probe whose own signature is such a key is
    skipped, as the reference's read index never stored those reads.
    Returns ([F, D] uint32 padded with SENTINEL, [F] int32 counts)."""
    n, f = signatures.shape
    dropped = []
    for t in range(f):
        ukeys, counts = np.unique(signatures[valid, t], return_counts=True)
        dropped.append(ukeys[counts > max_values_per_key].astype(np.uint32))
    d_max = max(1, max(len(d) for d in dropped))
    out = np.full((f, d_max), SENTINEL, dtype=np.uint32)
    for t in range(f):
        out[t, :len(dropped[t])] = dropped[t]
    return out, np.array([len(d) for d in dropped], dtype=np.int32)


def build_csr_index_device(signatures: torch.Tensor, valid: torch.Tensor,
                           kmer_length: int, hash_ids) -> CsrIndex:
    """CSR build on the signatures' device: per table a stable sort, run
    starts, ranks and scatters (radix sort + reduce_by_key).  No key
    dropping; the padded key width U equals the item count N."""
    n, f = signatures.shape
    dev = signatures.device
    key_in = torch.where(valid[None, :], signatures.T,
                         torch.full((f, n), SENTINEL, dtype=torch.int64,
                                    device=dev))
    keys_sorted, vals_sorted = torch.sort(key_in, dim=1, stable=True)
    is_real = keys_sorted != SENTINEL
    prev = torch.cat([torch.full((f, 1), SENTINEL, dtype=torch.int64,
                                 device=dev), keys_sorted[:, :-1]], dim=1)
    iota = torch.arange(n, device=dev)[None, :].expand(f, n)
    is_start = ((keys_sorted != prev) | (iota == 0)) & is_real
    rank = torch.cumsum(is_start.to(torch.int64), dim=1) - 1
    num_keys = torch.where(is_start, rank + 1,
                           torch.zeros_like(rank)).amax(dim=1)
    keys = torch.full((f, n + 1), SENTINEL, dtype=torch.int64, device=dev)
    keys.scatter_(1, torch.where(is_start, rank, torch.full_like(rank, n)),
                  keys_sorted)
    offsets = torch.zeros((f, n + 2), dtype=torch.int64, device=dev)
    offsets.scatter_(1, torch.where(is_start, rank,
                                    torch.full_like(rank, n + 1)), iota)
    offsets = offsets[:, :n + 1].contiguous()
    n_valid = is_real.sum(dim=1)
    offsets.scatter_(1, num_keys.clamp(max=n)[:, None], n_valid[:, None])
    values = torch.where(is_real, vals_sorted,
                         torch.full_like(vals_sorted, SENTINEL))
    return CsrIndex(keys=keys[:, :n].contiguous(), offsets=offsets,
                    values=values, num_keys=num_keys,
                    kmer_length=kmer_length,
                    hash_ids=np.asarray(hash_ids, dtype=np.uint32))


def build_probe_buckets(keys: torch.Tensor, num_keys: torch.Tensor,
                        bits: int) -> torch.Tensor:
    """bucket_start[f, b] = first key of table f whose top `bits` bits are
    >= b; bucket_start[f, 2^bits] = num_keys[f]."""
    tops = torch.arange(1 << bits, dtype=torch.int64,
                        device=keys.device) << (32 - bits)
    starts = torch.stack([torch.searchsorted(keys[t].contiguous(), tops)
                          for t in range(keys.shape[0])])
    starts = torch.minimum(starts, num_keys[:, None])
    return torch.cat([starts, num_keys[:, None]], dim=1)


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


def probe_tables(index_keys, index_offsets, index_values, index_num_keys,
                 sigs, sig_valid, probe_cap: int, dropped_keys=None,
                 bucket_start=None, probe_steps: int = 0,
                 tail_budget: int = 0, head_budget: int = 0, cuckoo=None,
                 cuckoo_bits: int = 0, cuckoo_seeds=(0, 0),
                 max_values_per_key: int = 0):
    """Capped CSR lookup of [N, F] query signatures, in the probe's native
    layout: (cand [F, N, probe_cap] ascending ids, SENTINEL where empty;
    counts [F, N] true match counts; tail_drops; head_drops).

    cuckoo=(keys, payload) probes the slot table, else the bucketed
    binary search (or a plain searchsorted without bucket_start).
    tail_budget > 0 gathers 4 head slots per probe and the remaining
    slots only for the <= tail_budget probes with count > 4; head_budget
    > 0 (with the two tiers) also compacts the found probes before the
    head gather.  Both are exact while their drop counter is 0.
    max_values_per_key > 0 finds nothing for a key carried by more values
    (the read index's drop-all rule, evaluated at probe time); it needs
    the exact counts of the binary search, not the cuckoo payload's.
    """
    n, f = sigs.shape
    sigs_t = sigs.T.contiguous()                                  # [F, N]
    if cuckoo is not None:
        if probe_cap >= 1023:
            raise ValueError("cuckoo payload counts saturate at 1023")
        if max_values_per_key > 0:
            raise ValueError("max_values_per_key needs exact counts; the "
                             "cuckoo payload saturates them at 1023")
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

    v_cols = index_values.shape[1]
    cap_eff = counts.clamp(max=probe_cap)
    two_tier = tail_budget > 0 and probe_cap > 4 and f * v_cols < 2**31
    c1 = 4 if two_tier else probe_cap
    zero = torch.zeros((), dtype=torch.int64, device=sigs.device)

    head_drops = zero
    if head_budget > 0 and two_tier:
        head, head_drops = _compact_gather(
            (counts > 0).reshape(-1), head_budget, off0, cap_eff,
            index_values, n, 0, c1)
    else:
        slot = torch.arange(c1, device=sigs.device)
        gidx = (off0[:, :, None] + slot).clamp(0, v_cols - 1)
        vals = torch.gather(index_values, 1, gidx.reshape(f, -1))
        head = torch.where(slot < cap_eff[:, :, None],
                           vals.reshape(f, n, c1),
                           torch.full((), SENTINEL, device=sigs.device))

    tail_drops = zero
    cand = head
    if two_tier:
        tail, tail_drops = _compact_gather(
            (counts > c1).reshape(-1), tail_budget, off0, cap_eff,
            index_values, n, c1, probe_cap)
        cand = torch.cat([head, tail], dim=2)
    return cand, counts, tail_drops, head_drops


def vote_candidates(cand: torch.Tensor, min_table_hits: int, out_cap: int):
    """vote over [N, F, C] candidates (ids [N, out_cap], counts
    [N, out_cap], num_kept [N])."""
    return vote_candidates_fnc(cand.permute(1, 0, 2), min_table_hits,
                               out_cap)


def vote_candidates_fnc_auto(cand_fnc: torch.Tensor, min_table_hits: int,
                             out_cap: int):
    """The vote over the probe's [F, N, C] output: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    return vote_candidates_fnc(cand_fnc, min_table_hits, out_cap)
