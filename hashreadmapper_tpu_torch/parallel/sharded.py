"""Table-sharded, data-parallel coarse mapping over a [data, table] mesh of
torch devices (counterpart of hashreadmapper_tpu/parallel/sharded.py).

The reference's own multi-GPU shape: one process drives every card, with
peer copies and no collective library (SURVEY.md §2.3;
multigpuminhasher.cuh:650-755):

  * the hash tables are split over the "table" axis, F / T consecutive
    tables a shard (MultiGpuMinhasher::Layout::EvenShare,
    multigpuminhasher.cuh:277-303); every shard builds its own CSR index,
    buckets and cuckoo table on the cards of its table column, and no card
    holds another shard's index;
  * a mesh batch is batchsize * D reads, and data shard d takes its rows
    [d * batchsize, (d + 1) * batchsize), so each data shard maps exactly
    the single mapper's batch i * D + d (the read rows of
    MultiGpu2dArray, multigpuarray.cuh:1315-1345);
  * per data shard the signatures are computed once on its first card,
    each table shard probes its F / T columns on its own card, and the
    partial [F / T, N, C] lists are copied back to the first card in table
    order (the JAX package's all_gather over the table axis); the vote,
    the SHD best and the fused STEP 2 run there.

The probe's head compaction is off on the mesh and its tail budget counts
per table shard, as in the JAX package, so a mesh equals the single mapper
wherever no budget or cap is over, and the JAX mesh always.  A device may
repeat in the mesh (every position "cpu" in the tests, a logical mesh on
one card): a shard that several positions share on one device is built
and stored once there.

The dispatch units (the JAX package's one shard_map'd program a mesh
batch): a data shard's batch is a pipeline/graphs.py CapturedStep, one
replay of a captured CUDA graph on a card, the eager step on the CPU.
Where every table shard of the row lies on its first device (a logical
mesh, every CPU mesh) the row is one step; else it is split at the cards:
the head (signatures) and the tail (vote, SHD best, fused STEP 2) on the
first device and one probe step a card, with the copies between cards
outside the graphs.  One thread enqueues every batch of every data shard
with no host sync, each card's replays and copies on that card's one
stream (graphs.stream: the graphs of a card share its pool, so they
replay in turn on one stream).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
from typing import Dict, List

import numpy as np
import torch

from ..config import ProgramOptions
from ..index import minhash_index as mi
from ..io.genome import Genome
from ..ops import minhash
from ..pipeline import graphs
from ..pipeline.engine import (OVERFLOW_KEYS, SENTINEL, CoarseMapper,
                               CoarseResults, WindowTable, coarse_pairs_best,
                               fused_step2_scores, window_bases_device)


def _device(d) -> torch.device:
    """torch.device(d), with the current card's index on a bare "cuda"."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A [data, table] grid of torch devices; a device may repeat."""

    def __init__(self, devices: List[List]):
        self.devices = [[_device(d) for d in row] for row in devices]
        self.shape = {"data": len(self.devices),
                      "table": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]

    def column(self, t: int) -> List[torch.device]:
        """The distinct devices of table column t, in data order."""
        return list(dict.fromkeys(row[t] for row in self.devices))


def make_mesh(data: int, table: int, devices=None) -> Mesh:
    """A data x table mesh: of the first data * table CUDA cards (raises
    when there are fewer), or of `devices` in row-major order."""
    n = data * table
    if devices is None:
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(f"--mesh {data} {table} needs {n} CUDA "
                             f"devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"a {data}x{table} mesh takes {n} devices, got "
                         f"{len(devices)}")
    return Mesh([devices[d * table:(d + 1) * table] for d in range(data)])


@contextlib.contextmanager
def _card_streams(devices):
    """Each CUDA card of `devices` with its own stream (graphs.stream) as
    its current stream, ordered after the work queued on the card's
    current stream; on exit the current streams are back, ordered after
    the cards' streams.  Nothing on the CPU."""
    prev = {}
    try:
        for dev in dict.fromkeys(devices):
            if dev.type != "cuda":
                continue
            with torch.cuda.device(dev):
                prev[dev] = torch.cuda.current_stream(dev)
                own = graphs.stream(dev)
                own.wait_stream(prev[dev])
                torch.cuda.set_stream(own)
        yield
    finally:
        for dev, cur in prev.items():
            with torch.cuda.device(dev):
                cur.wait_stream(graphs.stream(dev))
                torch.cuda.set_stream(cur)


def _index_to(idx: mi.CsrIndex, dev: torch.device) -> mi.CsrIndex:
    """A copy of a built index on another device."""
    return dataclasses.replace(idx, **{
        f.name: getattr(idx, f.name).to(dev)
        for f in dataclasses.fields(idx)
        if isinstance(getattr(idx, f.name), torch.Tensor)})


class ShardedCoarseMapper:
    """The window index split over the table axis of `mesh`, and read
    batches split over its data axis; the contract of CoarseMapper
    (map_reads, map_reads_packed, stage_reads_device, map_staged,
    fetch_results, the key-drop hooks, segments), so the driver,
    mapping.run_cssw and RegionShardedMapper drive it unchanged, and the
    JAX ShardedCoarseMapper's map_batch and _map_reads_device(_scored).
    `device` is the mesh's first device.  plan: for each data shard,
    ((device, table shards), ...), the cards its probes run on (each
    table shard once, on a device of its column); by default its table
    shards grouped by card."""

    supports_fused_scores = True

    def __init__(self, genome: Genome, opts: ProgramOptions, mesh: Mesh,
                 segments=None, build_direct_probe: bool = True, *,
                 plan=None):
        self.mesh = mesh
        self.opts = opts
        n_table = mesh.shape["table"]
        # the genome and window geometry on the first device; the index is
        # built shard by shard below
        self.base = CoarseMapper(genome, opts, mesh.first, segments=segments,
                                 build_index=False)
        self.n_tables = len(self.base.hash_ids) * (
            2 if opts.three_n_seeding else 1)
        if self.n_tables % n_table:
            raise ValueError(f"{self.n_tables} tables do not divide evenly "
                             f"over a table axis of {n_table}")
        self.f_local = self.n_tables // n_table
        self.shards = self._build_index_sharded(build_direct_probe)
        self._replicas: Dict[torch.device, tuple] = {}
        self._genome_s2: Dict[torch.device, torch.Tensor] = {}
        # (keys, num) of every table shard's dropped-keys mask by device
        self.dropped: Dict[tuple, tuple] = {}
        self._drops_set = False
        self._plans = [self._row_plan(d, plan)
                       for d in range(mesh.shape["data"])]
        # the captured steps, and the drop mask they were captured with
        self._steps: Dict[tuple, graphs.CapturedStep] = {}
        self._steps_dropped = None

    # -- the CoarseMapper hooks that the driver and the regions read -------
    @property
    def device(self) -> torch.device:
        return self.mesh.first

    @property
    def segments(self):
        return self.base.segments

    @property
    def seg_local_base(self):
        return self.base.seg_local_base

    @property
    def table(self) -> WindowTable:
        return self.base.table

    # -- index construction ------------------------------------------------
    def _build_index_sharded(self, build_direct_probe: bool,
                             sig_batch: int = 4096):
        """Window signatures a superbatch at a time on the first device
        (one launch each on the card), every table shard's columns copied
        to its column's first device as they come; each shard then builds
        its CSR index, buckets and cuckoo table there, and is copied to
        the other devices of its column.  Returns shards[t][device]."""
        opts, base = self.opts, self.base
        first = self.mesh.first
        w, fl = base.table.num_windows, self.f_local
        n_table = self.mesh.shape["table"]
        owners = [self.mesh.column(t)[0] for t in range(n_table)]
        sigs = [torch.empty((w, fl), dtype=torch.int64, device=dev)
                for dev in owners]
        valid = {dev: torch.empty((w,), dtype=torch.bool, device=dev)
                 for dev in dict.fromkeys(owners)}
        s0 = 0
        for gstart, lens in base.iter_window_superbatch_starts(sig_batch):
            s1 = s0 + len(lens)
            s, v = minhash.window_signatures(
                window_bases_device(base.table.genome_concat,
                                    torch.from_numpy(gstart).to(first),
                                    opts.window_size),
                torch.from_numpy(lens.astype(np.int32)).to(first),
                opts.kmer_length, base._hash_ids_dev, opts.three_n_seeding,
                sig_batch)
            for t, out in enumerate(sigs):
                out[s0:s1] = s[:, t * fl:(t + 1) * fl]
            for out in valid.values():
                out[s0:s1] = v
            s0 = s1
        shards = []
        for t, dev in enumerate(owners):
            idx = mi.build_csr_index_device(sigs[t], valid[dev],
                                            opts.kmer_length, base.hash_ids)
            sigs[t] = None
            idx.build_buckets()
            if opts.probe_cap < 1023 and build_direct_probe:
                idx.build_cuckoo()
            shards.append({d: idx if d == dev else _index_to(idx, d)
                           for d in self.mesh.column(t)})
        return shards

    def index_memory_per_device(self) -> Dict[str, int]:
        """Index bytes by physical device (a shard stored once a device)."""
        out: Dict[str, int] = {}
        for by_dev in self.shards:
            for dev, idx in by_dev.items():
                out[str(dev)] = out.get(str(dev), 0) + idx.memory_bytes()
        return out

    def index_memory_per_position(self) -> Dict[tuple, int]:
        """Index bytes by mesh position (data, table): what each position
        would hold on distinct cards."""
        return {(d, t): self.shards[t][dev].memory_bytes()
                for d, row in enumerate(self.mesh.devices)
                for t, dev in enumerate(row)}

    def memory_bytes(self) -> int:
        return sum(self.index_memory_per_device().values())

    # -- read-side key dropping (parity mode) ------------------------------
    def _place_drops(self, keys: torch.Tensor, num: torch.Tensor) -> None:
        """Split an [F, D] mask over the table shards' devices."""
        fl = self.f_local
        self.dropped = {
            (t, dev): (keys[t * fl:(t + 1) * fl].to(dev),
                       num[t * fl:(t + 1) * fl].to(dev))
            for t, by_dev in enumerate(self.shards) for dev in by_dev}

    def set_read_drops(self, read_sigs: np.ndarray,
                       read_valid: np.ndarray) -> None:
        if self.opts.three_n_seeding:
            raise ValueError("read-key-drop emulation is a parity-mode "
                             "feature (the 3N index has no reference "
                             "counterpart to emulate)")
        dk, dn = mi.build_dropped_keys(read_sigs, read_valid,
                                       self.opts.max_results_per_map)
        self._place_drops(torch.from_numpy(dk.astype(np.int64)),
                          torch.from_numpy(dn.astype(np.int64)))
        self._drops_set = True

    def ensure_read_drops(self, read_bases: np.ndarray,
                          read_lengths: np.ndarray) -> None:
        """The dropped-keys mask from the FULL read set (parity mode), as
        CoarseMapper.ensure_read_drops computes it, split by table
        columns.  No-op in 3N mode or when already set."""
        if self.opts.three_n_seeding or self._drops_set:
            return
        self.base.ensure_read_drops(read_bases, read_lengths)
        if self.base.dropped is not None:
            self._place_drops(*self.base.dropped)
            self._drops_set = True

    def ensure_empty_drops(self) -> None:
        if self.dropped:
            return
        f = torch.full((self.n_tables, 1), SENTINEL, dtype=torch.int64)
        self._place_drops(f, torch.zeros((self.n_tables,), dtype=torch.int64))

    # -- the dispatch units ------------------------------------------------
    def _row_plan(self, d: int, plan) -> tuple:
        """Data shard d's ((card, table shards), ...): the given plan's
        row, else the row's table shards grouped by card in first-seen
        order.  Every table shard once, on a device that holds it."""
        row = self.mesh.devices[d]
        if plan is None:
            groups: Dict[torch.device, list] = {}
            for t, dev in enumerate(row):
                groups.setdefault(dev, []).append(t)
            return tuple((dev, tuple(ts)) for dev, ts in groups.items())
        out = tuple((_device(dev), tuple(ts)) for dev, ts in plan[d])
        if sorted(t for _, ts in out for t in ts) != list(range(len(row))):
            raise ValueError(f"the plan of data shard {d} must take each of "
                             f"its {len(row)} table shards once: {out}")
        for dev, ts in out:
            for t in ts:
                if dev not in self.shards[t]:
                    raise ValueError(f"table shard {t} is not on {dev}")
        return out

    def _whole(self, d: int) -> bool:
        """Data shard d's batch is one step: every table shard it probes
        lies on its first device."""
        (dev, _), *rest = self._plans[d]
        return not rest and dev == self.mesh.devices[d][0]

    def _replica(self, dev: torch.device):
        """(window table, hash ids) on a data shard's first device."""
        if dev not in self._replicas:
            t = self.base.table
            table = t if dev == self.mesh.first else dataclasses.replace(
                t, genome_concat=None, **{
                    f: getattr(t, f).to(dev) for f in (
                        "genome_hi", "genome_lo", "chrom_offset",
                        "chrom_len", "win_pos", "win_chrom")})
            self._replicas[dev] = (table, self.base._hash_ids_dev.to(dev))
        return self._replicas[dev]

    def genome_s2(self, dev: torch.device) -> torch.Tensor:
        """The STEP-2 genome codes, staged once a physical device."""
        if dev not in self._genome_s2:
            self._genome_s2[dev] = self.base.genome_s2().to(dev)
        return self._genome_s2[dev]

    def _head(self, dev0: torch.device, read_bases: torch.Tensor,
              read_len: torch.Tensor, read_valid: torch.Tensor):
        """A data shard's signatures on its first device: (sigs [B, F],
        sig_valid [B]) and under --undirectional the mirrored sigs."""
        opts = self.opts
        _, hash_ids = self._replica(dev0)
        if opts.three_n_seeding:
            sigs, sig_valid = minhash.signatures_3n_pair(
                read_bases, read_len, opts.kmer_length, hash_ids)
        else:
            sigs, sig_valid = minhash.minhash_signatures(
                read_bases, read_len, opts.kmer_length, hash_ids)
        out = (sigs, sig_valid & read_valid)
        if opts.undirectional:
            # the mirrored (PBAT) query spaces, probed after the forward ones
            # as the single mapper concatenates them
            out += (minhash.signatures_3n_pair(
                read_bases, read_len, opts.kmer_length, hash_ids,
                mirror=True)[0],)
        return out

    def _probe(self, dev: torch.device, ts, sigs: torch.Tensor,
               sig_valid: torch.Tensor, sigs_u=None):
        """The table shards ts on their device dev: (cand [F / T, B, C],
        counts [F / T, B], tail_drops []) for each shard, forward, then
        for each shard mirrored."""
        opts = self.opts
        fl = self.f_local
        b = sig_valid.shape[0]
        out = []
        for block in (sigs,) if sigs_u is None else (sigs, sigs_u):
            for t in ts:
                idx = self.shards[t][dev]
                cuckoo_kw = {}
                if idx.cuckoo_keys is not None:
                    cuckoo_kw = dict(
                        cuckoo=(idx.cuckoo_keys, idx.cuckoo_payload),
                        cuckoo_bits=idx.cuckoo_bits,
                        cuckoo_seeds=idx.cuckoo_seeds)
                # no head budget: head compaction is off on the mesh
                cl, nl, td, _ = mi.probe_tables(
                    idx.keys, idx.offsets, idx.values, idx.num_keys,
                    block[:, t * fl:(t + 1) * fl], sig_valid, opts.probe_cap,
                    dropped_keys=self.dropped[(t, dev)],
                    bucket_start=idx.bucket_start,
                    probe_steps=idx.probe_steps,
                    tail_budget=b * opts.probe_tail_budget_per_read,
                    **cuckoo_kw)
                out += [cl, nl, td]
        return tuple(out)

    def _tail(self, dev0: torch.device, read_bases: torch.Tensor,
              read_len: torch.Tensor, cand: torch.Tensor,
              counts: torch.Tensor, tail_drops: torch.Tensor,
              with_scores: bool = False):
        """The gathered lists [F (2F undirectional), B, C] of a data shard
        -> (packed [B, 7] int32, overflow [5] int64), as
        CoarseMapper._map_batch packs them, and with_scores the fused
        STEP 2 (scores, tb_ops, tb_status) on its first device (the JAX
        package's _ensure_scored_tail)."""
        opts = self.opts
        kcap = opts.candidates_per_read_cap
        table, _ = self._replica(dev0)
        ids, _, num_kept = mi.vote_candidates_fnc_auto(
            cand, opts.min_table_hits, kcap)
        (out_ori, out_ham, out_shift, out_chrom, out_pos, best_gwin, has,
         _, out_strand, pair_drops) = coarse_pairs_best(
            ids, read_bases, read_len, opts, table.genome_hi,
            table.genome_lo, table.win_pos, table.win_chrom,
            table.chrom_offset, table.chrom_len)
        out_gwin = torch.where(has, best_gwin, torch.full_like(best_gwin, -1))
        packed = torch.stack(
            [out_ori, out_ham, out_shift, out_chrom, out_pos, out_gwin,
             out_strand], dim=1).to(torch.int32)
        # probe, vote and pair once a data shard, tail summed over the
        # table shards, head always 0
        tail = tail_drops.sum()
        overflow = torch.stack([(counts > opts.probe_cap).sum(),
                                (num_kept > kcap).sum(), pair_drops, tail,
                                torch.zeros_like(tail)])
        if not with_scores:
            return packed, overflow
        return (packed, overflow, *fused_step2_scores(
            opts, table.chrom_offset, table.chrom_len, self.genome_s2(dev0),
            read_bases, read_len, packed))

    def _blocks(self) -> int:
        return 2 if self.opts.undirectional else 1

    def _map_shard_batch(self, d: int, read_bases: torch.Tensor,
                         read_len: torch.Tensor, read_valid: torch.Tensor,
                         with_scores: bool = False):
        """Data shard d's batch, eagerly: the head on its first device, the
        probes on their cards, the partial lists copied back in table
        order, the tail.  The whole-row step captures it; the checks of a
        graph against the eager step call it."""
        dev0 = self.mesh.devices[d][0]
        head = self._head(dev0, read_bases, read_len, read_valid)
        parts = {}
        for dev, ts in self._plans[d]:
            got = self._probe(dev, ts, *(x.to(dev) for x in head))
            for j, key in enumerate(itertools.product(range(self._blocks()),
                                                      ts)):
                parts[key] = [x.to(dev0) for x in got[3 * j:3 * j + 3]]
        order = sorted(parts)    # forward before mirrored, in table order
        return self._tail(dev0, read_bases, read_len,
                          torch.cat([parts[k][0] for k in order]),
                          torch.cat([parts[k][1] for k in order]),
                          torch.stack([parts[k][2] for k in order]),
                          with_scores)

    def _step(self, key, like, device=None) -> graphs.CapturedStep:
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = graphs.CapturedStep(like, device)
        return step

    def _run_row(self, d: int, bases: torch.Tensor, lens: torch.Tensor,
                 valid: torch.Tensor, with_scores: bool):
        """Data shard d's batch through its steps, on the current streams
        of its cards: the tail's static outputs on its first device, which
        the next batch of that device overwrites.  One step where the row
        is one card; else the head, a probe a card and the tail, with the
        copies between cards outside the graphs (a copy between two cards
        runs on the source card's stream after the destination card's
        queued work, and the destination's stream waits on it)."""
        dev0 = self.mesh.devices[d][0]
        plan = self._plans[d]
        shape = (tuple(bases.shape), graphs.options_key(self.opts))
        if self._whole(d):
            return self._step(("row", plan, with_scores) + shape,
                              (bases, lens, valid)).run(
                functools.partial(self._map_shard_batch, d,
                                  with_scores=with_scores),
                bases, lens, valid)
        head = self._step(("head", dev0) + shape, (bases, lens, valid))
        sigs = head.run(functools.partial(self._head, dev0), bases, lens,
                        valid)
        # the head's outputs into every probe's inputs before any probe
        # replays: a probe on the first device may reuse their memory
        probes = [self._step(("probe", dev, ts) + shape, sigs, dev)
                  for dev, ts in plan]
        for probe in probes:
            for buf, x in zip(probe.inputs, sigs):
                buf.copy_(x)
        tail = self._steps.get(("tail", plan, with_scores) + shape)
        n_t, fl = self.mesh.shape["table"], self.f_local
        for probe, (dev, ts) in zip(probes, plan):
            got = probe.run(functools.partial(self._probe, dev, ts),
                            *probe.inputs)
            if tail is None:
                nb = self._blocks()
                meta = lambda x, n: torch.empty(
                    (n,) + x.shape[1:], dtype=x.dtype, device="meta")
                tail = self._step(
                    ("tail", plan, with_scores) + shape,
                    (bases, lens, meta(got[0], nb * n_t * fl),
                     meta(got[1], nb * n_t * fl),
                     torch.empty((nb * n_t,), dtype=got[2].dtype,
                                 device="meta")), dev0)
            cand, counts, drops = tail.inputs[2:]
            for j, (blk, t) in enumerate(itertools.product(
                    range(self._blocks()), ts)):
                k = blk * n_t + t
                cand[k * fl:(k + 1) * fl].copy_(got[3 * j])
                counts[k * fl:(k + 1) * fl].copy_(got[3 * j + 1])
                drops[k].copy_(got[3 * j + 2])
        return tail.run(functools.partial(self._tail, dev0,
                                          with_scores=with_scores),
                        head.inputs[0], head.inputs[1], *tail.inputs[2:])

    def _prepare(self, with_scores: bool) -> None:
        """The state the steps read from outside their inputs, made before
        any capture: the key drops (a replaced mask drops the steps
        captured with the old one), the replicas, the STEP-2 genome."""
        self.ensure_empty_drops()
        if self._steps_dropped is not self.dropped:
            self._steps.clear()
            self._steps_dropped = self.dropped
        for row in self.mesh.devices:
            self._replica(row[0])
            if with_scores:
                self.genome_s2(row[0])

    def _pool_device(self, bases, lens, valid, n_pad: int,
                     with_scores: bool):
        """Every mesh batch of a staged pool (stage_reads_device), enqueued
        batch by batch and data shard by data shard from this thread, each
        step's outputs copied into its data shard's results before that
        device's next step; then the shards' results gathered on the
        first device in read order: (packed [n_pad, 7], overflow [5]
        summed, and with_scores scores [10, 2 n_pad], tb_ops [2 n_pad, E],
        tb_status [2 n_pad])."""
        d_n, bsz = self.mesh.shape["data"], self.opts.batchsize
        nb = n_pad // (bsz * d_n)
        if n_pad <= 0 or n_pad != nb * bsz * d_n or len(bases) != d_n \
                or any(b.shape[:2] != (nb, bsz) for b in bases):
            raise ValueError(
                f"a staged pool of {[tuple(b.shape[:2]) for b in bases]} "
                f"cannot run {n_pad} rows in mesh batches of {d_n} x {bsz}")
        self._prepare(with_scores)
        # the batch axis of each output; None: summed over the batches
        axes = (0, None) + ((1, 0, 0) if with_scores else ())
        first = self.mesh.first
        outs = [None] * d_n
        with _card_streams([dev for row in self.mesh.devices for dev in row]):
            for i in range(nb):
                for d in range(d_n):
                    got = self._run_row(d, bases[d][i], lens[d][i],
                                        valid[d][i], with_scores)
                    if outs[d] is None:
                        outs[d] = [torch.zeros_like(x) if a is None
                                   else x.new_empty(x.shape[:a] + (nb,)
                                                    + x.shape[a:])
                                   for x, a in zip(got, axes)]
                    for dst, x, a in zip(outs[d], got, axes):
                        if a is None:
                            dst += x
                        else:
                            dst.select(a, i).copy_(x)
            # read order: mesh batch i, then data shard d
            res = []
            for k, a in enumerate(axes):
                parts = [o[k].to(first) for o in outs]
                if a is None:
                    res.append(sum(parts[1:], parts[0]))
                else:
                    x = torch.stack(parts, dim=a + 1)
                    res.append(x.reshape(x.shape[:a] + (-1,)
                                         + x.shape[a + 3:]))
        return tuple(res)

    # -- the JAX package's entry points --------------------------------------
    def map_batch(self, read_bases: torch.Tensor, read_len: torch.Tensor,
                  read_valid: torch.Tensor):
        """One mesh batch of batchsize * D rows (data shard d takes rows
        [d * batchsize, (d + 1) * batchsize)) -> (packed [B * D, 7] int32,
        overflow [5] int64 summed over the data shards), on the first
        device."""
        d_n, bsz = self.mesh.shape["data"], self.opts.batchsize
        if read_bases.shape[0] != d_n * bsz:
            raise ValueError(f"a mesh batch is {d_n} x {bsz} rows, got "
                             f"{read_bases.shape[0]}")
        shards = [[x[d * bsz:(d + 1) * bsz][None].to(row[0])
                   for d, row in enumerate(self.mesh.devices)]
                  for x in (read_bases, read_len, read_valid)]
        return self._pool_device(*shards, d_n * bsz, False)

    def stage_reads_device(self, read_bases: np.ndarray,
                           read_lengths: np.ndarray):
        """Upload the reads once, padded to max_read_length columns and a
        whole number of mesh batches -> (bases, lens, valid, n_pad): each a
        tuple of data shard d's [n_batches, batchsize, ...] rows on its
        first device (the JAX package's pool sharded over "data")."""
        opts = self.opts
        n, lr = read_bases.shape
        if lr > opts.max_read_length:
            raise ValueError(f"reads longer than max_read_length "
                             f"({lr} > {opts.max_read_length})")
        d_n, bsz = self.mesh.shape["data"], opts.batchsize
        n_batches = max(1, -(-n // (bsz * d_n)))
        n_pad = n_batches * bsz * d_n
        bases = np.zeros((n_pad, opts.max_read_length), np.int8)
        bases[:n, :lr] = read_bases
        lens = np.zeros(n_pad, np.int32)
        lens[:n] = read_lengths
        valid = np.arange(n_pad) < n

        def shard(x, d):
            x = x.reshape(n_batches, d_n, bsz, *x.shape[1:])[:, d]
            return torch.from_numpy(np.ascontiguousarray(x)).to(
                self.mesh.devices[d][0])
        return (*(tuple(shard(x, d) for d in range(d_n))
                  for x in (bases, lens, valid)), n_pad)

    def _map_reads_device(self, bases, lens, valid, n_pad: int, bsz: int,
                          collect_candidates: bool = False):
        """Every mesh batch of a staged pool, results on the first device:
        (packed [n_pad, 7], overflow [5], None).  Nothing is copied to the
        host, so a caller driving several mappers (the regions) enqueues
        all of their work first."""
        if collect_candidates:
            raise ValueError("candidate collection is a single-device "
                             "instrumentation mode (CoarseMapper)")
        packed, overflow = self._pool_device(bases, lens, valid, n_pad,
                                             False)
        return packed, overflow, None

    def _map_reads_device_scored(self, bases, lens, valid, n_pad: int,
                                 bsz: int):
        """_map_reads_device with the fused STEP 2: (packed [n_pad, 7],
        overflow [5], scores [10, 2 n_pad] int16, tb_ops [2 n_pad, E]
        uint8, tb_status [2 n_pad] int8), on the first device."""
        return self._pool_device(bases, lens, valid, n_pad, True)

    def map_staged(self, bases, lens, valid, n_pad: int, n: int,
                   with_scores: bool = False,
                   collect_candidates: bool = False):
        """CoarseMapper.map_staged over the mesh: (packed [n, 7], overflow
        [5], the bundle or None, None) on the first device."""
        if collect_candidates:
            raise ValueError("candidate collection is a single-device "
                             "instrumentation mode (CoarseMapper)")
        out = self._pool_device(bases, lens, valid, n_pad, with_scores)
        bundle = None
        if with_scores:
            sc, to, ts = out[2:]
            bundle = (sc[:, :2 * n], to[:2 * n], ts[:2 * n])
        return out[0][:n], out[1], bundle, None

    def fetch_results(self, parts, with_scores: bool = False,
                      collect_candidates: bool = False):
        """map_staged's results copied to the host, as
        CoarseMapper.fetch_results joins them."""
        return self.base.fetch_results(parts, with_scores,
                                       collect_candidates)

    def read_pool_size(self, n: int, bsz: int) -> int:
        """Reads staged at once: all of them, in whole mesh batches."""
        step = bsz * self.mesh.shape["data"]
        return -(-n // step) * step

    def stats(self, overflow: np.ndarray) -> Dict[str, int]:
        out = {k: int(v) for k, v in zip(OVERFLOW_KEYS, overflow)}
        # the direct probe is in use only where every shard has its table
        out["cuckoo_direct_probe"] = int(all(
            idx.cuckoo_keys is not None
            for by_dev in self.shards for idx in by_dev.values()))
        return out

    def map_reads_packed(self, read_bases: np.ndarray,
                         read_lengths: np.ndarray, with_scores: bool = False):
        """CoarseMapper.map_reads_packed over the mesh: (packed [N, 7]
        int32, overflow [5] int64, the fused STEP-2 bundle or None), numpy
        on the host, rows and bundle columns in read order."""
        n = read_bases.shape[0]
        parts = [self.map_staged(*self.stage_reads_device(read_bases,
                                                          read_lengths),
                                 n, with_scores)] if n else []
        return self.fetch_results(parts, with_scores)

    def map_reads(self, read_bases: np.ndarray, read_lengths: np.ndarray,
                  with_scores: bool = False, collect_candidates: bool = False):
        """CoarseMapper.map_reads over the mesh (results, and with_scores
        the fused STEP-2 bundle).  Candidate collection is a single-device
        instrumentation mode and is refused here, as in the JAX package."""
        if collect_candidates:
            raise ValueError("candidate collection is a single-device "
                             "instrumentation mode (CoarseMapper)")
        self.ensure_read_drops(read_bases, read_lengths)
        packed, overflow, bundle = self.map_reads_packed(
            read_bases, read_lengths, with_scores)
        results = CoarseResults(
            orientation=packed[:, 0].astype(np.int8),
            hamming=packed[:, 1].astype(np.int32),
            shift=packed[:, 2].astype(np.int32),
            chromosome_id=packed[:, 3].astype(np.int32),
            position=packed[:, 4].astype(np.int32),
            global_window_id=packed[:, 5].astype(np.uint32),
            stats=self.stats(overflow),
            bs_strand=packed[:, 6].astype(np.int8))
        if not with_scores:
            return results
        return results, (bundle if self.opts.step2_device_traceback
                         else bundle[0])
