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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..config import ProgramOptions
from ..index import minhash_index as mi
from ..io.genome import Genome
from ..ops import minhash
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


def _index_to(idx: mi.CsrIndex, dev: torch.device) -> mi.CsrIndex:
    """A copy of a built index on another device."""
    return dataclasses.replace(idx, **{
        f.name: getattr(idx, f.name).to(dev)
        for f in dataclasses.fields(idx)
        if isinstance(getattr(idx, f.name), torch.Tensor)})


class ShardedCoarseMapper:
    """The window index split over the table axis of `mesh`, and read
    batches split over its data axis; the contract of CoarseMapper
    (map_reads, map_reads_packed, the key-drop hooks, segments), so the
    driver, mapping.run_cssw and RegionShardedMapper drive it unchanged.
    `device` is the mesh's first device."""

    supports_fused_scores = True

    def __init__(self, genome: Genome, opts: ProgramOptions, mesh: Mesh,
                 segments=None, build_direct_probe: bool = True):
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

    # -- the per-batch step --------------------------------------------------
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

    def _map_shard_batch(self, d: int, read_bases: torch.Tensor,
                         read_len: torch.Tensor, read_valid: torch.Tensor):
        """Data shard d's batch, on its first device -> (packed [B, 7]
        int32, overflow [5] int64), as CoarseMapper._map_batch packs
        them."""
        opts = self.opts
        row = self.mesh.devices[d]
        dev0 = row[0]
        b = read_bases.shape[0]
        kcap = opts.candidates_per_read_cap
        fl = self.f_local
        table, hash_ids = self._replica(dev0)
        if opts.three_n_seeding:
            sigs, sig_valid = minhash.signatures_3n_pair(
                read_bases, read_len, opts.kmer_length, hash_ids)
        else:
            sigs, sig_valid = minhash.minhash_signatures(
                read_bases, read_len, opts.kmer_length, hash_ids)
        sig_valid = sig_valid & read_valid

        def probe_gather(sig_block):
            """Each table shard probes its columns on its device; the
            partial lists come back to dev0 in table order."""
            cand, counts = [], []
            tail = torch.zeros((), dtype=torch.int64, device=dev0)
            for t, dev in enumerate(row):
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
                    sig_block[:, t * fl:(t + 1) * fl].to(dev),
                    sig_valid.to(dev), opts.probe_cap,
                    dropped_keys=self.dropped[(t, dev)],
                    bucket_start=idx.bucket_start,
                    probe_steps=idx.probe_steps,
                    tail_budget=b * opts.probe_tail_budget_per_read,
                    **cuckoo_kw)
                cand.append(cl.to(dev0))
                counts.append(nl.to(dev0))
                tail = tail + td.to(dev0)
            return torch.cat(cand), torch.cat(counts), tail

        cand, counts, tail_drops = probe_gather(sigs)
        if opts.undirectional:
            # the mirrored (PBAT) query spaces, gathered after the forward
            # ones as the single mapper concatenates them
            sigs_u, _ = minhash.signatures_3n_pair(
                read_bases, read_len, opts.kmer_length, hash_ids,
                mirror=True)
            cand_u, counts_u, tail_u = probe_gather(sigs_u)
            cand = torch.cat([cand, cand_u])
            counts = torch.cat([counts, counts_u])
            tail_drops = tail_drops + tail_u
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
        overflow = torch.stack([(counts > opts.probe_cap).sum(),
                                (num_kept > kcap).sum(), pair_drops,
                                tail_drops, torch.zeros_like(tail_drops)])
        return packed, overflow

    def _stage_reads(self, read_bases: np.ndarray,
                     read_lengths: np.ndarray):
        """The reads padded to a whole number of mesh batches, data shard
        d's rows [n_batches, batchsize] on its first device: ([(bases,
        lens, valid)] a data shard, n_batches)."""
        opts = self.opts
        n, lr = read_bases.shape
        d_n, bsz = self.mesh.shape["data"], opts.batchsize
        n_batches = -(-n // (bsz * d_n))
        n_pad = n_batches * bsz * d_n
        bases = np.zeros((n_pad, max(lr, opts.max_read_length)), np.int8)
        bases[:n, :lr] = read_bases
        lens = np.zeros(n_pad, np.int32)
        lens[:n] = read_lengths
        valid = np.arange(n_pad) < n
        out = []
        for d, row in enumerate(self.mesh.devices):
            def shard(x):
                x = x.reshape(n_batches, d_n, bsz, *x.shape[1:])[:, d]
                return torch.from_numpy(np.ascontiguousarray(x)).to(row[0])
            out.append((shard(bases), shard(lens), shard(valid)))
        return out, n_batches

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
        opts = self.opts
        n, lr = read_bases.shape
        if lr > opts.max_read_length:
            raise ValueError(f"reads longer than max_read_length "
                             f"({lr} > {opts.max_read_length})")
        self.ensure_empty_drops()
        pools, n_batches = self._stage_reads(read_bases, read_lengths)
        # every shard's batches are enqueued before anything is read back
        packed, overflow, step2 = [], [], []
        for i in range(n_batches):
            for d, (bases, lens, valid) in enumerate(pools):
                p, o = self._map_shard_batch(d, bases[i], lens[i], valid[i])
                packed.append(p)
                overflow.append(o)
                if with_scores:
                    table, _ = self._replica(bases.device)
                    step2.append(fused_step2_scores(
                        opts, table.chrom_offset, table.chrom_len,
                        self.genome_s2(bases.device), bases[i], lens[i], p))

        def host_cat(parts, dim=0):
            return torch.cat([x.cpu() for x in parts], dim=dim)
        packed = (host_cat(packed)[:n].numpy() if packed
                  else np.zeros((0, 7), np.int32))
        overflow = (host_cat([o[None] for o in overflow]).sum(dim=0).numpy()
                    if overflow else np.zeros(5, np.int64))
        bundle = None
        if with_scores:
            if step2:
                bundle = (host_cat([x[0] for x in step2], 1)[:, :2 * n],
                          host_cat([x[1] for x in step2])[:2 * n],
                          host_cat([x[2] for x in step2])[:2 * n])
                bundle = tuple(x.numpy() for x in bundle)
            else:
                bundle = (np.zeros((10, 0), np.int16),
                          np.zeros((0, 1), np.uint8), np.zeros(0, np.int8))
        return packed, overflow, bundle

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
