"""Genome-region sharding: each region's mapper indexes a slice of the
genome (counterpart of hashreadmapper_tpu/parallel/region_sharded.py).

The route for genomes of 2**31 bases and more (a single mapper stages
fewer) and for window indexes larger than one device holds.  The genome's
window sequence is partitioned into contiguous regions: whole chromosomes
where that granularity suffices, intra-chromosome window spans with
read-length margins otherwise (parallel/segments.py).  Every region's
CoarseMapper indexes its segments only, every read goes through every
region, and the global best hit per read is the minimum of (hamming,
global window ordinal): an associative, deterministic merge, so the
results do not depend on the region count and equal the single mapper's
wherever no cap or budget drops candidates differently in a region than
in the whole genome.  Regions are placed round robin over a list of torch
devices (one card by default); or, given a mesh, every region's tables
are sharded over the same data x table mesh (one ShardedCoarseMapper a
region, parallel/sharded.py).  Either way every region's batches are
enqueued before the first copy to the host.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from ..config import ProgramOptions
from ..io.genome import Genome
from ..ops import bandtb, shd
from ..pipeline.engine import (OVERFLOW_KEYS, SENTINEL, CoarseMapper,
                               CoarseResults, Step2Bundle, Step2Rows,
                               pool_ranges)
from .sharded import ShardedCoarseMapper
from .segments import (Segment, partition_windows, regions_for_base_cap,
                       staged_bases, whole_chromosome_segments)

# a single mapper's staged bases must index in int32; leave headroom for
# margins and plane packing
SINGLE_MAPPER_BASE_CAP = 2**31 - 2**27


def bin_chromosomes(genome: Genome, n_regions: int) -> List[List[int]]:
    """Balanced greedy binning of chromosome ids by length."""
    order = sorted(range(genome.num_chromosomes),
                   key=lambda c: -genome.chromosome_length(c))
    loads = [0] * n_regions
    bins: List[List[int]] = [[] for _ in range(n_regions)]
    for c in order:
        r = min(range(n_regions), key=lambda i: loads[i])
        bins[r].append(c)
        loads[r] += genome.chromosome_length(c)
    for b in bins:
        b.sort()  # keep genome order within a region
    return bins


def plan_regions(genome: Genome, opts: ProgramOptions, n_regions: int,
                 partition: str = "auto") -> List[List[Segment]]:
    """Region plan as per-region segment lists.

    partition: 'chromosome' bins whole chromosomes (requires n_regions <=
    num chromosomes), 'window' cuts the global window sequence into equal
    contiguous spans, 'auto' picks chromosome binning when it is feasible
    AND every bin fits the staged-base cap, else window cuts (possibly
    with MORE regions than asked, to respect the cap)."""
    margin = opts.max_read_length

    def chrom_plan():
        bins = bin_chromosomes(genome, n_regions)
        return [whole_chromosome_segments(genome, opts, b) for b in bins]

    if partition == "chromosome":
        if n_regions > genome.num_chromosomes:
            raise ValueError("chromosome partition bins whole chromosomes; "
                             "use partition='window' for more regions than "
                             "chromosomes")
        return chrom_plan()
    if partition == "window":
        regions = partition_windows(genome, opts, n_regions)
    elif partition == "auto":
        if n_regions <= genome.num_chromosomes:
            regions = chrom_plan()
        else:
            regions = partition_windows(genome, opts, n_regions)
    else:
        raise ValueError(f"partition must be auto, chromosome or window, "
                         f"got {partition!r}")
    if any(staged_bases(genome, opts, r, margin) >= SINGLE_MAPPER_BASE_CAP
           for r in regions):
        regions = regions_for_base_cap(
            genome, opts, SINGLE_MAPPER_BASE_CAP, margin, n_min=n_regions)
    return regions


def chrom_gwin_base(genome: Genome, opts: ProgramOptions) -> np.ndarray:
    """[C] int64: the global window ordinal of each chromosome's first
    window."""
    counts = [genome.num_windows_in_chromosome(c, opts.kmer_length,
                                               opts.window_size)
              for c in range(genome.num_chromosomes)]
    return np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)


def region_key_payload(mapper: CoarseMapper, packed: np.ndarray,
                       chrom_gwin_base: np.ndarray):
    """Merge key and payload of one region's packed per-read rows.

    packed: [N, 7] rows (ori, ham, shift, segment index, pos, local
    window ordinal, bs strand) of the region's mapper.  Returns
      key      [N] int64: (hamming << 40) + global window ordinal
               (2**62 when unmapped), the associative merge key,
      payload  [N, 6] int32: ori, ham, shift, TRUE chromosome id, pos,
               bs strand,
      gwin_global [N] int64 (-1 when unmapped)."""
    ori = packed[:, 0]
    ham = packed[:, 1]
    mapped = ori != shd.NONE
    segs = mapper.segments
    seg_chrom = np.array([s.chrom_id for s in segs], dtype=np.int32)
    seg_gwin0 = np.array(
        [chrom_gwin_base[s.chrom_id] + s.win_start for s in segs],
        dtype=np.int64)
    seg_local0 = mapper.seg_local_base[:-1]
    seg_c = np.where(mapped, packed[:, 3], 0)
    in_seg = np.where(
        mapped, packed[:, 5].astype(np.int64) - seg_local0[seg_c], 0)
    gwin_global = np.where(mapped, seg_gwin0[seg_c] + in_seg, -1)
    key = np.where(mapped, (ham.astype(np.int64) << 40) + gwin_global,
                   np.int64(2**62))
    payload = np.stack(
        [ori, ham, packed[:, 2], seg_chrom[seg_c] * mapped, packed[:, 4],
         packed[:, 6]],
        axis=1).astype(np.int32)
    return key, payload, gwin_global


class RegionShardedMapper:
    """One CoarseMapper per region, and the deterministic merge of their
    per-read results on the host.

    devices: torch devices the regions are placed on, round robin (more
    regions than devices share a device); one card by default.  mesh (a
    parallel/sharded.py Mesh, in place of devices): every region's tables
    sharded over it.  With more than two regions on a device (or on a
    table shard of the mesh) the regions keep the binary-search probe: a
    cuckoo table costs more device memory than its CSR index."""

    def __init__(self, genome: Genome, opts: ProgramOptions, n_regions: int,
                 devices=None, partition: str = "auto", mesh=None):
        self.opts = opts
        self.genome = genome
        self.regions = plan_regions(genome, opts, n_regions, partition)
        self.n_regions = len(self.regions)
        devs = ([torch.device("cuda")] if devices is None
                else [torch.device(d) for d in devices])
        self.device = devs[0] if mesh is None else mesh.first
        self.mesh = mesh

        self.chrom_gwin_base = chrom_gwin_base(genome, opts)

        per_device = len(devs) if mesh is None else mesh.shape["table"]
        direct_probe = -(-self.n_regions // per_device) <= 2
        self.mappers: List[CoarseMapper] = []
        self.build_seconds: List[float] = []
        for r, segs in enumerate(self.regions):
            t0 = time.perf_counter()
            if mesh is None:
                mapper = CoarseMapper(genome, opts, devs[r % len(devs)],
                                      segments=segs,
                                      build_direct_probe=direct_probe)
            else:
                mapper = ShardedCoarseMapper(genome, opts, mesh,
                                             segments=segs,
                                             build_direct_probe=direct_probe)
            self.mappers.append(mapper)
            self.build_seconds.append(time.perf_counter() - t0)

    def _map_regions(self, read_bases: np.ndarray, read_lengths: np.ndarray,
                     with_scores: bool):
        """Every region's (packed, overflow, bundle) on the host, as
        CoarseMapper.map_reads_packed returns them.  The reads are staged
        once a device (once for the mesh) and every region's batches
        enqueued (a graph replay a batch, or a data shard's batch, on a
        card) before the first copy to the host (the JAX package's
        region_sharded.py:207-227)."""
        for mapper in self.mappers:
            mapper.ensure_empty_drops()
        n, bsz = len(read_lengths), self.opts.batchsize
        pool_n = min(m.read_pool_size(n, bsz) for m in self.mappers) \
            if n else 0
        parts = [[] for _ in self.mappers]
        for c0, c1 in pool_ranges(n, pool_n):
            staged = {}
            for mapper in self.mappers:
                if mapper.device not in staged:
                    staged[mapper.device] = mapper.stage_reads_device(
                        read_bases[c0:c1], read_lengths[c0:c1])
            for part, mapper in zip(parts, self.mappers):
                part.append(mapper.map_staged(*staged[mapper.device],
                                              c1 - c0, with_scores))
        return [m.fetch_results(part, with_scores)
                for m, part in zip(self.mappers, parts)]

    def map_reads(self, read_bases: np.ndarray, read_lengths: np.ndarray,
                  with_scores: bool = False):
        """Every region's coarse step over all reads, merged per read by
        (hamming, global window ordinal).  No read-key drop applies (each
        region's mask is empty).  with_scores: also the fused STEP-2
        bundle, each read's pair columns 2i and 2i+1 and its rows taken
        from the region that won it, as CoarseMapper.map_reads returns it.
        An unmapped read's pair columns are zeros and its rows those of
        the region that stages chromosome 0 from its first base as its
        segment 0, where the read stands (chromosome 0, position 0) as it
        does in the single mapper."""
        n = len(read_lengths)
        out = CoarseResults(
            orientation=np.full(n, shd.NONE, dtype=np.int8),
            hamming=np.zeros(n, dtype=np.int32),
            shift=np.zeros(n, dtype=np.int32),
            chromosome_id=np.zeros(n, dtype=np.int32),
            position=np.zeros(n, dtype=np.int32),
            global_window_id=np.full(n, SENTINEL, dtype=np.uint32),
            stats={k: 0 for k in OVERFLOW_KEYS},
            bs_strand=np.zeros(n, dtype=np.int8),
            global_window_id64=np.full(n, -1, dtype=np.int64))
        best_key = np.full(n, 2**62, dtype=np.int64)
        win_region = np.full(n, -1, dtype=np.int32)
        region_scores = []
        # the direct probe counts only where every region has it
        direct = 1
        for r_i, (mapper, (packed, ovf, bundle)) in enumerate(zip(
                self.mappers, self._map_regions(read_bases, read_lengths,
                                                with_scores))):
            region_scores.append(bundle)
            stats = mapper.stats(ovf)
            for k in OVERFLOW_KEYS:
                out.stats[k] += stats[k]
            direct = min(direct, stats["cuckoo_direct_probe"])
            key, payload, gwin_global = region_key_payload(
                mapper, packed, self.chrom_gwin_base)
            better = key < best_key
            best_key = np.where(better, key, best_key)
            win_region[better] = r_i
            out.orientation[better] = payload[better, 0].astype(np.int8)
            out.hamming[better] = payload[better, 1]
            out.shift[better] = payload[better, 2]
            out.chromosome_id[better] = payload[better, 3]
            out.position[better] = payload[better, 4]
            out.bs_strand[better] = payload[better, 5].astype(np.int8)
            out.global_window_id64[better] = gwin_global[better]
            out.global_window_id[better] = (
                gwin_global[better] & 0xFFFFFFFF).astype(np.uint32)
        out.stats["cuckoo_direct_probe"] = direct
        if not with_scores:
            return out
        scores = np.zeros((10, 2 * n), np.int16)
        tb_ops = np.zeros((2 * n, bandtb.FUSED_ENTRIES), np.uint8)
        tb_st = np.zeros(2 * n, np.int8)
        r0 = next(r for r, segs in enumerate(self.regions)
                  if (segs[0].chrom_id, segs[0].win_start) == (0, 0))
        rows = Step2Rows(*(x.copy() for x in region_scores[r0].rows))
        for r_i, bundle in enumerate(region_scores):
            won = np.nonzero(win_region == r_i)[0]
            cols = np.repeat(2 * won, 2)
            cols[1::2] += 1
            sc, to, ts = bundle
            scores[:, cols] = sc[:, cols]
            tb_ops[cols] = to[cols]
            tb_st[cols] = ts[cols]
            for name, dst, src in zip(Step2Rows._fields, rows, bundle.rows):
                sel = cols if name == "q3" else won
                dst[sel] = src[sel]
        return out, Step2Bundle(scores, tb_ops, tb_st, rows)
