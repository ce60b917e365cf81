"""End-to-end driver: STEP 1 coarse map -> STEP 2 SAM -> STEP 3 VCF
(counterpart of hashreadmapper_tpu/pipeline/driver.py).

STEP 1 runs on the CoarseMapper on the given device, in parity mode
(canonical k-mers), --threeN or --threeN --undirectional; with --mesh D T
on a ShardedCoarseMapper over a D x T mesh (distinct cards for a CUDA
device, every position the CPU for the CPU); with --regions N, or for a
genome of SINGLE_MAPPER_BASE_CAP bases or more, on a RegionShardedMapper
(one mapper a region, all on that device or all over the mesh).
STEP 2 runs there too (mapping.run_cssw: score passes and banded traceback
fused into the coarse step per chunk when the reads are pipelined, in
staged chunks otherwise), with the native CIGAR finish, rescore and
records on the host.  opts.step2_device = False (set in code; no flag) takes the serial
host path instead.  STEP 3 and the SAM writer are the native bulk
emitters.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from ..config import MapperType, ProgramOptions, SequencePairType
from ..io.genome import Genome
from ..io.readstore import ReadStorage
from ..utils.progress import ProgressReporter
from ..parallel.region_sharded import (SINGLE_MAPPER_BASE_CAP,
                                       RegionShardedMapper)
from ..parallel.sharded import ShardedCoarseMapper, make_mesh
from ..utils import tracing
from ..utils.timers import PhaseTimers
from . import mapping, mapping_edlib
from .engine import CoarseMapper, CoarseResults
from .mapping import run_cssw
from .records import MappingRecords, emit_sam, emit_vcf


def _step2_chunk(parent, *args, **kwargs):
    """run_cssw on a worker, as a span whose parent is the submitting
    chunk's."""
    with tracing.span("step2.chunk", parent=parent):
        return run_cssw(*args, **kwargs)


def _pipelined_sw(mapper, bases: np.ndarray,
                  reads: ReadStorage, genome: Genome, genome_rc: Genome,
                  opts: ProgramOptions):
    """Chunked coarse map on the device + STEP 2 on two workers: the
    workers finish chunk i while the main thread maps chunk i+1.  With
    device STEP 2 the coarse step also scores and traces back each chunk
    (map_reads with_scores), so the workers only run host code.  `mapper`
    is a CoarseMapper or a RegionShardedMapper.  Returns (results,
    MappingRecords, or AlignerArguments with global read ids)."""
    n = reads.num_reads
    chunk = opts.step2_pipeline_chunk
    # the parity-mode key-drop rule is a whole-dataset property; it must
    # precede the per-chunk mapping (regions apply no drop)
    if hasattr(mapper, "ensure_read_drops"):
        mapper.ensure_read_drops(bases, reads.lengths)
    progress = ProgressReporter(n, label="reads mapped+aligned",
                                enabled=opts.show_progress)
    res_parts, futs = [], []
    with ThreadPoolExecutor(max_workers=2, thread_name_prefix="step2") as ex:
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            with tracing.span("driver.chunk", chunk=c0, reads=c1 - c0):
                scores = None
                if opts.step2_device:
                    res, scores = mapper.map_reads(
                        bases[c0:c1], reads.lengths[c0:c1], with_scores=True)
                else:
                    res = mapper.map_reads(bases[c0:c1], reads.lengths[c0:c1])
                res_parts.append(res)
                futs.append((c0, c1, ex.submit(
                    _step2_chunk, tracing.current(), genome, genome_rc,
                    res.orientation, res.position, res.chromosome_id,
                    reads.slice_rows(c0, c1), opts, res.bs_strand, scores,
                    device=mapper.device)))
        parts = []
        with tracing.span("driver.wait"):
            for c0, c1, fut in futs:
                parts.append((c0, fut.result()))
                progress.add(c1 - c0)
    if all(isinstance(p, MappingRecords) for _, p in parts):
        mappingout = MappingRecords.concat([p for _, p in parts])
    else:
        # read ids in a chunk's AlignerArguments are chunk-local
        mappingout = []
        for c0, p in parts:
            aas = p.to_aas() if isinstance(p, MappingRecords) else p
            for aa in aas:
                aa.read_id += c0
            mappingout.extend(aas)
    if opts.show_progress:
        progress.finish()
    stats: Dict[str, int] = {}
    for r in res_parts:
        for k, v in r.stats.items():
            stats[k] = stats.get(k, 0) + v
    cat = lambda field: np.concatenate([getattr(r, field) for r in res_parts])
    g64 = all(r.global_window_id64 is not None for r in res_parts)
    results = CoarseResults(
        orientation=cat("orientation"), hamming=cat("hamming"),
        shift=cat("shift"), chromosome_id=cat("chromosome_id"),
        position=cat("position"), global_window_id=cat("global_window_id"),
        stats=stats, bs_strand=cat("bs_strand"),
        global_window_id64=cat("global_window_id64") if g64 else None)
    return results, mappingout


def build_mesh(opts: ProgramOptions, device):
    """The --mesh D T of opts, or None: the first D * T cards for a CUDA
    device (raising when there are fewer; a mesh asked for on the card
    never runs on the CPU), D * T positions of the device otherwise."""
    if opts.mesh_data is None and opts.mesh_table is None:
        return None
    n_data, n_table = opts.mesh_data or 1, opts.mesh_table or 1
    if opts.save_hashtables_to or opts.load_hashtables_from:
        raise ValueError("mesh-sharded tables do not serialize (the "
                         "reference's warpcore tables cannot either, "
                         "singlegpuminhasher.cuh:1052-1053)")
    if torch.device(device).type == "cuda":
        return make_mesh(n_data, n_table)
    return make_mesh(n_data, n_table, [device] * (n_data * n_table))


def run_pipeline(opts: ProgramOptions, device,
                 reads: Optional[ReadStorage] = None,
                 genome: Optional[Genome] = None) -> Dict:
    """Read ingest, window index on `device`, coarse map, STEP 2, SAM and
    VCF; returns the JAX driver's result dict."""
    timers = PhaseTimers()

    with timers.phase("STEP1"):
        with timers.phase("build_readstorage"):
            if reads is None:
                if opts.load_binary_reads_from:
                    reads = ReadStorage.load(opts.load_binary_reads_from)
                else:
                    reads = ReadStorage.from_files(
                        opts.inputfiles,
                        paired=opts.pair_type == SequencePairType.PAIRED_END,
                        quality_bits=(opts.quality_score_bits
                                      if opts.use_quality_scores else 0))
                if opts.save_binary_reads_to:
                    reads.save(opts.save_binary_reads_to)
        print(f"gpureadstorage: occupied memory: {reads.packed.nbytes}")
        print(f"Reads: {reads.num_reads}")

        if genome is None:
            genome = Genome.from_fasta(opts.genomefile)
        genome_rc = genome.reverse_complement()

        with timers.phase("build_minhasher"):
            if opts.max_read_length < reads.sequence_length_upper_bound():
                opts.max_read_length = reads.sequence_length_upper_bound()
            total_bases = sum(genome.chromosome_length(c)
                              for c in range(genome.num_chromosomes))
            mesh = build_mesh(opts, device)
            over = (f" over a {mesh.shape['data']}x{mesh.shape['table']} mesh"
                    if mesh else "")
            if opts.num_regions > 1 or total_bases >= SINGLE_MAPPER_BASE_CAP:
                n_regions = opts.num_regions or max(
                    1, -(-total_bases // SINGLE_MAPPER_BASE_CAP))
                mapper = RegionShardedMapper(genome, opts, n_regions,
                                             devices=[device], mesh=mesh)
                idx_bytes = sum(m.memory_bytes() for m in mapper.mappers)
                n_windows = sum(m.table.num_windows for m in mapper.mappers)
                print(f"window index: {idx_bytes} bytes, {n_windows} windows "
                      f"in {mapper.n_regions} regions{over}")
            elif mesh is not None:
                mapper = ShardedCoarseMapper(genome, opts, mesh)
                print(f"window index: {mapper.memory_bytes()} bytes, "
                      f"{mapper.table.num_windows} windows sharded{over}")
            else:
                mapper = CoarseMapper(
                    genome, opts, device,
                    load_index_from=opts.load_hashtables_from)
                if opts.save_hashtables_to:
                    mapper.save_index(opts.save_hashtables_to)
                print(f"window index: {mapper.index.memory_bytes()} bytes, "
                      f"{mapper.table.num_windows} windows")

        pipelined = (opts.mapper_type == MapperType.SW
                     and opts.step2_pipeline_chunk > 0
                     and reads.num_reads > opts.step2_pipeline_chunk)
        bases = reads.bases_matrix(opts.max_read_length).astype(np.int8)
        with timers.phase("process genome"):
            if pipelined:
                results, mappingout = _pipelined_sw(
                    mapper, bases, reads, genome, genome_rc, opts)
            else:
                results = mapper.map_reads(bases, reads.lengths)
        n_mapped = int((results.orientation != 3).sum())
        print(f"coarse mapped: {n_mapped}/{reads.num_reads} "
              f"stats={results.stats}")

    with timers.phase("process mapping"):
        if opts.mapper_type == MapperType.STHELSE:
            print("please implement your personal mapper")
            timers.print_all()
            return {"results": results, "mappingout": [], "sam_path": None,
                    "vcf_path": None, "timers": timers.totals(),
                    "reads": reads, "genome": genome, "mapper": mapper}
        sam_path = opts.outputfile + ".SAM"
        if opts.mapper_type == MapperType.SW:
            if not pipelined:
                mappingout = run_cssw(
                    genome, genome_rc, results.orientation, results.position,
                    results.chromosome_id, reads, opts, results.bs_strand,
                    device=mapper.device)
            if isinstance(mappingout, MappingRecords):
                sam_stats = emit_sam(mappingout, genome, sam_path,
                                     threads=max(1, opts.threads))
            else:
                sam_stats = mapping.print_to_sam(mappingout, genome, sam_path)
        else:
            mappingout = mapping_edlib.run_edlib(
                genome, genome_rc, results.orientation, results.position,
                results.chromosome_id, reads, opts)
            sam_stats = mapping_edlib.print_to_edlib_sam(
                mappingout, genome, sam_path)
        print(f"mapped reads: {sam_stats['mapped']}")
        print(f"unmapped reads: {sam_stats['unmapped']}")

    with timers.phase("process variant calling"):
        if opts.mapper_type != MapperType.SW:
            vcf_path = None
        elif isinstance(mappingout, MappingRecords):
            vcf_path = emit_vcf(mappingout, genome, opts.outputfile)
        else:
            vcf_path = mapping.do_vc(mappingout, genome, opts.outputfile)

    timers.print_all()
    return {"results": results, "mappingout": mappingout,
            "sam_path": sam_path, "vcf_path": vcf_path,
            "timers": timers.totals(), "reads": reads, "genome": genome,
            "mapper": mapper}
