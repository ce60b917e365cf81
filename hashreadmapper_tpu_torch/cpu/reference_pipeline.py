"""Oracle end-to-end coarse mapping in the reference's own orientation.

Faithfully mirrors STEP 1 of the reference driver (reference:
src/gpu/main_gpu.cu:859-1286): build a minhash index of the READS, then stream
the genome window-by-window through it, SHD-align candidate reads to extended
windows, and keep the best (first-window-wins) hit per read.  Used as the
equivalence oracle for the engine's inverted (genome-index) orientation
(a copy of hashreadmapper_tpu/cpu/reference_pipeline.py).
"""

from __future__ import annotations

from typing import List, Sequence

from ..config import ProgramOptions
from . import oracle


def coarse_map(chromosomes: Sequence[Sequence[int]],
               reads: Sequence[Sequence[int]],
               opts: ProgramOptions) -> List[oracle.MappedRead]:
    """Map every read against the genome; returns one MappedRead per read."""
    k = opts.kmer_length
    hash_ids = list(range(opts.num_hash_functions))

    # STEP 1a: read index (reference: constructGpuMinhasherFromGpuReadStorage)
    read_sigs = [oracle.minhash_signature(r, k, hash_ids) for r in reads]
    index = oracle.build_index_from_signatures(
        read_sigs, opts.num_hash_functions, opts.max_results_per_map)

    results = [oracle.MappedRead() for _ in reads]

    # STEP 1b: window loop (reference: genome.forEachBatchOfWindows +
    # WindowBatchProcessor).  Batch boundaries don't affect results; iterate
    # windows directly in genome order.
    stride = opts.window_stride
    for chrom_id, chrom in enumerate(chromosomes):
        chrom_len = len(chrom)
        nwin = oracle.num_windows_in_chromosome(chrom_len, k, opts.window_size)
        for wid in range(nwin):
            pos = wid * stride
            wlen = min(chrom_len, pos + opts.window_size) - pos
            window = chrom[pos:pos + wlen]
            sig = oracle.minhash_signature(window, k, hash_ids)
            cand = oracle.query_candidates(index, sig, opts.min_table_hits)
            for read_id in cand:
                read = reads[read_id]
                loc = oracle.extended_window_location(
                    chrom_len, pos, opts.window_size, len(read) // 2)
                anchor = chrom[loc.start:loc.start + loc.length]
                shd = oracle.shifted_hamming_distance(
                    anchor, read, opts.max_hamming_percent)
                new = oracle.MappedRead(
                    orientation=shd.orientation,
                    hamming_distance=shd.score,
                    shift=shd.shift - loc.left,
                    chromosome_id=chrom_id,
                    position=pos)
                results[read_id] = oracle.merge_result(results[read_id], new)
    return results
