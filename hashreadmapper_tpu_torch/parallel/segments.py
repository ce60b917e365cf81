"""Genome segments: contiguous window spans with extension margins (a
copy of hashreadmapper_tpu/parallel/segments.py).

A Segment is a contiguous run of windows of ONE chromosome.  It is the unit
of genome partitioning for region sharding and for genomes of 2**31 bases
and more: a mapper built over a list of segments stages only the covered
bases (plus a margin of max_read_length on each side, so extended-window
gathers and SHD word reads never leave the staged span) while window
positions, lengths, extension clamping, signatures and SHD results stay
identical to an uncut whole-genome mapper: the extension math sees the TRUE
chromosome length and TRUE positions, only the backing-store offset is
virtual.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..config import ProgramOptions
from ..io.genome import Genome


@dataclasses.dataclass(frozen=True)
class Segment:
    """A contiguous run of windows [win_start, win_stop) of one chromosome."""
    chrom_id: int
    win_start: int
    win_stop: int

    def num_windows(self) -> int:
        return self.win_stop - self.win_start


def segment_base_span(genome: Genome, opts: ProgramOptions, seg: Segment,
                      margin: int) -> tuple:
    """[lo, hi) base range of the chromosome this segment must stage."""
    stride, ws = opts.window_stride, opts.window_size
    clen = genome.chromosome_length(seg.chrom_id)
    first_pos = seg.win_start * stride
    last_pos = (seg.win_stop - 1) * stride
    span_end = min(clen, last_pos + ws)
    lo = max(0, first_pos - margin)
    hi = min(clen, span_end + margin)
    return lo, hi


def whole_chromosome_segments(genome: Genome, opts: ProgramOptions,
                              chrom_ids: List[int]) -> List[Segment]:
    """One segment per chromosome covering all of its windows."""
    k, ws = opts.kmer_length, opts.window_size
    return [Segment(c, 0, genome.num_windows_in_chromosome(c, k, ws))
            for c in chrom_ids]


def partition_windows(genome: Genome, opts: ProgramOptions,
                      n_regions: int) -> List[List[Segment]]:
    """Split the genome's global window sequence into n_regions contiguous,
    near-equal spans; spans crossing chromosome boundaries become several
    segments.  Deterministic, balanced by window count, and valid for any
    n_regions <= total windows (single-chromosome genomes included)."""
    k, ws = opts.kmer_length, opts.window_size
    nwin = [genome.num_windows_in_chromosome(c, k, ws)
            for c in range(genome.num_chromosomes)]
    total = sum(nwin)
    assert n_regions <= max(total, 1), "more regions than windows"
    bounds = [(total * r) // n_regions for r in range(n_regions + 1)]
    regions: List[List[Segment]] = [[] for _ in range(n_regions)]
    chrom_base = 0
    for c, n in enumerate(nwin):
        for r in range(n_regions):
            lo = max(bounds[r], chrom_base) - chrom_base
            hi = min(bounds[r + 1], chrom_base + n) - chrom_base
            if hi > lo:
                regions[r].append(Segment(c, lo, hi))
        chrom_base += n
    return regions


def staged_bases(genome: Genome, opts: ProgramOptions,
                 segments: List[Segment], margin: int) -> int:
    """Total bases a mapper over these segments stages on device."""
    return sum(hi - lo for lo, hi in
               (segment_base_span(genome, opts, s, margin) for s in segments))


def regions_for_base_cap(genome: Genome, opts: ProgramOptions,
                         base_cap: int, margin: int,
                         n_min: int = 1) -> List[List[Segment]]:
    """Smallest region count >= n_min whose every region stages < base_cap
    bases (the int32-gather limit is 2**31; callers pass a safety cap)."""
    total = genome.total_num_windows(opts.kmer_length, opts.window_size)
    n = max(n_min, 1)
    while n <= max(total, 1):
        regions = partition_windows(genome, opts, n)
        if all(staged_bases(genome, opts, r, margin) < base_cap
               for r in regions):
            return regions
        n *= 2
    raise ValueError("cannot partition genome under base cap")
