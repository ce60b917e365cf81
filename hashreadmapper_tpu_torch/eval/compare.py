"""Mapping-concordance comparison (compare1 equivalent).

Re-derivation of the reference's end-to-end accuracy tool
(reference: evaluation/compare1.cpp): each read's mapping is compared against
a ground-truth record and classified into a 4-bit status
(sameChromosome, orientationOk, positionOk, goodHamming), where goodHamming
tolerates mapping to an identical/repeat region by directly comparing the two
genome ranges (fwd and revcomp, compare1.cpp:146-183).  Prints the same
histogram shape.  A copy of hashreadmapper_tpu/eval/compare.py; the
records come from the port's CoarseResults.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from ..io.genome import Genome


@dataclasses.dataclass
class TruthRecord:
    """One ground-truth alignment (a reference-SAM row's essentials)."""
    read_id: int
    flags: int           # SAM flags (0x4 unmapped, 0x10 reverse)
    chromosome: str
    position: int        # 0-based


@dataclasses.dataclass
class MapperRecord:
    """One mapper output record (readId/orientation/chr/windowPos/shift/len,
    the reference's comparison input format, compare1.cpp:84-99)."""
    read_id: int
    orientation: int     # 1 fwd, 2 rc, 3 unmapped
    chromosome: str
    window_position: int
    shift: int
    read_length: int


@dataclasses.dataclass
class CompareStats:
    status_histogram: Dict[int, int]
    one_is_unmapped: int
    num_clipped: int
    num_ref_clipped: int
    processed: int

    def concordant(self) -> int:
        """Reads with sameChrom+orientation+position or goodHamming."""
        full = self.status_histogram.get(0b1111, 0)
        repeat = sum(v for k, v in self.status_histogram.items()
                     if (k & 1) and k != 0b1111)
        return full + repeat

    def print_histogram(self) -> None:
        print("status histogram (sameChrom|orientation|position|goodHamming):")
        for status in sorted(self.status_histogram):
            print(f"  {status:04b}: {self.status_histogram[status]}")
        print(f"one_is_unmapped: {self.one_is_unmapped}")
        print(f"clipped: {self.num_clipped}, ref_clipped: {self.num_ref_clipped}")


def _hamming_full(a: str, b: str) -> int:
    """Non-overlap counts as mismatch (compare1.cpp:19-35)."""
    n = min(len(a), len(b))
    d = sum(1 for i in range(n) if a[i] != b[i])
    return d + (len(a) - n) + (len(b) - n)


_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _revcomp(s: str) -> str:
    return "".join(_COMP.get(c, c) for c in reversed(s))


def compare_mappings(genome: Genome, truth: Sequence[TruthRecord],
                     mapped: Sequence[MapperRecord],
                     max_mismatches_between_regions: int = 0) -> CompareStats:
    stats = CompareStats({}, 0, 0, 0, 0)
    by_id = {m.read_id: m for m in mapped}
    name_to_idx = {n: i for i, n in enumerate(genome.names)}
    # decode each chromosome once (sequence_str re-decodes the full
    # chromosome per call; at evaluation scale that dominated everything)
    seq_cache: Dict[int, str] = {}

    def seq(ci: int) -> str:
        s = seq_cache.get(ci)
        if s is None:
            s = seq_cache[ci] = genome.sequence_str(ci)
        return s

    for t in truth:
        m = by_id.get(t.read_id)
        if m is None:
            continue
        stats.processed += 1
        is_mapped1 = (t.flags & 0x4) == 0
        is_mapped2 = m.orientation != 3
        if not (is_mapped1 and is_mapped2):
            stats.one_is_unmapped += 1
            continue
        ci1 = name_to_idx[t.chromosome]
        ci2 = name_to_idx[m.chromosome]
        mapper_pos = m.window_position + m.shift
        seq1 = seq(ci1)
        seq2 = seq(ci2)
        if mapper_pos < 0 or mapper_pos + m.read_length >= len(seq2):
            stats.num_clipped += 1
            continue
        if t.position < 0 or t.position + m.read_length >= len(seq1):
            stats.num_ref_clipped += 1
            continue
        range1 = seq1[t.position:t.position + m.read_length]
        range2 = seq2[mapper_pos:mapper_pos + m.read_length]
        is_rev1 = (t.flags & 0x10) == 0x10
        is_rev2 = m.orientation == 2
        same_chrom = t.chromosome == m.chromosome
        orient_ok = is_rev1 == is_rev2
        pos_ok = t.position == mapper_pos
        best_hamming = 0
        if not (same_chrom and orient_ok and pos_ok):
            best_hamming = min(_hamming_full(range1, range2),
                               _hamming_full(_revcomp(range1), range2))
        good_hamming = best_hamming <= max_mismatches_between_regions
        status = (int(same_chrom) << 3) | (int(orient_ok) << 2) | (
            int(pos_ok) << 1) | int(good_hamming)
        stats.status_histogram[status] = stats.status_histogram.get(
            status, 0) + 1
    return stats


def mapper_records_from_results(results, genome: Genome,
                                read_lengths) -> List[MapperRecord]:
    """Convert CoarseResults into comparison records."""
    out = []
    for i in range(len(results.orientation)):
        out.append(MapperRecord(
            read_id=i,
            orientation=int(results.orientation[i]),
            chromosome=genome.names[int(results.chromosome_id[i])],
            window_position=int(results.position[i]),
            shift=int(results.shift[i]),
            read_length=int(read_lengths[i])))
    return out


def truth_from_sam(path: str) -> List[TruthRecord]:
    """Parse ground-truth records from a (standard) SAM file; QNAME must be
    the integer read id (as the reference's evaluation flow assumes)."""
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            out.append(TruthRecord(
                read_id=int(f[0]), flags=int(f[1]), chromosome=f[2],
                position=int(f[3]) - 1))
    return out
