"""Window-hit statistics (candidate recall instrumentation).

Re-derivation of the reference's opt-in COUNT_WINDOW_HITS machinery:
  * ground-truth read -> window mapping with >=50% overlap
    (reference: evaluation/computeWindowsFromSam.cpp:52-59 via
    Genome::getWindowIdWithOverlap, genome.hpp:387-420);
  * per-window true/false candidate hits after hashing and after SHD
    (reference: include/windowhitstatisticcollector.hpp:42-61,
    src/gpu/main_gpu.cu:555-574, 824-852);
  * precision / true-hit-ratio summaries
    (reference: evaluation/windowhitstats.py, numreadsperwindow.py).
A copy of hashreadmapper_tpu/eval/window_stats.py; the candidates come
from CoarseMapper.map_reads(collect_candidates=True).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..io.genome import Genome


def window_id_with_overlap(genome: Genome, window_size: int, k: int,
                           chrom_id: int, pos: int, length: int,
                           overlap: int) -> Optional[int]:
    """First window overlapping [pos, pos+length) by >= overlap bases
    (reference: genome.hpp:387-420)."""
    chrom_len = genome.chromosome_length(chrom_id)
    seq_end = min(pos + length, chrom_len)
    length = seq_end - pos
    stride = window_size - k + 1
    first = pos // stride
    last = (pos + length - 1) // stride
    for wid in range(first, last + 1):
        wbegin = wid * stride
        wend = (wid + 1) * stride
        if min(wend, seq_end) - max(wbegin, pos) >= overlap:
            return wid
    return None


def truth_windows_from_alignments(genome: Genome, window_size: int, k: int,
                                  alignments: Sequence[Tuple[int, int, int, int]]
                                  ) -> Dict[Tuple[int, int], set]:
    """(read_id, chrom_id, pos, length) -> {(chrom, window): {read ids}}.

    Overlap threshold = length // 2 (computeWindowsFromSam semantics)."""
    out: Dict[Tuple[int, int], set] = {}
    for read_id, chrom_id, pos, length in alignments:
        wid = window_id_with_overlap(
            genome, window_size, k, chrom_id, pos, length, length // 2)
        if wid is None:
            continue
        out.setdefault((chrom_id, wid), set()).add(read_id)
    return out


@dataclasses.dataclass
class WindowHitStats:
    """Per-window hit counters (true = read truly belongs to the window)."""
    true_hits: Dict[Tuple[int, int], int]
    false_hits: Dict[Tuple[int, int], int]

    def precision(self) -> float:
        t = sum(self.true_hits.values())
        f = sum(self.false_hits.values())
        return t / (t + f) if (t + f) else 0.0

    def recall(self, truth: Dict[Tuple[int, int], set]) -> float:
        total_truth = sum(len(v) for v in truth.values())
        return (sum(self.true_hits.values()) / total_truth
                if total_truth else 0.0)


class WindowHitStatisticCollector:
    """Counts candidate hits per window against the ground truth."""

    def __init__(self, truth: Dict[Tuple[int, int], set]):
        self.truth = truth
        self.stats = WindowHitStats({}, {})

    def add_hits(self, chrom_id: int, window_id: int,
                 read_ids: Iterable[int]) -> None:
        key = (chrom_id, window_id)
        expected = self.truth.get(key, set())
        for rid in read_ids:
            if rid in expected:
                self.stats.true_hits[key] = self.stats.true_hits.get(key, 0) + 1
            else:
                self.stats.false_hits[key] = self.stats.false_hits.get(key, 0) + 1

    def report(self) -> Dict[str, float]:
        return {
            "precision": self.stats.precision(),
            "recall": self.stats.recall(self.truth),
            "true_hits": sum(self.stats.true_hits.values()),
            "false_hits": sum(self.stats.false_hits.values()),
        }


def collect_from_candidates(genome: Genome, window_size: int, k: int,
                            truth: Dict[Tuple[int, int], set],
                            candidate_windows: Sequence[Sequence[int]],
                            win_chrom: Sequence[int],
                            win_id_within_chrom: Sequence[int]
                            ) -> WindowHitStatisticCollector:
    """candidate_windows[read_id] = iterable of global window ids."""
    coll = WindowHitStatisticCollector(truth)
    for read_id, gwins in enumerate(candidate_windows):
        for g in gwins:
            coll.add_hits(int(win_chrom[g]), int(win_id_within_chrom[g]),
                          [read_id])
    return coll
