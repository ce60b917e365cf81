"""Variant matching against a reference set.

Equivalent of genomic_analysis-master/match_variants_against_reference.py
(reference: :1-84): reference variants in a ';'-separated CSV
(chr;pos;ref;alt;gene), called variants looked up per (chr, pos) and matched
on ref then alt, reporting ref/alt mismatches, missing records, and the
total matched percentage (the upstream project's published figure is 163/184
= 88.59%, :79-81).  A copy of hashreadmapper_tpu/eval/variants.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass
class MatchReport:
    ref_mismatches: int
    alt_mismatches: int
    missing: int
    total: int

    @property
    def matched(self) -> int:
        return self.total - (self.ref_mismatches + self.alt_mismatches
                             + self.missing)

    @property
    def percentage(self) -> float:
        return self.matched / self.total * 100 if self.total else 0.0

    def print(self) -> None:
        print(f"Refs mismatched {self.ref_mismatches}")
        print(f"Alts mismatched {self.alt_mismatches}")
        print(f"Records missing {self.missing}")
        print(f"Total matched {self.matched} out of {self.total}, "
              f"percentage: {self.percentage}")


def load_reference_variants(path: str) -> List[Tuple[str, int, str, str, str]]:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            chrom, pos, ref, alt, gene = line.split(";")
            out.append((chrom, int(pos), ref, alt, gene))
    return out


def load_called_variants_vcf(path: str) -> Dict[Tuple[str, int], List[Tuple[str, str]]]:
    """Parse our VariantHandler VCF into {(chrom, pos): [(ref, alt), ...]}."""
    out: Dict[Tuple[str, int], List[Tuple[str, str]]] = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            chrom, pos, _rid, ref, alt = f[0], int(f[1]), f[2], f[3], f[4]
            out.setdefault((chrom, pos), []).append((ref, alt))
    return out


def match_variants(reference: List[Tuple[str, int, str, str, str]],
                   called: Dict[Tuple[str, int], List[Tuple[str, str]]],
                   chromosomes: List[str] = None) -> MatchReport:
    ref_mm = 0
    alt_mm = 0
    missing = 0
    total = 0
    for chrom, pos, ref, alt, _gene in reference:
        if chromosomes is not None and chrom not in chromosomes:
            continue
        total += 1
        rows = called.get((chrom, pos))
        if not rows:
            missing += 1
            continue
        if not any(r == ref for r, _ in rows):
            ref_mm += 1
        elif not any(a == alt for r, a in rows if r == ref):
            alt_mm += 1
    return MatchReport(ref_mm, alt_mm, missing, total)
