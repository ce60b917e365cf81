"""Plain reference of STEP 2 and STEP 3 for single reads: the SAM row
(and its @SQ line) that a read's coarse row leads to, and the VCF lines
that a run of SAM rows leads to.

A frozen copy of the port's serial host path (AlignerArguments, the
window slices, the two 3N alignments, the bisulfite rescore, the SAM
layout of print_to_sam and the VariantHandler of STEP 3), the oracle that
its device STEP 2 and native emitters are held to.  NumPy and the standard
library only: the alignments run in worker processes.
"""

from __future__ import annotations

import bisect
from typing import List, Sequence, Tuple

from . import sw

FORWARD, REVERSE_COMPLEMENT, NONE = 1, 2, 3
ACGT = "ACGT"
_COMPLEMENT = str.maketrans("ACGT", "TGCA")
_REVCOMP = str.maketrans("ACGTN", "TGCAN")
SEQ_READ_SIZE = 82
MAP_QUALITY_THRESHOLD = 20


def revcomp(s: str) -> str:
    return s.translate(_REVCOMP)[::-1]


def three_n(s: str, bs_strand: int) -> str:
    """C -> T; G -> A in the mirrored (PBAT) space."""
    return s.replace("G", "A") if bs_strand else s.replace("C", "T")


def window_views(codes, pos: int, window_size: int):
    """The window at pos of a chromosome (base codes) and the slice of the
    reverse-complement chromosome that starts at len - pos - 1, NUL past
    its end: (window, window_rc, wlen)."""
    size = len(codes)
    wlen = window_size if pos + window_size < size else size - pos
    window = "".join(ACGT[b] for b in codes[pos:pos + wlen])
    window_rc = "".join("TGCA"[codes[pos - j]] if pos - j >= 0 else "\x00"
                        for j in range(wlen))
    return window, window_rc, wlen


def parse_cigar(cigar: str) -> List[Tuple[str, int]]:
    out, num = [], 0
    for c in cigar:
        if c.isdigit():
            num = num * 10 + int(c)
        else:
            out.append((c, num))
            num = 0
    return out


def rescore(ali: sw.Alignment, query: str, rc_query: str, ref: str,
            rc_ref: str, bs_strand: int, h: int) -> int:
    """The bisulfite rescore of alignment h along its CIGAR with the
    82-base horizon (h 0 walks the reverse-complemented query, h 1 the
    query, as the reference does); returns its conversions."""
    n_conv = 0
    _query = query if h else rc_query
    _ref = ref
    if bs_strand:
        _query = _query.translate(_COMPLEMENT)
        _ref = _ref.translate(_COMPLEMENT)
        rc_ref = rc_ref.translate(_COMPLEMENT)
    ref_pos = alt_pos = 0
    for op, length in parse_cigar(ali.cigar_string):
        bases_left = min(82 - max(ref_pos, alt_pos), length)
        if op in ("M", "="):
            for i in range(max(0, bases_left)):
                if (alt_pos + i >= len(_query) or ref_pos + i >= len(_ref)
                        or ref_pos + i >= len(rc_ref)):
                    continue
                q = _query[alt_pos + i]
                r = _ref[ref_pos + i]
                if q == r or r == "N" or q == "N":
                    continue
                if op == "M" and q == "C":
                    if ((r == "T" and rc_ref[ref_pos + i] == "A")
                            or (r == "A" and rc_ref[ref_pos + i] == "T")):
                        ali.sw_score_next_best -= sw.get_score("T", r)
                        ali.sw_score_next_best += sw.get_score("C", r)
                        ali.sw_score -= sw.get_score("T", r)
                        ali.sw_score += sw.get_score("C", r)
                if q == "T":
                    if ((r == "C" and rc_ref[ref_pos + i] == "G")
                            or (r == "G" and rc_ref[ref_pos + i] == "C")):
                        n_conv += 1
                        if op == "M":
                            delta = (sw.get_score("T", r)
                                     - sw.get_score("T", "T"))
                        else:
                            delta = sw.get_score(q, r) - 2
                        ali.sw_score_next_best += delta
                        ali.sw_score += delta
            ref_pos += bases_left
            alt_pos += bases_left
        elif op in ("I", "S"):
            alt_pos += bases_left
        elif op in ("D", "N"):
            ref_pos += bases_left
        elif op == "X":
            ref_pos += bases_left
            alt_pos += bases_left
    return n_conv


def sam_lines_batch(items: Sequence[tuple]) -> List[Tuple[str, str]]:
    """(@SQ line, SAM row) of each read, without their newlines; an item
    is (read id, `read` as sequenced, the coarse row's orientation,
    position, the chromosome's name, window_views' window, window_rc and
    wlen at that position, the strand column).  The alignments of all
    the reads run together."""
    pairs, masks = [], []
    for (_, read, orientation, _, _, window, _, _, bs_strand) in items:
        if orientation == NONE:
            continue
        bs = 1 if (bs_strand and orientation == FORWARD) else 0
        query = revcomp(read) if orientation == REVERSE_COMPLEMENT else read
        ref3 = three_n(window, bs)
        pairs += [(three_n(query, bs), ref3),
                  (three_n(revcomp(query), bs), ref3)]
        masks += [max(15, len(read) // 2)] * 2
    aligned = iter(sw.ssw_align_many(pairs, masks))
    out = []
    for (read_id, read, orientation, position, chrom_name, window,
         window_rc, wlen, bs_strand) in items:
        bs = 1 if (bs_strand and orientation == FORWARD) else 0
        query = revcomp(read) if orientation == REVERSE_COMPLEMENT else read
        rc_query = revcomp(query)
        als = [sw.Alignment(), sw.Alignment()]
        conv = [0, 0]
        flag = flag_rc = 0
        if orientation == NONE:
            flag |= 0x4
        else:
            als = [next(aligned), next(aligned)]
            flag, flag_rc = als[0].flag, als[1].flag
            conv = [rescore(als[h], query, rc_query, window, window_rc, bs,
                            h) for h in (0, 1)]
        h = 0 if als[0].sw_score >= als[1].sw_score else 1
        a = als[h]
        samtag = f"Yf:i:<{conv[h]}>YZ:A:<{'+-'[h]}>"
        samflag = flag if h == 0 else flag_rc
        mapq = sw.mapq_cssw(a.sw_score, a.sw_score_next_best)
        tag = samtag if (flag & 0x4) == 0 else str(flag)
        row = (f"{read_id}\t{samflag}\t{chrom_name}\t"
               f"{position + a.query_begin}\t{mapq}\t{a.cigar_string}\t"
               f"{window}\t\t0\t{query}\t*\t{tag}\t")
        out.append((f"@SQ\tSN:{read_id}\tLN:{wlen}", row))
    return out


class VariantHandler:
    """STEP 3: CIGAR walks with the 82-base horizon, an ordered set of
    (pos, "ref\\talt"), and after every call a flush of the entries with
    pos + 82 < the call's position, written with that call's chromosome,
    read id and quality (the tail is never flushed)."""

    def __init__(self):
        self.lines: List[str] = []
        self._set: List[Tuple[int, str]] = []

    def _save(self, pos: int, ref: str, alt: str) -> None:
        entry = (pos, f"{ref}\t{alt}")
        i = bisect.bisect_left(self._set, entry)
        if i < len(self._set) and self._set[i] == entry:
            return
        self._set.insert(i, entry)

    def call(self, read_pos: int, prefix: str, ref: str, alt: str,
             cigar: Sequence[Tuple[str, int]], chrom: str, read_id: int,
             qual: int) -> None:
        ref_pos = alt_pos = 0
        for op, length in cigar:
            bases_left = min(SEQ_READ_SIZE - max(ref_pos, alt_pos), length)
            if op in ("M", "X", "="):
                for i in range(max(0, bases_left)):
                    if ref_pos + i >= len(ref) or alt_pos + i >= len(alt):
                        continue
                    r, a = ref[ref_pos + i], alt[alt_pos + i]
                    if r == a or r == "N" or a == "N":
                        continue
                    self._save(read_pos + ref_pos + i, r, a)
                ref_pos += bases_left
                alt_pos += bases_left
            elif op == "I":
                if bases_left > 0:
                    if ref_pos == 0:
                        self._save(read_pos, prefix,
                                   prefix + alt[alt_pos:alt_pos + bases_left])
                    else:
                        self._save(read_pos + ref_pos,
                                   ref[ref_pos - 1:ref_pos],
                                   alt[alt_pos - 1:alt_pos + bases_left])
                alt_pos += bases_left
            elif op == "D":
                if bases_left > 0:
                    if ref_pos == 0:
                        self._save(read_pos,
                                   prefix + ref[ref_pos:ref_pos + bases_left],
                                   prefix)
                    else:
                        self._save(read_pos + ref_pos,
                                   ref[ref_pos - 1:ref_pos + bases_left],
                                   alt[alt_pos - 1:alt_pos])
                ref_pos += bases_left
            elif op == "S":
                alt_pos += bases_left
            elif op == "N":
                ref_pos += bases_left
        keep = 0
        for i, (pos, variant) in enumerate(self._set):
            if pos + SEQ_READ_SIZE >= read_pos:
                break
            self.lines.append(f"{chrom}\t{pos}\t{read_id}\t{variant}\t{qual}"
                              "\t\t\t\t")
            keep = i + 1
        self._set = self._set[keep:]


def vcf_lines(rows: Sequence[str], window_pos: Sequence[int]) -> List[str]:
    """The VCF body lines that STEP 3 writes while it walks these SAM rows
    in order (window_pos: each read's coarse window position)."""
    vh = VariantHandler()
    for row, wpos in zip(rows, window_pos):
        f = row.split("\t")
        mapq = int(f[4])
        if mapq < MAP_QUALITY_THRESHOLD:
            continue
        pos = int(f[3])
        window = f[6]
        vh.call(pos, window[:max(0, pos - int(wpos))], window, f[9],
                parse_cigar(f[5]), f[2], int(f[0]), mapq)
    return vh.lines
