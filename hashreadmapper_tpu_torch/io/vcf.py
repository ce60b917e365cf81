"""VCF variant handler (STEP 3 output).

Behavioral re-derivation of the reference's VariantHandler
(reference: src/varianthandler.cpp:14-166, include/varianthandler.hpp):

  * call() walks a CIGAR against (ref, alt) strings with an 82-base horizon
    (SEQ_READ_SIZE; each op processes min(82 - max(refPos, altPos), len)
    bases — negative values DECREMENT the positions, faithfully kept);
  * variants are buffered in an ordered set keyed by (pos, "ref\talt") —
    duplicates collapse;
  * flush() after every call writes entries with pos + 82 < lastPos using the
    CURRENT call's chrom/readId/qual (a reference quirk: buffered variants
    inherit the flushing read's metadata), and the tail is never force-flushed.
"""

from __future__ import annotations

from typing import List, Tuple

SEQ_READ_SIZE = 82
WILDCARD = "N"
MAP_QUALITY_THRESHOLD = 20  # reference: include/constants.hpp:11


class VariantHandler:
    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "w")
        self._set = []  # sorted list of (pos, variant_str)

    def vcf_file_header(self) -> None:
        self._fh.write("##fileformat=VCFv4.2\n")
        self._fh.write("#CHROM\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\n")

    def _save(self, pos: int, ref: str, alt: str) -> None:
        entry = (pos, f"{ref}\t{alt}")
        import bisect
        i = bisect.bisect_left(self._set, entry)
        if i < len(self._set) and self._set[i] == entry:
            return  # std::set dedup
        self._set.insert(i, entry)

    def call(self, read_pos: int, prefix: str, ref: str, alt: str,
             cigar_entries: List[Tuple[str, int]], chrom: str,
             read_id: int, qual: int) -> None:
        ref_pos = 0
        alt_pos = 0
        for op, length in cigar_entries:
            bases_left = min(SEQ_READ_SIZE - max(ref_pos, alt_pos), length)
            if op in ("M", "X", "="):
                for i in range(max(0, bases_left)):
                    r = ref[ref_pos + i] if ref_pos + i < len(ref) else None
                    a = alt[alt_pos + i] if alt_pos + i < len(alt) else None
                    if r is None or a is None:
                        continue
                    if r == a or r == WILDCARD or a == WILDCARD:
                        continue
                    self._save(read_pos + ref_pos + i, r, a)
                ref_pos += bases_left
                alt_pos += bases_left
            elif op == "I":
                if bases_left > 0:
                    if ref_pos == 0:
                        self._save(read_pos + ref_pos, prefix,
                                   prefix + alt[alt_pos:alt_pos + bases_left])
                    else:
                        self._save(read_pos + ref_pos,
                                   ref[ref_pos - 1:ref_pos],
                                   alt[alt_pos - 1:alt_pos + bases_left])
                alt_pos += bases_left
            elif op == "D":
                if bases_left > 0:
                    if ref_pos == 0:
                        self._save(read_pos + ref_pos,
                                   prefix + ref[ref_pos:ref_pos + bases_left],
                                   prefix)
                    else:
                        self._save(read_pos + ref_pos,
                                   ref[ref_pos - 1:ref_pos + bases_left],
                                   alt[alt_pos - 1:alt_pos])
                ref_pos += bases_left
            elif op == "S":
                alt_pos += bases_left
            elif op == "H" or op == "P":
                pass
            elif op == "N":
                ref_pos += bases_left
            else:
                raise AssertionError(f"Unhandled CIGAR operation {op!r}")
        self.flush(read_pos, chrom, read_id, qual)

    def flush(self, last_pos: int, chrom: str, read_id: int,
              qual: int) -> None:
        keep_from = 0
        for i, (pos, variant) in enumerate(self._set):
            if pos + SEQ_READ_SIZE >= last_pos:
                keep_from = i
                break
            self._write(pos, variant, chrom, read_id, qual)
            keep_from = i + 1
        self._set = self._set[keep_from:]

    def _write(self, pos: int, variant: str, chrom: str, read_id: int,
               qual: int) -> None:
        self._fh.write(
            f"{chrom}\t{pos}\t{read_id}\t{variant}\t{qual}\t\t\t\t\n")

    def close(self) -> None:
        self._fh.close()


def parse_cigar(cigar: str) -> List[Tuple[str, int]]:
    """Parse a CIGAR string into [(op, len)] (reference: src/cigar.cpp)."""
    out = []
    num = 0
    for c in cigar:
        if c.isdigit():
            num = num * 10 + int(c)
        else:
            out.append((c, num))
            num = 0
    return out
