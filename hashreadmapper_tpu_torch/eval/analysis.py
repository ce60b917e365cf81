"""genomic_analysis subproject port: variantcall-from-SAM + analyser
(a copy of hashreadmapper_tpu/eval/analysis.py; CLI: python -m
hashreadmapper_tpu_torch.eval.analysis).

Behavioral re-derivation of the reference's standalone analysis pipeline
(reference: genomic_analysis-master/):

* ``variantcall(sam, ref, out)`` — the SAM -> comma-VCF caller
  (src_variant_calling/main.cpp:9-66 driving sequencehandler.cpp,
  referencehandler.cpp, cigar.cpp, varianthandler.cpp).  This is an
  OLDER, simpler sibling of the mapper-integrated VariantHandler ported
  in io/vcf.py: fixed SEQ_READ_SIZE=82 window clamp, MAPQ<40 filter,
  ``pos,ref,alt`` output lines, and a raw-byte reference stream (NO FASTA
  header or newline handling — the reference reads the file as a flat
  character array, referencehandler.cpp:58-67).
* ``Analyser`` — the per-region variant-count aggregator
  (src_analysis/analyser.cpp): merges N per-sample VCFs in 100-line
  batches, counts identical (pos, variant) entries across samples inside
  [region_start, region_end], and emits ``pos,ref,alt,count`` rows in
  (pos, variant) lexicographic order, flushing only positions strictly
  below the minimum position currently buffered in any stream.

Byte-exactness: tests/golden/genomic_analysis/* were produced by
compiling the reference sources unmodified (recipe in
tests/golden/genomic_analysis/regen_recipe.py; drivers rebuilt in /tmp)
and running them on synthetic inputs covering every CIGAR branch, all
three reference-seek cases, wildcard suppression, the 82-column clamp,
the batch flush, and region filtering.  tests/test_analysis.py asserts
this module reproduces those files byte-for-byte
(tests/test_torch_eval.py, this copy).

Observed reference quirks preserved here (each verified by running the
compiled reference):
* the analyser's own unit fixtures (src_analysis/tests/test.*.vcf) are
  TAB-separated while its parser splits on ','; the reference's own test
  binary FAILS its assertions on them.  The production chain is
  comma-separated end-to-end (varianthandler.cpp:85 writes
  ``pos,ref,alt``), which is what the goldens cover.  For a comma-less
  line the reference wraps npos+1 to 0 and takes the WHOLE line as the
  variant string (analyser.cpp:86) — mirrored.
* a SAM line whose sequence column is not followed by a tab never
  populates the sequence (the column loop exits first,
  sequencehandler.cpp:40-60) and the read is silently skipped.
* CIGARs longer than the query throw out_of_range in the reference; this
  port raises IndexError on the same inputs (malformed input, not golden
  behavior).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

SEQ_READ_SIZE = 82            # constants.hpp:4
MAP_QUALITY_THRESHOLD = 40    # constants.hpp:11
WILDCARD = "N"                # constants.hpp:13
_BATCH_SIZE_VC = 100          # varianthandler.cpp:5
_BATCH_SIZE_AN = 100          # src_analysis/main.cpp:6
_INT_MAX = 2**31 - 1

# SAM columns (constants.hpp:6-9)
_COL_POS, _COL_MAPQ, _COL_CIGAR, _COL_SEQ = 3, 4, 5, 9

_CIGAR_OPS = {"M": "M", "I": "I", "D": "D", "S": "S", "H": "H"}


def _parse_cigar(cigar: str) -> List[Tuple[str, int]]:
    """cigar.cpp:3-15: digits accumulate, any A-Z flushes an entry.

    Unknown uppercase ops map to Invalid and trip the caller's assert
    (varianthandler.cpp:52); mirrored with ValueError at call time, so
    parsing itself accepts them like the reference does."""
    entries: List[Tuple[str, int]] = []
    bases = 0
    for c in cigar:
        if "A" <= c <= "Z":
            entries.append((_CIGAR_OPS.get(c, "?"), bases))
            bases = 0
        elif "0" <= c <= "9":
            bases = bases * 10 + (ord(c) - ord("0"))
    return entries


def _stoi(s: str) -> int:
    """std::stoi: optional sign + leading digits, error if none."""
    i, n = 0, len(s)
    while i < n and s[i] in " \t":
        i += 1
    j = i
    if j < n and s[j] in "+-":
        j += 1
    k = j
    while k < n and s[k].isdigit():
        k += 1
    if k == j:
        raise ValueError(f"stoi: no digits in {s!r}")
    return int(s[i:k])


def _parse_sam_line(line: str):
    """sequencehandler.cpp:31-65: only columns 3/4/5/9 are read; the
    loop requires a tab AFTER each consumed column (a line ending at the
    sequence column yields no sequence and the read is skipped)."""
    pos = mapq = -1
    cigar = seq = ""
    column, cur = 0, 0
    entry = line.find("\t")
    while True:
        field = line[cur:] if entry < 0 else line[cur:entry]
        if column == _COL_POS:
            pos = _stoi(field)
        elif column == _COL_MAPQ:
            mapq = _stoi(field)
        elif column == _COL_CIGAR:
            cigar = field
        elif column == _COL_SEQ:
            seq = field
        cur = entry + 1
        entry = line.find("\t", cur)
        column += 1
        if entry < 0 or column > _COL_SEQ:
            break
    if pos == -1 or mapq == -1 or not cigar or not seq:
        return None
    return pos, mapq, cigar, seq


class _ReferenceStream:
    """referencehandler.cpp: a flat-byte view of the reference file with
    the reference's three seek cases.  Positions are 1-based; the stream
    never rewinds (SAM must be position-sorted, case INVALID asserts)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._data = f.read().decode("latin-1")
        self._start = 1
        self._end = SEQ_READ_SIZE
        self.sequence = self._data[:SEQ_READ_SIZE]
        self.prefix = WILDCARD    # referencehandler.cpp:9

    def seek(self, pos: int) -> None:
        start, end = pos, pos + SEQ_READ_SIZE - 1
        if start == self._start and end == self._end:
            pass                                        # case 1
        elif start > self._start and end > self._end and start < self._end:
            trim = start - self._start                  # case 2 (overlap)
            self.prefix = self.sequence[trim - 1:trim]
            self.sequence = (self.sequence[trim:]
                             + self._data[self._end:self._end + trim])
        elif start > self._start and end > self._end:
            self.prefix = self._data[start - 2:start - 1]   # case 3 (gap)
            self.sequence = self._data[start - 1:start - 1 + SEQ_READ_SIZE]
        else:
            raise AssertionError(
                "read could not be aligned given current reference "
                "position (SAM not position-sorted?)")
        self._start, self._end = start, end


class _VariantWriter:
    """varianthandler.cpp: ordered (pos, 'ref,alt') set with batched
    flush; only entries with pos + 82 < lastPos leave the buffer."""

    def __init__(self, out_path: str):
        self._file = open(out_path, "w")
        self._set: Dict[Tuple[int, str], None] = {}
        self._iter_since_flush = 0

    def call(self, read_pos: int, prefix: str, ref: str, alt: str,
             entries: List[Tuple[str, int]]) -> None:
        ref_pos = alt_pos = 0
        for op, n in entries:
            bases_left = min(SEQ_READ_SIZE - max(ref_pos, alt_pos), n)
            if op == "M":
                for i in range(bases_left):
                    r, a = ref[ref_pos + i], alt[alt_pos + i]
                    if r == a or r == WILDCARD or a == WILDCARD:
                        continue
                    self._save(read_pos + ref_pos + i, r, a)
                ref_pos += bases_left
                alt_pos += bases_left
            elif op == "I":
                if ref_pos == 0:
                    self._save(read_pos, prefix,
                               prefix + alt[alt_pos:alt_pos + bases_left])
                else:
                    self._save(read_pos + ref_pos, ref[ref_pos - 1],
                               alt[alt_pos - 1:alt_pos + bases_left])
                alt_pos += bases_left
            elif op == "D":
                if ref_pos == 0:
                    self._save(read_pos,
                               prefix + ref[:bases_left], prefix)
                else:
                    self._save(read_pos + ref_pos,
                               ref[ref_pos - 1:ref_pos + bases_left],
                               alt[alt_pos - 1])
                ref_pos += bases_left
            elif op == "S":
                alt_pos += bases_left
            elif op == "H":
                pass
            else:
                raise ValueError(f"unhandled CIGAR operation {op!r}")
        self._iter_since_flush += 1
        if self._iter_since_flush >= _BATCH_SIZE_VC:
            self._flush(read_pos)

    def _save(self, pos: int, ref: str, alt: str) -> None:
        # out-of-range reads on malformed CIGARs raise in the reference
        # (std::out_of_range from substr); python '' slices would hide
        # that — detect and raise the same way
        if not ref or not alt:
            raise IndexError("CIGAR walks past the sequence "
                             "(reference throws std::out_of_range)")
        self._set[(pos, f"{ref},{alt}")] = None

    def _flush(self, last_pos: int) -> None:
        self._iter_since_flush = 0
        remaining: Dict[Tuple[int, str], None] = {}
        for key in sorted(self._set):
            if key[0] + SEQ_READ_SIZE >= last_pos:
                remaining[key] = None
            else:
                self._file.write(f"{key[0]},{key[1]}\n")
        self._set = remaining

    def close(self) -> None:
        self._flush(_INT_MAX)
        self._file.close()


def variantcall(sam_path: str, ref_path: str, out_path: str) -> Tuple[int, int]:
    """The ``variantcall <SAM> <REF> <OUT>`` binary (main.cpp:9-66).

    Returns (called, total) read counts (main.cpp:63 prints
    ``Called variants on <called>/<total> reads``)."""
    ref = _ReferenceStream(ref_path)
    writer = _VariantWriter(out_path)
    called = total = 0
    try:
        with open(sam_path) as f:
            for line in f:
                parsed = _parse_sam_line(line.rstrip("\n"))
                if parsed is None:
                    continue
                pos, mapq, cigar, seq = parsed
                total += 1
                if mapq < MAP_QUALITY_THRESHOLD:
                    continue
                called += 1
                ref.seek(pos)
                writer.call(pos, ref.prefix, ref.sequence, seq,
                            _parse_cigar(cigar))
    finally:
        writer.close()
    return called, total


class Analyser:
    """src_analysis/analyser.cpp: k-way batched merge of per-sample
    VCFs with (pos, variant) counting and region filtering.

    The reference hardcodes ``metadata.csv`` in the cwd and the
    ``variants/chr<CHR>/`` layout (analyser.cpp:17-27 — it IGNORES its
    metadataPath argument); ``open_from_metadata`` reproduces that
    derivation but takes the base directory explicitly."""

    def __init__(self, out_path: str, region_start: int = 0,
                 region_end: int = _INT_MAX,
                 batch_size: int = _BATCH_SIZE_AN):
        self._out = open(out_path, "w") if out_path else None
        self._region = (region_start, region_end)
        self._batch = batch_size
        self._files: List = []
        self._counts: Dict[Tuple[int, str], int] = {}
        self._min_pos = _INT_MAX
        self.rows: List[str] = []    # captured when out_path == ""

    def open_vcf(self, path: str) -> bool:
        try:
            self._files.append(open(path))
            return True
        except OSError:
            return False

    def open_from_metadata(self, metadata_path: str, chromosome: str,
                           base_dir: str = ".") -> bool:
        """metadata lines ``<id>\\t<name>.bam`` -> VCF
        ``variants/chr<CHR>/<name>.chr<CHR>.vcf`` (analyser.cpp:22-27:
        second field minus its last 3 chars + ``chr<CHR>.vcf``)."""
        try:
            meta = open(metadata_path)
        except OSError:
            return False
        with meta:
            for line in meta:
                line = line.rstrip("\n")
                if not line:
                    continue
                delim = line.find("\t")
                fname = line[delim + 1:len(line) - 3] + f"chr{chromosome}.vcf"
                if not self.open_vcf(os.path.join(
                        base_dir, f"variants/chr{chromosome}", fname)):
                    return False
        return True

    def sample_count(self) -> int:
        return len(self._files)

    def start(self) -> None:
        complete = [False] * len(self._files)
        updated = True
        while updated:
            updated = False
            self._min_pos = _INT_MAX
            for i in range(len(self._files)):
                if complete[i]:
                    continue
                complete[i] = self._batch_read(i)
                updated = updated or not complete[i]
            self._flush()
        for f in self._files:
            f.close()
        self._min_pos = _INT_MAX
        self._flush()

    def _batch_read(self, i: int) -> bool:
        for _ in range(self._batch):
            line = self._files[i].readline()
            if not line:
                return True
            line = line.rstrip("\n")
            delim = line.find(",")
            if delim < 0:
                # npos+1 wraps to 0: the WHOLE line becomes the variant
                pos, variant = _stoi(line), line
            else:
                pos, variant = _stoi(line[:delim]), line[delim + 1:]
            if self._min_pos > pos:
                self._min_pos = pos
            if self._region[0] <= pos <= self._region[1]:
                key = (pos, variant)
                self._counts[key] = self._counts.get(key, 0) + 1
        return False

    def _write(self, pos: int, variant: str, count: int) -> None:
        row = f"{pos},{variant},{count}"
        if self._out is not None:
            self._out.write(row + "\n")
        else:
            self.rows.append(row)

    def _flush(self) -> None:
        remaining: Dict[Tuple[int, str], int] = {}
        for key in sorted(self._counts):
            if key[0] >= self._min_pos:
                remaining[key] = self._counts[key]
            else:
                self._write(key[0], key[1], self._counts[key])
        self._counts = remaining

    def close(self) -> None:
        if self._out is not None:
            self._out.close()


def analyse(metadata_path: str, chromosome: str, region_start: int,
            region_end: int, out_path: str, base_dir: str = ".") -> int:
    """The ``analysis <META> <CHR> <RBEG> <REND> <OUT>`` binary
    (src_analysis/main.cpp:8-46).  Returns the sample count."""
    an = Analyser(out_path, region_start, region_end)
    try:
        if not an.open_from_metadata(metadata_path, chromosome, base_dir):
            raise FileNotFoundError(
                "could not open metadata or one of the VCF files")
        an.start()
        return an.sample_count()
    finally:
        an.close()


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="hashreadmapper_tpu_torch.eval.analysis",
        description="genomic_analysis pipeline: variantcall + analyse")
    sub = p.add_subparsers(dest="cmd", required=True)
    vc = sub.add_parser("variantcall",
                        help="call variants from a SAM file (pos-sorted)")
    vc.add_argument("sam")
    vc.add_argument("ref")
    vc.add_argument("out")
    an = sub.add_parser("analyse", help="per-region variant counts")
    an.add_argument("metadata")
    an.add_argument("chromosome")
    an.add_argument("region_start", type=int)
    an.add_argument("region_end", type=int)
    an.add_argument("out")
    an.add_argument("--base-dir", default=".")
    args = p.parse_args(argv)
    if args.cmd == "variantcall":
        called, total = variantcall(args.sam, args.ref, args.out)
        print(f"Called variants on {called}/{total} reads")
    else:
        n = analyse(args.metadata, args.chromosome, args.region_start,
                    args.region_end, args.out, args.base_dir)
        print(f"Starting statistical analysis on chromosome "
              f"{args.chromosome} from {n} samples(s).\nDone.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
