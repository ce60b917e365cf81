"""Genome loading, reverse-complement genome, and window math.

Re-derivation of the reference Genome struct (reference: include/genome.hpp:84-450):
  * FASTA chromosomes, uppercased, in file order (names + data).
  * A full reverse-complement copy of the genome (RC constructor,
    genome.hpp:152-163) used by STEP-2 rescoring.
  * Fixed windows of `window_size` bases with stride window_size - k + 1
    (k-1 overlap, genome.hpp:176-181); the last window of a chromosome is
    truncated.

Two views per chromosome are kept:
  * `seq`  — the uppercased string (N preserved) for fine alignment / VCF.
  * `bases`— uint8 codes 0..3 where every non-ACGT char encodes as A(0),
    matching the GPU encode kernel's default case
    (reference: src/gpu/sequenceconversionkernels.cu:473-492).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

from . import fastx

_ENCODE_LUT = np.zeros(256, dtype=np.uint8)  # every unknown char -> A(0)
for _c, _v in zip(b"ACGT", range(4)):
    _ENCODE_LUT[_c] = _v

_COMPLEMENT_LUT = np.frombuffer(
    bytes(range(256)), dtype=np.uint8).copy()
for _a, _b in [(ord("A"), ord("T")), (ord("C"), ord("G")),
               (ord("G"), ord("C")), (ord("T"), ord("A"))]:
    _COMPLEMENT_LUT[_a] = _b


def encode_ascii(seq_bytes: np.ndarray) -> np.ndarray:
    """ASCII uint8 -> base codes 0..3 (non-ACGT -> 0)."""
    return _ENCODE_LUT[seq_bytes]


def revcomp_ascii(seq_bytes: np.ndarray) -> np.ndarray:
    return _COMPLEMENT_LUT[seq_bytes][::-1].copy()


@dataclasses.dataclass
class FaiEntry:
    """One samtools-style .fai line (reference FastaIndex::Entry,
    include/genome.hpp:18-23: lineLength, lineLengthWithNewline, length,
    byteOffset)."""
    name: str
    length: int        # bases in the sequence
    byte_offset: int   # file offset of the first sequence byte
    line_bases: int    # bases per line
    line_bytes: int    # bytes per line incl. newline


class FastaIndex:
    """samtools .fai index: sequence lengths + byte offsets.

    Reference: include/genome.hpp:16-81 (FastaIndex).  Beyond the
    reference's parser this can also BUILD the index from a FASTA and
    seek-load single chromosomes (region planning wants lengths without
    reading sequence data; plain files only — .gz is not seekable)."""

    def __init__(self, entries: List[FaiEntry]):
        self.entries = entries
        self._by_name = {e.name: i for i, e in enumerate(entries)}

    @classmethod
    def from_file(cls, path: str) -> "FastaIndex":
        entries = []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                tok = line.rstrip("\n").split("\t")
                assert len(tok) == 5, f"malformed .fai line: {line!r}"
                entries.append(FaiEntry(
                    name=tok[0], length=int(tok[1]), byte_offset=int(tok[2]),
                    line_bases=int(tok[3]), line_bytes=int(tok[4])))
        return cls(entries)

    @classmethod
    def build(cls, fasta_path: str) -> "FastaIndex":
        """Scan a plain (non-gz) FASTA once, recording lengths/offsets;
        .fai convention keys entries by the first header word."""
        entries = []
        name = None
        length = 0
        offset = 0
        line_bases = 0
        line_bytes = 0
        with open(fasta_path, "rb") as f:
            pos = 0
            for raw in f:
                n = len(raw)
                line = raw.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if name is not None:
                        entries.append(FaiEntry(name, length, offset,
                                                line_bases, line_bytes))
                    name = line[1:].split()[0].decode()
                    length = 0
                    offset = pos + n
                    line_bases = 0
                    line_bytes = 0
                elif line:
                    if line_bases == 0:
                        line_bases, line_bytes = len(line), n
                    length += len(line)
                pos += n
        if name is not None:
            entries.append(FaiEntry(name, length, offset,
                                    line_bases, line_bytes))
        return cls(entries)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for e in self.entries:
                f.write(f"{e.name}\t{e.length}\t{e.byte_offset}"
                        f"\t{e.line_bases}\t{e.line_bytes}\n")

    # reference accessors (genome.hpp:61-76)
    def get_length(self, name_or_index) -> int:
        if isinstance(name_or_index, str):
            name_or_index = self.get_name_index(name_or_index)
        return self.entries[name_or_index].length

    def get_name_index(self, name: str) -> int:
        return self._by_name[name]

    @property
    def names(self) -> List[str]:
        return [e.name for e in self.entries]

    def load_sequence(self, fasta_path: str, name_or_index) -> str:
        """Seek-load one chromosome's sequence via its byte offset."""
        if isinstance(name_or_index, str):
            name_or_index = self.get_name_index(name_or_index)
        e = self.entries[name_or_index]
        full_lines = e.length // e.line_bases if e.line_bases else 0
        tail = e.length - full_lines * e.line_bases
        nbytes = full_lines * e.line_bytes + (
            tail + (e.line_bytes - e.line_bases) if tail else 0)
        with open(fasta_path, "rb") as f:
            f.seek(e.byte_offset)
            raw = f.read(nbytes)
        return b"".join(raw.split()).decode("ascii")


@dataclasses.dataclass
class WindowBatch:
    """One batch of same-chromosome windows (reference BatchOfWindows)."""
    chromosome_id: int
    window_ids: np.ndarray        # [B] int32, window index within chromosome
    global_window_ids: np.ndarray  # [B] int64, ordinal across the genome
    positions: np.ndarray         # [B] int32, window start in chromosome
    lengths: np.ndarray           # [B] int32


class Genome:
    def __init__(self, names: List[str], sequences: List[str]):
        self.names = names
        self.seqs_ascii: List[np.ndarray] = []
        self.bases: List[np.ndarray] = []
        for s in sequences:
            arr = np.frombuffer(s.upper().encode("ascii"), dtype=np.uint8).copy()
            self.seqs_ascii.append(arr)
            self.bases.append(encode_ascii(arr))

    @classmethod
    def from_fasta(cls, path: str) -> "Genome":
        names, seqs = [], []
        for rec in fastx.iter_fastx(path):
            # reference keeps the full header line as the name (genome.hpp:141)
            header = rec.name if not rec.comment else f"{rec.name} {rec.comment}"
            names.append(header)
            seqs.append(rec.sequence)
        g = cls(names, seqs)
        # a sibling samtools index cross-checks the parse (FastaIndex,
        # genome.hpp:16-81; keyed by the first header word)
        import os
        fai = path + ".fai"
        if os.path.exists(fai) and not path.endswith(".gz"):
            idx = FastaIndex.from_file(fai)
            assert len(idx.entries) == len(names), (
                f"{fai}: {len(idx.entries)} entries vs "
                f"{len(names)} FASTA sequences")
            for name, seq, e in zip(names, seqs, idx.entries):
                assert name.split()[0] == e.name and len(seq) == e.length, (
                    f"{fai}: entry {e.name}/{e.length} does not match "
                    f"FASTA sequence {name.split()[0]}/{len(seq)}")
        return g

    @property
    def num_chromosomes(self) -> int:
        return len(self.names)

    def chromosome_length(self, chrom_id: int) -> int:
        return len(self.seqs_ascii[chrom_id])

    def sequence_str(self, chrom_id: int) -> str:
        """The decoded chromosome, decoded once: host STEP 2
        (mapping._window_views) asks for it per read, and decoding it each
        time made that path linear in the chromosome length per read."""
        cache = self.__dict__.setdefault("_strings", {})
        s = cache.get(chrom_id)
        if s is None:
            s = cache[chrom_id] = \
                self.seqs_ascii[chrom_id].tobytes().decode("ascii")
        return s

    # --- reverse-complement genome (STEP-2 companion) ---

    def reverse_complement(self) -> "Genome":
        rc = Genome.__new__(Genome)
        rc.names = list(self.names)
        rc.seqs_ascii = [revcomp_ascii(a) for a in self.seqs_ascii]
        rc.bases = [encode_ascii(a) for a in rc.seqs_ascii]
        return rc

    # --- window math (reference: genome.hpp:176-354) ---

    def window_stride(self, k: int, window_size: int) -> int:
        return window_size - k + 1

    def num_windows_in_chromosome(self, chrom_id: int, k: int,
                                  window_size: int) -> int:
        stride = self.window_stride(k, window_size)
        length = self.chromosome_length(chrom_id)
        return (length + stride - 1) // stride

    def total_num_windows(self, k: int, window_size: int) -> int:
        return sum(self.num_windows_in_chromosome(c, k, window_size)
                   for c in range(self.num_chromosomes))

    def iter_window_batches(self, k: int, window_size: int,
                            batchsize: int) -> Iterator[WindowBatch]:
        """Window batches in genome order; batches never span chromosomes
        (reference: forEachBatchOfWindows, genome.hpp:304-354)."""
        stride = self.window_stride(k, window_size)
        global_base = 0
        for chrom_id in range(self.num_chromosomes):
            length = self.chromosome_length(chrom_id)
            nwin = self.num_windows_in_chromosome(chrom_id, k, window_size)
            start = 0
            while start < nwin:
                stop = min(start + batchsize, nwin)
                wids = np.arange(start, stop, dtype=np.int32)
                positions = wids * stride
                lengths = np.minimum(length - positions.astype(np.int64),
                                     window_size).astype(np.int32)
                yield WindowBatch(
                    chromosome_id=chrom_id,
                    window_ids=wids,
                    global_window_ids=global_base + wids.astype(np.int64),
                    positions=positions.astype(np.int32),
                    lengths=lengths,
                )
                start = stop
            global_base += nwin

    def window_bases(self, chrom_id: int, pos: int, length: int) -> np.ndarray:
        return self.bases[chrom_id][pos:pos + length]

    def window_str(self, chrom_id: int, pos: int, length: int) -> str:
        return self.seqs_ascii[chrom_id][pos:pos + length].tobytes().decode()

    def get_section(self, chrom_id: int, begin: int, end: int
                    ) -> Tuple[int, int, np.ndarray]:
        """Clamped genome section (reference: genome.hpp:243-255)."""
        size = self.chromosome_length(chrom_id)
        begin = max(begin, 0)
        end = min(end, size)
        return begin, end, self.bases[chrom_id][begin:end]
