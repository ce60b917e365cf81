"""FASTA / FASTQ parsing (plain or gzip).

Python counterpart of the reference's kseqpp-based reader
(reference: include/readlibraryio.hpp:288 forEachReadInFile, include/kseqpp/).
A native C++ parser (native/fastx.cpp) is used automatically for bulk ingest
when the shared library is built; this module is the portable fallback and
the format authority for tests.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
from typing import Iterator, List


@dataclasses.dataclass
class SequenceRecord:
    name: str
    comment: str
    sequence: str
    quality: str = ""


def _open_maybe_gzip(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def iter_fastx(path: str) -> Iterator[SequenceRecord]:
    """Yields records from FASTA or FASTQ, auto-detected per record marker."""
    fh = _open_maybe_gzip(path)
    try:
        line = fh.readline()
        while line:
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                line = fh.readline()
                continue
            if line.startswith(">"):
                header = line[1:]
                parts = header.split(None, 1)
                name = parts[0] if parts else ""
                comment = parts[1] if len(parts) > 1 else ""
                seq_parts: List[str] = []
                line = fh.readline()
                while line and not line.startswith((">", "@")):
                    seq_parts.append(line.strip())
                    line = fh.readline()
                yield SequenceRecord(name, comment, "".join(seq_parts))
            elif line.startswith("@"):
                header = line[1:]
                parts = header.split(None, 1)
                name = parts[0] if parts else ""
                comment = parts[1] if len(parts) > 1 else ""
                seq = fh.readline().strip()
                plus = fh.readline()
                if not plus.startswith("+"):
                    raise ValueError(f"malformed FASTQ near {name!r} in {path}")
                qual = fh.readline().strip()
                yield SequenceRecord(name, comment, seq, qual)
                line = fh.readline()
            else:
                raise ValueError(f"unrecognized record start {line[:20]!r}")
    finally:
        fh.close()


def write_fasta(path: str, records) -> None:
    with open(path, "w") as fh:
        for rec in records:
            header = rec.name if not rec.comment else f"{rec.name} {rec.comment}"
            fh.write(f">{header}\n{rec.sequence}\n")


def write_fastq(path: str, records) -> None:
    with open(path, "w") as fh:
        for rec in records:
            qual = rec.quality or ("I" * len(rec.sequence))
            fh.write(f"@{rec.name}\n{rec.sequence}\n+\n{qual}\n")
