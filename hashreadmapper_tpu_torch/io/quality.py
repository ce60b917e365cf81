"""Quality-score storage with 1/2/8-bit compression.

Capability counterpart of the reference's QualityCompressorWrapper
(reference: include/qualityscorecompression.hpp, 565 LoC; selected by
--qualityScoreBits {1,2,8}, options.hpp:37):
  * 8 bits: raw phred+33 characters;
  * 2 bits: four quality bins;
  * 1 bit:  two bins (below/at-or-above Q30-style threshold).
Decompression returns representative characters per bin.
"""

from __future__ import annotations

from typing import List

import numpy as np

# bin upper bounds (phred scores) and representatives for 2-bit mode
_BINS_2BIT = np.array([7, 19, 29, 127], dtype=np.int32)
_REPR_2BIT = np.array([6, 15, 25, 37], dtype=np.int32)
_THRESH_1BIT = 30
_REPR_1BIT = np.array([15, 37], dtype=np.int32)


class QualityStore:
    def __init__(self, bits: int = 8):
        assert bits in (1, 2, 8)
        self.bits = bits
        self._rows: List[np.ndarray] = []
        self._lengths: List[int] = []

    def append(self, quality: str) -> None:
        phred = np.frombuffer(quality.encode("latin1"),
                              dtype=np.uint8).astype(np.int32) - 33
        self._lengths.append(len(phred))
        if self.bits == 8:
            self._rows.append(phred.astype(np.uint8))
        elif self.bits == 2:
            codes = np.searchsorted(_BINS_2BIT, phred)
            self._rows.append(self._pack(codes, 2))
        else:
            codes = (phred >= _THRESH_1BIT).astype(np.int32)
            self._rows.append(self._pack(codes, 1))

    def append_batch(self, raw: np.ndarray, lengths: np.ndarray) -> None:
        """Bulk append from a [N, pitch] raw phred+33 uint8 matrix (0-padded
        rows; all-zero rows — FASTA records — store as 'I'*len, the same
        default the python ingest uses for quality-less records)."""
        for i in range(raw.shape[0]):
            ln = int(lengths[i])
            row = raw[i, :ln]
            if ln and row[0] == 0:
                self.append("I" * ln)
            else:
                self.append(row.tobytes().decode("latin1"))

    @staticmethod
    def _pack(codes: np.ndarray, bits: int) -> np.ndarray:
        per = 8 // bits
        n = len(codes)
        padded = np.zeros(((n + per - 1) // per) * per, dtype=np.uint8)
        padded[:n] = codes
        padded = padded.reshape(-1, per)
        shifts = np.arange(per, dtype=np.uint8) * bits
        return (padded << shifts).sum(axis=1).astype(np.uint8)

    @staticmethod
    def _unpack(row: np.ndarray, bits: int, length: int) -> np.ndarray:
        per = 8 // bits
        shifts = np.arange(per, dtype=np.uint8) * bits
        mask = (1 << bits) - 1
        expanded = (row[:, None] >> shifts[None, :]) & mask
        return expanded.reshape(-1)[:length]

    def get(self, index: int) -> str:
        length = self._lengths[index]
        row = self._rows[index]
        if self.bits == 8:
            phred = row.astype(np.int32)
        elif self.bits == 2:
            phred = _REPR_2BIT[self._unpack(row, 2, length)]
        else:
            phred = _REPR_1BIT[self._unpack(row, 1, length)]
        return "".join(chr(int(p) + 33) for p in phred[:length])

    def memory_bytes(self) -> int:
        return sum(r.nbytes for r in self._rows)

    @property
    def num_reads(self) -> int:
        return len(self._rows)

    # --- artifact (de)serialization: concatenated rows + offsets ---

    def to_arrays(self):
        data = (np.concatenate(self._rows) if self._rows
                else np.zeros(0, dtype=np.uint8))
        offsets = np.zeros(len(self._rows) + 1, dtype=np.int64)
        np.cumsum([len(r) for r in self._rows], out=offsets[1:])
        lengths = np.asarray(self._lengths, dtype=np.int32)
        return data, offsets, lengths

    @classmethod
    def from_arrays(cls, bits: int, data: np.ndarray, offsets: np.ndarray,
                    lengths: np.ndarray) -> "QualityStore":
        qs = cls(int(bits))
        qs._rows = [data[offsets[i]:offsets[i + 1]]
                    for i in range(len(offsets) - 1)]
        qs._lengths = [int(x) for x in lengths]
        return qs
