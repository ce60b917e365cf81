"""Packed read storage with binary save/load.

TPU-native counterpart of the reference's ChunkedReadStorage
(reference: include/chunkedreadstorage.hpp:31, chunkedreadstorageconstruction.hpp:31):
reads are 2-bit packed row-major into one pitched uint32 matrix (the shape the
device consumes directly), with an int32 length vector and an ambiguous-read
bitmask.  Non-ACGT bases are replaced round-robin with A,C,G,T using a counter
that persists across reads (reference: chunkedreadstorageconstruction.hpp:70-95)
and the read is flagged ambiguous.

Save/load replaces --save-preprocessedreads-to / --load-preprocessedreads-from
(reference: main_gpu.cu:939-945) with an .npz artifact.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from . import fastx

_BASE_LUT = np.full(256, 255, dtype=np.uint8)
for _c, _v in zip(b"ACGT", range(4)):
    _BASE_LUT[_c] = _v
for _c, _v in zip(b"acgt", range(4)):
    _BASE_LUT[_c] = _v

BASES_PER_WORD = 16


def preprocess_batch(raw: np.ndarray, ncount: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Vectorized N-replacement over a padded ASCII matrix.

    Args:
      raw: [N, L] uint8 ASCII, zero-padded past each read's length.
    Returns:
      (bases [N, L] uint8 codes with pads=0, ambiguous [N] bool, new ncount).
    The replacement counter advances in read-major, position-minor order,
    exactly like the reference's sequential loop.
    """
    codes = _BASE_LUT[raw]
    invalid = (codes == 255) & (raw != 0)
    ambiguous = invalid.any(axis=1)
    flat = invalid.ravel()
    n_invalid = int(flat.sum())
    if n_invalid:
        repl = ((ncount + np.arange(n_invalid)) % 4).astype(np.uint8)
        out = codes.ravel()
        out[np.flatnonzero(flat)] = repl
        codes = out.reshape(codes.shape)
        ncount = (ncount + n_invalid) % 4
    codes[raw == 0] = 0
    return codes, ambiguous, ncount


def pack_rows(bases: np.ndarray, lengths: np.ndarray,
              pitch_words: int) -> np.ndarray:
    """[N, L] base codes -> [N, pitch_words] uint32, reference 2-bit layout."""
    n, maxlen = bases.shape
    width = pitch_words * BASES_PER_WORD
    if width > maxlen:
        bases = np.pad(bases, ((0, 0), (0, width - maxlen)))
    else:
        bases = bases[:, :width]
    # zero out pads so packed words match the reference's zero-padded tail
    mask = np.arange(width)[None, :] < lengths[:, None]
    bases = np.where(mask, bases, 0).astype(np.uint32)
    b = bases.reshape(n, pitch_words, BASES_PER_WORD)
    shifts = (30 - 2 * np.arange(BASES_PER_WORD, dtype=np.uint32)).astype(np.uint32)
    return (b << shifts[None, None, :]).sum(axis=-1, dtype=np.uint64).astype(np.uint32)


def unpack_rows(packed: np.ndarray, maxlen: int) -> np.ndarray:
    n, nwords = packed.shape
    shifts = (30 - 2 * np.arange(BASES_PER_WORD, dtype=np.uint32)).astype(np.uint32)
    expanded = (packed[:, :, None] >> shifts[None, None, :]) & np.uint32(3)
    return expanded.reshape(n, nwords * BASES_PER_WORD)[:, :maxlen].astype(np.uint8)


class ReadStorage:
    """In-memory packed read store."""

    def __init__(self, packed: np.ndarray, lengths: np.ndarray,
                 ambiguous: np.ndarray, names: Optional[List[str]] = None,
                 qualities=None):
        self.packed = packed            # [N, W] uint32
        self.lengths = lengths          # [N] int32
        self.ambiguous = ambiguous      # [N] bool
        self.names = names
        self.qualities = qualities      # Optional[QualityStore]

    @property
    def num_reads(self) -> int:
        return self.packed.shape[0]

    @property
    def max_length(self) -> int:
        return int(self.lengths.max()) if self.num_reads else 0

    def sequence_length_upper_bound(self) -> int:
        """Pitch-derived bound (reference: getSequenceLengthUpperBound)."""
        return self.packed.shape[1] * BASES_PER_WORD

    def gather_bases(self, read_ids: Sequence[int], maxlen: int) -> np.ndarray:
        return unpack_rows(self.packed[np.asarray(read_ids)], maxlen)

    def slice_rows(self, c0: int, c1: int) -> "ReadStorage":
        """Zero-copy row-range view (the STEP1/STEP2 pipeline maps chunk
        [c0, c1) while the previous chunk fine-aligns)."""
        q = None
        if self.qualities is not None:
            from .quality import QualityStore
            q = QualityStore(self.qualities.bits)
            q._rows = self.qualities._rows[c0:c1]
            q._lengths = self.qualities._lengths[c0:c1]
        return ReadStorage(
            self.packed[c0:c1], self.lengths[c0:c1], self.ambiguous[c0:c1],
            names=self.names[c0:c1] if self.names else None, qualities=q)

    def bases_matrix(self, maxlen: Optional[int] = None) -> np.ndarray:
        return unpack_rows(self.packed, maxlen or self.sequence_length_upper_bound())

    def get_sequence_str(self, read_id: int) -> str:
        bases = unpack_rows(self.packed[read_id:read_id + 1],
                            int(self.lengths[read_id]))[0]
        return "".join("ACGT"[b] for b in bases)

    def get_quality_str(self, read_id: int) -> str:
        """Stored (possibly re-binned) quality, or '' when not stored."""
        if self.qualities is None:
            return ""
        return self.qualities.get(read_id)

    # --- binary artifacts ---

    def save(self, path: str) -> None:
        extra = {}
        if self.qualities is not None:
            qd, qo, ql = self.qualities.to_arrays()
            extra = {"qual_bits": np.int32(self.qualities.bits),
                     "qual_data": qd, "qual_offsets": qo, "qual_lengths": ql}
        np.savez_compressed(
            path, packed=self.packed, lengths=self.lengths,
            ambiguous=self.ambiguous, **extra)

    @classmethod
    def load(cls, path: str) -> "ReadStorage":
        data = np.load(path)
        qualities = None
        if "qual_bits" in data:
            from .quality import QualityStore
            qualities = QualityStore.from_arrays(
                int(data["qual_bits"]), data["qual_data"],
                data["qual_offsets"], data["qual_lengths"])
        return cls(data["packed"], data["lengths"], data["ambiguous"],
                   qualities=qualities)

    @classmethod
    def from_files(cls, paths: Iterable[str], max_read_length: int = 0,
                   keep_names: bool = False, paired: bool = False,
                   use_native: bool = True,
                   quality_bits: int = 0) -> "ReadStorage":
        """Ingest FASTA/FASTQ(.gz) files.

        Single-end: files concatenated in order (reference MultiInputReader,
        readlibraryio.hpp:63-116).  Paired-end with two files: records
        interleaved mate1,mate2,mate1,... (PairedInputReader); one file is
        assumed pre-interleaved (chunkedreadstorageconstruction.hpp:420-462).

        The native zlib parser (native/fastx.cpp) is used when built and
        keep_names is False; it applies the same round-robin N replacement.

        quality_bits > 0 stores FASTQ qualities compressed to 1/2/8 bits
        (reference: include/qualityscorecompression.hpp, enabled by
        useQualityScores + qualityScoreBits; FASTA records store 'I'*len).
        """
        paths = list(paths)
        if paired:
            assert 1 <= len(paths) <= 2, "paired mode takes 1 or 2 files"

        if use_native and not keep_names and not (paired and len(paths) == 2):
            from .. import native
            if native.available():
                return cls._from_files_native(paths, max_read_length,
                                              quality_bits)

        def _iter_records():
            if paired and len(paths) == 2:
                it1 = fastx.iter_fastx(paths[0])
                it2 = fastx.iter_fastx(paths[1])
                while True:
                    r1 = next(it1, None)
                    r2 = next(it2, None)
                    if r1 is None and r2 is None:
                        return
                    assert r1 is not None and r2 is not None, (
                        "paired files have different record counts")
                    yield r1
                    yield r2
            else:
                for path in paths:
                    yield from fastx.iter_fastx(path)

        seqs: List[bytes] = []
        names: List[str] = []
        qualities = None
        if quality_bits:
            from .quality import QualityStore
            qualities = QualityStore(quality_bits)
        maxlen = 0
        for rec in _iter_records():
            s = rec.sequence.encode("ascii")
            seqs.append(s)
            maxlen = max(maxlen, len(s))
            if keep_names:
                names.append(rec.name)
            if qualities is not None:
                qualities.append(rec.quality or "I" * len(s))
        if max_read_length:
            assert maxlen <= max_read_length, (
                f"read of length {maxlen} exceeds max_read_length")
        n = len(seqs)
        raw = np.zeros((n, maxlen), dtype=np.uint8)
        lengths = np.zeros(n, dtype=np.int32)
        for i, s in enumerate(seqs):
            raw[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
            lengths[i] = len(s)
        bases, ambiguous, _ = preprocess_batch(raw, 0)
        pitch = max(1, (maxlen + BASES_PER_WORD - 1) // BASES_PER_WORD)
        packed = pack_rows(bases, lengths, pitch)
        return cls(packed, lengths, ambiguous, names if keep_names else None,
                   qualities=qualities)

    @classmethod
    def _from_files_native(cls, paths: List[str], max_read_length: int,
                           quality_bits: int = 0) -> "ReadStorage":
        from .. import native

        pitch_bases = max(max_read_length, 256)
        qualities = None
        if quality_bits:
            from .quality import QualityStore
            qualities = QualityStore(quality_bits)
        parts = []
        for path in paths:
            for out in native.read_fastx_native(
                    path, pitch=pitch_bases,
                    with_qualities=bool(quality_bits)):
                bases, lengths, amb = out[:3]
                parts.append((bases, lengths, amb))
                if qualities is not None:
                    qualities.append_batch(out[3], lengths)
        if not parts:
            empty = np.zeros((0, 1), dtype=np.uint32)
            return cls(empty, np.zeros(0, np.int32), np.zeros(0, bool),
                       qualities=qualities)
        bases = np.concatenate([p[0] for p in parts])
        lengths = np.concatenate([p[1] for p in parts])
        ambiguous = np.concatenate([p[2] for p in parts])
        maxlen = int(lengths.max()) if len(lengths) else 1
        if max_read_length:
            assert maxlen <= max_read_length
        pitch = max(1, (maxlen + BASES_PER_WORD - 1) // BASES_PER_WORD)
        packed = pack_rows(bases[:, :maxlen].astype(np.uint8), lengths, pitch)
        return cls(packed, lengths, ambiguous, qualities=qualities)
