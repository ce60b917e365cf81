"""Pure-Python oracle of the reference mapper's core semantics (M0).

Deliberately simple and slow; every device kernel is golden-tested against
this module.  Each function cites the reference behavior it re-derives
(file:line in the reference's source tree).  No code is copied from the
reference — the semantics are re-implemented from its observable behavior.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

_BASE_TO_INT = {"A": 0, "C": 1, "G": 2, "T": 3}
_INT_TO_BASE = "ACGT"
_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}

U64_MASK = (1 << 64) - 1


# ---------------------------------------------------------------------------
# read preprocessing (reference: chunkedreadstorageconstruction.hpp:70-95)
# ---------------------------------------------------------------------------

class NReplacer:
    """Round-robin replacement of non-ACGT bases with A,C,G,T.

    The counter persists across reads within one parser thread
    (reference: `int& Ncount` captured by preprocessSequence).
    """

    def __init__(self) -> None:
        self.ncount = 0

    def __call__(self, sequence: str) -> Tuple[str, bool]:
        out = []
        had_undetermined = False
        for c in sequence:
            c = c.upper()
            if c in _BASE_TO_INT:
                out.append(c)
            else:
                had_undetermined = True
                out.append(_INT_TO_BASE[self.ncount])
                self.ncount = (self.ncount + 1) % 4
        return "".join(out), had_undetermined


# ---------------------------------------------------------------------------
# encodings (reference: sequencehelpers.hpp:178-357, 543-578)
# ---------------------------------------------------------------------------

def encode_bases(seq: str) -> List[int]:
    return [_BASE_TO_INT[c] for c in seq]


def decode_bases(bases: Sequence[int]) -> str:
    return "".join(_INT_TO_BASE[b] for b in bases)


def pack_2bit(bases: Sequence[int]) -> List[int]:
    """Left-justified 2-bit packing, 16 bases per uint32 word.

    Base i lives at bits (30 - 2*(i%16)) of word i//16
    (reference: sequencehelpers.hpp:178-275).
    """
    nwords = (len(bases) + 15) // 16
    words = [0] * nwords
    for i, b in enumerate(bases):
        words[i // 16] |= (b & 3) << (30 - 2 * (i % 16))
    return words


def unpack_2bit(words: Sequence[int], length: int) -> List[int]:
    return [(words[i // 16] >> (30 - 2 * (i % 16))) & 3 for i in range(length)]


def revcomp_str(seq: str) -> str:
    return "".join(_COMPLEMENT[c] for c in reversed(seq))


def revcomp_bases(bases: Sequence[int]) -> List[int]:
    return [3 - b for b in reversed(bases)]


def three_n_c_to_t_str(seq: str) -> str:
    """Reference NucleoideConverer (mappinghandler.cu:163-179): C -> T."""
    return seq.replace("C", "T")


# ---------------------------------------------------------------------------
# hashing (reference: hashers.cuh:128-137, gpusequencehasher.cuh:114-169)
# ---------------------------------------------------------------------------

def murmur64(x: int) -> int:
    x &= U64_MASK
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & U64_MASK
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & U64_MASK
    x ^= x >> 33
    return x


def canonical_kmers(bases: Sequence[int], k: int) -> List[int]:
    """min(kmer, revcomp-kmer) for every position, as 2k-bit ints.

    Reference: forEachEncodedCanonicalKmerFromEncodedSequence
    (sequencehelpers.hpp:847-935).
    """
    n = len(bases)
    out = []
    for p in range(n - k + 1):
        fwd = 0
        rc = 0
        for i in range(k):
            fwd = (fwd << 2) | bases[p + i]
            rc |= (3 - bases[p + i]) << (2 * i)
        out.append(min(fwd, rc))
    return out


def minhash_signature(bases: Sequence[int], k: int,
                      hash_ids: Sequence[int]) -> Optional[List[int]]:
    """Per-hash-function minimum of murmur64(kmer + id), masked to 2k bits.

    Returns None when len < k (reference: gpusequencehasher.cuh:162-166).
    """
    if len(bases) < k:
        return None
    kmers = canonical_kmers(bases, k)
    mask = (1 << (2 * k)) - 1
    sig = []
    for f in hash_ids:
        best = min(murmur64((km + f) & U64_MASK) for km in kmers)
        sig.append(best & mask)
    return sig


# ---------------------------------------------------------------------------
# minhash index (reference: fakegpuminhasher.cuh + groupbykey.hpp:60-67)
# ---------------------------------------------------------------------------

class MinhashIndex:
    """One hash table per hash function: signature value -> sorted value list.

    Keys accumulating more than max_values_per_key values lose ALL values
    (reference: groupbykey.hpp:60-67).
    """

    def __init__(self, num_tables: int, max_values_per_key: int) -> None:
        self.tables: List[Dict[int, List[int]]] = [
            {} for _ in range(num_tables)]
        self.max_values_per_key = max_values_per_key

    def insert(self, table: int, key: int, value: int) -> None:
        self.tables[table].setdefault(key, []).append(value)

    def compact(self) -> None:
        for t in self.tables:
            for key in list(t):
                vals = t[key]
                if len(vals) > self.max_values_per_key:
                    t[key] = []
                else:
                    vals.sort()

    def query(self, table: int, key: int) -> List[int]:
        return self.tables[table].get(key, [])


def build_index_from_signatures(signatures: Sequence[Optional[Sequence[int]]],
                                num_tables: int,
                                max_values_per_key: int) -> MinhashIndex:
    idx = MinhashIndex(num_tables, max_values_per_key)
    for item_id, sig in enumerate(signatures):
        if sig is None:
            continue
        for f in range(num_tables):
            idx.insert(f, sig[f], item_id)
    idx.compact()
    return idx


def query_candidates(index: MinhashIndex, sig: Optional[Sequence[int]],
                     min_table_hits: int) -> List[int]:
    """Union of per-table matches, frequency-filtered, ascending ids.

    Reference: findReadIdsOfSimilarSequences (main_gpu.cu:172-278) with
    keepDistinctByFrequency (minhashqueryfilter.cuh:239-278) when
    min_table_hits > 1, else keepDistinct (sorted unique).
    """
    if sig is None:
        return []
    hits: Dict[int, int] = {}
    for f in range(len(index.tables)):
        for v in index.query(f, sig[f]):
            hits[v] = hits.get(v, 0) + 1
    if min_table_hits > 1:
        keep = [v for v, c in hits.items() if c >= min_table_hits]
    else:
        keep = list(hits.keys())
    return sorted(keep)


# ---------------------------------------------------------------------------
# genome windowing (reference: genome.hpp:176-354)
# ---------------------------------------------------------------------------

def num_windows_in_chromosome(chrom_len: int, k: int, window_size: int) -> int:
    stride = window_size - k + 1
    return (chrom_len + stride - 1) // stride


def window_position(window_id: int, k: int, window_size: int) -> int:
    return (window_size - k + 1) * window_id


def window_length(chrom_len: int, pos: int, window_size: int) -> int:
    return min(chrom_len, pos + window_size) - pos


# ---------------------------------------------------------------------------
# extended windows (reference: windowgenerationkernels.cuh:17-48
#                   computeWindowLocation; genome.hpp:210-238)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExtendedWindow:
    left: int       # bases of extension actually applied on the left
    right: int      # bases of extension actually applied on the right
    start: int      # chromosome-global start of the extended window
    length: int     # total extended-window length


def extended_window_location(chrom_len: int, pos: int, window_size: int,
                             extension: int) -> ExtendedWindow:
    """Quirk-compatible extension math.

    Notably the left extension is ALL-or-NOTHING: if extension >= pos the
    window is not extended left at all (reference:
    windowgenerationkernels.cuh:28-31 `if(extension < globalWindowPosition)`).
    """
    length = window_size
    left = 0
    if extension < pos:
        left = extension
        length += extension
    right = 0
    if pos + window_size <= chrom_len:
        if pos + window_size + extension < chrom_len:
            right = extension
        else:
            right = chrom_len - (pos + window_size)
        length += right
    else:
        length -= (pos + window_size) - chrom_len
    return ExtendedWindow(left=left, right=right, start=pos - left,
                          length=length)


# ---------------------------------------------------------------------------
# shifted hamming distance (reference: hammingdistancekernels.cu:73-263)
# ---------------------------------------------------------------------------

FORWARD = 1
REVERSE_COMPLEMENT = 2
NONE = 3


@dataclasses.dataclass
class ShdResult:
    shift: int
    score: int
    orientation: int  # FORWARD / REVERSE_COMPLEMENT / NONE


def shifted_hamming_distance(anchor: Sequence[int], candidate: Sequence[int],
                             max_hamming_percent: float) -> ShdResult:
    """Best full-overlap alignment of candidate (fwd and RC) inside anchor.

    Tie rules re-derived from the kernel's iteration order: orientation 0
    (forward) before 1 (RC), shifts ascending, strictly-smaller score wins
    (hammingdistancekernels.cu:196-256).  Candidate longer than anchor =>
    (shift 0, score len(candidate), None) (":257-262").
    """
    cand_len = len(candidate)
    anchor_len = len(anchor)
    if cand_len > anchor_len:
        return ShdResult(shift=0, score=cand_len, orientation=NONE)
    threshold = int(float(cand_len) * max_hamming_percent)
    best_score = None
    best_shift = -1
    best_orientation = -1
    for orientation, cand in ((0, list(candidate)),
                              (1, [3 - b for b in reversed(candidate)])):
        for shift in range(anchor_len - cand_len + 1):
            score = sum(1 for i in range(cand_len)
                        if anchor[shift + i] != cand[i])
            if best_score is None or score < best_score:
                best_score = score
                best_shift = shift
                best_orientation = orientation
    if best_score > threshold:
        orientation = NONE
    else:
        orientation = FORWARD if best_orientation == 0 else REVERSE_COMPLEMENT
    return ShdResult(shift=best_shift, score=best_score,
                     orientation=orientation)


# ---------------------------------------------------------------------------
# best-hit merge (reference: main_gpu.cu:777-821)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MappedRead:
    orientation: int = NONE
    hamming_distance: int = 0
    shift: int = 0
    chromosome_id: int = 0
    position: int = 0


def merge_result(best: MappedRead, new: MappedRead) -> MappedRead:
    """First good window wins; later windows only on strictly smaller hamming."""
    if new.orientation == NONE:
        return best
    if best.orientation == NONE:
        return new
    if best.hamming_distance > new.hamming_distance:
        return new
    return best
