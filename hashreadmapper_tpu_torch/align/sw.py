"""Striped-Smith-Waterman-equivalent local aligner (host, NumPy).

Behavioral re-derivation of the vendored Complete-Striped-Smith-Waterman
library (reference: src/ssw.c, src/ssw_cpp.cpp) with the reference's default
parameters (match 2, mismatch -2, gapO 3, gapE 1; ssw_cpp.cpp:405-414) and
its exact result semantics:

  * best score = global max of the local affine-gap DP; the reported end
    reference column is the FIRST column attaining the global max (strict
    improvement while scanning columns, ssw.c:327-334); the end read position
    is the SMALLEST read index with that score in that column (ssw.c:344-350).
  * second-best score = max column-maximum outside
    [end_ref - maskLen, end_ref + maskLen) (ssw.c:367-381).
  * begin positions from a reverse pass over the reversed prefixes,
    terminating at the first column (scanning from the end backwards) whose
    column max equals the best score (ssw.c:341 terminate / 877-886).
  * CIGAR from a banded DP over the [begin, end] subregion with band
    doubling, the reference's direction tie rules, and its M -> =/X rewrite
    plus soft clips (ssw.c banded_sw:600-780, ssw_cpp.cpp:54-211).

The word (16-bit) arithmetic path is modeled (the reference uses
score_size=2, mappinghandler's aligner never saturates at BS read scales).
This module is the scoring oracle; the batched device score kernel
(ops/swdev.py) and the native C++ fast path are validated against it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# Base translation table (reference: ssw_cpp.cpp:12-25 kBaseTranslation,
# including its 'U'->0 quirk); every other char -> 4 (N).
TRANSLATE = np.full(256, 4, dtype=np.int8)
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 0)):
    TRANSLATE[ord(_ch)] = _v
    TRANSLATE[ord(_ch.lower())] = _v


def default_score_matrix(match: int = 2, mismatch: int = 2) -> np.ndarray:
    """5x5 matrix; N scores -mismatch against everything incl. itself
    (reference: ssw_cpp.cpp:27-52)."""
    m = np.full((5, 5), -mismatch, dtype=np.int32)
    for i in range(4):
        m[i, i] = match
    return m


SCORE_MATRIX = default_score_matrix()
GAP_OPEN = 3
GAP_EXTEND = 1


@dataclasses.dataclass(slots=True)
class Alignment:
    """Mirrors StripedSmithWaterman::Alignment after CalculateNumberMismatch."""
    sw_score: int = 0
    sw_score_next_best: int = 0
    ref_begin: int = 0
    ref_end: int = 0
    query_begin: int = 0
    query_end: int = 0
    ref_end_next_best: int = 0
    mismatches: int = 0
    cigar_string: str = ""
    flag: int = 0  # s_align flag: 0 ok, 1 banded failed, 2 begin missing


def translate(seq: str) -> np.ndarray:
    return TRANSLATE[np.frombuffer(seq.encode("latin1"), dtype=np.uint8)]


def _striped_pass(read: np.ndarray, ref: np.ndarray, ref_dir: int,
                  score_matrix: np.ndarray, gap_open: int,
                  gap_extend: int, terminate: int, byte_mode: bool):
    """Exact simulation of sw_sse2_byte / sw_sse2_word (ssw.c:197-588).

    The striped layout is observable: the E update uses H values whose lazy-F
    correction hasn't fully propagated, so maxColumn[] (and hence the
    second-best score) depends on segLen and lane count.  We simulate the
    lanes faithfully instead of computing the textbook DP.

    byte_mode: 16 uint8 lanes with bias arithmetic and saturation at 255
    (sw_sse2_byte); otherwise 8 uint16 lanes (sw_sse2_word).

    Returns (max, end_ref, end_read, max_column[refLen], overflowed).
    """
    read_len, ref_len = len(read), len(ref)
    lanes = 16 if byte_mode else 8
    seg_len = (read_len + lanes - 1) // lanes
    bias = int(-score_matrix.min()) if byte_mode else 0

    # profile[nt, j, lane] (qP_byte ssw.c:163-189 / qP_word ssw.c:404-425)
    nsyms = score_matrix.shape[0]
    prof = np.zeros((nsyms, seg_len, lanes), dtype=np.int32)
    for nt in range(nsyms):
        for j in range(seg_len):
            for k in range(lanes):
                pos = j + k * seg_len
                if byte_mode:
                    prof[nt, j, k] = (bias if pos >= read_len
                                      else score_matrix[nt, read[pos]] + bias)
                elif pos < read_len:
                    prof[nt, j, k] = score_matrix[nt, read[pos]]

    h_store = np.zeros((seg_len, lanes), dtype=np.int32)
    h_load = np.zeros((seg_len, lanes), dtype=np.int32)
    e_arr = np.zeros((seg_len, lanes), dtype=np.int32)
    h_max_col_store = np.zeros((seg_len, lanes), dtype=np.int32)
    max_column = np.zeros(ref_len, dtype=np.int32)

    best = 0
    end_ref = -1 if byte_mode else 0
    end_read = read_len - 1
    overflowed = False

    cols = range(ref_len - 1, -1, -1) if ref_dir == 1 else range(ref_len)
    for i in cols:
        vf = np.zeros(lanes, dtype=np.int32)
        # vH = pvHStore[segLen-1] shifted left by one lane
        vh = np.zeros(lanes, dtype=np.int32)
        vh[1:] = h_store[seg_len - 1, :-1]
        h_load, h_store = h_store, h_load
        vmax_col = np.zeros(lanes, dtype=np.int32)
        p = prof[ref[i]]
        for j in range(seg_len):
            if byte_mode:
                vh = np.minimum(vh + p[j], 255)          # adds_epu8
                vh = np.maximum(vh - bias, 0)            # subs_epu8
            else:
                vh = vh + p[j]                           # adds_epi16
            e = e_arr[j]
            np.maximum(vh, e, out=vh)
            np.maximum(vh, vf, out=vh)
            np.maximum(vmax_col, vh, out=vmax_col)
            h_store[j] = vh
            vhg = np.maximum(vh - gap_open, 0)           # subs_epu
            e = np.maximum(np.maximum(e - gap_extend, 0), vhg)
            e_arr[j] = e
            vf = np.maximum(np.maximum(vf - gap_extend, 0), vhg)
            vh = h_load[j].copy()
        # lazy-F loop (ssw.c:301-316 / 508-521)
        done = False
        for _k in range(lanes):
            if done:
                break
            vf = np.concatenate(([0], vf[:-1]))          # slli_si128 one lane
            for j in range(seg_len):
                vh = np.maximum(h_store[j], vf)
                np.maximum(vmax_col, vh, out=vmax_col)
                h_store[j] = vh
                vh = np.maximum(vh - gap_open, 0)
                vf = np.maximum(vf - gap_extend, 0)
                if not (vf > vh).any():
                    done = True
                    break
        colmax = int(vmax_col.max())
        if colmax > best:
            best = colmax
            if byte_mode and best + bias >= 255:         # overflow (ssw.c:327)
                overflowed = True
                max_column[i] = colmax
                break
            end_ref = i
            h_max_col_store[:] = h_store
        max_column[i] = colmax
        if colmax == terminate:
            break

    # trace end_read in striped order (ssw.c:344-350 / 546-556)
    flat = h_max_col_store.reshape(-1)                   # memory order (j, k)
    for idx in range(seg_len * lanes):
        if flat[idx] == best:
            pos = idx // lanes + (idx % lanes) * seg_len
            if pos < end_read:
                end_read = pos
    if byte_mode and best + bias >= 255:
        best = 255
    return best, end_ref, end_read, max_column, overflowed


def _dp_matrix(read: np.ndarray, ref: np.ndarray,
               score_matrix: np.ndarray, gap_open: int, gap_extend: int
               ) -> np.ndarray:
    """Full local affine H matrix [readLen, refLen] (word semantics)."""
    read_len, ref_len = len(read), len(ref)
    h = np.zeros((read_len, ref_len), dtype=np.int32)
    h_prev = np.zeros(read_len, dtype=np.int32)
    e_prev = np.zeros(read_len, dtype=np.int32)
    karr = gap_extend * np.arange(read_len, dtype=np.int32)
    for j in range(ref_len):
        scores = score_matrix[ref[j], read]                      # [readLen]
        e = np.maximum(h_prev - gap_open, e_prev - gap_extend)
        np.maximum(e, 0, out=e)
        diag = np.empty(read_len, dtype=np.int32)
        diag[0] = 0
        diag[1:] = h_prev[:-1]
        h_nof = np.maximum(diag + scores, e)
        np.maximum(h_nof, 0, out=h_nof)
        # lazy-F fold: F[i] = max_{k<i}(H[k] - gapO - (i-1-k)*gapE); since
        # gapO >= gapE, F sources never chain through F-derived cells.
        g = h_nof + karr
        run = np.maximum.accumulate(g)
        f = np.empty(read_len, dtype=np.int32)
        f[0] = 0
        f[1:] = run[:-1] - gap_open - karr[1:] + gap_extend
        np.maximum(f, 0, out=f)
        h_col = np.maximum(h_nof, f)
        h[:, j] = h_col
        h_prev, e_prev = h_col, e
    return h


def _banded_cigar(read: np.ndarray, ref: np.ndarray, score: int,
                  score_matrix: np.ndarray, gap_open: int, gap_extend: int
                  ) -> Optional[List[Tuple[int, str]]]:
    """banded_sw re-derivation (ssw.c:595-790): returns [(len, op)] in
    M/I/D ops over the exact subregion, or None on failure."""
    ref_len, read_len = len(ref), len(read)
    band_width = abs(ref_len - read_len) + 1
    max_len = max(ref_len, read_len)

    best = 0
    while True:
        # DP over the band; out-of-band neighbors read as 0.
        h = np.zeros((read_len, ref_len), dtype=np.int32)
        e = np.zeros((read_len, ref_len), dtype=np.int32)
        d_e = np.zeros((read_len, ref_len), dtype=np.int8)
        d_f = np.zeros((read_len, ref_len), dtype=np.int8)
        d_h = np.zeros((read_len, ref_len), dtype=np.int8)
        for i in range(read_len):
            beg = max(0, i - band_width)
            end = min(ref_len - 1, i + band_width)
            f = 0
            for j in range(beg, end + 1):
                in_up = i > 0 and abs(j - (i - 1)) <= band_width
                h_up = h[i - 1, j] if in_up else 0
                e_up = e[i - 1, j] if in_up else 0
                if i == 0:
                    t1, t2 = -gap_open, -gap_extend
                else:
                    t1, t2 = h_up - gap_open, e_up - gap_extend
                e_cur = t1 if t1 > t2 else t2
                d_e[i, j] = 3 if t1 > t2 else 2
                e[i, j] = e_cur

                in_left = j > beg  # h of (i, j-1) inside band
                h_left = h[i, j - 1] if in_left else 0
                t1 = h_left - gap_open
                t2 = f - gap_extend
                f = t1 if t1 > t2 else t2
                d_f[i, j] = 5 if t1 > t2 else 4

                e1 = e_cur if e_cur > 0 else 0
                f1 = f if f > 0 else 0
                t1 = e1 if e1 > f1 else f1
                in_diag = (i > 0 and j > beg
                           and abs((j - 1) - (i - 1)) <= band_width)
                h_diag = h[i - 1, j - 1] if in_diag else 0
                t2 = h_diag + score_matrix[ref[j], read[i]]
                h_cur = t1 if t1 > t2 else t2
                h[i, j] = h_cur
                if h_cur > best:
                    best = h_cur
                if t1 <= t2:
                    d_h[i, j] = 1
                else:
                    d_h[i, j] = d_e[i, j] if e1 > f1 else d_f[i, j]
        band_width *= 2
        if not (best < score and band_width <= max_len):
            break
    band_width //= 2  # kept for fidelity; directions already absolute here

    # traceback (ssw.c:674-741)
    i, j = read_len - 1, ref_len - 1
    ops: List[str] = []
    layer = 2  # 0=e, 1=f, 2=h
    while i >= 0 and j > 0:
        d = (d_e[i, j], d_f[i, j], d_h[i, j])[layer]
        if d == 1:
            i -= 1; j -= 1; layer = 2; op = "M"
        elif d == 2:
            i -= 1; layer = 0; op = "I"
        elif d == 3:
            i -= 1; layer = 2; op = "I"
        elif d == 4:
            j -= 1; layer = 1; op = "D"
        elif d == 5:
            j -= 1; layer = 2; op = "D"
        else:
            return None
        ops.append(op)

    # final entry handling (ssw.c:742-760): run-length encode reversed ops
    entries: List[Tuple[int, str]] = []
    if not ops:
        entries.append((1, "M"))
    else:
        cnt = 1
        for a, b in zip(ops, ops[1:]):
            if a == b:
                cnt += 1
            else:
                entries.append((cnt, a))
                cnt = 1
        last_op = ops[-1]
        if last_op == "M":
            entries.append((cnt + 1, "M"))
        else:
            entries.append((cnt, last_op))
            entries.append((1, "M"))
    entries.reverse()
    return entries


def _rewrite_m_to_eq_x(entries: List[Tuple[int, str]], read: np.ndarray,
                       ref: np.ndarray, query_begin: int, query_end: int,
                       ref_begin: int, query_len: int
                       ) -> Tuple[str, int]:
    """CalculateNumberMismatch (ssw_cpp.cpp:126-211): expand M into =/X runs,
    add soft clips, count mismatches (indels count toward mismatches)."""
    out: List[str] = []
    if query_begin > 0:
        out.append(f"{query_begin}S")
    mismatches = 0
    ri, qi = ref_begin, query_begin
    run_op = ""
    run_len = 0

    def flush():
        nonlocal run_len, run_op
        if run_len:
            out.append(f"{run_len}{run_op}")
        run_len, run_op = 0, ""

    for length, op in entries:
        if op == "M":
            for _ in range(length):
                cur = "=" if ref[ri] == read[qi] else "X"
                if cur == "X":
                    mismatches += 1
                if cur != run_op:
                    flush()
                    run_op = cur
                run_len += 1
                ri += 1
                qi += 1
        elif op == "I":
            mismatches += length
            flush()
            out.append(f"{length}I")
            qi += length
        elif op == "D":
            mismatches += length
            flush()
            out.append(f"{length}D")
            ri += length
    flush()
    end_clip = query_len - query_end - 1
    if end_clip > 0:
        out.append(f"{end_clip}S")
    return "".join(out), mismatches


def ssw_align(query: str, ref: str, mask_len: int,
              score_matrix: np.ndarray = SCORE_MATRIX,
              gap_open: int = GAP_OPEN, gap_extend: int = GAP_EXTEND,
              compute_cigar: bool = True) -> Alignment:
    """Full CSSW-equivalent alignment of query against ref."""
    read = translate(query)
    ref_t = translate(ref)
    read_len, ref_len = len(read), len(ref_t)
    al = Alignment(ref_begin=-1, query_begin=-1)  # s_align init (ssw.c:834-835)
    if read_len == 0 or ref_len == 0:
        return al

    # byte pass first; word rerun on saturation (ssw_align, ssw.c:846-855)
    byte_mode = True
    score1, end_ref, end_read, max_column, _ovf = _striped_pass(
        read, ref_t, 0, score_matrix, gap_open, gap_extend, terminate=255,
        byte_mode=True)
    if score1 == 255:
        byte_mode = False
        score1, end_ref, end_read, max_column, _ = _striped_pass(
            read, ref_t, 0, score_matrix, gap_open, gap_extend, terminate=-1,
            byte_mode=False)
    al.sw_score = score1
    al.ref_end = end_ref
    al.query_end = end_read

    # second best outside the masked window (byte ssw.c:367-381: the second
    # loop starts one PAST the edge; word ssw.c:570-583: at the edge)
    score2 = 0
    ref_end2 = 0
    lo = max(0, end_ref - mask_len)
    hi = min(ref_len, end_ref + mask_len)
    for i in range(0, lo):
        if max_column[i] > score2:
            score2 = int(max_column[i]); ref_end2 = i
    for i in range(hi + 1 if byte_mode else hi, ref_len):
        if max_column[i] > score2:
            score2 = int(max_column[i]); ref_end2 = i
    if mask_len >= 15:
        al.sw_score_next_best = score2
        al.ref_end_next_best = ref_end2
    else:
        al.sw_score_next_best = 0
        al.ref_end_next_best = -1

    if score1 == 0 or end_ref < 0:
        # degenerate: the reference would read out of bounds here; report the
        # score-only result (cannot happen for real window alignments)
        return al

    # reverse pass for begin positions (ssw.c:877-886): reversed read prefix,
    # ref columns iterated from end_ref downward, terminate at score1
    read_prefix = read[:end_read + 1][::-1].copy()
    ref_prefix = ref_t[:end_ref + 1].copy()
    rev_score, rev_ref, rev_read, _mc, _ = _striped_pass(
        read_prefix, ref_prefix, 1, score_matrix, gap_open, gap_extend,
        terminate=score1, byte_mode=byte_mode)
    al.ref_begin = rev_ref
    al.query_begin = end_read - rev_read
    if score1 > rev_score:
        # "banded_sw result will miss a small part" (ssw.c:890-893)
        al.flag = 2

    if not compute_cigar:
        return al

    sub_read = read[al.query_begin:end_read + 1]
    sub_ref = ref_t[al.ref_begin:end_ref + 1]
    entries = _banded_cigar(sub_read, sub_ref, score1, score_matrix,
                            gap_open, gap_extend)
    if entries is None:
        al.flag = 1
        return al
    al.cigar_string, al.mismatches = _rewrite_m_to_eq_x(
        entries, read, ref_t, al.query_begin, al.query_end, al.ref_begin,
        read_len)
    return al


def get_score(a: str, b: str, score_matrix: np.ndarray = SCORE_MATRIX) -> int:
    """Aligner::getScore (ssw_cpp.cpp:415-443): default char -> A."""
    lut = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}
    return int(score_matrix[lut.get(a, 0), lut.get(b, 0)])


def mapq_cssw(sw_score: int, sw_score_next_best: int) -> int:
    """MAPQ exactly as the reference computes it (mappinghandler.cu:184-193).

    The reference assigns the double to a uint32_t FIRST (truncation), then
    adds 4.99 and truncates again — so the result is trunc(-4.343*ln(1-f))+4.
    NaN (0/0, unmapped) and +inf (next_best==0 -> ln(0)) both cast to 0 on
    x86-64 (cvttsd2si indefinite -> low 32 bits 0), yielding MAPQ 4.
    """
    import math
    if sw_score == 0:
        m1 = 0   # NaN cast
    else:
        frac = abs(sw_score - sw_score_next_best) / sw_score
        if frac >= 1.0:
            m1 = 0   # -4.343*log(0) = +inf cast
        else:
            m1 = int(-4.343 * math.log(1 - frac))
    mapq = m1 + 4    # trunc(m1 + 4.99)
    return min(mapq, 254)
