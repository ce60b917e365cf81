"""Striped-Smith-Waterman-equivalent local aligner (host, NumPy): the
benchmark's plain reference of STEP 2's alignments.

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
A frozen copy of the port's host scoring oracle (the plain version its
device score passes, banded traceback and native finish are held to);
it imports nothing but NumPy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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


def _striped_passes(reads: Sequence[np.ndarray], refs: Sequence[np.ndarray],
                    ref_dir: int, score_matrix: np.ndarray, gap_open: int,
                    gap_extend: int, terminate: Sequence[int],
                    byte_mode: bool) -> List[tuple]:
    """Exact simulation of sw_sse2_byte / sw_sse2_word (ssw.c:197-588) for
    each (read, ref) pair, the pairs of one segment length at once (every
    array below has the pair as its first axis).

    The striped layout is observable: the E update uses H values whose lazy-F
    correction hasn't fully propagated, so maxColumn[] (and hence the
    second-best score) depends on segLen and lane count.  We simulate the
    lanes faithfully instead of computing the textbook DP.  A pair whose
    columns have run out, or that has terminated, computes on but changes
    none of its results; one that has left the lazy-F loop changes nothing.

    byte_mode: 16 uint8 lanes with bias arithmetic and saturation at 255
    (sw_sse2_byte); otherwise 8 uint16 lanes (sw_sse2_word).

    Returns (max, end_ref, end_read, max_column[refLen], overflowed) of
    each pair.
    """
    lanes = 16 if byte_mode else 8
    groups: Dict[int, List[int]] = {}
    for b, read in enumerate(reads):
        groups.setdefault((len(read) + lanes - 1) // lanes, []).append(b)
    out: List[tuple] = [None] * len(reads)
    for seg_len, members in groups.items():
        got = _striped_group([reads[b] for b in members],
                             [refs[b] for b in members], seg_len, lanes,
                             ref_dir, score_matrix, gap_open, gap_extend,
                             np.array([terminate[b] for b in members]),
                             byte_mode)
        for b, r in zip(members, got):
            out[b] = r
    return out


def _striped_group(reads, refs, seg_len, lanes, ref_dir, score_matrix,
                   gap_open, gap_extend, terminate, byte_mode):
    n = len(reads)
    rows = np.arange(n)
    read_len = np.array([len(r) for r in reads])
    ref_len = np.array([len(r) for r in refs])
    bias = int(-score_matrix.min()) if byte_mode else 0

    # profile[pair, nt, j, lane] (qP_byte ssw.c:163-189 / qP_word ssw.c:404-425)
    pos = np.arange(seg_len)[:, None] + np.arange(lanes)[None, :] * seg_len
    padded = np.zeros((n, seg_len * lanes), dtype=np.int64)
    for b, r in enumerate(reads):
        padded[b, :len(r)] = r
    inside = pos[None] < read_len[:, None, None]
    nsyms = score_matrix.shape[0]
    prof = np.where(inside[:, None], score_matrix[:, padded[:, pos]]
                    .transpose(1, 0, 2, 3) + bias, bias if byte_mode else 0)
    ref_codes = np.zeros((n, max(1, int(ref_len.max()))), dtype=np.int64)
    for b, r in enumerate(refs):
        ref_codes[b, :len(r)] = r

    h_store = np.zeros((n, seg_len, lanes), dtype=np.int32)
    h_load = np.zeros((n, seg_len, lanes), dtype=np.int32)
    e_arr = np.zeros((n, seg_len, lanes), dtype=np.int32)
    h_max_col_store = np.zeros((n, seg_len, lanes), dtype=np.int32)
    max_column = np.zeros(ref_codes.shape, dtype=np.int32)

    best = np.zeros(n, dtype=np.int32)
    end_ref = np.full(n, -1 if byte_mode else 0)
    finished = np.zeros(n, dtype=bool)
    overflowed = np.zeros(n, dtype=bool)
    zero = np.zeros((n, 1), dtype=np.int32)

    for t in range(ref_codes.shape[1]):
        active = (t < ref_len) & ~finished
        if not active.any():
            break
        col = np.maximum(ref_len - 1 - t, 0) if ref_dir == 1 else \
            np.full(n, t)
        vf = np.zeros((n, lanes), dtype=np.int32)
        # vH = pvHStore[segLen-1] shifted left by one lane
        vh = np.concatenate([zero, h_store[:, seg_len - 1, :-1]], axis=1)
        h_load, h_store = h_store, h_load
        vmax_col = np.zeros((n, lanes), dtype=np.int32)
        p = prof[rows, ref_codes[rows, col]]
        for j in range(seg_len):
            if byte_mode:
                vh = np.minimum(vh + p[:, j], 255)       # adds_epu8
                vh = np.maximum(vh - bias, 0)            # subs_epu8
            else:
                vh = vh + p[:, j]                        # adds_epi16
            e = e_arr[:, j]
            np.maximum(vh, e, out=vh)
            np.maximum(vh, vf, out=vh)
            np.maximum(vmax_col, vh, out=vmax_col)
            h_store[:, j] = vh
            vhg = np.maximum(vh - gap_open, 0)           # subs_epu
            e_arr[:, j] = np.maximum(np.maximum(e - gap_extend, 0), vhg)
            vf = np.maximum(np.maximum(vf - gap_extend, 0), vhg)
            vh = h_load[:, j].copy()
        # lazy-F loop (ssw.c:301-316 / 508-521), a pair leaving it at the
        # first segment where no lane of vF exceeds vH
        lazy = active.copy()
        for _k in range(lanes):
            if not lazy.any():
                break
            vf = np.concatenate([zero, vf[:, :-1]], axis=1)  # slli_si128
            for j in range(seg_len):
                vh = np.maximum(h_store[:, j], vf)
                keep = lazy[:, None]
                vmax_col = np.where(keep, np.maximum(vmax_col, vh), vmax_col)
                h_store[:, j] = np.where(keep, vh, h_store[:, j])
                vh = np.maximum(vh - gap_open, 0)
                vf = np.maximum(vf - gap_extend, 0)
                lazy &= (vf > vh).any(axis=1)
                if not lazy.any():
                    break
        colmax = vmax_col.max(axis=1)
        better = active & (colmax > best)
        best = np.where(better, colmax, best)
        over = better & byte_mode & (best + bias >= 255)  # ssw.c:327
        overflowed |= over
        moved = better & ~over
        end_ref = np.where(moved, col, end_ref)
        h_max_col_store[moved] = h_store[moved]
        max_column[rows[active], col[active]] = colmax[active]
        finished |= over | (active & (colmax == terminate))

    # trace end_read in striped order (ssw.c:344-350 / 546-556): the
    # smallest read position holding the best in memory order (j, k)
    flat = h_max_col_store.reshape(n, -1)
    at = pos.reshape(-1)
    end_read = np.minimum(read_len - 1, np.where(
        flat == best[:, None], at[None], 1 << 30).min(axis=1))
    if byte_mode:
        best = np.where(best + bias >= 255, 255, best)
    return [(int(best[b]), int(end_ref[b]), int(end_read[b]),
             max_column[b, :ref_len[b]], bool(overflowed[b]))
            for b in range(n)]


def _banded_cigar(read: np.ndarray, ref: np.ndarray, score: int,
                  score_matrix: np.ndarray, gap_open: int, gap_extend: int
                  ) -> Optional[List[Tuple[int, str]]]:
    """banded_sw re-derivation (ssw.c:595-790): returns [(len, op)] in
    M/I/D ops over the exact subregion, or None on failure."""
    ref_len, read_len = len(ref), len(read)
    band_width = abs(ref_len - read_len) + 1
    max_len = max(ref_len, read_len)
    sm = score_matrix.tolist()
    ref_l, read_l = ref.tolist(), read.tolist()

    best = 0
    while True:
        # DP over the band; out-of-band neighbors read as 0.
        h = [[0] * ref_len for _ in range(read_len)]
        e = [[0] * ref_len for _ in range(read_len)]
        d_e = [[0] * ref_len for _ in range(read_len)]
        d_f = [[0] * ref_len for _ in range(read_len)]
        d_h = [[0] * ref_len for _ in range(read_len)]
        for i in range(read_len):
            beg = max(0, i - band_width)
            end = min(ref_len - 1, i + band_width)
            f = 0
            h_i, e_i = h[i], e[i]
            h_up_row = h[i - 1] if i > 0 else None
            e_up_row = e[i - 1] if i > 0 else None
            de_i, df_i, dh_i = d_e[i], d_f[i], d_h[i]
            sm_read = [row[read_l[i]] for row in sm]
            for j in range(beg, end + 1):
                in_up = i > 0 and abs(j - (i - 1)) <= band_width
                h_up = h_up_row[j] if in_up else 0
                e_up = e_up_row[j] if in_up else 0
                if i == 0:
                    t1, t2 = -gap_open, -gap_extend
                else:
                    t1, t2 = h_up - gap_open, e_up - gap_extend
                e_cur = t1 if t1 > t2 else t2
                de_i[j] = 3 if t1 > t2 else 2
                e_i[j] = e_cur

                in_left = j > beg  # h of (i, j-1) inside band
                h_left = h_i[j - 1] if in_left else 0
                t1 = h_left - gap_open
                t2 = f - gap_extend
                f = t1 if t1 > t2 else t2
                df_i[j] = 5 if t1 > t2 else 4

                e1 = e_cur if e_cur > 0 else 0
                f1 = f if f > 0 else 0
                t1 = e1 if e1 > f1 else f1
                in_diag = (i > 0 and j > beg
                           and abs((j - 1) - (i - 1)) <= band_width)
                h_diag = h_up_row[j - 1] if in_diag else 0
                t2 = h_diag + sm_read[ref_l[j]]
                h_cur = t1 if t1 > t2 else t2
                h_i[j] = h_cur
                if h_cur > best:
                    best = h_cur
                if t1 <= t2:
                    dh_i[j] = 1
                else:
                    dh_i[j] = de_i[j] if e1 > f1 else df_i[j]
        band_width *= 2
        if not (best < score and band_width <= max_len):
            break
    band_width //= 2  # kept for fidelity; directions already absolute here

    # traceback (ssw.c:674-741)
    i, j = read_len - 1, ref_len - 1
    ops: List[str] = []
    layer = 2  # 0=e, 1=f, 2=h
    while i >= 0 and j > 0:
        d = (d_e[i][j], d_f[i][j], d_h[i][j])[layer]
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


def ssw_align_many(pairs: Sequence[Tuple[str, str]],
                   mask_lens: Sequence[int],
                   score_matrix: np.ndarray = SCORE_MATRIX,
                   gap_open: int = GAP_OPEN, gap_extend: int = GAP_EXTEND,
                   compute_cigar: bool = True) -> List[Alignment]:
    """Full CSSW-equivalent alignment of each (query, ref) pair, with the
    striped passes of all pairs run together."""
    reads = [translate(q) for q, _ in pairs]
    refs = [translate(r) for _, r in pairs]
    # s_align init (ssw.c:834-835)
    als = [Alignment(ref_begin=-1, query_begin=-1) for _ in pairs]
    live = [b for b in range(len(pairs)) if len(reads[b]) and len(refs[b])]

    # byte pass first; word rerun on saturation (ssw_align, ssw.c:846-855)
    first = dict(zip(live, _striped_passes(
        [reads[b] for b in live], [refs[b] for b in live], 0, score_matrix,
        gap_open, gap_extend, [255] * len(live), byte_mode=True)))
    byte = {b: True for b in live}
    redo = [b for b in live if first[b][0] == 255]
    for b, r in zip(redo, _striped_passes(
            [reads[b] for b in redo], [refs[b] for b in redo], 0,
            score_matrix, gap_open, gap_extend, [-1] * len(redo),
            byte_mode=False)):
        first[b], byte[b] = r, False

    back = []
    for b in live:
        al, (score1, end_ref, end_read, max_column, _) = als[b], first[b]
        al.sw_score, al.ref_end, al.query_end = score1, end_ref, end_read
        # second best outside the masked window (byte ssw.c:367-381: the
        # second loop starts one PAST the edge; word ssw.c:570-583: at the
        # edge)
        score2 = 0
        ref_end2 = 0
        ref_len, mask_len = len(refs[b]), mask_lens[b]
        lo = max(0, end_ref - mask_len)
        hi = min(ref_len, end_ref + mask_len)
        for i in range(0, lo):
            if max_column[i] > score2:
                score2 = int(max_column[i]); ref_end2 = i
        for i in range(hi + 1 if byte[b] else hi, ref_len):
            if max_column[i] > score2:
                score2 = int(max_column[i]); ref_end2 = i
        if mask_len >= 15:
            al.sw_score_next_best = score2
            al.ref_end_next_best = ref_end2
        else:
            al.sw_score_next_best = 0
            al.ref_end_next_best = -1
        # degenerate (score 0): the reference would read out of bounds
        # here; the score-only result (cannot happen for real windows)
        if score1 != 0 and end_ref >= 0:
            back.append(b)

    # reverse pass for begin positions (ssw.c:877-886): reversed read
    # prefix, ref columns iterated from end_ref downward, terminate at
    # score1
    for mode in (True, False):
        todo = [b for b in back if byte[b] == mode]
        rev = _striped_passes(
            [reads[b][:als[b].query_end + 1][::-1].copy() for b in todo],
            [refs[b][:als[b].ref_end + 1].copy() for b in todo], 1,
            score_matrix, gap_open, gap_extend,
            [als[b].sw_score for b in todo], byte_mode=mode)
        for b, (rev_score, rev_ref, rev_read, _mc, _) in zip(todo, rev):
            al = als[b]
            al.ref_begin = rev_ref
            al.query_begin = al.query_end - rev_read
            if al.sw_score > rev_score:
                # "banded_sw result will miss a small part" (ssw.c:890-893)
                al.flag = 2

    if not compute_cigar:
        return als
    for b in back:
        al = als[b]
        sub_read = reads[b][al.query_begin:al.query_end + 1]
        sub_ref = refs[b][al.ref_begin:al.ref_end + 1]
        entries = _banded_cigar(sub_read, sub_ref, al.sw_score, score_matrix,
                                gap_open, gap_extend)
        if entries is None:
            al.flag = 1
            continue
        al.cigar_string, al.mismatches = _rewrite_m_to_eq_x(
            entries, reads[b], refs[b], al.query_begin, al.query_end,
            al.ref_begin, len(reads[b]))
    return als


def ssw_align(query: str, ref: str, mask_len: int,
              score_matrix: np.ndarray = SCORE_MATRIX,
              gap_open: int = GAP_OPEN, gap_extend: int = GAP_EXTEND,
              compute_cigar: bool = True) -> Alignment:
    """Full CSSW-equivalent alignment of query against ref."""
    return ssw_align_many([(query, ref)], [mask_len], score_matrix, gap_open,
                          gap_extend, compute_cigar)[0]


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
