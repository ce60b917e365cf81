"""Global (NW) edit-distance alignment: Myers bit-vector + DP traceback.

Capability counterpart of the reference's vendored edlib (reference:
src/edlib.cpp, include/edlib.h; used by the edlib mapper mode,
mappinghandler.cu:841-1176).  The distance is golden-tested against the
compiled reference edlib in EDLIB_MODE_NW.

Note: the reference's own edlib mapping mode cannot run to completion (it
indexes the empty CSSW result vector for MAPQ, reads freed memory for the RC
score, and leaves readId/queryStart uninitialized — see
pipeline/mapping_edlib.py), so only the aligner itself has a parity target.

Myers' algorithm runs on arbitrary-precision Python ints (a 150-bit read is
one word), giving O(n) per reference base.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def myers_nw_distance(query: str, target: str) -> int:
    """Global (NW) edit distance via Myers' bit-parallel algorithm."""
    m = len(query)
    n = len(target)
    if m == 0:
        return n
    if n == 0:
        return m
    peq = {}
    for i, c in enumerate(query):
        peq[c] = peq.get(c, 0) | (1 << i)
    mask = (1 << m) - 1
    vp = mask
    vn = 0
    score = m
    high = 1 << (m - 1)
    for c in target:
        eq = peq.get(c, 0)
        xv = eq | vn
        xh = (((eq & vp) + vp) ^ vp) | eq
        hp = vn | ~(xh | vp) & mask
        hn = vp & xh
        if hp & high:
            score += 1
        elif hn & high:
            score -= 1
        hp = ((hp << 1) | 1) & mask
        hn = (hn << 1) & mask
        vp = (hn | ~(xv | hp)) & mask
        vn = hp & xv
    return score


def nw_align(query: str, target: str) -> Tuple[int, str]:
    """NW alignment returning (edit distance, standard M/I/D CIGAR).

    I consumes query, D consumes target (edlib EDLIB_CIGAR_STANDARD
    convention: 'I' = insertion to target == extra query base).
    Traceback prefers diagonal, then deletion (target gap consumed... target
    base), then insertion — deterministic.
    """
    m, n = len(query), len(target)
    q = np.frombuffer(query.encode("latin1"), dtype=np.uint8)
    t = np.frombuffer(target.encode("latin1"), dtype=np.uint8)
    dp = np.zeros((m + 1, n + 1), dtype=np.int32)
    dp[0, :] = np.arange(n + 1)
    dp[:, 0] = np.arange(m + 1)
    for i in range(1, m + 1):
        sub = (t != q[i - 1]).astype(np.int32)
        row_prev = dp[i - 1]
        row = dp[i]
        row[1:] = np.minimum(row_prev[:-1] + sub, row_prev[1:] + 1)
        # fold in the horizontal (left + 1) dependency with a prefix scan
        best = row[0]
        for j in range(1, n + 1):
            best = min(row[j], best + 1)
            row[j] = best
    dist = int(dp[m, n])

    # traceback
    ops: List[str] = []
    i, j = m, n
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (
                q[i - 1] != t[j - 1]):
            ops.append("M")
            i -= 1
            j -= 1
        elif j > 0 and dp[i, j] == dp[i, j - 1] + 1:
            ops.append("D")
            j -= 1
        else:
            ops.append("I")
            i -= 1
    ops.reverse()
    out = []
    cnt = 0
    cur = ""
    for op in ops:
        if op == cur:
            cnt += 1
        else:
            if cnt:
                out.append(f"{cnt}{cur}")
            cur, cnt = op, 1
    if cnt:
        out.append(f"{cnt}{cur}")
    return dist, "".join(out)
