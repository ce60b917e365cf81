"""ctypes bindings for the native C++ runtime (the repository's
native/*.cpp, built by _build.build_native into build/).

The native layer carries the host-side hot paths (the reference implements
these in C++/CUDA: SSW src/ssw.c, edlib src/edlib.cpp, kseqpp ingest):
  * hrm_ssw_align    — SSW-equivalent aligner (STEP 2 production path)
  * hrm_nw_distance / hrm_nw_align — NW edit distance + CIGAR (edlib mode)
  * hrm_fastx_*      — FASTA/FASTQ(.gz) bulk reader with N-replacement

get_lib() builds the library at first use and raises, with the compiler's
output, when it cannot be built or loaded: device STEP 2, the cuckoo
table build, the records and the emitters need it.  available() is False in
that case, and only the callers that have a pure-Python implementation of
the same function (the golden oracles) ask it.
"""

from __future__ import annotations

import ctypes
import threading

from . import _build

_lib = None
_load_error = None
_lock = threading.Lock()


class HrmAlignment(ctypes.Structure):
    _fields_ = [
        ("sw_score", ctypes.c_int32),
        ("sw_score_next_best", ctypes.c_int32),
        ("ref_begin", ctypes.c_int32),
        ("ref_end", ctypes.c_int32),
        ("query_begin", ctypes.c_int32),
        ("query_end", ctypes.c_int32),
        ("ref_end_next_best", ctypes.c_int32),
        ("mismatches", ctypes.c_int32),
        ("flag", ctypes.c_int32),
        ("cigar_len", ctypes.c_int32),
    ]


def get_lib() -> ctypes.CDLL:
    """The native library, built and bound at first use (thread-safe);
    raises RuntimeError when the build or the load fails."""
    global _lib, _load_error
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise RuntimeError(_load_error)
        try:
            lib = ctypes.CDLL(_build.build_native())
        except (RuntimeError, OSError) as e:
            _load_error = f"the native host library is unavailable: {e}"
            raise RuntimeError(_load_error) from e
        lib.hrm_ssw_align.restype = ctypes.c_int
        lib.hrm_ssw_align.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(HrmAlignment),
            ctypes.c_char_p, ctypes.c_int]
        lib.hrm_ssw_align_batch.restype = ctypes.c_int
        lib.hrm_ssw_align_batch.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(HrmAlignment), ctypes.c_char_p,
            ctypes.c_int]
        lib.hrm_ssw_finish_batch.restype = ctypes.c_int
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.hrm_ssw_finish_batch.argtypes = [
            ctypes.c_char_p, i32p, i32p,   # query pool/off/len
            ctypes.c_char_p, i32p, i32p,   # ref pool/off/len
            i32p, i32p, i32p, i32p, i32p, i32p,  # score1, rb, re, qb, qe, flag
            ctypes.c_char_p,               # diag (int8, nullable)
            ctypes.POINTER(ctypes.c_int16),  # dev_ops RLE pool (nullable)
            ctypes.c_int,                  # dev_ops stride (elements)
            ctypes.c_char_p,               # dev_fail (int8 0/1/2, nullable)
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n_pairs, threads, codes
            i32p, i32p,                    # mismatches_out, flag_out
            ctypes.c_char_p, i32p, ctypes.c_int]  # cigars, lens, stride
        lib.hrm_rescore_batch.restype = ctypes.c_int
        lib.hrm_rescore_batch.argtypes = [
            ctypes.c_char_p, i32p, i32p,   # per-alignment query pool/off/len
            ctypes.c_char_p, i32p, i32p,   # ref
            ctypes.c_char_p, i32p, i32p,   # rc ref
            ctypes.c_char_p, i32p, i32p,   # cigar
            i32p, i32p, i32p,              # sw_score io, sw_next io, conv out
            ctypes.c_int, ctypes.c_int]
        lib.hrm_nw_distance.restype = ctypes.c_int
        lib.hrm_nw_distance.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.hrm_nw_align.restype = ctypes.c_int
        lib.hrm_nw_align.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.hrm_fastx_open.restype = ctypes.c_void_p
        lib.hrm_fastx_open.argtypes = [ctypes.c_char_p]
        lib.hrm_fastx_close.argtypes = [ctypes.c_void_p]
        lib.hrm_fastx_next_batch.restype = ctypes.c_int
        lib.hrm_fastx_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p]
        lib.hrm_fastx_next_batch_q.restype = ctypes.c_int
        lib.hrm_fastx_next_batch_q.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.c_char_p]
        if hasattr(lib, "hrm_sam_emit"):
            i64p = ctypes.POINTER(ctypes.c_int64)
            u8p = ctypes.c_char_p
            lib.hrm_sam_emit.restype = ctypes.c_int
            lib.hrm_sam_emit.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong,
                u8p, ctypes.c_int, i32p,           # q pool/lq/len
                u8p, ctypes.c_int, i32p,           # win pool/ws/len
                i64p, i32p,                        # position, chrom
                u8p, i64p, i32p,                   # names pool/off/len
                i32p, i32p,                        # flag0, flag1
                i32p, i32p, i32p, i32p,            # sw, nb, qb, conv
                u8p, i64p, i32p,                   # cig pool/off/len
                u8p,                               # qual pool (nullable)
                ctypes.c_longlong, ctypes.c_int,   # rid_base, threads
                i64p, i64p]                        # mapped/unmapped out
            lib.hrm_vc_emit.restype = ctypes.c_int
            lib.hrm_vc_emit.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong,
                u8p, ctypes.c_int, i32p,
                u8p, ctypes.c_int, i32p,
                i64p, i32p,
                u8p, i64p, i32p,
                i32p, i32p, i32p,                  # sw, nb, qb
                u8p, i64p, i32p,                   # cig pool/off/len
                ctypes.c_longlong]                 # rid_base
        if hasattr(lib, "hrm_cuckoo_build"):
            lib.hrm_cuckoo_build.restype = ctypes.c_int
            lib.hrm_cuckoo_build.argtypes = [
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_longlong,
                ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    return _lib


def available() -> bool:
    """False when the library cannot be built (get_lib has the reason)."""
    try:
        get_lib()
    except RuntimeError:
        return False
    return True


def ssw_align_native(query: str, ref: str, mask_len: int,
                     compute_cigar: bool = True):
    """Native SSW-equivalent alignment; returns an align.sw.Alignment."""
    from .align.sw import Alignment

    lib = get_lib()
    out = HrmAlignment()
    buf = ctypes.create_string_buffer(4096)
    rc = lib.hrm_ssw_align(
        query.encode("latin1"), len(query), ref.encode("latin1"), len(ref),
        mask_len, 1 if compute_cigar else 0, ctypes.byref(out), buf, 4096)
    if rc != 0:
        raise RuntimeError("hrm_ssw_align failed")
    return Alignment(
        sw_score=out.sw_score, sw_score_next_best=out.sw_score_next_best,
        ref_begin=out.ref_begin, ref_end=out.ref_end,
        query_begin=out.query_begin, query_end=out.query_end,
        ref_end_next_best=out.ref_end_next_best, mismatches=out.mismatches,
        cigar_string=buf.value.decode("latin1"), flag=out.flag)


def nw_align_native(query: str, target: str):
    lib = get_lib()
    buf = ctypes.create_string_buffer(8192)
    clen = ctypes.c_int(0)
    dist = lib.hrm_nw_align(
        query.encode("latin1"), len(query), target.encode("latin1"),
        len(target), buf, 8192, ctypes.byref(clen))
    if dist < 0:
        raise RuntimeError("hrm_nw_align failed")
    return dist, buf.value.decode("latin1")


def read_fastx_native(path: str, pitch: int, batch: int = 65536,
                      with_qualities: bool = False):
    """Yields (bases [n, pitch] int8, lengths [n], ambiguous [n]) batches;
    with_qualities appends a [n, pitch] uint8 raw phred+33 matrix (all-zero
    rows for FASTA records)."""
    import numpy as np

    lib = get_lib()
    h = lib.hrm_fastx_open(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        while True:
            bases = np.zeros((batch, pitch), dtype=np.int8)
            lengths = np.zeros(batch, dtype=np.int32)
            amb = np.zeros(batch, dtype=np.uint8)
            if with_qualities:
                quals = np.zeros((batch, pitch), dtype=np.uint8)
                n = lib.hrm_fastx_next_batch_q(
                    h, batch, pitch,
                    bases.ctypes.data_as(ctypes.c_char_p),
                    lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    amb.ctypes.data_as(ctypes.c_char_p),
                    quals.ctypes.data_as(ctypes.c_char_p))
            else:
                n = lib.hrm_fastx_next_batch(
                    h, batch, pitch,
                    bases.ctypes.data_as(ctypes.c_char_p),
                    lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    amb.ctypes.data_as(ctypes.c_char_p))
            if n < 0:
                raise ValueError(f"malformed FASTA/FASTQ: {path}")
            if n == 0:
                break
            if with_qualities:
                yield bases[:n], lengths[:n], amb[:n].astype(bool), quals[:n]
            else:
                yield bases[:n], lengths[:n], amb[:n].astype(bool)
    finally:
        lib.hrm_fastx_close(h)


def ssw_finish_batch(query_pool: bytes, query_off, query_len,
                     ref_pool: bytes, ref_off, ref_len,
                     score1, ref_begin, ref_end, query_begin, query_end,
                     flag_in, threads: int = 0, cigar_stride: int = 1024,
                     codes: bool = False, diag=None, raw: bool = False,
                     dev_ops=None, dev_fail=None):
    """Banded CIGAR + =/X rewrite for device-scored pairs.

    All array args are int32 numpy arrays of equal length n.  With
    codes=True the pools hold 0..4 base codes instead of ASCII (zero-copy
    in the native worker).  diag (optional bool/int8 [n]): pairs certified
    all-M by the device (swdev._diag_fastpath_flag) skip the banded DP and
    run only the =/X rewrite.  Returns
    (cigars list[str], mismatches [n] int32, flags [n] int32); with
    raw=True the cigars come back undecoded as (raw bytes strided by
    cigar_stride, lengths [n] int32) for bulk pooling (records mode).
    """
    import os as _os

    import numpy as np

    lib = get_lib()
    n = len(score1)
    if n == 0:
        z = np.zeros(0, np.int32)
        if raw:
            return (b"", z.copy(), z.copy(), z.copy())
        return [], z.copy(), z.copy()
    if threads <= 0:
        threads = min(32, _os.cpu_count() or 1)
    i32p = ctypes.POINTER(ctypes.c_int32)
    as32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    arrs = [as32(a) for a in (query_off, query_len, ref_off, ref_len,
                              score1, ref_begin, ref_end, query_begin,
                              query_end, flag_in)]
    mism = np.zeros(n, np.int32)
    flags = np.zeros(n, np.int32)
    clens = np.zeros(n, np.int32)
    cigars_buf = ctypes.create_string_buffer(n * cigar_stride)
    if diag is not None:
        diag_arr = np.ascontiguousarray(diag, dtype=np.int8)
        diag_p = diag_arr.ctypes.data_as(ctypes.c_char_p)
    else:
        diag_p = None
    if dev_ops is not None:
        # device-walked traceback (ops/bandtb.py): [n, S] int16 rows of
        # backward-order run-length entries (op | len << 2, 0-terminated);
        # dev_fail int8 [n]: 0 ops valid, 1 oracle traceback failure,
        # 2 entry budget overflow -> host banded DP
        ops_arr = np.ascontiguousarray(dev_ops, dtype=np.int16)
        assert ops_arr.shape[0] == n
        ops_p = ops_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
        ops_stride = int(ops_arr.shape[1])
        fail_arr = np.ascontiguousarray(dev_fail, dtype=np.int8)
        fail_p = fail_arr.ctypes.data_as(ctypes.c_char_p)
    else:
        ops_p, ops_stride, fail_p = None, 0, None
    rc = lib.hrm_ssw_finish_batch(
        query_pool, arrs[0].ctypes.data_as(i32p), arrs[1].ctypes.data_as(i32p),
        ref_pool, arrs[2].ctypes.data_as(i32p), arrs[3].ctypes.data_as(i32p),
        arrs[4].ctypes.data_as(i32p), arrs[5].ctypes.data_as(i32p),
        arrs[6].ctypes.data_as(i32p), arrs[7].ctypes.data_as(i32p),
        arrs[8].ctypes.data_as(i32p), arrs[9].ctypes.data_as(i32p),
        diag_p, ops_p, ops_stride, fail_p, n, threads, int(codes),
        mism.ctypes.data_as(i32p), flags.ctypes.data_as(i32p),
        cigars_buf, clens.ctypes.data_as(i32p), cigar_stride)
    if rc != 0:
        raise RuntimeError("hrm_ssw_finish_batch failed (cigar overflow?)")
    raw_bytes = cigars_buf.raw
    if raw:
        return raw_bytes, clens, mism, flags
    cigars = [raw_bytes[i * cigar_stride:i * cigar_stride + clens[i]]
              .decode("latin1") for i in range(n)]
    return cigars, mism, flags


def rescore_batch(q_pool: bytes, q_off, q_len, ref_pool: bytes, ref_off,
                  ref_len, rcref_pool: bytes, rcref_off, rcref_len,
                  cig_pool: bytes, cig_off, cig_len, sw_score, sw_next,
                  threads: int = 0):
    """Native bisulfite rescoring (recalculateAlignmentScorefk batch).

    sw_score / sw_next are int32 arrays adjusted IN PLACE; returns the
    per-alignment conversion counts."""
    import os as _os

    import numpy as np

    lib = get_lib()
    n = len(sw_score)
    if n == 0:
        return np.zeros(0, np.int32)
    if threads <= 0:
        threads = min(32, _os.cpu_count() or 1)
    i32p = ctypes.POINTER(ctypes.c_int32)
    as32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    offs = [as32(a) for a in (q_off, q_len, ref_off, ref_len, rcref_off,
                              rcref_len, cig_off, cig_len)]
    assert sw_score.dtype == np.int32 and sw_score.flags.c_contiguous
    assert sw_next.dtype == np.int32 and sw_next.flags.c_contiguous
    conv = np.zeros(n, np.int32)
    lib.hrm_rescore_batch(
        q_pool, offs[0].ctypes.data_as(i32p), offs[1].ctypes.data_as(i32p),
        ref_pool, offs[2].ctypes.data_as(i32p), offs[3].ctypes.data_as(i32p),
        rcref_pool, offs[4].ctypes.data_as(i32p),
        offs[5].ctypes.data_as(i32p),
        cig_pool, offs[6].ctypes.data_as(i32p), offs[7].ctypes.data_as(i32p),
        sw_score.ctypes.data_as(i32p), sw_next.ctypes.data_as(i32p),
        conv.ctypes.data_as(i32p), n, threads)
    return conv


def ssw_align_batch(queries, refs, mask_lens, threads: int = 0,
                    compute_cigar: bool = True):
    """Threaded native batch alignment; returns a list of sw.Alignment."""
    import os

    import numpy as np

    from .align.sw import Alignment

    lib = get_lib()
    n = len(queries)
    if n == 0:
        return []
    if threads <= 0:
        threads = min(32, os.cpu_count() or 1)
    qpool = "".join(queries).encode("latin1")
    rpool = "".join(refs).encode("latin1")
    qlen = np.array([len(q) for q in queries], dtype=np.int32)
    rlen = np.array([len(r) for r in refs], dtype=np.int32)
    qoff = np.zeros(n, dtype=np.int32)
    roff = np.zeros(n, dtype=np.int32)
    np.cumsum(qlen[:-1], out=qoff[1:])
    np.cumsum(rlen[:-1], out=roff[1:])
    masks = np.asarray(mask_lens, dtype=np.int32)
    out = (HrmAlignment * n)()
    stride = 4096
    cigars = ctypes.create_string_buffer(n * stride)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.hrm_ssw_align_batch(
        qpool, qoff.ctypes.data_as(i32p), qlen.ctypes.data_as(i32p),
        rpool, roff.ctypes.data_as(i32p), rlen.ctypes.data_as(i32p),
        masks.ctypes.data_as(i32p), n, 1 if compute_cigar else 0, threads,
        out, cigars, stride)
    if rc != 0:
        raise RuntimeError("hrm_ssw_align_batch failed (cigar overflow?)")
    result = []
    raw = cigars.raw  # one copy; slicing per pair below is cheap
    for i in range(n):
        a = out[i]
        cig = raw[i * stride:i * stride + a.cigar_len].decode("latin1")
        result.append(Alignment(
            sw_score=a.sw_score, sw_score_next_best=a.sw_score_next_best,
            ref_begin=a.ref_begin, ref_end=a.ref_end,
            query_begin=a.query_begin, query_end=a.query_end,
            ref_end_next_best=a.ref_end_next_best, mismatches=a.mismatches,
            cigar_string=cig, flag=a.flag))
    return result


def cuckoo_build(keys, bits: int, seed1: int, seed2: int):
    """Slot assignment for one table's distinct keys (native/cuckoo.cpp).

    keys: [n] uint32 numpy (distinct).  Returns [n] int32 slots in a
    2^bits table, or None on insertion failure (caller retries with other
    seeds / more bits) or when the native library is unavailable.
    """
    import numpy as np

    lib = get_lib()
    if lib is None or not hasattr(lib, "hrm_cuckoo_build"):
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    out = np.empty(len(keys), dtype=np.int32)
    rc = lib.hrm_cuckoo_build(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(keys), bits, seed1 & 0xFFFFFFFF, seed2 & 0xFFFFFFFF,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out if rc == 0 else None


def emit_available() -> bool:
    lib = get_lib()
    return lib is not None and hasattr(lib, "hrm_sam_emit")


def sam_emit(path: str, rec, names_pool: bytes, names_off, names_len,
             rid_base: int = 0, threads: int = 0):
    """Bulk SAM writer over a MappingRecords struct (native/emit.cpp);
    byte-identical to pipeline.mapping.print_to_sam.  Returns the
    {'mapped','unmapped'} stats dict."""
    import os as _os

    import numpy as np

    lib = get_lib()
    if threads <= 0:
        threads = min(16, _os.cpu_count() or 1)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    as_ = lambda a, dt: np.ascontiguousarray(a, dtype=dt)
    p32 = lambda a: as_(a, np.int32).ctypes.data_as(i32p)
    p64 = lambda a: as_(a, np.int64).ctypes.data_as(i64p)
    # keep converted arrays alive for the call
    q = as_(rec.q, np.uint8)
    win = as_(rec.win, np.uint8)
    keep = [q, win,
            as_(rec.q_len, np.int32), as_(rec.win_len, np.int32),
            as_(rec.position, np.int64), as_(rec.chrom, np.int32),
            as_(names_off, np.int64), as_(names_len, np.int32),
            as_(rec.flag0, np.int32), as_(rec.flag1, np.int32),
            as_(rec.sw, np.int32), as_(rec.nb, np.int32),
            as_(rec.qb, np.int32), as_(rec.conv, np.int32),
            as_(rec.cig_pool, np.uint8),
            as_(rec.cig_off, np.int64), as_(rec.cig_len, np.int32)]
    qual = None
    if rec.qual is not None:
        qual = as_(rec.qual, np.uint8)
        assert qual.shape == q.shape
    mapped = ctypes.c_int64(0)
    unmapped = ctypes.c_int64(0)
    pp = lambda a: a.ctypes.data_as(ctypes.c_char_p)
    rc = lib.hrm_sam_emit(
        path.encode(), rec.n,
        pp(q), int(rec.lq), keep[2].ctypes.data_as(i32p),
        pp(win), int(rec.ws), keep[3].ctypes.data_as(i32p),
        keep[4].ctypes.data_as(i64p), keep[5].ctypes.data_as(i32p),
        names_pool, keep[6].ctypes.data_as(i64p),
        keep[7].ctypes.data_as(i32p),
        keep[8].ctypes.data_as(i32p), keep[9].ctypes.data_as(i32p),
        keep[10].ctypes.data_as(i32p), keep[11].ctypes.data_as(i32p),
        keep[12].ctypes.data_as(i32p), keep[13].ctypes.data_as(i32p),
        pp(keep[14]), keep[15].ctypes.data_as(i64p),
        keep[16].ctypes.data_as(i32p),
        (pp(qual) if qual is not None else None),
        rid_base, threads, ctypes.byref(mapped), ctypes.byref(unmapped))
    if rc != 0:
        raise RuntimeError(f"hrm_sam_emit failed rc={rc}")
    return {"mapped": int(mapped.value), "unmapped": int(unmapped.value)}


def vc_emit(path: str, rec, names_pool: bytes, names_off, names_len,
            rid_base: int = 0) -> bool:
    """Bulk VCF writer (VariantHandler walk in C++, native/emit.cpp);
    byte-identical to pipeline.mapping.do_vc.  Returns False when the
    native walk hit a python-semantics edge it cannot replicate (caller
    falls back to the python VariantHandler, which raises the same way
    the oracle would)."""
    import numpy as np

    lib = get_lib()
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    as_ = lambda a, dt: np.ascontiguousarray(a, dtype=dt)
    q = as_(rec.q, np.uint8)
    win = as_(rec.win, np.uint8)
    keep = [q, win,
            as_(rec.q_len, np.int32), as_(rec.win_len, np.int32),
            as_(rec.position, np.int64), as_(rec.chrom, np.int32),
            as_(names_off, np.int64), as_(names_len, np.int32),
            as_(rec.sw, np.int32), as_(rec.nb, np.int32),
            as_(rec.qb, np.int32),
            as_(rec.cig_pool, np.uint8),
            as_(rec.cig_off, np.int64), as_(rec.cig_len, np.int32)]
    pp = lambda a: a.ctypes.data_as(ctypes.c_char_p)
    rc = lib.hrm_vc_emit(
        path.encode(), rec.n,
        pp(q), int(rec.lq), keep[2].ctypes.data_as(i32p),
        pp(win), int(rec.ws), keep[3].ctypes.data_as(i32p),
        keep[4].ctypes.data_as(i64p), keep[5].ctypes.data_as(i32p),
        names_pool, keep[6].ctypes.data_as(i64p),
        keep[7].ctypes.data_as(i32p),
        keep[8].ctypes.data_as(i32p), keep[9].ctypes.data_as(i32p),
        keep[10].ctypes.data_as(i32p),
        pp(keep[11]), keep[12].ctypes.data_as(i64p),
        keep[13].ctypes.data_as(i32p), rid_base)
    if rc == -1:
        raise OSError(f"cannot open {path}")
    return rc == 0
