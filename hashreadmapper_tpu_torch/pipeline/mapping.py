"""STEP 2 (fine alignment -> SAM) and STEP 3 (variant calling -> VCF)
(counterpart of hashreadmapper_tpu/pipeline/mapping.py).

Behavioral re-derivation of the reference's Mappinghandler
(reference: src/gpu/mappinghandler.cu):

  CSSW path (:383-774): per read, take the 128-base genome window at the
  coarse-mapped position plus the RC-genome "window" (the reference's
  off-by-design slice starting at chromLen - pos - 1), build 3N (C->T)
  versions, align (3N query vs 3N window) and (3N RC-query vs 3N window)
  with SSW, rescore bisulfite conversions along the CIGAR (:601-745),
  compute CSSW MAPQ, and emit the reference's exact SAM layout (:196-293)
  with Yf/YZ tags.  STEP 3 (doVC, :92-156) feeds the better-scoring
  alignment into the VariantHandler when MAPQ >= 20.

Faithfully-kept quirks (each cited inline): the rescoring swaps query/RC
( `if (!h) _query = rc_query` ), POS = window position + query_begin (begin
of the QUERY, the "shenanigan" in ssw_cpp.cpp:349-351), the RC window slice,
the 82-base rescoring horizon with negative bases_left arithmetic, and the
@PG header line missing its newline.

STEP 2 has one form in the program: the coarse step builds every read's
rows (the query, its reverse complement, the window and the RC window,
and their 3N forms: G->A instead of C->T for a PBAT read in FORWARD
orientation), then scores and traces back its 3N pairs (query and
reverse-complement query against the read's 3N window) on the torch
device (engine.fused_step2_scores), and run_cssw turns that bundle into
MappingRecords, the native bulk SAM/VCF emitters' input: the native
CIGAR finish (its banded DP for every pair whose walk overflowed its
entry budget), the rescore and the records assembly on the host, all
reading the bundle's rows where they lie.  It needs the native library
and raises without it.

AlignerArguments, the serial host path _run_cssw_host, rescore_alignment,
print_to_sam and do_vc are copies of the JAX package's host code: the
oracle the tests hold run_cssw's records to.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .. import native
from ..align import sw
from ..config import ProgramOptions
from ..io.genome import Genome
from ..io.readstore import ReadStorage
from ..io.vcf import MAP_QUALITY_THRESHOLD, VariantHandler, parse_cigar
from ..cpu import oracle
from ..ops import swdev
from ..utils import tracing
from .records import MappingRecords

FORWARD, REVERSE_COMPLEMENT, NONE = 1, 2, 3

_COMPLEMENT = str.maketrans("ACGT", "TGCA")


class AlignerArguments:
    """Mirror of the reference's AlignerArguments (mappinghandler.cuh:67-100).

    The RC/3N string variants are pure functions of `query`/`ref`
    (NucleoideConverer, mappinghandler.cu:163-179), so they are derived
    lazily — the batched device path never materializes them unless a
    host fallback (or a parity test) reads them.  `rc_ref` is NOT
    derivable from `ref` (it is a different genome slice) and stays
    stored.
    """
    __slots__ = ("read_id", "query", "ref", "rc_ref", "window_length",
                 "position", "chromosome_id", "flag", "flag_rc",
                 "alignments", "num_conversions", "mask_len", "qual",
                 "bs_strand",
                 "_rc_query", "_three_n_query", "_three_n_rc_query",
                 "_three_n_ref")

    def __init__(self):
        self.read_id = 0
        self.query = ""          # read, RC'd in place when orientation == RC
        self.ref = ""            # 128-base window (raw chars, N preserved)
        self.rc_ref = ""         # RC-genome slice starting at len - pos - 1
        self.window_length = 0
        self.position = 0
        self.chromosome_id = 0
        self.flag = 0
        self.flag_rc = 0
        self.alignments: Optional[List[sw.Alignment]] = None
        self.num_conversions: Optional[List[int]] = None
        self.mask_len = 15
        # stored quality aligned with `query` (reversed when orientation ==
        # RC); empty = reference parity ('*' in SAM).  Opt-in via
        # useQualityScores — the reference parses the flag but always
        # writes '*' (mappinghandler.cu:196-293); real QUAL exceeds it.
        self.qual = ""
        # 0 = directional C->T space; 1 = mirrored PBAT G->A space
        # (opts.undirectional coarse stage sets it per read)
        self.bs_strand = 0
        self._rc_query = None
        self._three_n_query = None
        self._three_n_rc_query = None
        self._three_n_ref = None

    @property
    def rc_query(self):
        if self._rc_query is None:
            self._rc_query = oracle.revcomp_str(self.query)
        return self._rc_query

    @rc_query.setter
    def rc_query(self, v):
        self._rc_query = v

    @property
    def three_n_query(self):
        if self._three_n_query is None:
            self._three_n_query = _three_n(self.query, self.bs_strand)
        return self._three_n_query

    @three_n_query.setter
    def three_n_query(self, v):
        self._three_n_query = v

    @property
    def three_n_rc_query(self):
        if self._three_n_rc_query is None:
            self._three_n_rc_query = _three_n(self.rc_query, self.bs_strand)
        return self._three_n_rc_query

    @three_n_rc_query.setter
    def three_n_rc_query(self, v):
        self._three_n_rc_query = v

    @property
    def three_n_ref(self):
        if self._three_n_ref is None:
            self._three_n_ref = _three_n(self.ref, self.bs_strand)
        return self._three_n_ref

    @three_n_ref.setter
    def three_n_ref(self, v):
        self._three_n_ref = v


def _three_n(s: str, bs_strand: int = 0) -> str:
    """NucleoideConverer (mappinghandler.cu:163-179): C -> T only.
    bs_strand=1 is the mirrored PBAT space: G -> A."""
    if bs_strand:
        return s.replace("G", "A")
    return s.replace("C", "T")


def _window_views(genome: Genome, genome_rc: Genome, chrom_id: int, pos: int,
                  window_size: int):
    """The reference's window + RC-window slices (mappinghandler.cu:430-450).

    The RC window starts at aef = chromLen - pos - 1; for pos < windowSize-1
    that slice runs past the chromosome end in the reference (string_view over
    the terminator) — we pad with NUL bytes, matching the first OOB byte.
    """
    seq = genome.sequence_str(chrom_id)
    seq_rc = genome_rc.sequence_str(chrom_id)
    size = len(seq)
    wlen = window_size if pos + window_size < size else size - pos
    wlen_rc = wlen
    window = seq[pos:pos + wlen]
    aef = size - pos - 1
    window_rc = seq_rc[aef:aef + wlen_rc]
    if len(window_rc) < wlen_rc:
        window_rc = window_rc + "\x00" * (wlen_rc - len(window_rc))
    return window, window_rc, wlen


def rescore_alignment(aa: AlignerArguments, h: int) -> None:
    """recalculateAlignmentScorefk (mappinghandler.cu:601-745).

    Walks the h-th alignment's CIGAR with an 82-base horizon, adjusting
    sw_score / sw_score_next_best where a query T aligns over a genomic C
    (bisulfite conversion) and counting conversions.  Quirk kept: h==0 uses
    rc_query, h==1 uses query (the reference's `if (!h)` swap).
    """
    ali = aa.alignments[h]
    num_conversions = 0
    _query = aa.query if h else aa.rc_query
    _ref = aa.ref
    rc_ref = aa.rc_ref
    if aa.bs_strand:
        # mirrored PBAT space: complementing every sequence maps the G->A
        # conversion patterns onto the reference's C->T walk below (the
        # score matrix is match/mismatch only, hence complement-invariant)
        _query = _query.translate(_COMPLEMENT)
        _ref = _ref.translate(_COMPLEMENT)
        rc_ref = rc_ref.translate(_COMPLEMENT)
    cig = parse_cigar(ali.cigar_string)
    ref_pos, alt_pos = 0, 0
    for op, length in cig:
        bases_left = min(82 - max(ref_pos, alt_pos), length)
        if op == "M":
            for i in range(max(0, bases_left)):
                if (alt_pos + i >= len(_query) or ref_pos + i >= len(_ref)
                        or ref_pos + i >= len(rc_ref)):
                    continue
                q = _query[alt_pos + i]
                r = _ref[ref_pos + i]
                if q == r or r == "N" or q == "N":
                    continue
                if q == "C":
                    if ((r == "T" and rc_ref[ref_pos + i] == "A")
                            or (r == "A" and rc_ref[ref_pos + i] == "T")):
                        ali.sw_score_next_best -= sw.get_score("T", r)
                        ali.sw_score_next_best += sw.get_score("C", r)
                        ali.sw_score -= sw.get_score("T", r)
                        ali.sw_score += sw.get_score("C", r)
                if q == "T":
                    if ((r == "C" and rc_ref[ref_pos + i] == "G")
                            or (r == "G" and rc_ref[ref_pos + i] == "C")):
                        num_conversions += 1
                        ali.sw_score_next_best -= sw.get_score("T", "T")
                        ali.sw_score_next_best += sw.get_score("T", r)
                        ali.sw_score -= sw.get_score("T", "T")
                        ali.sw_score += sw.get_score("T", r)
            ref_pos += bases_left
            alt_pos += bases_left
        elif op == "I":
            alt_pos += bases_left
        elif op == "D":
            ref_pos += bases_left
        elif op == "S":
            alt_pos += bases_left
        elif op == "H" or op == "P":
            pass
        elif op == "N":
            ref_pos += bases_left
        elif op == "X":
            ref_pos += bases_left
            alt_pos += bases_left
        elif op == "=":
            for i in range(max(0, bases_left)):
                if (alt_pos + i >= len(_query) or ref_pos + i >= len(_ref)
                        or ref_pos + i >= len(rc_ref)):
                    continue
                q = _query[alt_pos + i]
                r = _ref[ref_pos + i]
                if q == r or r == "N" or q == "N":
                    continue
                if q == "T":
                    if ((r == "C" and rc_ref[ref_pos + i] == "G")
                            or (r == "G" and rc_ref[ref_pos + i] == "C")):
                        num_conversions += 1
                        ali.sw_score_next_best -= 2
                        ali.sw_score_next_best += sw.get_score(q, r)
                        ali.sw_score -= 2
                        ali.sw_score += sw.get_score(q, r)
            ref_pos += bases_left
            alt_pos += bases_left
    aa.num_conversions[h] = num_conversions


CIGAR_STRIDE = 1024    # bytes per pair in the native finish's raw buffer
_B5 = np.frombuffer(b"ACGTN", dtype=np.uint8)
_COMPL_U8 = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMPL_U8[_a] = _b


def records_supported() -> bool:
    """True when the records-mode production path (struct-of-arrays STEP 2
    + native bulk emit, pipeline/records.py) can run; raises with the
    compiler's output when the native library cannot be built."""
    lib = native.get_lib()
    return hasattr(lib, "hrm_rescore_batch") and native.emit_available()


def run_cssw(genome: Genome, genome_rc: Genome, orientation: np.ndarray,
             position: np.ndarray, chromosome_id: np.ndarray,
             reads: ReadStorage, opts: ProgramOptions,
             bs_strand: np.ndarray, bundle) -> MappingRecords:
    """The CSSW mapping stage over all reads (mapping.run_cssw): bundle
    is the fused coarse step's engine.Step2Bundle for these reads
    (map_reads with_scores: scores [10, 2n], tb_ops [2n, E], tb_status
    [2n] and the reads' rows); returns MappingRecords.  genome and
    genome_rc are the JAX signature's: the windows are the bundle's."""
    if not records_supported():
        raise RuntimeError(
            "device STEP 2 needs the native library's CIGAR finish, "
            "rescore and emitters")
    # the mirrored (G->A) treatment applies only to PBAT reads in FORWARD
    # orientation (mapping.run_cssw)
    bs_strand = ((np.asarray(bs_strand) != 0)
                 & (np.asarray(orientation) == FORWARD)).astype(np.int8)
    out = _run_cssw_device(orientation, position, chromosome_id, reads,
                           opts, bs_strand, bundle)
    if opts.use_quality_scores and reads.qualities is not None:
        qm = np.zeros((out.n, out.lq), np.uint8)
        for r in range(out.n):
            q = reads.get_quality_str(r)
            if orientation[r] == REVERSE_COMPLEMENT:
                q = q[::-1]
            b = np.frombuffer(q.encode("latin1"), np.uint8)
            qm[r, :len(b)] = b
        out.qual = qm
    return out


_ROWS = 1 << 16   # reads a native call takes: its int32 row offsets stay small


def _row_blocks(read_ids: np.ndarray):
    """(lo, hi, r0) over ascending read indices: entries lo:hi lie in
    reads r0 .. r0 + _ROWS - 1, the rows a native call is handed."""
    if not len(read_ids):
        return []
    blk = read_ids // _ROWS
    cut = np.flatnonzero(np.diff(blk)) + 1
    return [(int(lo), int(hi), int(blk[lo]) * _ROWS)
            for lo, hi in zip(np.concatenate([[0], cut]),
                              np.concatenate([cut, [len(read_ids)]]))]


def _run_cssw_device(orientation, position, chromosome_id, reads, opts,
                     bs_strand, bundle) -> MappingRecords:
    """mapping._run_cssw_device in records mode: the device's scores,
    traceback and rows from the fused bundle; the native finish and the
    records assembly on the host, reading the rows where the bundle holds
    them (the pairs' 3N rows q3 at pair * L, the windows at read * ws)."""
    rows = bundle.rows
    with tracing.span("step2.prep") as sp:
        n = reads.num_reads
        lens32 = reads.lengths.astype(np.int32)
        lq, ws = rows.q.shape[1], rows.win.shape[1]
        m = np.nonzero(orientation != NONE)[0]
        nm = len(m)
        if sp is not None:
            # the mapped reads' rows, all of them the card's
            sp.attrs.update(card_rows=nm, host_rows=0)
        if nm == 0:
            z32 = lambda k: np.zeros(k, np.int32)
            return MappingRecords(
                n=n, lq=lq, ws=ws, q=rows.q, q_len=lens32, win=rows.win,
                win_len=rows.wlen, position=position.astype(np.int64),
                chrom=chromosome_id.astype(np.int32),
                flag0=np.full(n, 0x4, np.int32), flag1=z32(n), sw=z32(2 * n),
                nb=z32(2 * n), qb=z32(2 * n), conv=z32(2 * n),
                cig_pool=np.zeros(0, np.uint8),
                cig_off=np.zeros(2 * n, np.int64), cig_len=z32(2 * n))
        # the mapped reads' interleaved pairs: [2k] the 3N query and
        # [2k+1] the 3N RC query of read m[k], both against its 3N window
        P = 2 * nm
        sel = np.empty(P, np.int64)
        sel[0::2] = 2 * m
        sel[1::2] = 2 * m + 1
        pair_read = sel // 2
        pair_rl = lens32[pair_read]
        pair_fl = rows.wlen[pair_read]
        pair_ml = np.maximum(15, pair_rl // 2).astype(np.int32)
        scores, tb_ops, tb_status = bundle
        dev = swdev.unpack_scores(scores[:, sel].astype(np.int32))
        ops_all = tb_ops[sel].astype(np.int16)
        fail_all = tb_status[sel].astype(np.int8)

    # native CIGAR finish (multi-threaded) of every pair that is neither
    # saturated (host rerun in _assemble_records) nor degenerate
    fb = dev["host_fallback"]
    dg = dev["degenerate"] & ~fb
    fin = np.nonzero(~fb & ~dg)[0]
    cl_all = np.zeros(P, np.int32)
    flags_all = np.zeros(P, np.int32)
    raw_chunks = []
    counts = {}
    if tracing.enabled():
        # pairs whose DP runs on the host: the saturated ones' rerun in
        # _assemble_records, and in the native finish every traceback
        # that the device did not walk (status 2: its entry budget
        # overflowed)
        walked = fail_all[fin] != 2
        counts = dict(pairs=P, host_dp_pairs=int(np.count_nonzero(fb))
                      + int(np.count_nonzero(~dev["diag"][fin] & ~walked)))
    with tracing.span("step2.finish", **counts):
        for lo, hi, r0 in _row_blocks(pair_read[fin]):
            f = fin[lo:hi]
            raw_b, clens, _mism, flags = native.ssw_finish_batch(
                rows.q3[2 * r0:], (sel[f] - 2 * r0) * lq, pair_rl[f],
                rows.win3[r0:], (pair_read[f] - r0) * ws, pair_fl[f],
                dev["score1"][f], dev["ref_begin"][f], dev["ref_end"][f],
                dev["query_begin"][f], dev["query_end"][f], dev["flag"][f],
                threads=max(1, opts.threads), codes=True, diag=dev["diag"][f],
                raw=True, cigar_stride=CIGAR_STRIDE, dev_ops=ops_all[f],
                dev_fail=fail_all[f])
            cl_all[f] = clens
            flags_all[f] = flags
            raw_chunks.append((f, raw_b, clens))
    with tracing.span("step2.assemble"):
        return _assemble_records(
            n, nm, m, orientation, position, chromosome_id, lens32, rows,
            sel, pair_rl, pair_fl, pair_ml, dev, fb, dg, cl_all, flags_all,
            raw_chunks, CIGAR_STRIDE, bs_strand, opts)


def _run_cssw_host(genome: Genome, genome_rc: Genome,
                   orientation: np.ndarray, position: np.ndarray,
                   chromosome_id: np.ndarray, reads: ReadStorage,
                   opts: ProgramOptions,
                   bs_strand: Optional[np.ndarray] = None
                   ) -> List[AlignerArguments]:
    """Serial host reference path (the oracle for the device path)."""
    out: List[AlignerArguments] = []
    n = reads.num_reads
    for r in range(n):
        read_len = int(reads.lengths[r])
        bases = list(reads.gather_bases([r], read_len)[0])
        if orientation[r] == REVERSE_COMPLEMENT:
            bases = oracle.revcomp_bases(bases)
        query = oracle.decode_bases(bases)
        pos = int(position[r])
        chrom = int(chromosome_id[r])

        window, window_rc, wlen = _window_views(
            genome, genome_rc, chrom, pos, opts.window_size)

        aa = AlignerArguments()
        aa.read_id = r
        if bs_strand is not None:
            aa.bs_strand = int(bs_strand[r])
        aa.query = query
        aa.rc_query = oracle.revcomp_str(query)
        aa.three_n_query = _three_n(query, aa.bs_strand)
        aa.three_n_rc_query = _three_n(aa.rc_query, aa.bs_strand)
        aa.ref = window
        aa.rc_ref = window_rc
        aa.three_n_ref = _three_n(window, aa.bs_strand)
        aa.window_length = wlen
        aa.position = pos
        aa.chromosome_id = chrom
        aa.mask_len = max(15, read_len // 2)
        aa.alignments = [sw.Alignment(), sw.Alignment()]
        aa.num_conversions = [0, 0]
        if orientation[r] == NONE:
            aa.flag |= 0x4
        out.append(aa)

    # parallelFor mapfk (mappinghandler.cu:560-595); the native threaded
    # batch path is bit-identical to the python oracle (tests/test_native.py)
    mapped_aas = [aa for aa in out if not (aa.flag & 0x4)]
    if native.available() and mapped_aas:
        queries, refs, masks = [], [], []
        for aa in mapped_aas:
            queries.append(aa.three_n_query)
            refs.append(aa.three_n_ref)
            masks.append(aa.mask_len)
            queries.append(aa.three_n_rc_query)
            refs.append(aa.three_n_ref)
            masks.append(aa.mask_len)
        als = native.ssw_align_batch(queries, refs, masks,
                                     threads=max(1, opts.threads))
        for i, aa in enumerate(mapped_aas):
            aa.alignments[0] = als[2 * i]
            aa.flag = als[2 * i].flag
            aa.alignments[1] = als[2 * i + 1]
            aa.flag_rc = als[2 * i + 1].flag
    else:
        for aa in mapped_aas:
            al0 = sw.ssw_align(aa.three_n_query, aa.three_n_ref, aa.mask_len)
            aa.alignments[0] = al0
            aa.flag = al0.flag
            al1 = sw.ssw_align(aa.three_n_rc_query, aa.three_n_ref,
                               aa.mask_len)
            aa.alignments[1] = al1
            aa.flag_rc = al1.flag

    # parallelFor comparefk (mappinghandler.cu:747-766)
    for aa in out:
        if aa.flag & 0x4:
            continue
        rescore_alignment(aa, 0)
        rescore_alignment(aa, 1)
    return out

def _assemble_records(n, nm, m, orientation, position, chromosome_id,
                      lens32, rows, sel, pair_rl, pair_fl, pair_ml, dev, fb,
                      dg, cl_all, flags_all, raw_chunks, stride, bs_strand,
                      opts):
    """Records-mode tail of _run_cssw_device: patch degenerate/fallback
    pairs, pool the CIGAR bytes, rescore natively in place, and scatter
    the per-pair arrays into the [2n] MappingRecords layout."""
    P = 2 * nm
    lq, ws = rows.q.shape[1], rows.win.shape[1]
    sw_pairs = np.ascontiguousarray(dev["score1"], np.int32)
    nb_pairs = np.ascontiguousarray(dev["score2"], np.int32)
    qb_pairs = np.ascontiguousarray(dev["query_begin"], np.int32).copy()
    qb_pairs[dg] = -1  # ssw_align's score-0 early return (query_begin=-1)
    fb_cigs = {}
    for pi in np.nonzero(fb)[0]:
        # byte saturation -> host word-mode rerun (align/sw.py:379-388)
        q = _B5[rows.q3[sel[pi], :pair_rl[pi]]].tobytes().decode("latin1")
        w = _B5[rows.win3[sel[pi] // 2, :pair_fl[pi]]].tobytes().decode(
            "latin1")
        al = sw.ssw_align(q, w, int(pair_ml[pi]))
        sw_pairs[pi] = al.sw_score
        nb_pairs[pi] = al.sw_score_next_best
        qb_pairs[pi] = al.query_begin
        flags_all[pi] = al.flag
        cb = al.cigar_string.encode("latin1")
        cl_all[pi] = len(cb)
        fb_cigs[int(pi)] = cb

    # pool the per-pair CIGAR bytes (strided native buffers -> compact)
    cig_off = np.zeros(P, np.int64)
    np.cumsum(cl_all[:-1], dtype=np.int64, out=cig_off[1:])
    pool = np.empty(int(cig_off[-1]) + int(cl_all[-1]) if P else 0,
                    np.uint8)
    for fin, raw_b, clens in raw_chunks:
        tot = int(clens.sum())
        if tot == 0:
            continue
        src = np.frombuffer(raw_b, np.uint8)
        cl64 = clens.astype(np.int64)
        within = (np.arange(tot, dtype=np.int64)
                  - np.repeat(np.cumsum(cl64) - cl64, cl64))
        starts_src = np.repeat(np.arange(len(fin), dtype=np.int64) * stride,
                               cl64)
        starts_dst = np.repeat(cig_off[fin], cl64)
        pool[starts_dst + within] = src[starts_src + within]
    for pi, cb in fb_cigs.items():
        o = int(cig_off[pi])
        pool[o:o + len(cb)] = np.frombuffer(cb, np.uint8)

    # native batched rescoring (comparefk, mappinghandler.cu:747-766):
    # alignment h=0 rescored against rc_query, h=1 against query (the
    # reference's `if (!h)` swap); adjusts sw/nb in place, emits conv
    q_rows, rcq_rows, win_rows, rc_rows = rows.q, rows.rcq, rows.win, \
        rows.win_rc
    mirrored = bs_strand != 0
    if mirrored.any():
        # mirrored PBAT rescore via the complement trick (rescore_alignment)
        def complemented(a):
            a = a.copy()
            a[mirrored] = _COMPL_U8[a[mirrored]]
            return a
        q_rows, rcq_rows, win_rows, rc_rows = map(
            complemented, (q_rows, rcq_rows, win_rows, rc_rows))
    conv = np.empty(P, np.int32)
    with tracing.span("step2.rescore"):
        for lo, hi, r0 in _row_blocks(m):
            k = m[lo:hi]
            q_off, w_off = (k - r0) * lq, (k - r0) * ws
            wl = rows.wlen[k]
            c0 = int(cig_off[2 * lo])
            c1 = int(cig_off[2 * hi - 1]) + int(cl_all[2 * hi - 1])
            for h, query in ((0, rcq_rows), (1, q_rows)):
                idx = np.arange(2 * lo + h, 2 * hi, 2)
                sw_h, nb_h = sw_pairs[idx], nb_pairs[idx]
                conv[idx] = native.rescore_batch(
                    query[r0:], q_off, lens32[k], win_rows[r0:], w_off, wl,
                    rc_rows[r0:], w_off, wl, pool[c0:c1], cig_off[idx] - c0,
                    cl_all[idx], sw_h, nb_h, threads=max(1, opts.threads))
                sw_pairs[idx] = sw_h
                nb_pairs[idx] = nb_h

    # scatter per-pair arrays ([P] over mapped reads) into [2n]
    n2 = 2 * n
    z32 = lambda: np.zeros(n2, np.int32)
    sw2, nb2, qb2, conv2, cl2 = z32(), z32(), z32(), z32(), z32()
    co2 = np.zeros(n2, np.int64)
    sw2[sel] = sw_pairs
    nb2[sel] = nb_pairs
    qb2[sel] = qb_pairs
    conv2[sel] = conv
    cl2[sel] = cl_all
    co2[sel] = cig_off
    flag0 = np.zeros(n, np.int32)
    flag1 = np.zeros(n, np.int32)
    flag0[m] = flags_all[0::2]
    flag1[m] = flags_all[1::2]
    flag0[orientation == NONE] = 0x4
    return MappingRecords(
        n=n, lq=lq, ws=ws, q=rows.q, q_len=lens32, win=rows.win,
        win_len=rows.wlen, position=position.astype(np.int64),
        chrom=chromosome_id.astype(np.int32),
        flag0=flag0, flag1=flag1, sw=sw2, nb=nb2, qb=qb2, conv=conv2,
        cig_pool=pool, cig_off=co2, cig_len=cl2)


def print_to_sam(mappingout: List[AlignerArguments], genome: Genome,
                 path: str) -> dict:
    """printtoSAM byte-layout replica (mappinghandler.cu:196-293)."""
    mapped = 0
    unmapped = 0
    with open(path, "w") as fh:
        fh.write("@HD\tVN:1.4\n")
        for aa in mappingout:
            fh.write(f"@SQ\tSN:{aa.read_id}\tLN:{aa.window_length}\n")
        # the reference omits the newline after the @PG line
        fh.write("@PG\tHashreadmapper\tID:1.0")
        fh.write("@CO: QNAME\tFLAG\tRNAME\tPOS\tMAPQ\tCIGAR\tRNEXT\tPNEXT\t"
                 "TLEN\tSEQ\tQUAL\tTAG\n")
        for aa in mappingout:
            a0, a1 = aa.alignments
            if a0.sw_score >= a1.sw_score:
                samtag = f"Yf:i:<{aa.num_conversions[0]}>YZ:A:<+>"
                samflag = aa.flag
                mapq = sw.mapq_cssw(a0.sw_score, a0.sw_score_next_best)
                pos = aa.position + a0.query_begin
                cig = a0.cigar_string
            else:
                samtag = f"Yf:i:<{aa.num_conversions[1]}>YZ:A:<->"
                samflag = aa.flag_rc
                mapq = sw.mapq_cssw(a1.sw_score, a1.sw_score_next_best)
                pos = aa.position + a1.query_begin
                cig = a1.cigar_string
            rname = genome.names[aa.chromosome_id]
            if (aa.flag & 0x4) == 0:
                mapped += 1
                tag = samtag
            else:
                unmapped += 1
                tag = str(aa.flag)
            fh.write(f"{aa.read_id}\t{samflag}\t{rname}\t{pos}\t{mapq}\t"
                     f"{cig}\t{aa.ref}\t\t0\t{aa.query}\t"
                     f"{aa.qual or '*'}\t{tag}\t\n")
    return {"mapped": mapped, "unmapped": unmapped}


def do_vc(mappingout: List[AlignerArguments], genome: Genome,
          outputfile: str) -> str:
    """doVC (mappinghandler.cu:92-156): STEP 3 variant calling."""
    path = outputfile + ".VCF"
    vh = VariantHandler(path)
    vh.vcf_file_header()
    for aa in mappingout:
        a0, a1 = aa.alignments
        h = 0 if a0.sw_score >= a1.sw_score else 1
        ali = aa.alignments[h]
        mapq = sw.mapq_cssw(ali.sw_score, ali.sw_score_next_best)
        if mapq < MAP_QUALITY_THRESHOLD:
            continue
        prefix = aa.ref[:max(0, ali.query_begin)]
        vh.call(aa.position + ali.query_begin, prefix, aa.ref, aa.query,
                parse_cigar(ali.cigar_string),
                genome.names[aa.chromosome_id], aa.read_id, mapq)
    vh.close()
    return path
