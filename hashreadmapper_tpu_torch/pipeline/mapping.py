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

The host half (AlignerArguments, the serial host path _run_cssw_host, the
rescore, the records assembly and the SAM/VCF writers) is a copy of the
JAX package's.  The device half is the port's own: the 3N pairs of every
mapped read (query and reverse-complement query against the read's 3N
window; G->A instead of C->T for a PBAT read in FORWARD orientation) go
through the striped-SW score passes (ops/swdev.py) and the banded
traceback (ops/bandtb.py) on the torch device, either in the coarse step
(pre_scores, engine.fused_step2_scores) or here in chunks of staged
pairs, then through the native CIGAR finish and the records assembly.

The device path returns MappingRecords (the native bulk SAM/VCF
emitters' input), so it needs the native library; it raises without it
instead of falling back to the host path.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import native
from ..align import sw
from ..config import ProgramOptions
from ..io.genome import Genome
from ..io.readstore import ReadStorage
from ..io.vcf import MAP_QUALITY_THRESHOLD, VariantHandler, parse_cigar
from ..cpu import oracle
from ..ops import bandtb, swdev
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


TB_CHUNK = 8192        # pairs per device traceback call (bounds the
                       # [P, LQ, 128] int16 directions to ~268 MB)
CIGAR_STRIDE = 1024    # bytes per pair in the native finish's raw buffer
_B4 = np.frombuffer(b"ACGT", dtype=np.uint8)
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
             bs_strand: Optional[np.ndarray] = None, pre_scores=None, *,
             device):
    """The CSSW mapping stage over all reads (mapping.run_cssw).

    With opts.step2_device (the default) the fine alignment runs on
    `device` and the result is MappingRecords; pre_scores is the fused
    coarse step's bundle for these reads (CoarseMapper.map_reads
    with_scores).  Otherwise the serial host path runs and returns
    AlignerArguments.  Callers accept either, as with the JAX package."""
    if bs_strand is None:
        bs_strand = np.zeros(len(orientation), dtype=np.int8)
    # the mirrored (G->A) treatment applies only to PBAT reads in FORWARD
    # orientation (mapping.run_cssw)
    bs_strand = ((np.asarray(bs_strand) != 0)
                 & (np.asarray(orientation) == FORWARD)).astype(np.int8)
    if opts.step2_device and reads.num_reads > 0:
        if not records_supported():
            raise RuntimeError(
                "device STEP 2 needs the native library's CIGAR finish, "
                "rescore and emitters; set opts.step2_device = False for "
                "the host path")
        out = _run_cssw_device(genome, genome_rc, orientation, position,
                               chromosome_id, reads, opts, bs_strand,
                               pre_scores, device)
    else:
        out = _run_cssw_host(genome, genome_rc, orientation, position,
                                    chromosome_id, reads, opts, bs_strand)
    if opts.use_quality_scores and reads.qualities is not None:
        if isinstance(out, MappingRecords):
            qm = np.zeros((out.n, out.lq), np.uint8)
            for r in range(out.n):
                q = reads.get_quality_str(r)
                if orientation[r] == REVERSE_COMPLEMENT:
                    q = q[::-1]
                b = np.frombuffer(q.encode("latin1"), np.uint8)
                qm[r, :len(b)] = b
            out.qual = qm
        else:
            for aa in out:
                q = reads.get_quality_str(aa.read_id)
                aa.qual = (q[::-1]
                           if orientation[aa.read_id] == REVERSE_COMPLEMENT
                           else q)
    return out


def _windows(genome, genome_rc, position, chromosome_id, ws):
    """The window and RC-window slices of every read (mapping.
    _window_views, batched): (win [n, ws] uint8, win_rc, wlens [n])."""
    n = len(position)
    win = np.zeros((n, ws), np.uint8)
    win_rc = np.zeros((n, ws), np.uint8)
    wlens = np.zeros(n, np.int64)
    iw = np.arange(ws, dtype=np.int32)
    for c in np.unique(chromosome_id):
        rows = np.nonzero(chromosome_id == c)[0]
        seq = genome.seqs_ascii[int(c)]
        seq_rc = genome_rc.seqs_ascii[int(c)]
        size = len(seq)
        p = position[rows].astype(np.int32)
        wl = np.where(p + ws < size, ws, size - p)
        g = p[:, None] + iw[None, :]
        v = iw[None, :] < wl[:, None]
        win[rows] = np.where(v, seq[np.minimum(g, size - 1)], 0)
        g2 = (size - p - 1).astype(np.int32)[:, None] + iw[None, :]
        win_rc[rows] = np.where(v & (g2 < size),
                                seq_rc[np.minimum(g2, size - 1)], 0)
        wlens[rows] = wl
    return win, win_rc, wlens


def _run_cssw_device(genome, genome_rc, orientation, position, chromosome_id,
                     reads, opts, bs_strand, pre_scores, device
                     ) -> MappingRecords:
    """mapping._run_cssw_device in records mode: pair prep on the host,
    score passes and traceback on `device` (fused bundle or chunks here),
    native finish and the records assembly on the host."""
    n = reads.num_reads
    lens = reads.lengths.astype(np.int64)
    lens32 = lens.astype(np.int32)
    lq = max(1, reads.max_length)
    mat = reads.bases_matrix(lq)
    idx = np.arange(lq, dtype=np.int32)
    valid = idx[None, :] < lens32[:, None]
    rev_idx = np.maximum(lens32[:, None] - 1 - idx[None, :], 0)
    rc_of = lambda a: np.where(valid, 3 - np.take_along_axis(a, rev_idx, 1),
                               0)
    # query = read, reverse-complemented in place when orientation is RC
    fwd_mat = np.where((orientation == REVERSE_COMPLEMENT)[:, None],
                       rc_of(mat), mat)
    rcq_mat = rc_of(fwd_mat)
    ws = opts.window_size
    win, win_rc, wlens = _windows(genome, genome_rc, position, chromosome_id,
                                  ws)
    q_ascii, rcq_ascii = _B4[fwd_mat], _B4[rcq_mat]

    m = np.nonzero(orientation != NONE)[0]
    nm = len(m)
    if nm == 0:
        z32 = lambda k: np.zeros(k, np.int32)
        return MappingRecords(
            n=n, lq=lq, ws=ws, q=q_ascii, q_len=lens32, win=win,
            win_len=wlens.astype(np.int32),
            position=position.astype(np.int64),
            chrom=chromosome_id.astype(np.int32),
            flag0=np.full(n, 0x4, np.int32), flag1=z32(n), sw=z32(2 * n),
            nb=z32(2 * n), qb=z32(2 * n), conv=z32(2 * n),
            cig_pool=np.zeros(0, np.uint8), cig_off=np.zeros(2 * n, np.int64),
            cig_len=z32(2 * n))
    # pairs [2i] = 3N query, [2i+1] = 3N RC query, same 3N window; reads
    # with bs_strand = 1 use the mirrored PBAT collapse (G->A)
    und = bool(bs_strand.any())
    sc = (bs_strand != 0)[:, None]

    def collapse(a):
        ct = np.where(a == 1, 3, a)
        if not und:
            return ct.astype(np.int8)
        return np.where(sc, np.where(a == 2, 0, a), ct).astype(np.int8)
    P = 2 * nm
    pair_q = np.empty((P, lq), np.int8)
    pair_q[0::2] = collapse(fwd_mat)[m]
    pair_q[1::2] = collapse(rcq_mat)[m]
    pair_ref = np.repeat(collapse(sw.TRANSLATE[win])[m], 2, axis=0)
    pair_rl = np.repeat(lens[m], 2).astype(np.int32)
    pair_fl = np.repeat(wlens[m], 2).astype(np.int32)
    pair_ml = np.repeat(np.maximum(15, lens[m] // 2), 2).astype(np.int32)

    use_tb = bool(opts.step2_device_traceback)
    ops_all = np.zeros((P, bandtb.N_ENTRIES), np.int16) if use_tb else None
    fail_all = np.zeros(P, np.int8) if use_tb else None
    pre_tb = None
    if isinstance(pre_scores, tuple):
        pre_scores, *pre_tb = pre_scores
    if pre_scores is not None:
        # the fused coarse step scored every (read x 2) pair: select the
        # mapped reads' interleaved rows
        sel = np.empty(P, np.int64)
        sel[0::2] = 2 * m
        sel[1::2] = 2 * m + 1
        dev = swdev.unpack_scores(pre_scores[:, sel].astype(np.int32))
        if use_tb and pre_tb is not None and pre_tb[0].shape[1] > 1:
            ops_all = pre_tb[0][sel].astype(np.int16)
            fail_all = pre_tb[1][sel].astype(np.int8)
        elif use_tb:
            _traceback(dev, pair_q, pair_ref, ops_all, fail_all, device)
    else:
        # pairs staged to the device in chunks; one fetch of all rows
        chunk = max(256, int(opts.step2_pair_chunk))
        sl = lambda a, s: a[s:s + chunk]
        dev = swdev.ssw_score_collect(torch.cat([swdev.ssw_score_dispatch(
            sl(pair_q, s), sl(pair_rl, s), sl(pair_ref, s), sl(pair_fl, s),
            sl(pair_ml, s), device) for s in range(0, P, chunk)], dim=1))
        if use_tb:
            _traceback(dev, pair_q, pair_ref, ops_all, fail_all, device)

    # native CIGAR finish (multi-threaded) of every pair that is neither
    # saturated (host rerun in _assemble_records) nor degenerate
    fb = dev["host_fallback"]
    dg = dev["degenerate"] & ~fb
    fin = np.nonzero(~fb & ~dg)[0]
    nf = len(fin)
    cl_all = np.zeros(P, np.int32)
    flags_all = np.zeros(P, np.int32)
    raw_chunks = []
    if nf:
        tb_kw = (dict(dev_ops=ops_all[fin], dev_fail=fail_all[fin])
                 if use_tb else {})
        raw_b, clens, _mism, flags = native.ssw_finish_batch(
            pair_q[fin].tobytes(), np.arange(nf, dtype=np.int64) * lq,
            pair_rl[fin], pair_ref[fin].tobytes(),
            np.arange(nf, dtype=np.int64) * ws, pair_fl[fin],
            dev["score1"][fin], dev["ref_begin"][fin], dev["ref_end"][fin],
            dev["query_begin"][fin], dev["query_end"][fin],
            dev["flag"][fin], threads=max(1, opts.threads), codes=True,
            diag=dev["diag"][fin], raw=True, cigar_stride=CIGAR_STRIDE,
            **tb_kw)
        cl_all[fin] = clens
        flags_all[fin] = flags
        raw_chunks.append((fin, raw_b, clens))
    return _assemble_records(
        n, lq, ws, nm, m, orientation, position, chromosome_id, lens, lens32,
        wlens, win, win_rc, q_ascii, rcq_ascii, pair_q, pair_ref, pair_rl,
        pair_fl, pair_ml, dev, fb, dg, cl_all, flags_all, raw_chunks,
        CIGAR_STRIDE, bs_strand, und, opts, lambda label: None, None)


def _traceback(dev, pair_q, pair_ref, ops_all, fail_all, device):
    """Device banded traceback of the pairs that need the DP (not
    diag-certified, not saturated, not degenerate), TB_CHUNK pairs per
    dispatch; fills ops_all / fail_all."""
    idx = np.nonzero(~dev["diag"] & ~dev["host_fallback"]
                     & ~dev["degenerate"])[0]
    for c in range(0, len(idx), TB_CHUNK):
        sub = idx[c:c + TB_CHUNK]
        ops_all[sub], fail_all[sub] = bandtb.banded_traceback_batch(
            pair_q[sub], dev["query_begin"][sub], dev["query_end"][sub],
            pair_ref[sub], dev["ref_begin"][sub], dev["ref_end"][sub],
            dev["score1"][sub], device)


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

def _assemble_records(n, lq, ws, nm, m, orientation, position, chromosome_id,
                      lens, lens32, wlens, win, win_rc, q_ascii, rcq_ascii,
                      pair_q, pair_ref, pair_rl, pair_fl, pair_ml,
                      dev, fb, dg, cl_all, flags_all, raw_chunks, stride,
                      bs_strand, und, opts, _mark, _marks):
    """Records-mode tail of _run_cssw_device: patch degenerate/fallback
    pairs, pool the CIGAR bytes, rescore natively in place, and scatter
    the per-pair arrays into the [2n] MappingRecords layout."""
    P = 2 * nm
    sw_pairs = np.ascontiguousarray(dev["score1"], np.int32)
    nb_pairs = np.ascontiguousarray(dev["score2"], np.int32)
    qb_pairs = np.ascontiguousarray(dev["query_begin"], np.int32).copy()
    qb_pairs[dg] = -1  # ssw_align's score-0 early return (query_begin=-1)
    fb_cigs = {}
    for pi in np.nonzero(fb)[0]:
        # byte saturation -> host word-mode rerun (align/sw.py:379-388)
        q = _B5[pair_q[pi, :pair_rl[pi]]].tobytes().decode("latin1")
        w = _B5[pair_ref[pi, :pair_fl[pi]]].tobytes().decode("latin1")
        al = sw.ssw_align(q, w, int(pair_ml[pi]))
        sw_pairs[pi] = al.sw_score
        nb_pairs[pi] = al.sw_score_next_best
        qb_pairs[pi] = al.query_begin
        flags_all[pi] = al.flag
        cb = al.cigar_string.encode("latin1")
        cl_all[pi] = len(cb)
        fb_cigs[int(pi)] = cb
    _mark("fallback_pairs")

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
    qa = np.empty((P, lq), np.uint8)
    qa[0::2] = rcq_ascii[m]
    qa[1::2] = q_ascii[m]
    qa_len = np.repeat(lens[m], 2).astype(np.int32)
    ref_rows = np.repeat(win[m], 2, axis=0)
    rcref_rows = np.repeat(win_rc[m], 2, axis=0)
    if und:
        # mirrored PBAT rescore via the complement trick (rescore_alignment)
        sp = np.repeat((bs_strand[m] != 0), 2)[:, None]
        qa = np.where(sp, _COMPL_U8[qa], qa)
        ref_rows = np.where(sp, _COMPL_U8[ref_rows], ref_rows)
        rcref_rows = np.where(sp, _COMPL_U8[rcref_rows], rcref_rows)
    wl2 = np.repeat(wlens[m], 2).astype(np.int32)
    block = 1 << 17   # keeps int32 pool offsets safe
    conv = np.empty(P, np.int32)
    for b0 in range(0, P, block):
        b1 = min(b0 + block, P)
        nb_ = b1 - b0
        pool_b = pool[int(cig_off[b0]):
                      int(cig_off[b1 - 1]) + int(cl_all[b1 - 1])].tobytes()
        conv[b0:b1] = native.rescore_batch(
            qa[b0:b1].tobytes(),
            np.arange(nb_, dtype=np.int64) * lq, qa_len[b0:b1],
            ref_rows[b0:b1].tobytes(),
            np.arange(nb_, dtype=np.int64) * ws, wl2[b0:b1],
            rcref_rows[b0:b1].tobytes(),
            np.arange(nb_, dtype=np.int64) * ws, wl2[b0:b1],
            pool_b, cig_off[b0:b1] - cig_off[b0], cl_all[b0:b1],
            sw_pairs[b0:b1], nb_pairs[b0:b1],
            threads=max(1, opts.threads))
    _mark("rescore")

    # scatter per-pair arrays ([P] over mapped reads) into [2n]
    idx2 = np.empty(P, np.int64)
    idx2[0::2] = 2 * m
    idx2[1::2] = 2 * m + 1
    n2 = 2 * n
    z32 = lambda: np.zeros(n2, np.int32)
    sw2, nb2, qb2, conv2, cl2 = z32(), z32(), z32(), z32(), z32()
    co2 = np.zeros(n2, np.int64)
    sw2[idx2] = sw_pairs
    nb2[idx2] = nb_pairs
    qb2[idx2] = qb_pairs
    conv2[idx2] = conv
    cl2[idx2] = cl_all
    co2[idx2] = cig_off
    flag0 = np.zeros(n, np.int32)
    flag1 = np.zeros(n, np.int32)
    flag0[m] = flags_all[0::2]
    flag1[m] = flags_all[1::2]
    flag0[orientation == NONE] = 0x4
    if _marks is not None:
        import sys as _sys
        for (l0, t0), (l1, t1) in zip(_marks, _marks[1:]):
            print(f"STEP2 {l1}: {t1 - t0:.3f}s", file=_sys.stderr,
                  flush=True)
    return MappingRecords(
        n=n, lq=lq, ws=ws, q=q_ascii, q_len=lens32.astype(np.int32),
        win=win, win_len=wlens.astype(np.int32),
        position=position.astype(np.int64),
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
