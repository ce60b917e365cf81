"""STEP 2 on the device (counterpart of the device path of
hashreadmapper_tpu/pipeline/mapping.py, run_cssw and _run_cssw_device).

The fine alignment of every mapped read runs on the torch device: the
3N pairs (query and reverse-complement query against the read's 3N
window) go through the striped-SW score passes (ops/swdev.py) and the
banded traceback (ops/bandtb.py), either in the coarse step
(pre_scores, engine.fused_step2_scores) or here in chunks of staged
pairs.  The host keeps the shared JAX-package code that needs no jax:
the native CIGAR finish (native.ssw_finish_batch), the rescore and the
records (mapping._assemble_records), and the serial host path
(mapping._run_cssw_host) when opts.step2_device is False.

The device path returns MappingRecords (the native bulk SAM/VCF
emitters' input), so it needs the native library with its emitters; it
raises without them instead of falling back to the host path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hashreadmapper_tpu import native
from hashreadmapper_tpu.align import sw
from hashreadmapper_tpu.config import ProgramOptions
from hashreadmapper_tpu.io.genome import Genome
from hashreadmapper_tpu.io.readstore import ReadStorage
from hashreadmapper_tpu.pipeline import mapping as shared
from hashreadmapper_tpu.pipeline.mapping import (_B4, FORWARD, NONE,
                                                 REVERSE_COMPLEMENT,
                                                 records_supported)
from hashreadmapper_tpu.pipeline.records import MappingRecords

from ..ops import bandtb, swdev
from .engine import unsupported

TB_CHUNK = 8192        # pairs per device traceback call (bounds the
                       # [P, LQ, 128] int16 directions to ~268 MB)
CIGAR_STRIDE = 1024    # bytes per pair in the native finish's raw buffer


def run_cssw(genome: Genome, genome_rc: Genome, orientation: np.ndarray,
             position: np.ndarray, chromosome_id: np.ndarray,
             reads: ReadStorage, opts: ProgramOptions,
             bs_strand: Optional[np.ndarray] = None, pre_scores=None, *,
             device):
    """The CSSW mapping stage over all reads (mapping.run_cssw).

    With opts.step2_device (the default) the fine alignment runs on
    `device` and the result is MappingRecords; pre_scores is the fused
    coarse step's bundle for these reads (CoarseMapper.map_reads
    with_scores).  Otherwise the shared serial host path runs and returns
    AlignerArguments.  Callers accept either, as with the JAX package."""
    if bs_strand is None:
        bs_strand = np.zeros(len(orientation), dtype=np.int8)
    # the mirrored (G->A) treatment applies only to PBAT reads in FORWARD
    # orientation (mapping.run_cssw)
    bs_strand = ((np.asarray(bs_strand) != 0)
                 & (np.asarray(orientation) == FORWARD)).astype(np.int8)
    if opts.step2_device and reads.num_reads > 0:
        if not (native.available() and records_supported()):
            raise RuntimeError(
                "device STEP 2 needs the native library with its CIGAR "
                "finish, rescore and emitters (make -C native); set "
                "opts.step2_device = False for the host path")
        out = _run_cssw_device(genome, genome_rc, orientation, position,
                               chromosome_id, reads, opts, bs_strand,
                               pre_scores, device)
    else:
        out = shared._run_cssw_host(genome, genome_rc, orientation, position,
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
    native finish and the shared records assembly on the host."""
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
    if bs_strand.any():
        raise unsupported("the G->A (PBAT) STEP-2 pairs of --undirectional",
                          "Queue 1 item 11")
    # pairs [2i] = 3N query, [2i+1] = 3N RC query, same 3N window
    ct = lambda a: np.where(a == 1, 3, a).astype(np.int8)
    P = 2 * nm
    pair_q = np.empty((P, lq), np.int8)
    pair_q[0::2] = ct(fwd_mat)[m]
    pair_q[1::2] = ct(rcq_mat)[m]
    pair_ref = np.repeat(ct(sw.TRANSLATE[win])[m], 2, axis=0)
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
    return shared._assemble_records(
        n, lq, ws, nm, m, orientation, position, chromosome_id, lens, lens32,
        wlens, win, win_rc, q_ascii, rcq_ascii, pair_q, pair_ref, pair_rl,
        pair_fl, pair_ml, dev, fb, dg, cl_all, flags_all, raw_chunks,
        CIGAR_STRIDE, bs_strand, False, opts, lambda label: None, None)


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
