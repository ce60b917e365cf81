"""Coarse-mapping engine: genome window index on the device, reads stream
through (counterpart of hashreadmapper_tpu/pipeline/engine.py).

Per read batch: signatures -> capped CSR probe -> min-table-hits vote
-> SHD against the extended candidate windows -> per-read best (min
Hamming, then earliest window); with scores, also the fused STEP 2: the
3N pairs of every read against its window, the striped-SW score passes
and the banded traceback (fused_step2_scores).  Three seeding modes:
parity (canonical k-mers, F tables, un-collapsed SHD), --threeN (CT and
GA spaces, 2F tables) and --threeN --undirectional (the 2F tables probed
a second time with the mirrored PBAT query spaces, and a second,
mirrored SHD evaluation).  One device; every tensor lives on the mapper's
`device` (a CUDA device runs the hand-written kernels, the CPU their
plain versions, with identical results).  A mapper built over segments
(parallel/segments.py) indexes and stages only their window spans; the
region-sharded mapper (parallel/region_sharded.py) holds one per region.

The batch step (_batch_step: _map_batch, and with scores
fused_step2_scores) is the counterpart of the JAX engine's jitted
dispatch units.  Over a staged read pool it runs through
pipeline/graphs.py: on a CUDA device one replay of a captured CUDA graph
a batch, on the CPU the same step eagerly on the same static buffers;
each batch's outputs are copied into the pool's results on the device
(_map_reads_device, _map_reads_device_scored, map_pool_scanned) before
the next batch runs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from ..align import sw
from ..config import ProgramOptions
from ..index import minhash_index as mi
from ..io.genome import Genome
from ..ops import (bandtb, encode, minhash, pairs_kernel, shd, swdev,
                   vote_kernel)
from ..ops.shd_kernel import pack_genome_planes
from ..parallel.segments import segment_base_span
from ..utils import tracing
from ..utils.progress import ProgressReporter
from . import graphs

SENTINEL = 0xFFFFFFFF
OVERFLOW_KEYS = ("probe_overflow", "vote_overflow", "pair_budget_overflow",
                 "probe_tail_overflow", "probe_head_overflow")


@dataclasses.dataclass
class WindowTable:
    """Device-resident genome geometry + per-window metadata."""
    genome_concat: torch.Tensor   # [G] int8 chromosomes concatenated
    genome_hi: torch.Tensor       # [G/32] int32 bit planes
    genome_lo: torch.Tensor
    chrom_offset: torch.Tensor    # [C] start in genome_concat
    chrom_len: torch.Tensor       # [C]
    win_pos: Optional[torch.Tensor] = None     # [W] start in chromosome
    win_chrom: Optional[torch.Tensor] = None   # [W] chromosome id
    num_windows: int = 0


@dataclasses.dataclass
class CoarseResults:
    """Per-read best hits, numpy on the host."""
    orientation: np.ndarray        # [N] int8 (1=fwd, 2=rc, 3=none)
    hamming: np.ndarray            # [N] int32
    shift: np.ndarray              # [N] int32
    chromosome_id: np.ndarray      # [N] int32
    position: np.ndarray           # [N] int32
    global_window_id: np.ndarray   # [N] uint32 (SENTINEL when unmapped)
    stats: Dict[str, int]
    bs_strand: Optional[np.ndarray] = None
    # the full-width window ordinal of the region-sharded mapper (a genome
    # of 2**31 bases or more has ordinals beyond uint32); None otherwise
    global_window_id64: Optional[np.ndarray] = None


def staged_spans(genome: Genome, segments, opts: Optional[ProgramOptions]):
    """(chromosome id, lo, hi) of every staged base range: whole
    chromosomes, or each segment's span with its margins."""
    if segments is None:
        return [(c, 0, genome.chromosome_length(c))
                for c in range(genome.num_chromosomes)]
    margin = opts.max_read_length
    return [(seg.chrom_id,
             *segment_base_span(genome, opts, seg, margin))
            for seg in segments]


def build_window_table(genome: Genome, device, segments=None,
                       opts: Optional[ProgramOptions] = None) -> WindowTable:
    """Stage the genome (or only `segments` of it, plus margins) and its
    packed bit planes on `device`.  With segments the "chromosome" axis
    indexes segments: chrom_offset holds VIRTUAL offsets (staged start
    minus true start, negative where a span starts inside its chromosome)
    and chrom_len the TRUE chromosome lengths, so chrom_offset[s] + a true
    position lands in the staged bases and the extension math is that of
    an uncut mapper."""
    spans = staged_spans(genome, segments, opts)
    total = sum(hi - lo for _, lo, hi in spans)
    if total >= 2**31:
        raise ValueError(
            f"a single mapper stages fewer than 2**31 bases ({total} asked); "
            "larger genomes go through RegionShardedMapper's window "
            "partition (parallel/region_sharded.py, --regions)")
    sizes = np.array([hi - lo for _, lo, hi in spans], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    offsets = starts - np.array([lo for _, lo, _ in spans], dtype=np.int64)
    lens = [genome.chromosome_length(c) for c, _, _ in spans]
    concat = torch.from_numpy(np.concatenate(
        [genome.bases[c][lo:hi].astype(np.int8)
         for c, lo, hi in spans])).to(device)
    g_hi, g_lo = pack_genome_planes(concat)
    return WindowTable(
        genome_concat=concat, genome_hi=g_hi, genome_lo=g_lo,
        chrom_offset=torch.from_numpy(offsets).to(device),
        chrom_len=torch.tensor(lens, dtype=torch.int64, device=device))


def plan_num_hash_functions(opts: ProgramOptions, num_windows: int) -> int:
    """Table count under the --memHashtables budget (hashreadmapper_tpu
    engine.py:123): ~16 bytes per window per table, 2 tables per hash
    function in 3N mode."""
    f = opts.num_hash_functions
    if opts.memory_for_hashtables <= 0:
        return f
    tables_per_func = 2 if opts.three_n_seeding else 1
    per_table = 16 * max(num_windows, 1) + 4096
    max_f = int(opts.memory_for_hashtables // (per_table * tables_per_func))
    if max_f < f:
        if opts.must_use_all_hash_functions:
            raise MemoryError(
                f"memHashtables budget fits only {max_f} of "
                f"{f} hash tables but mustUseAllHashfunctions is set")
        max_f = max(1, max_f)
        print(f"memHashtables: can use {max_f} of {f} hash tables")
        return max_f
    return f


def window_bases_device(genome_concat: torch.Tensor, gstart: torch.Tensor,
                        ws: int) -> torch.Tensor:
    """[n, ws] window bases gathered from the resident genome (indices
    clamped to its end)."""
    idx = gstart[:, None] + torch.arange(ws, device=gstart.device)[None, :]
    return genome_concat[idx.clamp(max=genome_concat.shape[0] - 1)]


def coarse_pairs_best(ids, read_bases, read_len, opts: ProgramOptions,
                      genome_hi, genome_lo, win_pos, win_chrom,
                      chrom_offset, chrom_len, probe_stats, num_kept):
    """Voted candidate ids [B, K] -> SHD -> per-read best, packed: the
    pair stage (ops/pairs_kernel.py::pair_select), the SHD launch, with
    opts.undirectional a second one in the mirrored (PBAT) collapse
    spaces, and the per-read best (pairs_kernel.read_best).

    With 0 < opts.shd_pairs_per_read_budget < K the valid (read,
    candidate) pairs are compacted to B * budget before SHD; pairs beyond
    it score as rejected and are counted in pair_drops.  The mirrored
    result wins only when it is not NONE and the directional one is NONE
    or has strictly larger Hamming.  Returns (packed [B, 7] int32: ori,
    hamming, shift, chrom, pos, window id (-1 unmapped), bs strand; ori
    [B, K] int8 every candidate's SHD orientation, NONE where rejected or
    not evaluated; overflow [5] int64 in OVERFLOW_KEYS order from
    probe_stats [S, 3] (ops/probe_kernel.py::probe_gather's stats of each
    probe), num_kept [B] and the pair drops)."""
    pair_sel, ridx, gstart, length, left, sel_valid, pair_drops = \
        pairs_kernel.pair_select(ids, read_len, win_pos, win_chrom,
                                 chrom_offset, chrom_len, opts.window_size,
                                 opts.shd_pairs_per_read_budget)
    params = shd.ShdParams(
        window_size=opts.window_size,
        max_ext_len=opts.window_size + opts.max_read_length,
        max_read_len=read_bases.shape[1],
        max_hamming_percent=opts.max_hamming_percent)

    def eval_pairs(undirectional):
        return shd.shd_pairs_best(
            read_bases, read_len, ridx, genome_hi, genome_lo, gstart,
            length, left, sel_valid, params, three_n=opts.three_n_seeding,
            undirectional=undirectional)

    return pairs_kernel.read_best(
        eval_pairs(False), eval_pairs(True) if opts.undirectional else None,
        pair_sel, sel_valid, ids, win_pos, win_chrom, probe_stats, num_kept,
        pair_drops)


def build_genome_s2(genome: Genome, segments=None,
                    opts: Optional[ProgramOptions] = None) -> np.ndarray:
    """[G] int8 STEP-2 genome codes 0..4 of exactly the spans the window
    table stages (with segments: each segment's span with its margins), so
    that the table's chrom_offset indexes it too.  Unlike genome_concat, N
    stays code 4 (align.sw.TRANSLATE), which the score passes treat as a
    mismatch.  The JAX package nibble-packs the same codes to work around
    TPU gathers (engine.build_genome_s2); here they stay one byte each."""
    return np.concatenate([sw.TRANSLATE[np.asarray(genome.seqs_ascii[c])
                                        [lo:hi]]
                           for c, lo, hi in staged_spans(genome, segments,
                                                         opts)]
                          ).astype(np.int8)


def fused_step2_scores(opts: ProgramOptions, chrom_offset, chrom_len,
                       genome_s2, read_bases, read_len, packed):
    """STEP 2 of one coarse-mapped batch (engine.fused_step2_scores):
    pairs [2i] = 3N query and [2i+1] = 3N reverse-complement query of read
    i, both against read i's 3N window, for every row of the batch
    (unmapped and padding rows score against chromosome 0, position 0).
    The collapse is C->T, or G->A for a read whose packed strand is 1 in
    FORWARD orientation (a PBAT read under opts.undirectional).
    Returns (scores [10, 2B] int16, tb_ops [2B, 48] uint8, tb_status
    [2B] int8); without opts.step2_device_traceback the traceback is
    skipped and tb_ops is [2B, 1] zeros."""
    ws = opts.window_size
    b, lq = read_bases.shape
    dev = read_bases.device
    packed = packed.to(torch.int64)
    ori, chrom, pos = packed[:, 0], packed[:, 3], packed[:, 4]
    ga_t = ((packed[:, 6] != 0) & (ori == 1))[None, :]
    rc = encode.revcomp_bases(read_bases, read_len)
    is_rc = (ori == 2)[:, None]
    # pairs built transposed ([L, pairs]), the layout the passes take
    fwd_t = torch.where(is_rc, rc, read_bases).T
    rcq_t = torch.where(is_rc, read_bases, rc).T
    clen = chrom_len[chrom]
    wl = torch.where(pos + ws < clen, ws, clen - pos).to(torch.int32)
    iw = torch.arange(ws, device=dev)[:, None]
    gidx = (chrom_offset[chrom] + pos)[None, :] + iw
    win_t = genome_s2[gidx.clamp(0, genome_s2.shape[0] - 1)]
    win_t = torch.where(iw < wl, win_t, 4)

    def collapse(m):
        ct = encode.three_n_c_to_t(m)
        if not opts.undirectional:
            return ct
        return torch.where(ga_t, encode.three_n_g_to_a(m), ct)
    pair_q_t = torch.stack([collapse(fwd_t), collapse(rcq_t)],
                           dim=2).reshape(lq, 2 * b)
    pair_ref_t = collapse(win_t).repeat_interleave(2, dim=1)
    rl32 = read_len.to(torch.int32)
    scores = swdev.ssw_score_packed_t(
        pair_q_t, rl32.repeat_interleave(2),
        pair_ref_t, wl.repeat_interleave(2),
        (rl32 // 2).clamp(min=15).repeat_interleave(2), ws)
    if opts.step2_device_traceback:
        tb_ops, tb_status = bandtb.fused_traceback_t(pair_q_t, pair_ref_t,
                                                     scores)
    else:
        tb_ops = torch.zeros((2 * b, 1), dtype=torch.uint8, device=dev)
        tb_status = torch.zeros(2 * b, dtype=torch.int8, device=dev)
    return scores.to(torch.int16), tb_ops, tb_status


def pool_ranges(n: int, pool_n: int):
    """(c0, c1) of the read pools of n reads, pool_n at a time."""
    return [(c0, min(c0 + pool_n, n)) for c0 in range(0, n, pool_n or 1)]


class CoarseMapper:
    """The window index of one genome on one device, and the coarse
    mapping of read batches against it.

    segments (parallel/segments.py): index and stage only these window
    spans; results then carry SEGMENT indices in chromosome_id and
    LOCAL window ordinals in global_window_id, which the region-sharded
    mapper converts back.  build_direct_probe=False keeps the binary-search
    probe (no cuckoo table), for several regions sharing one device.
    build_index=False stages the genome and the window geometry only (the
    table-sharded mapper, parallel/sharded.py, builds its own shards)."""

    supports_fused_scores = True

    def __init__(self, genome: Genome, opts: ProgramOptions, device,
                 sig_batch: int = 4096, load_index_from: str = "",
                 segments=None, build_direct_probe: bool = True,
                 build_index: bool = True):
        opts.validate()
        self.opts = opts
        self.genome = genome
        self.device = torch.device(device)
        self.segments = segments
        if segments is None:
            n_win = genome.total_num_windows(opts.kmer_length,
                                             opts.window_size)
        else:
            self.seg_local_base = np.concatenate(
                [[0], np.cumsum([s.num_windows() for s in segments])]
            ).astype(np.int64)
            n_win = int(self.seg_local_base[-1])
        self.hash_ids = np.arange(plan_num_hash_functions(opts, n_win),
                                  dtype=np.uint32)
        self._genome_s2 = None
        # dropped-keys mask of the read set (parity mode); None until
        # ensure_read_drops or map_reads sets it
        self.dropped = None
        # (ids [N, K] uint32, ori [N, K] int8) of the last map_reads with
        # collect_candidates
        self.last_candidates = None
        # the batch steps' CapturedSteps by shape, outputs and options, and
        # the key drops they were captured with
        self._steps = {}
        self._steps_dropped = None
        # the vote's tally word (ops/vote_kernel.py), which every batch
        # step adds to; map_reads reads it only while the tracer is on
        self._vote_tally = torch.zeros(1, dtype=torch.int64,
                                       device=self.device)
        self.index = None
        with tracing.span("index.build"):
            with tracing.span("index.table"):
                self._hash_ids_dev = torch.from_numpy(
                    self.hash_ids.astype(np.int64)).to(self.device)
                self.table = build_window_table(genome, self.device,
                                                segments, opts)
                win_pos, win_chrom, _ = self._window_geometry()
                self.table.win_pos = torch.from_numpy(win_pos).to(
                    self.device)
                self.table.win_chrom = torch.from_numpy(win_chrom).to(
                    self.device)
                self.table.num_windows = len(win_pos)
            if not build_index:
                return
            if load_index_from:
                self.index = mi.CsrIndex.load(load_index_from, self.device)
                if self.index.kmer_length != opts.kmer_length:
                    raise ValueError(
                        "loaded index was built with a different k")
            else:
                self.index = self._build_window_index(sig_batch)
            with tracing.span("index.buckets"):
                self.index.build_buckets()
            if opts.probe_cap < 1023 and build_direct_probe:
                with tracing.span("index.cuckoo"):
                    self.index.build_cuckoo()

    # -- index construction ------------------------------------------------
    def _window_geometry(self):
        """(win_pos, win_chrom, win_len) of every indexed window: TRUE
        positions and lengths; win_chrom indexes the segments of a
        segmented mapper."""
        k, ws = self.opts.kmer_length, self.opts.window_size
        if self.segments is None:
            spans = [(c, c, 0, self.genome.num_windows_in_chromosome(
                c, k, ws)) for c in range(self.genome.num_chromosomes)]
        else:
            spans = [(s, seg.chrom_id, seg.win_start, seg.win_stop)
                     for s, seg in enumerate(self.segments)]
        pos_l, chrom_l, len_l = [], [], []
        for axis, c, w0, w1 in spans:
            clen = self.genome.chromosome_length(c)
            p = np.arange(w0, w1, dtype=np.int64) * self.opts.window_stride
            pos_l.append(p)
            chrom_l.append(np.full(w1 - w0, axis, dtype=np.int64))
            len_l.append(np.minimum(clen - p, ws))
        return (np.concatenate(pos_l), np.concatenate(chrom_l),
                np.concatenate(len_l))

    def iter_window_superbatch_starts(self, sig_batch: int = 4096):
        """(gstart [n] offsets into genome_concat, lens [n]) per superbatch
        of sig_batch * 64 windows; bases are gathered on the device."""
        win_pos, win_chrom, win_len = self._window_geometry()
        chrom_offset = self.table.chrom_offset.cpu().numpy()
        superbatch = sig_batch * 64
        for s0 in range(0, len(win_pos), superbatch):
            s1 = min(s0 + superbatch, len(win_pos))
            yield (chrom_offset[win_chrom[s0:s1]] + win_pos[s0:s1],
                   win_len[s0:s1])

    def window_signatures(self, sig_batch: int = 4096):
        """(sig, valid) of every window: 3N [W, 2F] = [CT | GA] forward
        k-mers, parity [W, F] canonical k-mers.  Each superbatch's bases
        are gathered on the device and hashed into its rows of one output:
        one launch a superbatch on the card, the plain composition in
        chunks of sig_batch rows on the CPU."""
        opts = self.opts
        f = len(self.hash_ids)
        w = self.table.num_windows
        out = (torch.empty((w, 2 * f if opts.three_n_seeding else f),
                           dtype=torch.int64, device=self.device),
               torch.empty((w,), dtype=torch.bool, device=self.device))
        progress = ProgressReporter(w, label="hash windows",
                                    enabled=opts.show_progress)
        s0 = 0
        for gstart, lens in self.iter_window_superbatch_starts(sig_batch):
            s1 = s0 + len(lens)
            bdev = window_bases_device(
                self.table.genome_concat,
                torch.from_numpy(gstart).to(self.device), opts.window_size)
            ldev = torch.from_numpy(lens.astype(np.int32)).to(self.device)
            minhash.window_signatures(
                bdev, ldev, opts.kmer_length, self._hash_ids_dev,
                opts.three_n_seeding, sig_batch,
                out=(out[0][s0:s1], out[1][s0:s1]))
            s0 = s1
            progress.add(len(lens))
        if opts.show_progress:
            progress.finish()
        return out

    def _build_window_index(self, sig_batch: int) -> mi.CsrIndex:
        """Window signatures, then the CSR build, all on the device."""
        with tracing.span("index.signatures"):
            sigs = self.window_signatures(sig_batch)
        with tracing.span("index.csr"):
            return mi.build_csr_index_device(*sigs, self.opts.kmer_length,
                                             self.hash_ids)

    def save_index(self, path: str) -> None:
        self.index.save(path)

    # -- read-side key dropping (parity mode) ------------------------------
    def ensure_read_drops(self, read_bases: np.ndarray,
                          read_lengths: np.ndarray) -> None:
        """The dropped-keys mask from the FULL read set: keys carried by
        more than max_results_per_map reads are invisible to every probe
        of that table (the reference's read-index drop rule).  A chunked
        caller runs this over all reads before its per-chunk map_reads.
        No-op in 3N mode or when already computed."""
        opts = self.opts
        if opts.three_n_seeding or self.dropped is not None:
            return
        sigs, valid = [], []
        for s0 in range(0, read_bases.shape[0], opts.batchsize):
            sl = slice(s0, s0 + opts.batchsize)
            sg, v = minhash.minhash_signatures(
                torch.from_numpy(np.ascontiguousarray(
                    read_bases[sl])).to(self.device),
                torch.from_numpy(np.ascontiguousarray(
                    read_lengths[sl]).astype(np.int32)).to(self.device),
                opts.kmer_length, self._hash_ids_dev)
            sigs.append(sg.cpu().numpy().astype(np.uint32))
            valid.append(v.cpu().numpy())
        if not sigs:
            return
        dk, dn = mi.build_dropped_keys(np.concatenate(sigs),
                                       np.concatenate(valid),
                                       opts.max_results_per_map)
        self.dropped = (
            torch.from_numpy(dk.astype(np.int64)).to(self.device),
            torch.from_numpy(dn.astype(np.int64)).to(self.device))

    def ensure_empty_drops(self) -> None:
        if self.dropped is None:
            f = self.index.num_tables
            self.dropped = (
                torch.full((f, 1), SENTINEL, dtype=torch.int64,
                           device=self.device),
                torch.zeros((f,), dtype=torch.int64, device=self.device))

    # -- the per-batch step --------------------------------------------------
    def _map_batch(self, read_bases: torch.Tensor, read_len: torch.Tensor,
                   read_valid: torch.Tensor, collect_candidates: bool = False):
        """One read batch -> (packed [B, 7] int32: ori, hamming, shift,
        chrom, pos, window id (-1 unmapped), bs strand; overflow [5]
        int64 in OVERFLOW_KEYS order), and with collect_candidates the
        voted candidate ids [B, K] and their SHD orientations [B, K]."""
        opts = self.opts
        b = read_bases.shape[0]
        kcap = opts.candidates_per_read_cap
        idx, t = self.index, self.table
        if opts.three_n_seeding:
            sigs, sig_valid = minhash.signatures_3n_pair(
                read_bases, read_len, opts.kmer_length, self._hash_ids_dev)
        else:
            sigs, sig_valid = minhash.minhash_signatures(
                read_bases, read_len, opts.kmer_length, self._hash_ids_dev)
        sig_valid = sig_valid & read_valid
        self.ensure_empty_drops()
        cuckoo_kw = {}
        if idx.cuckoo_keys is not None:
            cuckoo_kw = dict(cuckoo=(idx.cuckoo_keys, idx.cuckoo_payload),
                             cuckoo_bits=idx.cuckoo_bits,
                             cuckoo_seeds=idx.cuckoo_seeds)

        def probe(sig_block):
            return mi.probe_tables_stats(
                idx.keys, idx.offsets, idx.values, idx.num_keys, sig_block,
                sig_valid, opts.probe_cap, dropped_keys=self.dropped,
                bucket_start=idx.bucket_start, probe_steps=idx.probe_steps,
                tail_budget=b * opts.probe_tail_budget_per_read,
                head_budget=b * opts.probe_head_budget_per_read,
                **cuckoo_kw)

        cand, _, stats = probe(sigs)
        stats = stats[None]
        if opts.undirectional:
            # PBAT strands: the same 2F tables probed with the mirrored
            # query spaces, CT(RC read) against the CT tables and GA(read)
            # against the GA tables; the vote merges all 4F lists
            sigs_u, _ = minhash.signatures_3n_pair(
                read_bases, read_len, opts.kmer_length, self._hash_ids_dev,
                mirror=True)
            cand_u, _, stats_u = probe(sigs_u)
            cand = torch.cat([cand, cand_u], dim=0)            # [4F, N, C]
            stats = torch.cat([stats, stats_u[None]])
        ids, _, num_kept = mi.vote_candidates_fnc_auto(
            cand, opts.min_table_hits, kcap, self._vote_tally)
        packed, ori, overflow = coarse_pairs_best(
            ids, read_bases, read_len, opts, t.genome_hi, t.genome_lo,
            t.win_pos, t.win_chrom, t.chrom_offset, t.chrom_len, stats,
            num_kept)
        if collect_candidates:
            # the reference's COUNT_WINDOW_HITS instrumentation
            # (main_gpu.cu:555-574, 824-852): each read's candidate windows
            # after the vote and the SHD orientation of each
            return packed, overflow, ids, ori
        return packed, overflow

    def _batch_step(self, read_bases: torch.Tensor, read_len: torch.Tensor,
                    read_valid: torch.Tensor, with_scores: bool = False,
                    collect_candidates: bool = False):
        """The eager batch step: _map_batch's (packed, overflow[, ids,
        ori]), then with_scores the fused STEP 2 of the same batch
        (scores, tb_ops, tb_status): the JAX engine's _map_batch_impl and
        _map_batch_scored_at_impl.  A CapturedStep captures and replays
        it; it stays callable as it is."""
        out = self._map_batch(read_bases, read_len, read_valid,
                              collect_candidates)
        if with_scores:
            t = self.table
            out = (*out, *fused_step2_scores(
                self.opts, t.chrom_offset, t.chrom_len, self.genome_s2(),
                read_bases, read_len, out[0]))
        return out

    def _run_step(self, bases, lens, valid, with_scores: bool,
                  collect_candidates: bool):
        """One batch through its CapturedStep (one replay on a CUDA
        device, captured at its first run; the eager step on the CPU):
        the step's static outputs, which the next run overwrites.  The
        key drops and the STEP-2 genome are set before any capture, outside
        the graph pool, and a replaced drop mask drops the steps captured
        with the old one."""
        self.ensure_empty_drops()
        if with_scores:
            self.genome_s2()
        if self._steps_dropped is not self.dropped:
            self._steps.clear()
            self._steps_dropped = self.dropped
        key = (tuple(bases.shape), with_scores, collect_candidates,
               graphs.options_key(self.opts))
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = graphs.CapturedStep((bases, lens,
                                                           valid))
        return step.run(functools.partial(
            self._batch_step, with_scores=with_scores,
            collect_candidates=collect_candidates), bases, lens, valid)

    def _map_batch_at(self, all_bases, all_lens, all_valid, start: int,
                      bsz: int, collect_candidates: bool = False):
        """Rows start:start + bsz of a staged pool, one step: the static
        (packed, overflow[, ids, ori]); copy them out before the next
        batch runs."""
        sl = slice(start, start + bsz)
        return self._run_step(all_bases[sl], all_lens[sl], all_valid[sl],
                              False, collect_candidates)

    def _map_batch_scored_at(self, all_bases, all_lens, all_valid,
                             start: int, bsz: int):
        """_map_batch_at with the fused STEP 2 in the same step: the static
        (packed, overflow, scores [10, 2 bsz], tb_ops, tb_status)."""
        sl = slice(start, start + bsz)
        return self._run_step(all_bases[sl], all_lens[sl], all_valid[sl],
                              True, False)

    def _pool_device(self, all_bases, all_lens, all_valid, n_pad: int,
                     bsz: int, with_scores: bool, collect_candidates: bool):
        """Every batch of a staged pool, one step each, each step's outputs
        copied into the pool's results on the device before the next step
        runs: the step's outputs over n_pad rows (overflow summed)."""
        if n_pad <= 0 or n_pad % bsz or all_bases.shape[0] < n_pad:
            raise ValueError(f"a staged pool of {all_bases.shape[0]} rows "
                             f"cannot run {n_pad} in batches of {bsz}")
        # the batch axis of each output; None: summed over the batches
        axes = ((0, None) + ((0, 0) if collect_candidates else ())
                + ((1, 0, 0) if with_scores else ()))
        nb = n_pad // bsz
        outs = None
        for i in range(nb):
            sl = slice(i * bsz, (i + 1) * bsz)
            got = self._run_step(all_bases[sl], all_lens[sl], all_valid[sl],
                                 with_scores, collect_candidates)
            if outs is None:
                outs = [torch.zeros_like(x) if a is None else x.new_empty(
                    x.shape[:a] + (x.shape[a] * nb,) + x.shape[a + 1:])
                        for x, a in zip(got, axes)]
            for dst, x, a in zip(outs, got, axes):
                if a is None:
                    dst += x
                else:
                    dst.narrow(a, i * x.shape[a], x.shape[a]).copy_(x)
        return tuple(outs)

    def _map_reads_device(self, all_bases, all_lens, all_valid, n_pad: int,
                          bsz: int, collect_candidates: bool = False):
        """Every batch of a staged pool, results on the device: (packed
        [n_pad, 7], overflow [5], (ids, ori) [n_pad, K] with
        collect_candidates, else None).  Nothing is copied to the host, so a
        caller driving several mappers (the regions) enqueues all of
        their work first."""
        out = self._pool_device(all_bases, all_lens, all_valid, n_pad, bsz,
                                False, collect_candidates)
        return out[0], out[1], (out[2:] if collect_candidates else None)

    def _map_reads_device_scored(self, all_bases, all_lens, all_valid,
                                 n_pad: int, bsz: int):
        """_map_reads_device with the fused STEP 2: (packed [n_pad, 7],
        overflow [5], scores [10, 2 n_pad] int16, tb_ops [2 n_pad, E]
        uint8, tb_status [2 n_pad] int8), on the device."""
        return self._pool_device(all_bases, all_lens, all_valid, n_pad, bsz,
                                 True, False)

    def map_pool_scanned(self, all_bases, all_lens, all_valid, n_pad: int,
                         bsz: int):
        """The coarse step over a staged pool, one step a batch written
        into a preallocated [n_pad, 7] (the JAX engine's one-dispatch
        lax.scan): (packed, overflow [5]) on the device."""
        return self._pool_device(all_bases, all_lens, all_valid, n_pad, bsz,
                                 False, False)

    def stage_reads_device(self, read_bases: np.ndarray,
                           read_lengths: np.ndarray):
        """Upload reads once, padded to max_read_length columns and a
        batchsize multiple of rows -> (bases, lens, valid, n_pad): the one
        batch shape of every pool, so a short last pool replays the same
        graph."""
        opts = self.opts
        n, lr = read_bases.shape
        if lr > opts.max_read_length:
            raise ValueError(f"reads longer than max_read_length "
                             f"({lr} > {opts.max_read_length})")
        bsz = opts.batchsize
        n_pad = ((n + bsz - 1) // bsz) * bsz
        bases = np.zeros((n_pad, opts.max_read_length), np.int8)
        bases[:n, :lr] = read_bases
        lens = np.zeros(n_pad, np.int32)
        lens[:n] = read_lengths
        return (torch.from_numpy(bases).to(self.device),
                torch.from_numpy(lens).to(self.device),
                torch.arange(n_pad, device=self.device) < n, n_pad)

    def resident_bytes(self) -> int:
        """Device bytes held by the index + staged genome."""
        t = self.table
        return self.index.memory_bytes() + sum(
            x.numel() * x.element_size()
            for x in (t.genome_concat, t.genome_hi, t.genome_lo, t.win_pos,
                      t.win_chrom, t.chrom_offset, t.chrom_len))

    def read_pool_size(self, n: int, bsz: int) -> int:
        """Reads staged at once under the --memTotal budget (all of them
        without one)."""
        limit = self.opts.memory_total_limit
        n_pad = ((n + bsz - 1) // bsz) * bsz
        if limit <= 0:
            return n_pad
        lr = self.opts.max_read_length
        per_read = lr + 4 + 1 + 24 + 16 * ((lr + 31) // 32)
        pool = int((limit - self.resident_bytes()) // per_read)
        return min(max(bsz, (pool // bsz) * bsz), n_pad)

    def memory_bytes(self) -> int:
        """Device bytes of the window index."""
        return self.index.memory_bytes()

    def stats(self, overflow: np.ndarray) -> Dict[str, int]:
        out = {k: int(v) for k, v in zip(OVERFLOW_KEYS, overflow)}
        out["cuckoo_direct_probe"] = int(self.index.cuckoo_keys is not None)
        return out

    def genome_s2(self) -> torch.Tensor:
        """The STEP-2 genome codes on the device, staged at first use."""
        if self._genome_s2 is None:
            self._genome_s2 = torch.from_numpy(build_genome_s2(
                self.genome, self.segments, self.opts)).to(self.device)
        return self._genome_s2

    def map_reads_packed(self, read_bases: np.ndarray,
                         read_lengths: np.ndarray, with_scores: bool = False,
                         collect_candidates: bool = False):
        """The coarse step over all reads with the key drops as they stand
        (map_reads sets them first): (packed [N, 7] int32 rows as
        _map_batch packs them, overflow [5] int64, and with_scores the
        fused STEP-2 bundle (scores [10, 2N] int16, tb_ops [2N, E] uint8,
        tb_status [2N] int8), else None), numpy on the host.
        collect_candidates sets last_candidates."""
        n = read_bases.shape[0]
        pool_n = self.read_pool_size(n, self.opts.batchsize) if n else 0
        parts = []
        for c0, c1 in pool_ranges(n, pool_n):
            with tracing.span("engine.stage"):
                staged = self.stage_reads_device(read_bases[c0:c1],
                                                 read_lengths[c0:c1])
            with tracing.span("engine.enqueue"):
                parts.append(self.map_staged(*staged, c1 - c0, with_scores,
                                             collect_candidates))
        with tracing.span("engine.fetch"):
            return self.fetch_results(parts, with_scores, collect_candidates)

    def map_staged(self, bases, lens, valid, n_pad: int, n: int,
                   with_scores: bool = False,
                   collect_candidates: bool = False):
        """Every batch of a staged pool of n reads (n_pad rows, as
        stage_reads_device returns it), its results left on the device:
        (packed [n, 7], overflow [5], the bundle (scores [10, 2n], tb_ops
        [2n, E], tb_status [2n]) or None, (ids, ori) [n, K] or None)."""
        out = self._pool_device(bases, lens, valid, n_pad,
                                self.opts.batchsize, with_scores,
                                collect_candidates)
        bundle = cand = None
        if with_scores:
            sc, to, ts = out[-3:]
            bundle = (sc[:, :2 * n], to[:2 * n], ts[:2 * n])
        if collect_candidates:
            cand = (out[2][:n], out[3][:n])
        return out[0][:n], out[1], bundle, cand

    def fetch_results(self, parts, with_scores: bool = False,
                      collect_candidates: bool = False):
        """map_staged's results of consecutive pools, joined and copied to
        the host: (packed, overflow, bundle) as map_reads_packed returns
        them; collect_candidates sets last_candidates."""
        def host(xs, dim=0):
            return torch.cat(xs, dim=dim).cpu().numpy()
        packed = (host([p[0] for p in parts]) if parts
                  else np.zeros((0, 7), np.int32))
        overflow = (sum(p[1] for p in parts).cpu().numpy() if parts
                    else np.zeros(5, np.int64))
        if collect_candidates:
            kcap = self.opts.candidates_per_read_cap
            ids, ori = ([host([p[3][i] for p in parts]) for i in range(2)]
                        if parts else [np.zeros((0, kcap))] * 2)
            self.last_candidates = (ids.astype(np.uint32),
                                    ori.astype(np.int8))
        bundle = None
        if with_scores:
            if parts:
                bundle = tuple(host([p[2][i] for p in parts],
                                    dim=1 if i == 0 else 0)
                               for i in range(3))
            else:
                bundle = (np.zeros((10, 0), np.int16),
                          np.zeros((0, 1), np.uint8), np.zeros(0, np.int8))
        return packed, overflow, bundle

    def map_reads(self, read_bases: np.ndarray, read_lengths: np.ndarray,
                  with_scores: bool = False, collect_candidates: bool = False):
        """Map all reads: [N, L] int8 padded bases, [N] lengths.

        with_scores: also run the fused STEP 2 per batch and return
        (results, (scores [10, 2N] int16, tb_ops [2N, 48] uint8,
        tb_status [2N] int8)), or (results, scores) when
        opts.step2_device_traceback is False.  collect_candidates: also
        set last_candidates = (ids [N, K] uint32, SENTINEL where empty;
        ori [N, K] int8), every read's voted candidate windows and the SHD
        orientation of each (eval/window_stats.py reads them)."""
        with tracing.span("engine.map_reads",
                          reads=len(read_lengths)) as sp:
            # parity mode: the read-side key drops of this read set, unless
            # a chunked caller has set them from the whole set already
            self.ensure_read_drops(read_bases, read_lengths)
            if sp is not None:
                self._vote_tally.zero_()
            packed, overflow, bundle = self.map_reads_packed(
                read_bases, read_lengths, with_scores, collect_candidates)
            if sp is not None:
                # rows mapped, and of those the ones the mirrored (G->A)
                # space won under --undirectional
                mapped = packed[:, 0] != 3
                sp.attrs["mapped"] = int(np.count_nonzero(mapped))
                sp.attrs["mirrored"] = int(np.count_nonzero(
                    mapped & (packed[:, 6] == 1)))
                sp.attrs.update(zip(OVERFLOW_KEYS, overflow.tolist()))
                # the vote's wide path (F*C above 2,048): ids present, and
                # reads with more than 1,024 left to sort after its sift
                sp.attrs["vote_ids"], sp.attrs["vote_wide_rows"] = \
                    vote_kernel.tally_counts(self._vote_tally)
        results = CoarseResults(
            orientation=packed[:, 0].astype(np.int8),
            hamming=packed[:, 1].astype(np.int32),
            shift=packed[:, 2].astype(np.int32),
            chromosome_id=packed[:, 3].astype(np.int32),
            position=packed[:, 4].astype(np.int32),
            global_window_id=packed[:, 5].astype(np.uint32),
            stats=self.stats(overflow),
            bs_strand=packed[:, 6].astype(np.int8))
        if not with_scores:
            return results
        return results, (bundle if self.opts.step2_device_traceback
                         else bundle[0])
