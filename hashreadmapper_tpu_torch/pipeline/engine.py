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
plain versions, with identical results).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..align import sw
from ..config import ProgramOptions
from ..index import minhash_index as mi
from ..io.genome import Genome
from ..ops import bandtb, encode, minhash, shd, swdev
from ..ops.shd_kernel import pack_genome_planes
from ..utils.progress import ProgressReporter

SENTINEL = 0xFFFFFFFF
_BIG = 0x3FFFFFFF
OVERFLOW_KEYS = ("probe_overflow", "vote_overflow", "pair_budget_overflow",
                 "probe_tail_overflow", "probe_head_overflow")


def unsupported(what: str, item: str):
    """The error for an option outside this port's slice."""
    return NotImplementedError(
        f"{what} is not ported to hashreadmapper_tpu_torch yet "
        f"(ROADMAP.md, {item}); use hashreadmapper_tpu")


def check_supported(opts: ProgramOptions) -> None:
    if opts.mesh_data is not None or opts.mesh_table is not None:
        raise unsupported("--mesh", "Queue 1 item 15")
    if opts.num_regions > 1:
        raise unsupported("--regions", "Queue 1 item 14")


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


def build_window_table(genome: Genome, device) -> WindowTable:
    """Stage the genome and its packed bit planes on `device`."""
    lens = [genome.chromosome_length(c) for c in range(genome.num_chromosomes)]
    total = sum(lens)
    if total >= 2**31:
        raise unsupported(f"a genome of {total} bases (>= 2**31)",
                          "Queue 1 item 14")
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    concat = torch.from_numpy(np.concatenate(
        [genome.bases[c].astype(np.int8)
         for c in range(genome.num_chromosomes)])).to(device)
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
                      chrom_offset, chrom_len):
    """Voted candidate ids [B, K] -> SHD -> per-read best.

    With 0 < opts.shd_pairs_per_read_budget < K the valid (read,
    candidate) pairs are compacted to B * budget before SHD; pairs beyond
    it score as rejected and are counted in pair_drops.  Under
    opts.undirectional every pair is also evaluated in the mirrored (PBAT)
    collapse spaces, and the mirrored result wins only when it is not NONE
    and the directional one is NONE or has strictly larger Hamming.
    Returns (out_ori, out_ham, out_shift, out_chrom, out_pos, best_gwin,
    has, out_strand, pair_drops); out_strand is 1 where the mirrored space
    won.
    """
    b, kcap = ids.shape
    dev = ids.device
    gwin = ids.reshape(-1)
    pair_valid = gwin != SENTINEL
    gwin_full = torch.where(pair_valid, gwin, torch.zeros_like(gwin))
    nk = b * kcap
    kb = opts.shd_pairs_per_read_budget
    compact = 0 < kb < kcap
    if compact:
        budget = b * kb
        rank = torch.cumsum(pair_valid.to(torch.int64), dim=0) - 1
        n_valid = pair_valid.sum()
        slot = torch.where(pair_valid & (rank < budget), rank,
                           torch.full_like(rank, budget))
        pair_sel = torch.zeros(budget + 1, dtype=torch.int64,
                               device=dev).scatter_(
            0, slot, torch.arange(nk, device=dev))[:budget]
        sel_valid = torch.arange(budget, device=dev) < n_valid
        pair_drops = (n_valid - budget).clamp(min=0)
    else:
        pair_sel = torch.arange(nk, device=dev)
        sel_valid = pair_valid
        pair_drops = torch.zeros((), dtype=torch.int64, device=dev)

    gwin_c = gwin_full[pair_sel]
    ridx = pair_sel // kcap
    pos = win_pos[gwin_c]
    chrom = win_chrom[gwin_c]
    rl_rep = read_len.to(torch.int64)[ridx]
    loc = shd.extended_window_location(pos, chrom_len[chrom], rl_rep,
                                       opts.window_size)
    params = shd.ShdParams(
        window_size=opts.window_size,
        max_ext_len=opts.window_size + opts.max_read_length,
        max_read_len=read_bases.shape[1],
        max_hamming_percent=opts.max_hamming_percent)

    gstart = chrom_offset[chrom] + loc.start

    def eval_pairs(undirectional):
        return shd.shd_pairs_best(
            read_bases, read_len, ridx, genome_hi, genome_lo, gstart,
            loc.length, loc.left, sel_valid, params,
            three_n=opts.three_n_seeding, undirectional=undirectional)

    res = eval_pairs(False)
    res_ham, res_shf, res_ori = res.hamming, res.shift, res.orientation
    res_strand = torch.zeros_like(res_ham)
    if opts.undirectional:
        res_u = eval_pairs(True)
        better_u = (res_u.orientation != shd.NONE) & (
            (res_ori == shd.NONE) | (res_u.hamming < res_ham))
        res_ham = torch.where(better_u, res_u.hamming, res_ham)
        res_shf = torch.where(better_u, res_u.shift, res_shf)
        res_ori = torch.where(better_u, res_u.orientation, res_ori)
        res_strand = better_u.to(res_strand.dtype)

    if compact:
        tgt = torch.where(sel_valid, pair_sel, torch.full_like(pair_sel, nk))

        def spread(x, fill):
            buf = torch.full((nk + 1,), fill, dtype=x.dtype, device=dev)
            buf[tgt] = x
            return buf[:nk]
        res_ham, res_shf = spread(res_ham, 0), spread(res_shf, 0)
        res_ori = spread(res_ori, shd.NONE)
        res_strand = spread(res_strand, 0)

    ham = res_ham.reshape(b, kcap)
    shf = res_shf.reshape(b, kcap)
    ori = res_ori.reshape(b, kcap)
    good = ori != shd.NONE
    # best per read: min hamming, then the earliest window (ids ascend in
    # genome order); first-index argmin over the masked window ids
    ham_m = torch.where(good, ham, torch.full_like(ham, _BIG))
    min_h = ham_m.amin(dim=1, keepdim=True)
    gw = gwin_full.reshape(b, kcap)
    slot_key = torch.where(good & (ham_m == min_h), gw,
                           torch.full_like(gw, _BIG))
    best_slot = slot_key.argmin(dim=1, keepdim=True)
    has = good.any(dim=1)

    def take(m):
        return torch.gather(m, 1, best_slot)[:, 0]
    zero = torch.zeros(b, dtype=torch.int64, device=dev)
    best_gwin = take(gw)
    out_ori = torch.where(has, take(ori).to(torch.int64),
                          torch.full_like(zero, shd.NONE))
    out_ham = torch.where(has, take(ham).to(torch.int64), zero)
    out_shift = torch.where(has, take(shf).to(torch.int64), zero)
    out_strand = torch.where(
        has, take(res_strand.reshape(b, kcap)).to(torch.int64), zero)
    out_chrom = torch.where(has, win_chrom[best_gwin], zero)
    out_pos = torch.where(has, win_pos[best_gwin], zero)
    return (out_ori, out_ham, out_shift, out_chrom, out_pos, best_gwin, has,
            out_strand, pair_drops)


def build_genome_s2(genome: Genome) -> np.ndarray:
    """[G] int8 STEP-2 genome codes 0..4, chromosomes concatenated as in
    the window table.  Unlike genome_concat, N stays code 4
    (align.sw.TRANSLATE), which the score passes treat as a mismatch.
    The JAX package nibble-packs the same codes to work around TPU
    gathers (engine.build_genome_s2); here they stay one byte each."""
    return np.concatenate([sw.TRANSLATE[np.asarray(a)]
                           for a in genome.seqs_ascii]).astype(np.int8)


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
    win_t = genome_s2[gidx.clamp(max=genome_s2.shape[0] - 1)]
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


class CoarseMapper:
    """The window index of one genome on one device, and the coarse
    mapping of read batches against it."""

    supports_fused_scores = True

    def __init__(self, genome: Genome, opts: ProgramOptions, device,
                 sig_batch: int = 4096, load_index_from: str = ""):
        opts.validate()
        check_supported(opts)
        self.opts = opts
        self.genome = genome
        self.device = torch.device(device)
        n_win = genome.total_num_windows(opts.kmer_length, opts.window_size)
        self.hash_ids = np.arange(plan_num_hash_functions(opts, n_win),
                                  dtype=np.uint32)
        self._hash_ids_dev = torch.from_numpy(
            self.hash_ids.astype(np.int64)).to(self.device)
        self.table = build_window_table(genome, self.device)
        win_pos, win_chrom, _ = self._window_geometry()
        self.table.win_pos = torch.from_numpy(win_pos).to(self.device)
        self.table.win_chrom = torch.from_numpy(win_chrom).to(self.device)
        self.table.num_windows = len(win_pos)
        if load_index_from:
            self.index = mi.CsrIndex.load(load_index_from, self.device)
            if self.index.kmer_length != opts.kmer_length:
                raise ValueError("loaded index was built with a different k")
        else:
            self.index = self._build_window_index(sig_batch)
        self.index.build_buckets()
        if opts.probe_cap < 1023:
            self.index.build_cuckoo()
        self._genome_s2 = None
        # dropped-keys mask of the read set (parity mode); None until
        # ensure_read_drops or map_reads sets it
        self.dropped = None

    # -- index construction ------------------------------------------------
    def _window_geometry(self):
        k, ws = self.opts.kmer_length, self.opts.window_size
        pos_l, chrom_l, len_l = [], [], []
        for c in range(self.genome.num_chromosomes):
            clen = self.genome.chromosome_length(c)
            n = self.genome.num_windows_in_chromosome(c, k, ws)
            p = np.arange(n, dtype=np.int64) * self.opts.window_stride
            pos_l.append(p)
            chrom_l.append(np.full(n, c, dtype=np.int64))
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
        return mi.build_csr_index_device(
            *self.window_signatures(sig_batch), self.opts.kmer_length,
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
                   read_valid: torch.Tensor):
        """One read batch -> (packed [B, 7] int32: ori, hamming, shift,
        chrom, pos, window id (-1 unmapped), bs strand; overflow [5]
        int64 in OVERFLOW_KEYS order)."""
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
            return mi.probe_tables(
                idx.keys, idx.offsets, idx.values, idx.num_keys, sig_block,
                sig_valid, opts.probe_cap, dropped_keys=self.dropped,
                bucket_start=idx.bucket_start, probe_steps=idx.probe_steps,
                tail_budget=b * opts.probe_tail_budget_per_read,
                head_budget=b * opts.probe_head_budget_per_read,
                **cuckoo_kw)

        cand, counts, tail_drops, head_drops = probe(sigs)
        if opts.undirectional:
            # PBAT strands: the same 2F tables probed with the mirrored
            # query spaces, CT(RC read) against the CT tables and GA(read)
            # against the GA tables; the vote merges all 4F lists
            sigs_u, _ = minhash.signatures_3n_pair(
                read_bases, read_len, opts.kmer_length, self._hash_ids_dev,
                mirror=True)
            cand_u, counts_u, tail_u, head_u = probe(sigs_u)
            cand = torch.cat([cand, cand_u], dim=0)            # [4F, N, C]
            counts = torch.cat([counts, counts_u], dim=0)
            tail_drops = tail_drops + tail_u
            head_drops = head_drops + head_u
        ids, _, num_kept = mi.vote_candidates_fnc_auto(
            cand, opts.min_table_hits, kcap)
        (out_ori, out_ham, out_shift, out_chrom, out_pos, best_gwin, has,
         out_strand, pair_drops) = coarse_pairs_best(
            ids, read_bases, read_len, opts, t.genome_hi, t.genome_lo,
            t.win_pos, t.win_chrom, t.chrom_offset, t.chrom_len)
        out_gwin = torch.where(has, best_gwin, torch.full_like(best_gwin, -1))
        packed = torch.stack(
            [out_ori, out_ham, out_shift, out_chrom, out_pos, out_gwin,
             out_strand], dim=1).to(torch.int32)
        overflow = torch.stack([(counts > opts.probe_cap).sum(),
                                (num_kept > kcap).sum(), pair_drops,
                                tail_drops, head_drops])
        return packed, overflow

    def stage_reads_device(self, read_bases: np.ndarray,
                           read_lengths: np.ndarray):
        """Upload reads once, padded to max_read_length columns and a
        batchsize multiple of rows -> (bases, lens, valid, n_pad)."""
        opts = self.opts
        n, lr = read_bases.shape
        bsz = opts.batchsize
        n_pad = ((n + bsz - 1) // bsz) * bsz
        bases = np.zeros((n_pad, max(lr, opts.max_read_length)), np.int8)
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

    def stats(self, overflow: np.ndarray) -> Dict[str, int]:
        out = {k: int(v) for k, v in zip(OVERFLOW_KEYS, overflow)}
        out["cuckoo_direct_probe"] = int(self.index.cuckoo_keys is not None)
        return out

    def genome_s2(self) -> torch.Tensor:
        """The STEP-2 genome codes on the device, staged at first use."""
        if self._genome_s2 is None:
            self._genome_s2 = torch.from_numpy(
                build_genome_s2(self.genome)).to(self.device)
        return self._genome_s2

    def map_reads(self, read_bases: np.ndarray, read_lengths: np.ndarray,
                  with_scores: bool = False):
        """Map all reads: [N, L] int8 padded bases, [N] lengths.

        with_scores: also run the fused STEP 2 per batch and return
        (results, (scores [10, 2N] int16, tb_ops [2N, 48] uint8,
        tb_status [2N] int8)), or (results, scores) when
        opts.step2_device_traceback is False."""
        opts = self.opts
        n, lr = read_bases.shape
        if lr > opts.max_read_length:
            raise ValueError(f"reads longer than max_read_length "
                             f"({lr} > {opts.max_read_length})")
        # parity mode: the read-side key drops of this read set, unless a
        # chunked caller has set them from the whole set already
        self.ensure_read_drops(read_bases, read_lengths)
        bsz = opts.batchsize
        packed_parts, overflow = [], torch.zeros(5, dtype=torch.int64,
                                                 device=self.device)
        step2_parts = []
        pool_n = self.read_pool_size(n, bsz) if n else 0
        for c0 in range(0, n, pool_n or 1):
            c1 = min(c0 + pool_n, n)
            bases, lens, valid, n_pad = self.stage_reads_device(
                read_bases[c0:c1], read_lengths[c0:c1])
            pool_parts, pool_step2 = [], []
            for s in range(0, n_pad, bsz):
                sl = slice(s, s + bsz)
                p, o = self._map_batch(bases[sl], lens[sl], valid[sl])
                pool_parts.append(p)
                overflow += o
                if with_scores:
                    t = self.table
                    pool_step2.append(fused_step2_scores(
                        opts, t.chrom_offset, t.chrom_len, self.genome_s2(),
                        bases[sl], lens[sl], p))
            packed_parts.append(torch.cat(pool_parts)[:c1 - c0])
            if with_scores:
                k = 2 * (c1 - c0)
                step2_parts.append((
                    torch.cat([x[0] for x in pool_step2], dim=1)[:, :k],
                    torch.cat([x[1] for x in pool_step2])[:k],
                    torch.cat([x[2] for x in pool_step2])[:k]))
        packed = (torch.cat(packed_parts).cpu().numpy() if packed_parts
                  else np.zeros((0, 7), np.int32))
        results = CoarseResults(
            orientation=packed[:, 0].astype(np.int8),
            hamming=packed[:, 1].astype(np.int32),
            shift=packed[:, 2].astype(np.int32),
            chromosome_id=packed[:, 3].astype(np.int32),
            position=packed[:, 4].astype(np.int32),
            global_window_id=packed[:, 5].astype(np.uint32),
            stats=self.stats(overflow.cpu().numpy()),
            bs_strand=packed[:, 6].astype(np.int8))
        if not with_scores:
            return results
        if step2_parts:
            bundle = tuple(torch.cat([x[i] for x in step2_parts],
                                     dim=1 if i == 0 else 0).cpu().numpy()
                           for i in range(3))
        else:
            bundle = (np.zeros((10, 0), np.int16), np.zeros((0, 1), np.uint8),
                      np.zeros(0, np.int8))
        return results, (bundle if opts.step2_device_traceback
                         else bundle[0])
