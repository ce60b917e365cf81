"""Window-streaming orientation: the read index resident, genome windows
streamed through it (counterpart of
hashreadmapper_tpu/pipeline/window_stream.py).

This is the reference's own architecture, for a read set that fits on the
device when the genome's window index would not:

  window batch -> window bases gathered on the device -> signatures
  -> probe the READ index -> min-table-hits vote (candidate read ids per
  window, ascending) -> SHD of each candidate read against the extended
  window -> host merge of the per-(window, read) rows in genome order
  (first window wins, a strictly smaller Hamming distance replaces).

The results equal the inverted engine's (pipeline/engine.py) where no cap
drops candidates differently in the two orientations.  Parity mode
applies the read index's drop-all rule for keys carried by more than
max_results_per_map reads lazily, at probe time.  Every tensor lives on
the mapper's `device`: a CUDA device runs the hand-written kernels (the
signature stage, the vote, the fused SHD stage), the CPU their plain
versions, with identical results.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ProgramOptions
from ..index import minhash_index as mi
from ..io.genome import Genome
from ..ops import minhash, shd
from ..ops.shd_kernel import pack_genome_planes
from .engine import (OVERFLOW_KEYS, SENTINEL, CoarseResults, best_of_spaces,
                     compact_pairs, pair_spreader, window_bases_device)

# reads a block of the read index's signatures (one signature launch on
# the card; bounds the plain composition's memory on the CPU)
SIG_ROWS = 1 << 16


class WindowStreamMapper:
    """The read index of one read set on one device; map_genome streams a
    genome's windows through it."""

    def __init__(self, read_bases: np.ndarray, read_lengths: np.ndarray,
                 opts: ProgramOptions, device):
        opts.validate()
        self.opts = opts
        self.device = torch.device(device)
        n, lr = read_bases.shape
        bases = np.zeros((n, max(lr, opts.max_read_length)), np.int8)
        bases[:, :lr] = read_bases
        self.num_reads = n
        self.read_bases = torch.from_numpy(bases).to(self.device)
        self.read_lengths = torch.from_numpy(
            np.asarray(read_lengths, dtype=np.int32)).to(self.device)
        self.hash_ids = np.arange(opts.num_hash_functions, dtype=np.uint32)
        self._hash_ids_dev = torch.from_numpy(
            self.hash_ids.astype(np.int64)).to(self.device)
        sigs, valid = self.read_signatures()
        self.index = mi.build_csr_index_device(sigs, valid, opts.kmer_length,
                                               self.hash_ids)
        del sigs, valid
        self.index.build_buckets()
        if opts.three_n_seeding and opts.probe_cap < 1023:
            # the direct probe in 3N; parity keeps the binary search, whose
            # exact counts its drop-all rule compares
            self.index.build_cuckoo()

    def read_signatures(self):
        """The read index's keys, in row blocks of SIG_ROWS: 3N [N, 2F] =
        [CT(read) | GA(RC read)] (the mirror of the window index, so the
        candidate pairs are the inverted engine's), and under
        --undirectional [N, 4F] with [CT(RC read) | GA(read)] appended (the
        PBAT spaces); parity [N, F] canonical k-mers."""
        opts = self.opts
        k, ids = opts.kmer_length, self._hash_ids_dev
        sig_parts, valid_parts = [], []
        for s in range(0, self.num_reads, SIG_ROWS):
            rb = self.read_bases[s:s + SIG_ROWS]
            rl = self.read_lengths[s:s + SIG_ROWS]
            if opts.three_n_seeding:
                sig, valid = minhash.signatures_3n_pair(rb, rl, k, ids)
                if opts.undirectional:
                    sig_u, _ = minhash.signatures_3n_pair(rb, rl, k, ids,
                                                          mirror=True)
                    sig = torch.cat([sig, sig_u], dim=1)
            else:
                sig, valid = minhash.minhash_signatures(rb, rl, k, ids)
            sig_parts.append(sig)
            valid_parts.append(valid)
        f = len(self.hash_ids) * (
            (4 if opts.undirectional else 2) if opts.three_n_seeding else 1)
        if not sig_parts:
            return (torch.zeros((0, f), dtype=torch.int64,
                                device=self.device),
                    torch.zeros((0,), dtype=torch.bool, device=self.device))
        return torch.cat(sig_parts), torch.cat(valid_parts)

    def resident_bytes(self) -> int:
        """Device bytes held by the read index and the staged reads."""
        return self.index.memory_bytes() + sum(
            x.numel() * x.element_size()
            for x in (self.read_bases, self.read_lengths))

    def _window_batch(self, genome_concat, genome_hi, genome_lo, goff, clen,
                      win_pos, win_len, win_valid):
        """One batch of B windows of one chromosome (start goff in the
        staged genome, length clen) -> (packed [B*K, 5] int32 rows: read
        id (-1 where no pair was kept), hamming, shift, orientation, bs
        strand; overflow [5] int64 in OVERFLOW_KEYS order)."""
        opts = self.opts
        b = win_pos.shape[0]
        kcap = opts.candidates_per_read_cap
        idx = self.index
        win_bases = window_bases_device(genome_concat, goff + win_pos,
                                        opts.window_size)
        if opts.three_n_seeding:
            # [CT | GA] forward k-mers in one launch; the same two spaces
            # probe the PBAT table blocks under --undirectional
            sigs, sig_valid = minhash.window_signatures(
                win_bases, win_len, opts.kmer_length, self._hash_ids_dev,
                True, b)
            if opts.undirectional:
                sigs = torch.cat([sigs, sigs], dim=1)
        else:
            sigs, sig_valid = minhash.minhash_signatures(
                win_bases, win_len, opts.kmer_length, self._hash_ids_dev)
        sig_valid = sig_valid & win_valid
        cuckoo_kw = {}
        if idx.cuckoo_keys is not None:
            cuckoo_kw = dict(cuckoo=(idx.cuckoo_keys, idx.cuckoo_payload),
                             cuckoo_bits=idx.cuckoo_bits,
                             cuckoo_seeds=idx.cuckoo_seeds)
        cand, counts, tail_drops, head_drops = mi.probe_tables(
            idx.keys, idx.offsets, idx.values, idx.num_keys, sigs, sig_valid,
            opts.probe_cap, bucket_start=idx.bucket_start,
            probe_steps=idx.probe_steps,
            tail_budget=b * opts.probe_tail_budget_per_read,
            head_budget=b * opts.probe_head_budget_per_read,
            max_values_per_key=(0 if opts.three_n_seeding
                                else opts.max_results_per_map),
            **cuckoo_kw)
        ids, _, num_kept = mi.vote_candidates_fnc_auto(
            cand, opts.min_table_hits, kcap)

        rid = ids.reshape(-1)                               # [B*K] read ids
        pair_valid = rid != SENTINEL
        rid_full = torch.where(pair_valid, rid, torch.zeros_like(rid))
        nk = b * kcap
        pair_sel, sel_valid, pair_drops, compact = compact_pairs(
            pair_valid, b, kcap, opts.shd_pairs_per_read_budget)
        rid_c = rid_full[pair_sel]
        pos_rep = win_pos[pair_sel // kcap]
        r_len = self.read_lengths.to(torch.int64)[rid_c]
        loc = shd.extended_window_location(
            pos_rep, torch.full_like(pos_rep, clen), r_len, opts.window_size)
        params = shd.ShdParams(
            window_size=opts.window_size,
            max_ext_len=opts.window_size + opts.max_read_length,
            max_read_len=self.read_bases.shape[1],
            max_hamming_percent=opts.max_hamming_percent)
        gstart = goff + loc.start

        def eval_pairs(undirectional):
            return shd.shd_pairs_best(
                self.read_bases, self.read_lengths, rid_c, genome_hi,
                genome_lo, gstart, loc.length, loc.left, sel_valid, params,
                three_n=opts.three_n_seeding, undirectional=undirectional)

        res_ham, res_shf, res_ori, res_strand = best_of_spaces(
            eval_pairs, opts.undirectional)
        if compact:
            spread = pair_spreader(pair_sel, sel_valid, nk)
            res_ham, res_shf = spread(res_ham, 0), spread(res_shf, 0)
            res_ori = spread(res_ori, shd.NONE)
            res_strand = spread(res_strand, 0)
        out_rid = torch.where(pair_valid & (res_ori != shd.NONE), rid_full,
                              torch.full_like(rid_full, -1))
        packed = torch.stack(
            [out_rid, res_ham.to(torch.int64), res_shf.to(torch.int64),
             res_ori.to(torch.int64), res_strand.to(torch.int64)],
            dim=1).to(torch.int32)
        overflow = torch.stack([(counts > opts.probe_cap).sum(),
                                (num_kept > kcap).sum(), pair_drops,
                                tail_drops, head_drops])
        return packed, overflow

    def map_genome(self, genome: Genome) -> CoarseResults:
        """Stream every window of `genome` through the read index in
        batches of opts.batchsize windows of one chromosome; the per-read
        best hits, with one copy of the rows to the host at the end."""
        opts = self.opts
        dev = self.device
        lens = [genome.chromosome_length(c)
                for c in range(genome.num_chromosomes)]
        if sum(lens) >= 2**31:
            raise ValueError("the window stream stages fewer than 2**31 "
                             f"bases ({sum(lens)} asked)")
        chrom_offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(
            np.int64)
        concat = torch.from_numpy(np.concatenate(
            [genome.bases[c].astype(np.int8)
             for c in range(genome.num_chromosomes)])).to(dev)
        g_hi, g_lo = pack_genome_planes(concat)

        bsz = opts.batchsize
        kcap = opts.candidates_per_read_cap
        batches = list(genome.iter_window_batches(
            opts.kmer_length, opts.window_size, bsz))
        nb = len(batches)
        # every batch's positions, lengths and validity in one upload;
        # padding rows are position 0, length 0 and not valid
        pos = np.zeros((nb, bsz), np.int64)
        wlen = np.zeros((nb, bsz), np.int32)
        valid = np.zeros((nb, bsz), bool)
        for i, batch in enumerate(batches):
            pos[i, :len(batch.positions)] = batch.positions
            wlen[i, :len(batch.lengths)] = batch.lengths
            valid[i, :len(batch.positions)] = True
        pos_dev, wlen_dev, valid_dev = (torch.from_numpy(x).to(dev)
                                        for x in (pos, wlen, valid))
        packed_parts = []
        overflow = torch.zeros(5, dtype=torch.int64, device=dev)
        for i, batch in enumerate(batches):
            c = batch.chromosome_id
            packed, ovf = self._window_batch(
                concat, g_hi, g_lo, int(chrom_offsets[c]), lens[c],
                pos_dev[i], wlen_dev[i], valid_dev[i])
            packed_parts.append(packed)
            overflow += ovf
        all_packed = (torch.cat(packed_parts).cpu().numpy() if packed_parts
                      else np.zeros((0, 5), np.int32))
        ovf = overflow.cpu().numpy()

        n = self.num_reads
        out = CoarseResults(
            orientation=np.full(n, shd.NONE, dtype=np.int8),
            hamming=np.zeros(n, dtype=np.int32),
            shift=np.zeros(n, dtype=np.int32),
            chromosome_id=np.zeros(n, dtype=np.int32),
            position=np.zeros(n, dtype=np.int32),
            global_window_id=np.full(n, SENTINEL, dtype=np.uint32),
            stats={k: int(v) for k, v in zip(OVERFLOW_KEYS, ovf)},
            bs_strand=np.zeros(n, dtype=np.int8))
        # host merge in genome order (the reference's first window wins, a
        # strictly smaller Hamming distance replaces): the lexicographic
        # minimum over (hamming, row order), the rows being in genome,
        # window and candidate order
        rows = np.flatnonzero(all_packed[:, 0] >= 0)
        if not len(rows):
            return out
        rid_v = all_packed[rows, 0]
        sel = np.lexsort((rows, all_packed[rows, 1], rid_v))
        first = np.ones(len(sel), dtype=bool)
        first[1:] = rid_v[sel][1:] != rid_v[sel][:-1]
        win = rows[sel[first]]            # the winning row of each read
        r = all_packed[win, 0]
        bi, wi = win // (bsz * kcap), win % (bsz * kcap) // kcap
        gwin = np.array([b.global_window_ids[0] for b in batches],
                        dtype=np.int64)[bi] + wi
        out.orientation[r] = all_packed[win, 3]
        out.bs_strand[r] = all_packed[win, 4].astype(np.int8)
        out.hamming[r] = all_packed[win, 1]
        out.shift[r] = all_packed[win, 2]
        out.chromosome_id[r] = np.array(
            [b.chromosome_id for b in batches], dtype=np.int32)[bi]
        out.position[r] = pos[bi, wi]
        out.global_window_id[r] = gwin.astype(np.uint32)
        return out
