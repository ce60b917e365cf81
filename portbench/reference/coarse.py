"""Plain reference of the coarse mapper (STEP 1): the window index built
again from the genome, then signatures, the capped probe, the vote, SHD
against the extended windows and the per-read best, a read batch at a
time.

A frozen copy of the port's plain PyTorch versions (the functions that its
CPU path runs and that its tests hold against the JAX package), trimmed to
what the 3N modes need: the probe is the plain searchsorted over the CSR
tables (the port's cuckoo slot table finds the same windows), and the
parity mode's read-side key drops are left out.  It imports nothing of the
port and takes nothing that the port built; it runs on any torch device.

Rows are packed as the port packs them: [N, 7] int32 (orientation 1 fwd /
2 rc / 3 none, hamming, shift, chromosome, position, window id or -1, bs
strand), with the overflow vector [5] (probes over the cap, reads over the
candidate cap, pairs over the pair budget, tail and head drops).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

SENTINEL = 0xFFFFFFFF
MASK32 = 0xFFFFFFFF
BIG = 0x3FFFFFFF
FORWARD, REVERSE_COMPLEMENT, NONE = 1, 2, 3
_C1 = 0xFF51AFD7ED558CCD
_C2 = 0xC4CEB9FE1A85EC53
_NO_HIT = (1 << 63) - 1
SIG_ROWS = 1 << 16       # windows hashed a call in the index build


@dataclasses.dataclass(frozen=True)
class MapperOptions:
    """The options the coarse stage reads (the port's ProgramOptions
    fields of the same meaning)."""
    kmer_length: int = 16
    num_hash_functions: int = 16
    window_size: int = 128
    min_table_hits: int = 4
    batchsize: int = 4096
    max_hamming_percent: float = 0.05
    probe_cap: int = 128
    candidates_per_read_cap: int = 32
    shd_pairs_per_read_budget: int = 16
    max_read_length: int = 128
    undirectional: bool = False

    @property
    def window_stride(self) -> int:
        return self.window_size - self.kmer_length + 1


# -- unsigned arithmetic on int64 tensors ------------------------------------

def _mul_lo32(x, c):
    c0, c1 = c & 0xFFFF, c >> 16
    return (x * c0 + (((x * c1) & 0xFFFF) << 16)) & MASK32


def _mul_wide32(x, c):
    c0, c1 = c & 0xFFFF, c >> 16
    p0 = x * c0
    p1 = x * c1
    t = p0 + ((p1 & 0xFFFF) << 16)
    return ((p1 >> 16) + (t >> 32)) & MASK32, t & MASK32


def _mul_const(hi, lo, c):
    chi, clo = c >> 32, c & MASK32
    phi, plo = _mul_wide32(lo, clo)
    phi = (phi + _mul_lo32(lo, chi) + _mul_lo32(hi, clo)) & MASK32
    return phi, plo


def murmur64(hi, lo):
    """MurmurHash3 fmix64 on (hi, lo) u32 pairs."""
    lo = lo ^ (hi >> 1)
    hi, lo = _mul_const(hi, lo, _C1)
    lo = lo ^ (hi >> 1)
    hi, lo = _mul_const(hi, lo, _C2)
    lo = lo ^ (hi >> 1)
    return hi, lo


# -- encodings and signatures ------------------------------------------------

def revcomp_bases(bases, lengths):
    n, maxlen = bases.shape
    idx = torch.arange(maxlen, device=bases.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    src = (lens - 1 - idx).clamp(0, maxlen - 1)
    rc = 3 - torch.gather(bases, 1, src)
    return torch.where(idx < lens, rc, bases).to(bases.dtype)


def c_to_t(bases):
    return torch.where(bases == 1, torch.full_like(bases, 3), bases)


def g_to_a(bases):
    return torch.where(bases == 2, torch.zeros_like(bases), bases)


def _min_sig(kmers, valid, hid):
    lo = kmers[:, None, :] + hid
    hi, lo = murmur64(lo >> 32, lo & MASK32)
    key = (hi - (1 << 31)) * (1 << 32) + lo
    key = torch.where(valid, key, torch.full_like(key, _NO_HIT))
    return key.amin(dim=2) & MASK32


def _sigs_from_bases(bases, lengths, k, hash_ids, mode):
    """Low words of the 64-bit minima of murmur64(k-mer + hash id):
    [N, F] forward k-mers ('fwd'), [N, 2F] forward then reverse-complement
    k-mers ('both')."""
    n, maxlen = bases.shape
    dev = bases.device
    b = torch.zeros((n, maxlen + k), dtype=torch.int64, device=dev)
    b[:, :maxlen] = bases.to(torch.int64)
    fwd = torch.zeros((n, maxlen), dtype=torch.int64, device=dev)
    rcv = torch.zeros_like(fwd)
    for i in range(k):
        bi = b[:, i:i + maxlen]
        fwd |= bi << (2 * (k - 1 - i))
        rcv |= (3 - bi) << (2 * i)
    lens = lengths.to(torch.int64).clamp(max=maxlen)
    pos = torch.arange(maxlen, device=dev)[None, :]
    valid = (pos <= lens[:, None] - k)[:, None, :]
    hid = hash_ids.to(torch.int64)[None, :, None]
    if mode == "both":
        return torch.cat([_min_sig(fwd, valid, hid),
                          _min_sig(rcv, valid, hid)], dim=1)
    return _min_sig(fwd, valid, hid)


def signatures(bases, lengths, k, hash_ids, mode, mirror=False):
    """(sig, valid [N]): mode 'read' = [CT(x) fwd | CT(x) rc] ('both' over
    the C->T collapse; with mirror the G->A collapse, halves swapped);
    mode 'window' = [CT(x) fwd | GA(x) fwd].  SENTINEL rows below k."""
    if mode == "window":
        min_lo = torch.cat([
            _sigs_from_bases(c_to_t(bases), lengths, k, hash_ids, "fwd"),
            _sigs_from_bases(g_to_a(bases), lengths, k, hash_ids, "fwd")],
            dim=1)
    else:
        collapsed = g_to_a(bases) if mirror else c_to_t(bases)
        min_lo = _sigs_from_bases(collapsed, lengths, k, hash_ids, "both")
    sig = min_lo if k == 16 else min_lo & ((1 << (2 * k)) - 1)
    valid = lengths >= k
    sig = torch.where(valid[:, None], sig, torch.full_like(sig, SENTINEL))
    if mirror:
        f = hash_ids.shape[0]
        sig = torch.cat([sig[:, f:], sig[:, :f]], dim=1)
    return sig, valid


# -- the index -----------------------------------------------------------------

class Index(NamedTuple):
    keys: torch.Tensor       # [F, U] ascending, SENTINEL pad
    offsets: torch.Tensor    # [F, U + 1]
    values: torch.Tensor     # [F, V] window ids grouped by key
    num_keys: torch.Tensor   # [F]


def build_csr(sigs, valid) -> Index:
    """One CSR table per column of the window signatures: a stable sort,
    run starts, ranks and scatters."""
    n, f = sigs.shape
    dev = sigs.device
    key_in = torch.where(valid[None, :], sigs.T,
                         torch.full((f, n), SENTINEL, dtype=torch.int64,
                                    device=dev))
    keys_sorted, vals_sorted = torch.sort(key_in, dim=1, stable=True)
    del key_in
    is_real = keys_sorted != SENTINEL
    prev = torch.cat([torch.full((f, 1), SENTINEL, dtype=torch.int64,
                                 device=dev), keys_sorted[:, :-1]], dim=1)
    iota = torch.arange(n, device=dev)[None, :].expand(f, n)
    is_start = ((keys_sorted != prev) | (iota == 0)) & is_real
    del prev
    rank = torch.cumsum(is_start.to(torch.int64), dim=1) - 1
    num_keys = torch.where(is_start, rank + 1,
                           torch.zeros_like(rank)).amax(dim=1)
    keys = torch.full((f, n + 1), SENTINEL, dtype=torch.int64, device=dev)
    keys.scatter_(1, torch.where(is_start, rank, torch.full_like(rank, n)),
                  keys_sorted)
    offsets = torch.zeros((f, n + 2), dtype=torch.int64, device=dev)
    offsets.scatter_(1, torch.where(is_start, rank,
                                    torch.full_like(rank, n + 1)), iota)
    offsets = offsets[:, :n + 1].contiguous()
    n_valid = is_real.sum(dim=1)
    offsets.scatter_(1, num_keys.clamp(max=n)[:, None], n_valid[:, None])
    values = torch.where(is_real, vals_sorted,
                         torch.full_like(vals_sorted, SENTINEL)).contiguous()
    return Index(keys[:, :n].contiguous(), offsets, values, num_keys)


def probe(index: Index, sigs, sig_valid, probe_cap: int):
    """Capped lookup of [N, F] query signatures: (cand [F, N, probe_cap]
    the first ids of each key, SENTINEL past the count; probes whose
    count exceeds the cap)."""
    sigs_t = sigs.T.contiguous()
    idx = torch.searchsorted(index.keys, sigs_t)
    idx_c = idx.clamp(max=index.keys.shape[1] - 1)
    found = ((torch.gather(index.keys, 1, idx_c) == sigs_t)
             & (idx < index.num_keys[:, None]) & sig_valid[None, :])
    off0 = torch.gather(index.offsets, 1, idx_c)
    cnt = torch.gather(index.offsets, 1, idx_c + 1) - off0
    counts = torch.where(found, cnt, torch.zeros_like(cnt))
    f, n = counts.shape
    v_cols = index.values.shape[1]
    cap_eff = counts.clamp(max=probe_cap)
    slot = torch.arange(probe_cap, device=sigs.device)
    gidx = (off0[:, :, None] + slot).clamp(0, v_cols - 1)
    vals = torch.gather(index.values, 1, gidx.reshape(f, -1))
    cand = torch.where(slot < cap_eff[:, :, None], vals.reshape(f, n, -1),
                       torch.full((), SENTINEL, device=sigs.device))
    return cand, (counts > probe_cap).sum()


def vote(cand_fnc, min_table_hits: int, out_cap: int):
    """Ids seen in >= min_table_hits of a read's lists, ascending, in
    out_cap slots: (ids [N, out_cap], num_kept [N], which may exceed
    out_cap)."""
    f, n, c = cand_fnc.shape
    m = f * c
    dev = cand_fnc.device
    flat = torch.sort(cand_fnc.permute(1, 0, 2).reshape(n, m).to(torch.int64),
                      dim=1).values
    prev = torch.cat([torch.full((n, 1), SENTINEL, dtype=torch.int64,
                                 device=dev), flat[:, :-1]], dim=1)
    iota = torch.arange(m, device=dev)[None, :]
    is_start = ((flat != prev) | (iota == 0)) & (flat != SENTINEL)
    start_pos = torch.where(is_start | (flat == SENTINEL), iota,
                            torch.full_like(iota, m))
    suffix_min = torch.cummin(start_pos.flip(1), dim=1).values.flip(1)
    nxt = torch.cat([suffix_min[:, 1:],
                     torch.full((n, 1), m, dtype=torch.int64, device=dev)],
                    dim=1)
    run_len = nxt - iota
    keep = is_start & (run_len >= min_table_hits) if min_table_hits > 1 \
        else is_start
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    num_kept = torch.where(keep, rank + 1, torch.zeros_like(rank)).amax(dim=1)
    slot = torch.where(keep & (rank < out_cap), rank,
                       torch.full_like(rank, out_cap))
    ids = torch.full((n, out_cap + 1), SENTINEL, dtype=torch.int64,
                     device=dev).scatter_(1, slot, flat)[:, :out_cap]
    return ids, num_kept


def compact_pairs(pair_valid, seg_len: int, slots: int):
    """The valid pairs of each segment of seg_len grid slots (a batch's),
    in grid order, into `slots` slots a segment, the rest dropped: (grid
    index of each slot, its validity, the dropped pairs).  slots 0 keeps
    the whole grid."""
    dev = pair_valid.device
    nk = pair_valid.shape[0]
    if slots == 0:
        return (torch.arange(nk, device=dev), pair_valid,
                torch.zeros((), dtype=torch.int64, device=dev))
    valid_g = pair_valid.reshape(nk // seg_len, seg_len)
    rank = torch.cumsum(valid_g.to(torch.int64), dim=1) - 1
    n_valid = valid_g.sum(dim=1)
    slot = torch.where(valid_g & (rank < slots), rank,
                       torch.full_like(rank, slots))
    grid = torch.arange(nk, device=dev).reshape(-1, seg_len)
    pair_sel = torch.zeros((grid.shape[0], slots + 1), dtype=torch.int64,
                           device=dev).scatter_(1, slot, grid)[:, :slots]
    sel_valid = torch.arange(slots, device=dev)[None, :] < n_valid[:, None]
    return (pair_sel.reshape(-1), sel_valid.reshape(-1),
            (n_valid - slots).clamp(min=0).sum())


# -- SHD against the extended windows -------------------------------------------

def _as_i32(v):
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _to_words(bits):
    shifts = torch.arange(32, device=bits.device)
    words = (bits.reshape(*bits.shape[:-1], -1, 32) << shifts).sum(-1)
    return _as_i32(words)


def pack_bitplanes(bases, lengths, nwords: int):
    n, maxlen = bases.shape
    width = nwords * 32
    b = bases.to(torch.int64)
    if width > maxlen:
        b = torch.nn.functional.pad(b, (0, width - maxlen))
    else:
        b = b[:, :width]
    pos = torch.arange(width, device=bases.device)[None, :]
    in_len = pos < lengths.to(torch.int64)[:, None]
    zero = torch.zeros_like(b)
    return (_to_words(torch.where(in_len, (b >> 1) & 1, zero)),
            _to_words(torch.where(in_len, b & 1, zero)),
            _to_words(in_len.to(torch.int64)))


def pack_genome_planes(concat, chunk: int = 1 << 24):
    g = concat.shape[0]
    width = ((g + 31) // 32) * 32
    padded = torch.nn.functional.pad(concat.to(torch.int8), (0, width - g))
    his, los = [], []
    for s0 in range(0, width, chunk):
        b = padded[s0:s0 + chunk].to(torch.int64)
        his.append(_to_words((b >> 1) & 1))
        los.append(_to_words(b & 1))
    return torch.cat(his), torch.cat(los)


def _popcount32(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _shd_best(anchor_hi, anchor_lo, read_hi, read_lo, read_mask, bounds,
              n_shifts: int, wr: int):
    """[P, 4] (best_f, shift_f, best_r, shift_r): every shift's Hamming
    count word by word, masked to the inclusive bounds, first argmin."""
    dev = anchor_hi.device
    u = lambda t: t.to(torch.int64) & MASK32
    a_hi, a_lo = u(anchor_hi), u(anchor_lo)
    r_hi, r_lo = u(read_hi)[:, :, None, :], u(read_lo)[:, :, None, :]
    m = u(read_mask)[:, None, None, :]
    bits = torch.arange(32, device=dev)[:, None]
    low_mask = (1 << bits) - 1

    def shifted(a, word):
        w0 = a[:, :, None, word:word + wr]
        w1 = a[:, :, None, word + 1:word + wr + 1]
        return (w0 >> bits) | ((w1 & low_mask) << (32 - bits))

    n_words = (n_shifts + 31) // 32
    ham = torch.cat([
        _popcount32(((shifted(a_hi, w) ^ r_hi) | (shifted(a_lo, w) ^ r_lo))
                    & m).sum(-1) for w in range(n_words)], dim=2)
    s = torch.arange(n_words * 32, device=dev)[None, None, :]
    lo_b = bounds[:, 0].to(torch.int64)
    hi_b = bounds[:, 1].to(torch.int64)
    ham = torch.where((s >= lo_b[:, None, None]) & (s <= hi_b[:, None, None]),
                      ham, torch.full_like(ham, BIG))
    idx = ham.argmin(dim=2)
    best = torch.gather(ham, 2, idx[:, :, None])[:, :, 0]
    shift = torch.where(best < BIG, idx, lo_b[:, None])
    return torch.stack([best[:, 0], shift[:, 0], best[:, 1], shift[:, 1]],
                       dim=1).to(torch.int32)


class ShdResult(NamedTuple):
    hamming: torch.Tensor
    shift: torch.Tensor
    orientation: torch.Tensor


def extended_window(pos, chrom_len, read_len, window_size: int):
    """(start, left, length) of the window extended by read_len // 2 each
    side, the left extension all or nothing."""
    ext = read_len // 2
    zero = torch.zeros_like(ext)
    left = torch.where(ext < pos, ext, zero)
    end = pos + window_size
    in_bounds = end <= chrom_len
    right = torch.where(in_bounds,
                        torch.where(end + ext < chrom_len, ext,
                                    chrom_len - end), zero)
    length = window_size + left + right - torch.where(
        in_bounds, zero, end - chrom_len)
    return pos - left, left, length


def shd_pairs(read_bases, read_len, ridx, genome_hi, genome_lo, gstart,
              anchor_length, anchor_left, pair_valid, opts: MapperOptions,
              mirrored: bool) -> ShdResult:
    """SHD of each (read ridx[p], extended window at gstart[p]) pair in
    both orientations, 3N-collapsed (C->T read / G->A reverse complement;
    mirrored: G->A / C->T), forward first on ties, NONE above
    trunc(float32(read_len) * float32(max_hamming_percent))."""
    wr = (read_bases.shape[1] + 31) // 32
    rc = revcomp_bases(read_bases, read_len)
    if mirrored:
        o0, o1 = g_to_a(read_bases), c_to_t(rc)
    else:
        o0, o1 = c_to_t(read_bases), g_to_a(rc)
    hi0, lo0, mask = pack_bitplanes(o0, read_len, wr)
    hi1, lo1, _ = pack_bitplanes(o1, read_len, wr)
    r_hi = torch.stack([hi0[ridx], hi1[ridx]], dim=1)
    r_lo = torch.stack([lo0[ridx], lo1[ridx]], dim=1)
    mask = mask[ridx]
    rl = read_len.to(torch.int64)[ridx]
    s_max = opts.window_size + 32
    wa_pad = (s_max - 1) // 32 + wr + 2
    g = gstart.to(torch.int64)
    word0 = g.clamp(min=0) >> 5
    bit0 = g & 31
    widx = (word0[:, None] + torch.arange(wa_pad, device=g.device)
            ).clamp(0, genome_hi.shape[0] - 1)
    a_hi, a_lo = genome_hi[widx], genome_lo[widx]
    ct = (a_hi | a_lo, a_lo)
    ga = (a_hi & a_lo, a_lo)
    first, second = (ga, ct) if mirrored else (ct, ga)
    max_shift = bit0 + (anchor_length - rl)
    bounds = torch.stack([bit0, max_shift], dim=1).to(torch.int32)
    best4 = _shd_best(torch.stack([first[0], second[0]], dim=1),
                      torch.stack([first[1], second[1]], dim=1),
                      r_hi, r_lo, mask, bounds, s_max, wr)
    b0 = bit0.to(torch.int32)
    best_f, shift_f = best4[:, 0], best4[:, 1] - b0
    best_r, shift_r = best4[:, 2], best4[:, 3] - b0
    use_rc = best_r < best_f
    best = torch.where(use_rc, best_r, best_f)
    best_shift = torch.where(use_rc, shift_r, shift_f)
    too_long = rl > anchor_length
    threshold = (rl.to(torch.float32) * torch.tensor(
        opts.max_hamming_percent, dtype=torch.float32,
        device=g.device)).to(torch.int32)
    good = (best <= threshold) & ~too_long & pair_valid
    orientation = torch.where(
        good, torch.where(use_rc, REVERSE_COMPLEMENT, FORWARD), NONE)
    zero = torch.zeros_like(best_shift)
    score = torch.where(too_long, rl.to(best.dtype), best)
    shift = (torch.where(too_long, zero, best_shift)
             - torch.where(too_long, zero, anchor_left.to(best_shift.dtype)))
    return ShdResult(score.to(torch.int32), shift.to(torch.int32),
                     orientation.to(torch.int8))


# -- the mapper ------------------------------------------------------------------

class ReferenceMapper:
    """The coarse mapper's semantics over one genome: window index on
    `device`, then map_batch per read batch.

    chromosomes: base codes 0..3 of each chromosome (numpy int8)."""

    def __init__(self, chromosomes: Sequence[np.ndarray],
                 opts: MapperOptions, device):
        self.opts = opts
        self.device = torch.device(device)
        dev = self.device
        k, ws, stride = opts.kmer_length, opts.window_size, opts.window_stride
        lens = [len(c) for c in chromosomes]
        self.chrom_offset = torch.tensor(
            np.concatenate([[0], np.cumsum(lens)[:-1]]), dtype=torch.int64,
            device=dev)
        self.chrom_len = torch.tensor(lens, dtype=torch.int64, device=dev)
        concat = torch.cat([torch.from_numpy(np.asarray(c, np.int8)).to(dev)
                            for c in chromosomes])
        pos_l, chrom_l = [], []
        for c, clen in enumerate(lens):
            nwin = (clen + stride - 1) // stride
            pos_l.append(torch.arange(nwin, dtype=torch.int64,
                                      device=dev) * stride)
            chrom_l.append(torch.full((nwin,), c, dtype=torch.int64,
                                      device=dev))
        self.win_pos = torch.cat(pos_l)
        self.win_chrom = torch.cat(chrom_l)
        win_len = torch.minimum(self.chrom_len[self.win_chrom]
                                - self.win_pos, torch.tensor(ws, device=dev))
        gwin = self.chrom_offset[self.win_chrom] + self.win_pos
        self.hash_ids = torch.arange(opts.num_hash_functions,
                                     dtype=torch.int64, device=dev)
        w = self.win_pos.shape[0]
        sig = torch.empty((w, 2 * opts.num_hash_functions), dtype=torch.int64,
                          device=dev)
        valid = torch.empty((w,), dtype=torch.bool, device=dev)
        cols = torch.arange(ws, device=dev)[None, :]
        for s0 in range(0, w, SIG_ROWS):
            s1 = min(s0 + SIG_ROWS, w)
            idx = (gwin[s0:s1, None] + cols).clamp(max=concat.shape[0] - 1)
            sig[s0:s1], valid[s0:s1] = signatures(
                concat[idx], win_len[s0:s1], k, self.hash_ids, "window")
        self.index = build_csr(sig, valid)
        del sig, valid
        self.genome_hi, self.genome_lo = pack_genome_planes(concat)

    def map_batch(self, read_bases, read_len, read_valid, seg: int = 0):
        """Consecutive batches of `seg` rows (one batch by default): bases
        [B, max_read_length] int8, lengths [B], valid [B] -> (packed
        [B, 7] int32, overflow [5] int64 summed over the batches).  Only
        the pair budget is a batch's own; every other step is a read's."""
        o = self.opts
        seg = seg or read_bases.shape[0]
        kcap = o.candidates_per_read_cap
        b = read_bases.shape[0]
        dev = self.device
        sigs, sig_valid = signatures(read_bases, read_len, o.kmer_length,
                                     self.hash_ids, "read")
        sig_valid = sig_valid & read_valid
        cand, over = probe(self.index, sigs, sig_valid, o.probe_cap)
        if o.undirectional:
            sigs_u, _ = signatures(read_bases, read_len, o.kmer_length,
                                   self.hash_ids, "read", mirror=True)
            cand_u, over_u = probe(self.index, sigs_u, sig_valid, o.probe_cap)
            cand = torch.cat([cand, cand_u], dim=0)
            over = over + over_u
        ids, num_kept = vote(cand, o.min_table_hits, kcap)
        # the valid pairs of each batch, in grid order, in seg * budget slots
        gwin = ids.reshape(-1)
        pair_valid = gwin != SENTINEL
        gwin_full = torch.where(pair_valid, gwin, torch.zeros_like(gwin))
        nk = b * kcap
        budget = o.shd_pairs_per_read_budget
        pair_sel, sel_valid, pair_drops = compact_pairs(
            pair_valid, seg * kcap, budget * seg if 0 < budget < kcap else 0)
        gwin_c = gwin_full[pair_sel]
        ridx = pair_sel // kcap
        chrom = self.win_chrom[gwin_c]
        start, left, length = extended_window(
            self.win_pos[gwin_c], self.chrom_len[chrom],
            read_len.to(torch.int64)[ridx], o.window_size)
        gstart = self.chrom_offset[chrom] + start

        def shd(mirrored):
            return shd_pairs(read_bases, read_len, ridx, self.genome_hi,
                             self.genome_lo, gstart, length, left, sel_valid,
                             o, mirrored)

        res = shd(False)
        ham, shf, ori = res.hamming, res.shift, res.orientation
        strand = torch.zeros_like(ham)
        if o.undirectional:
            res_u = shd(True)
            better_u = (res_u.orientation != NONE) & (
                (ori == NONE) | (res_u.hamming < ham))
            ham = torch.where(better_u, res_u.hamming, ham)
            shf = torch.where(better_u, res_u.shift, shf)
            ori = torch.where(better_u, res_u.orientation, ori)
            strand = better_u.to(strand.dtype)
        if pair_sel.shape[0] != nk:
            tgt = torch.where(sel_valid, pair_sel,
                              torch.full_like(pair_sel, nk))

            def spread(x, fill):
                buf = torch.full((nk + 1,), fill, dtype=x.dtype, device=dev)
                buf[tgt] = x
                return buf[:nk]
            ham, shf = spread(ham, 0), spread(shf, 0)
            ori, strand = spread(ori, NONE), spread(strand, 0)
        ham, shf = ham.reshape(b, kcap), shf.reshape(b, kcap)
        ori, strand = ori.reshape(b, kcap), strand.reshape(b, kcap)
        good = ori != NONE
        # best per read: min hamming, then the lowest window id
        ham_m = torch.where(good, ham, torch.full_like(ham, BIG))
        min_h = ham_m.amin(dim=1, keepdim=True)
        gw = gwin_full.reshape(b, kcap)
        slot_key = torch.where(good & (ham_m == min_h), gw,
                               torch.full_like(gw, BIG))
        best_slot = slot_key.argmin(dim=1, keepdim=True)
        has = good.any(dim=1)

        def take(m):
            return torch.gather(m, 1, best_slot)[:, 0].to(torch.int64)
        zero = torch.zeros(b, dtype=torch.int64, device=dev)
        best_gwin = take(gw)
        packed = torch.stack([
            torch.where(has, take(ori), torch.full_like(zero, NONE)),
            torch.where(has, take(ham), zero),
            torch.where(has, take(shf), zero),
            torch.where(has, self.win_chrom[best_gwin], zero),
            torch.where(has, self.win_pos[best_gwin], zero),
            torch.where(has, best_gwin, torch.full_like(best_gwin, -1)),
            torch.where(has, take(strand), zero)], dim=1).to(torch.int32)
        zero0 = torch.zeros((), dtype=torch.int64, device=dev)
        overflow = torch.stack([over, (num_kept > kcap).sum(), pair_drops,
                                zero0, zero0])
        return packed, overflow

    def map_reads(self, read_bases: np.ndarray, read_lengths: np.ndarray,
                  group: int = 8):
        """All reads in the port's batches of batchsize rows in read order,
        padded to max_read_length columns, `group` batches a call:
        (packed [N, 7] int32 numpy, overflow [5] int64 numpy)."""
        o = self.opts
        n, lr = read_bases.shape
        bsz = o.batchsize
        step = bsz * group
        out: List[np.ndarray] = []
        overflow = torch.zeros(5, dtype=torch.int64, device=self.device)
        for s0 in range(0, n, step):
            s1 = min(s0 + step, n)
            rows = -(-(s1 - s0) // bsz) * bsz
            bases = torch.zeros((rows, o.max_read_length), dtype=torch.int8)
            bases[:s1 - s0, :lr] = torch.from_numpy(read_bases[s0:s1])
            lens = torch.zeros(rows, dtype=torch.int32)
            lens[:s1 - s0] = torch.from_numpy(
                np.asarray(read_lengths[s0:s1], np.int32))
            valid = torch.arange(rows) < s1 - s0
            packed, ov = self.map_batch(bases.to(self.device),
                                        lens.to(self.device),
                                        valid.to(self.device), seg=bsz)
            out.append(packed[:s1 - s0].cpu().numpy())
            overflow += ov
        return np.concatenate(out), overflow.cpu().numpy()
