"""Bit-plane shifted Hamming distance (counterpart of
hashreadmapper_tpu/ops/shd_pallas.py).

Bases become two bit planes (hi = bit 1, lo = bit 0 of the 2-bit code)
packed 32 positions per int32 word, bit j of word w = position 32*w + j;
a mismatch is a set bit of (a_hi ^ r_hi) | (a_lo ^ r_lo).  shd_best (the
best shift per orientation) and shd_hamming_matrix (every shift's score)
launch the kernels of csrc/shd.cu for CUDA tensors and run their *_plain
versions for CPU tensors.  shd_pairs_best binds the third entry of
csrc/shd.cu, the coarse mapper's whole SHD stage in one launch; its
plain version, and the dispatch between the two, are
ops/shd.py::shd_pairs_best's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .u64 import MASK32

BIG = 0x3FFFFFFF
WR_MAX = 16              # read words the CUDA kernels keep in registers
# the kernels' argmin key is (hamming << 16 | shift): shifts below 2**16
MAX_SHIFTS = 65536


def as_i32(v: torch.Tensor) -> torch.Tensor:
    """u32 values in int64 -> the same bits as int32."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _to_words(bits: torch.Tensor) -> torch.Tensor:
    """[..., W*32] 0/1 int64 -> [..., W] int32 words."""
    shifts = torch.arange(32, device=bits.device)
    words = (bits.reshape(*bits.shape[:-1], -1, 32) << shifts).sum(-1)
    return as_i32(words)


def pack_bitplanes(bases: torch.Tensor, lengths: torch.Tensor, nwords: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[N, L] int8 bases -> (hi, lo, mask) [N, nwords] int32 planes; mask
    has 1-bits exactly at positions < length."""
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


def pack_genome_planes(concat: torch.Tensor, chunk: int = 1 << 24
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[G] int8 genome -> (hi, lo) [ceil(G/32)] int32 plane words, packed
    in chunks of `chunk` bases to bound the temporaries."""
    g = concat.shape[0]
    width = ((g + 31) // 32) * 32
    padded = torch.nn.functional.pad(concat.to(torch.int8), (0, width - g))
    his, los = [], []
    for s0 in range(0, width, chunk):
        b = padded[s0:s0 + chunk].to(torch.int64)
        his.append(_to_words((b >> 1) & 1))
        los.append(_to_words(b & 1))
    return torch.cat(his), torch.cat(los)


def collapse_planes_ct(hi, lo):
    """C(01) -> T(11) on bit planes: hi' = hi | lo."""
    return hi | lo, lo


def collapse_planes_ga(hi, lo):
    """G(10) -> A(00) on bit planes: hi' = hi & lo."""
    return hi & lo, lo


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of u32 values held in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _check(anchor_hi, anchor_lo, read_hi, read_lo, mask, bounds, n_shifts,
           wa, wr, name="shd_best"):
    p = anchor_hi.shape[0]
    if (anchor_hi.shape != (p, 2, wa) or anchor_lo.shape != (p, 2, wa)
            or read_hi.shape != (p, 2, wr) or read_lo.shape != (p, 2, wr)
            or mask.shape != (p, wr)
            or (bounds is not None and bounds.shape != (p, 2))):
        raise ValueError(f"{name}: expected anchors [P, 2, wa], reads "
                         "[P, 2, wr], mask [P, wr], bounds [P, 2]")
    if n_shifts < 1 or wa < (n_shifts + 31) // 32 + wr:
        raise ValueError(f"{name}: wa={wa} < ceil(n_shifts/32) + wr "
                         f"(shift windows would read past the anchor)")


def _hamming_by_word(anchor_hi, anchor_lo, read_hi_both, read_lo_both,
                     read_mask, n_shifts: int, wr: int) -> torch.Tensor:
    """[P, 2, 32 * ceil(n_shifts / 32)] int64 Hamming matrix, built word
    by word: the anchor planes shifted right by word*32 + bit across word
    boundaries (the upper word contributes nothing when bit == 0)."""
    dev = anchor_hi.device
    u = lambda t: t.to(torch.int64) & MASK32
    a_hi, a_lo = u(anchor_hi), u(anchor_lo)
    r_hi, r_lo = u(read_hi_both)[:, :, None, :], u(read_lo_both)[:, :, None, :]
    m = u(read_mask)[:, None, None, :]
    bits = torch.arange(32, device=dev)[:, None]                 # [32, 1]
    low_mask = (1 << bits) - 1

    def shifted(a, word):
        # [P, 2, 32, wr]: plane shifted right by word*32 + bit
        w0 = a[:, :, None, word:word + wr]
        w1 = a[:, :, None, word + 1:word + wr + 1]
        return (w0 >> bits) | ((w1 & low_mask) << (32 - bits))

    hams = []
    for word in range((n_shifts + 31) // 32):
        mm = ((shifted(a_hi, word) ^ r_hi) | (shifted(a_lo, word) ^ r_lo)) & m
        hams.append(_popcount32(mm).sum(-1))                     # [P, 2, 32]
    return torch.cat(hams, dim=2)


def shd_best_plain(anchor_hi, anchor_lo, read_hi_both, read_lo_both,
                   read_mask, shift_bounds, n_shifts: int, wa: int, wr: int
                   ) -> torch.Tensor:
    """Plain PyTorch version: the [P, 2, 32*nw] Hamming matrix word by
    word, masked to the shift bounds, first-occurrence argmin."""
    _check(anchor_hi, anchor_lo, read_hi_both, read_lo_both, read_mask,
           shift_bounds, n_shifts, wa, wr)
    dev = anchor_hi.device
    n_words = (n_shifts + 31) // 32
    ham = _hamming_by_word(anchor_hi, anchor_lo, read_hi_both, read_lo_both,
                           read_mask, n_shifts, wr)
    s = torch.arange(n_words * 32, device=dev)[None, None, :]
    lo_b = shift_bounds[:, 0].to(torch.int64)
    hi_b = shift_bounds[:, 1].to(torch.int64)
    ham = torch.where((s >= lo_b[:, None, None]) & (s <= hi_b[:, None, None]),
                      ham, torch.full_like(ham, BIG))
    idx = ham.argmin(dim=2)                                      # [P, 2]
    best = torch.gather(ham, 2, idx[:, :, None])[:, :, 0]
    shift = torch.where(best < BIG, idx, lo_b[:, None])
    return torch.stack([best[:, 0], shift[:, 0], best[:, 1], shift[:, 1]],
                       dim=1).to(torch.int32)


def shd_best(anchor_hi, anchor_lo, read_hi_both, read_lo_both, read_mask,
             shift_bounds, n_shifts: int, wa: int, wr: int) -> torch.Tensor:
    """Best (score, shift) per orientation for P pairs -> [P, 4] int32
    (best_f, shift_f, best_r, shift_r); unreachable best = 0x3FFFFFFF with
    shift = min_shift.  shift_bounds [P, 2] = inclusive (min, max) shift."""
    if anchor_hi.device.type == "cpu":
        return shd_best_plain(anchor_hi, anchor_lo, read_hi_both,
                              read_lo_both, read_mask, shift_bounds,
                              n_shifts, wa, wr)
    _check(anchor_hi, anchor_lo, read_hi_both, read_lo_both, read_mask,
           shift_bounds, n_shifts, wa, wr)
    if wr > WR_MAX:
        raise ValueError(f"shd_best: wr={wr} exceeds the kernel's {WR_MAX}")
    if n_shifts > MAX_SHIFTS:
        raise ValueError(f"shd_best: n_shifts={n_shifts} exceeds the "
                         f"kernel's {MAX_SHIFTS}")
    args = [t.to(torch.int32).contiguous()
            for t in (anchor_hi, anchor_lo, read_hi_both, read_lo_both,
                      read_mask, shift_bounds)]
    p = args[0].shape[0]
    out = torch.empty((p, 4), dtype=torch.int32, device=args[0].device)
    _build.check_cuda("shd_best", *args, out)
    _build.launch("hrm_shd_best", out, *[t.data_ptr() for t in args],
                  out.data_ptr(), p, wa, wr, n_shifts)
    shd_best.launches += 1
    return out


shd_best.launches = 0


def shd_hamming_matrix_plain(anchor_hi, anchor_lo, read_hi_both,
                             read_lo_both, read_mask, n_shifts: int, wa: int,
                             wr: int) -> torch.Tensor:
    """Plain PyTorch version of shd_hamming_matrix."""
    _check(anchor_hi, anchor_lo, read_hi_both, read_lo_both, read_mask, None,
           n_shifts, wa, wr, "shd_hamming_matrix")
    ham = _hamming_by_word(anchor_hi, anchor_lo, read_hi_both, read_lo_both,
                           read_mask, n_shifts, wr)
    return ham[:, :, :n_shifts].to(torch.int32).contiguous()


def shd_hamming_matrix(anchor_hi, anchor_lo, read_hi_both, read_lo_both,
                       read_mask, n_shifts: int, wa: int, wr: int
                       ) -> torch.Tensor:
    """The whole Hamming matrix [P, 2, n_shifts] int32: for pair p,
    orientation o and shift s, sum_w popcount(((a_hi[p, o] >> s) ^
    r_hi[p, o] | (a_lo[p, o] >> s) ^ r_lo[p, o]) & mask[p]), the anchor
    shifted across word boundaries.  No bounds and no argmin.  Anchors
    [P, 2, wa] with wa >= ceil(n_shifts / 32) + wr, reads [P, 2, wr], mask
    [P, wr], int32 words (any P; wr <= WR_MAX on the card).  CUDA tensors
    launch csrc/shd.cu, CPU tensors take the plain version."""
    if anchor_hi.device.type == "cpu":
        return shd_hamming_matrix_plain(anchor_hi, anchor_lo, read_hi_both,
                                        read_lo_both, read_mask, n_shifts,
                                        wa, wr)
    _check(anchor_hi, anchor_lo, read_hi_both, read_lo_both, read_mask, None,
           n_shifts, wa, wr, "shd_hamming_matrix")
    if wr > WR_MAX:
        raise ValueError(f"shd_hamming_matrix: wr={wr} exceeds the kernel's "
                         f"{WR_MAX}")
    args = [t.to(torch.int32).contiguous()
            for t in (anchor_hi, anchor_lo, read_hi_both, read_lo_both,
                      read_mask)]
    p = args[0].shape[0]
    out = torch.empty((p, 2, n_shifts), dtype=torch.int32,
                      device=args[0].device)
    _build.check_cuda("shd_hamming_matrix", *args, out)
    _build.launch("hrm_shd_hamming_matrix", out, *[t.data_ptr() for t in args],
                  out.data_ptr(), p, wa, wr, n_shifts)
    shd_hamming_matrix.launches += 1
    return out


shd_hamming_matrix.launches = 0

# collapse modes of shd_pairs_best, as csrc/shd.cu numbers them
PARITY, THREE_N, THREE_N_UNDIRECTIONAL = 0, 1, 2


def shd_pairs_best(read_bases, read_len, ridx, genome_hi, genome_lo,
                   anchor_global_start, anchor_length, anchor_left,
                   pair_valid, n_shifts: int, max_hamming_percent: float,
                   mode: int):
    """The coarse mapper's SHD stage in one launch of hrm_shd_pairs_best
    (CUDA tensors only; ops/shd.py::shd_pairs_best dispatches and holds
    the plain version): read ridx[p] of read_bases [B, L] int8 against
    the anchor at anchor_global_start[p] of the packed genome planes,
    collapsed per `mode`, shifts below n_shifts.  Returns (hamming, shift,
    orientation) [P] int32, int32, int8."""
    b, l = read_bases.shape
    p = ridx.shape[0]
    if (read_len.shape != (b,) or genome_lo.shape != genome_hi.shape
            or any(t.shape != (p,) for t in (
                anchor_global_start, anchor_length, anchor_left,
                pair_valid))):
        raise ValueError("shd_pairs_best: expected read_bases [B, L], "
                         "read_len [B], ridx and the pair vectors [P]")
    if not 1 <= (l + 31) // 32 <= WR_MAX or n_shifts > MAX_SHIFTS:
        raise ValueError(f"shd_pairs_best: L={l} (at most {32 * WR_MAX}) or "
                         f"window_size + 32 = {n_shifts} (at most "
                         f"{MAX_SHIFTS}) outside the kernel's range")
    if genome_hi.shape[0] < 1:
        raise ValueError("shd_pairs_best: empty genome planes")
    ins = [read_bases.to(torch.int8), read_len.to(torch.int32),
           ridx.to(torch.int64), genome_hi.to(torch.int32),
           genome_lo.to(torch.int32), anchor_global_start.to(torch.int64),
           anchor_length.to(torch.int64), anchor_left.to(torch.int64),
           pair_valid.to(torch.bool)]
    ins = [t.contiguous() for t in ins]
    dev = ins[0].device
    outs = [torch.empty(p, dtype=torch.int32, device=dev),
            torch.empty(p, dtype=torch.int32, device=dev),
            torch.empty(p, dtype=torch.int8, device=dev)]
    _build.check_cuda("shd_pairs_best", *ins, *outs)
    _build.launch("hrm_shd_pairs_best", outs[0],
                  *[t.data_ptr() for t in ins + outs],
                  p, l, genome_hi.shape[0], n_shifts,
                  float(max_hamming_percent), mode)
    shd_pairs_best.launches += 1
    return tuple(outs)


shd_pairs_best.launches = 0
