"""Shifted Hamming distance against extended genome windows (counterpart
of hashreadmapper_tpu/ops/shd.py, the packed-planes production path).

The anchor is the candidate window extended by read_len // 2 each side
(left extension all-or-nothing); reads slide over every full-overlap shift
in both orientations; strictly smaller scores win, ties keep the forward
orientation and the earlier shift; orientation is NONE above
trunc(float32(read_len) * float32(max_hamming_percent)) or when the read
is longer than the anchor.

shd_pairs_best is the coarse mapper's whole SHD stage: for CUDA tensors
one launch of csrc/shd.cu through shd_kernel.shd_pairs_best (read planes,
anchor gather and collapses, best shift, finish), for CPU tensors its
plain version, the composition of pack_read_planes, the per-pair gathers
and shd_pairs_packed_planes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import encode, shd_kernel
from .shd_kernel import (collapse_planes_ct, collapse_planes_ga,
                         pack_bitplanes, shd_best)

FORWARD = 1
REVERSE_COMPLEMENT = 2
NONE = 3


class ExtendedWindows(NamedTuple):
    start: torch.Tensor    # [P] chromosome-local start of extended window
    left: torch.Tensor     # [P] applied left extension
    length: torch.Tensor   # [P] extended-window length


def extended_window_location(pos, chrom_len, read_len, window_size: int
                             ) -> ExtendedWindows:
    """Vectorised computeWindowLocation (hashreadmapper_tpu shd.py:53)."""
    ext = read_len // 2
    zero = torch.zeros_like(ext)
    left = torch.where(ext < pos, ext, zero)
    end = pos + window_size
    in_bounds = end <= chrom_len
    right = torch.where(in_bounds,
                        torch.where(end + ext < chrom_len, ext,
                                    chrom_len - end),
                        zero)
    length = window_size + left + right - torch.where(
        in_bounds, zero, end - chrom_len)
    return ExtendedWindows(start=pos - left, left=left, length=length)


class ShdParams(NamedTuple):
    window_size: int
    max_ext_len: int       # window_size + max_read_len
    max_read_len: int
    max_hamming_percent: float


class ShdResult(NamedTuple):
    hamming: torch.Tensor      # [P] int32 best score
    shift: torch.Tensor        # [P] int32 shift in window coordinates
    orientation: torch.Tensor  # [P] int8 FORWARD / REVERSE_COMPLEMENT / NONE


def finalize_shd_from_best(best4, anchor_length, anchor_left, read_len,
                           pair_valid, params: ShdParams) -> ShdResult:
    """Orientation, threshold and shift from the per-orientation bests;
    forward wins orientation ties."""
    best_f, shift_f, best_r, shift_r = best4.unbind(1)
    use_rc = best_r < best_f
    best = torch.where(use_rc, best_r, best_f)
    best_shift = torch.where(use_rc, shift_r, shift_f)
    too_long = read_len > anchor_length
    threshold = (read_len.to(torch.float32) * torch.tensor(
        params.max_hamming_percent, dtype=torch.float32,
        device=read_len.device)).to(torch.int32)
    good = (best <= threshold) & ~too_long & pair_valid
    orientation = torch.where(
        good, torch.where(use_rc, REVERSE_COMPLEMENT, FORWARD), NONE)
    zero = torch.zeros_like(best_shift)
    score = torch.where(too_long, read_len.to(best.dtype), best)
    shift = (torch.where(too_long, zero, best_shift)
             - torch.where(too_long, zero, anchor_left.to(best_shift.dtype)))
    return ShdResult(hamming=score.to(torch.int32),
                     shift=shift.to(torch.int32),
                     orientation=orientation.to(torch.int8))


def pack_read_planes(read_bases: torch.Tensor, read_len: torch.Tensor,
                     three_n: bool, undirectional: bool = False):
    """Per-read planes (hi_o0, lo_o0, hi_o1, lo_o1, mask) [N, wr]:
    orientation 0 is the read (CT-collapsed in 3N mode), orientation 1 its
    reverse complement (GA-collapsed in 3N mode); parity mode packs both
    un-collapsed.  undirectional=True mirrors the 3N collapses for the
    PBAT strands: orientation 0 GA-collapsed, orientation 1 CT-collapsed."""
    wr = (read_bases.shape[1] + 31) // 32
    rc = encode.revcomp_bases(read_bases, read_len)
    if three_n and undirectional:
        o0 = encode.three_n_g_to_a(read_bases)
        o1 = encode.three_n_c_to_t(rc)
    elif three_n:
        o0 = encode.three_n_c_to_t(read_bases)
        o1 = encode.three_n_g_to_a(rc)
    else:
        o0, o1 = read_bases, rc
    hi0, lo0, mask = pack_bitplanes(o0, read_len, wr)
    hi1, lo1, _ = pack_bitplanes(o1, read_len, wr)
    return hi0, lo0, hi1, lo1, mask


def shd_pairs_packed_planes(genome_hi, genome_lo, anchor_global_start,
                            anchor_length, anchor_left, r_hi_f, r_lo_f,
                            r_hi_r, r_lo_r, mask, read_len, pair_valid,
                            params: ShdParams, three_n: bool = False,
                            undirectional: bool = False) -> ShdResult:
    """SHD over pairs whose read planes are already packed and gathered:
    word-aligned anchor gathers from the packed genome, the sub-word start
    folded into the shift bounds and taken back off the result.  The
    anchor planes are collapsed as pack_read_planes collapses the reads:
    CT / GA per orientation in 3N mode, GA / CT with undirectional, none
    in parity mode."""
    p, wr = r_hi_f.shape
    s_max = params.window_size + 32
    wa_pad = (s_max - 1) // 32 + wr + 2
    gstart = anchor_global_start.to(torch.int64)
    word0 = gstart.clamp(min=0) >> 5
    bit0 = gstart & 31
    widx = (word0[:, None] + torch.arange(wa_pad, device=gstart.device)
            ).clamp(0, genome_hi.shape[0] - 1)
    a_hi, a_lo = genome_hi[widx], genome_lo[widx]              # [P, wa_pad]
    if three_n and undirectional:
        f_hi, f_lo = collapse_planes_ga(a_hi, a_lo)
        r2_hi, r2_lo = collapse_planes_ct(a_hi, a_lo)
    elif three_n:
        f_hi, f_lo = collapse_planes_ct(a_hi, a_lo)
        r2_hi, r2_lo = collapse_planes_ga(a_hi, a_lo)
    else:
        f_hi, f_lo, r2_hi, r2_lo = a_hi, a_lo, a_hi, a_lo
    max_shift = bit0 + (anchor_length - read_len)
    bounds = torch.stack([bit0, max_shift], dim=1).to(torch.int32)
    best4 = shd_best(torch.stack([f_hi, r2_hi], dim=1),
                     torch.stack([f_lo, r2_lo], dim=1),
                     torch.stack([r_hi_f, r_hi_r], dim=1),
                     torch.stack([r_lo_f, r_lo_r], dim=1),
                     mask, bounds, s_max, wa_pad, wr)
    b0 = bit0.to(torch.int32)
    best4 = torch.stack([best4[:, 0], best4[:, 1] - b0,
                         best4[:, 2], best4[:, 3] - b0], dim=1)
    return finalize_shd_from_best(best4, anchor_length, anchor_left,
                                  read_len, pair_valid, params)


def shd_pairs_best_plain(read_bases, read_len, ridx, genome_hi, genome_lo,
                         anchor_global_start, anchor_length, anchor_left,
                         pair_valid, params: ShdParams, three_n: bool = False,
                         undirectional: bool = False) -> ShdResult:
    """Plain version of shd_pairs_best: the read planes packed per read,
    gathered per pair, then shd_pairs_packed_planes."""
    hi0, lo0, hi1, lo1, mask = pack_read_planes(read_bases, read_len,
                                                three_n, undirectional)
    return shd_pairs_packed_planes(
        genome_hi, genome_lo, anchor_global_start, anchor_length,
        anchor_left, hi0[ridx], lo0[ridx], hi1[ridx], lo1[ridx], mask[ridx],
        read_len.to(torch.int64)[ridx], pair_valid, params, three_n=three_n,
        undirectional=undirectional)


def shd_pairs_best(read_bases, read_len, ridx, genome_hi, genome_lo,
                   anchor_global_start, anchor_length, anchor_left,
                   pair_valid, params: ShdParams, three_n: bool = False,
                   undirectional: bool = False) -> ShdResult:
    """SHD of P (read, anchor) pairs from the reads themselves: read
    ridx[p] of read_bases [B, L] int8 (lengths read_len [B]) against the
    anchor at anchor_global_start[p] of the packed genome planes, collapsed
    per orientation as pack_read_planes and shd_pairs_packed_planes
    collapse (3N, 3N undirectional or parity); the ShdResult of
    shd_pairs_packed_planes.  CUDA tensors launch
    shd_kernel.shd_pairs_best (L <= 32 * shd_kernel.WR_MAX), CPU tensors take
    shd_pairs_best_plain."""
    if read_bases.device.type == "cpu":
        return shd_pairs_best_plain(
            read_bases, read_len, ridx, genome_hi, genome_lo,
            anchor_global_start, anchor_length, anchor_left, pair_valid,
            params, three_n, undirectional)
    mode = (shd_kernel.THREE_N_UNDIRECTIONAL if three_n and undirectional
            else shd_kernel.THREE_N if three_n else shd_kernel.PARITY)
    return ShdResult(*shd_kernel.shd_pairs_best(
        read_bases, read_len, ridx, genome_hi, genome_lo,
        anchor_global_start, anchor_length, anchor_left, pair_valid,
        params.window_size + 32, params.max_hamming_percent, mode))
