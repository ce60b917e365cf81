"""STEP 2's per-read rows of a coarse-mapped batch as one kernel
(counterpart of the pair build in hashreadmapper_tpu/pipeline/engine.py::
fused_step2_scores and of the host's rebuild of the same rows in
hashreadmapper_tpu/pipeline/mapping.py::_run_cssw_device; no pallas_call
stands behind it).

step2_rows: from a batch's read codes, lengths and packed coarse rows, and
the staged genome letters, every row STEP 2 reads of a read, written once:
the score passes' transposed 3N pairs (ops/swdev.py::ssw_score_packed_t and
ops/bandtb.py::fused_traceback_t take them as they are) and the host's rows
(the query and its reverse complement, the window and the RC window in
ASCII, the window length, the pairs' and the window's 3N codes), which
pipeline/mapping.py::run_cssw finishes, rescores and writes from.

For CUDA tensors it launches csrc/step2rows.cu, for CPU tensors it runs
the plain version, the port's torch code.  Nothing falls back: a CUDA
input the kernel cannot take raises ValueError.  The letter tables are the
program's own (align/sw.py's TRANSLATE, io/genome.py's complement table),
staged on the device with the letters (tables()).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..align import sw
from ..io import genome as genome_io

_ACGT = np.array(list(b"ACGT"), dtype=np.uint8)


def tables(device) -> tuple:
    """(translate [256] int8: a letter's code 0..4, complement [256] uint8:
    a letter's complement) on device."""
    return (torch.from_numpy(sw.TRANSLATE.copy()).to(device),
            torch.from_numpy(genome_io._COMPLEMENT_LUT.copy()).to(device))


def step2_rows_plain(read_bases, read_len, packed, offset, chrom_len,
                     letters, translate, complement, window_size: int,
                     undirectional: bool):
    """Plain version of step2_rows."""
    b, lq = read_bases.shape
    ws = window_size
    dev = read_bases.device
    p = packed.to(torch.int64)
    ori, pos = p[:, 0], p[:, 4]
    chrom = p[:, 3].clamp(0, chrom_len.shape[0] - 1)
    is_rc = (ori == 2)[:, None]
    ga = (((p[:, 6] != 0) & (ori == 1)) if undirectional
          else torch.zeros_like(is_rc[:, 0]))[:, None]
    n = read_len.to(torch.int64).clamp(0, lq)[:, None]
    idx = torch.arange(lq, device=dev)[None, :]
    valid = idx < n
    f = read_bases.to(torch.int64)
    rcc = torch.where(valid, 3 - torch.gather(f, 1, (n - 1 - idx).clamp(
        0, lq - 1)), 0)
    fwd = torch.where(is_rc, rcc, f)
    rcq = torch.where(is_rc, torch.where(valid, f, 0), rcc)
    acgt = torch.from_numpy(_ACGT).to(dev)

    def collapse(c):
        return torch.where(ga, torch.where(c == 2, 0, c),
                           torch.where(c == 1, 3, c)).to(torch.int8)
    q3 = torch.stack([collapse(fwd), collapse(rcq)], dim=1).reshape(2 * b, lq)

    clen = chrom_len[chrom]
    wlen = torch.where(pos + ws < clen, ws, clen - pos)
    iw = torch.arange(ws, device=dev)[None, :]
    v = iw < wlen[:, None]
    base = (offset[chrom] + pos)[:, None]
    g = letters.shape[0]
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    win = torch.where(v, letters[(base + iw).clamp(0, g - 1)], zero)
    back = complement[letters[(base - iw).clamp(0, g - 1)].to(torch.int64)]
    win_rc = torch.where(v & (pos[:, None] - iw >= 0), back, zero)
    win3 = collapse(translate[win.to(torch.int64)].to(torch.int64))
    return (q3.T.contiguous(),
            win3.repeat_interleave(2, dim=0).T.contiguous(),
            acgt[fwd & 3], acgt[rcq & 3], win, win_rc,
            wlen.to(torch.int32), q3, win3)


def _expect(name: str, t: torch.Tensor, shape, dtype) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t.to(dtype).contiguous()


def step2_rows(read_bases, read_len, packed, offset, chrom_len, letters,
               translate, complement, window_size: int,
               undirectional: bool):
    """Read codes [B, L] (0..3), lengths [B] and packed coarse rows [B, 7]
    (orientation, chromosome, position, strand in columns 0, 3, 4, 6), the
    staged letters [G] uint8 with offset [C] (a chromosome's base 0 in
    them) and chrom_len [C], and tables() -> (pair_q_t [L, 2B] int8,
    pair_ref_t [ws, 2B] int8, q [B, L] uint8, rcq [B, L] uint8, win
    [B, ws] uint8, win_rc [B, ws] uint8, wlen [B] int32, q3 [2B, L] int8,
    win3 [B, ws] int8).

    q is the read in ASCII, reverse-complemented when the orientation is
    RC (2), rcq its reverse complement (code 0, 'A', past the length in a
    reverse complement; the forward read keeps its codes there); win the
    letters at position + i for i < wlen (ws, or the rest of the
    chromosome), 0 past it; win_rc the complement of the letter at
    position - i, 0 where that is negative or i >= wlen; q3 rows 2i, 2i + 1
    and win3 the 3N codes of q, rcq and win (TRANSLATE, then C->T, or G->A
    for a read whose strand is 1 in FORWARD orientation under
    undirectional); pair_q_t = q3.T and pair_ref_t each win3 row twice,
    transposed."""
    if read_bases.device.type == "cpu":
        return step2_rows_plain(read_bases, read_len, packed, offset,
                                chrom_len, letters, translate, complement,
                                window_size, undirectional)
    if read_bases.dim() != 2 or read_bases.shape[1] < 1 or window_size < 1:
        raise ValueError(f"step2_rows: expected read_bases [B, L], L >= 1, "
                         f"and a window size >= 1, got "
                         f"{tuple(read_bases.shape)}, {window_size}")
    b, lq = read_bases.shape
    ws = window_size
    n_chrom, g = chrom_len.shape[0], letters.shape[0]
    if n_chrom < 1 or g < 1:
        raise ValueError("step2_rows: no chromosomes or no letters")
    ins = [_expect("step2_rows read_bases", read_bases, (b, lq), torch.int8),
           _expect("step2_rows read_len", read_len, (b,), torch.int32),
           _expect("step2_rows packed", packed, (b, 7), torch.int32),
           _expect("step2_rows offset", offset, (n_chrom,), torch.int64),
           _expect("step2_rows chrom_len", chrom_len, (n_chrom,),
                   torch.int64),
           _expect("step2_rows letters", letters, (g,), torch.uint8),
           _expect("step2_rows translate", translate, (256,), torch.int8),
           _expect("step2_rows complement", complement, (256,),
                   torch.uint8)]
    dev = read_bases.device

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)
    outs = [empty((lq, 2 * b), torch.int8), empty((ws, 2 * b), torch.int8),
            empty((b, lq), torch.uint8), empty((b, lq), torch.uint8),
            empty((b, ws), torch.uint8), empty((b, ws), torch.uint8),
            empty((b,), torch.int32), empty((2 * b, lq), torch.int8),
            empty((b, ws), torch.int8)]
    _build.check_cuda("step2_rows", *ins, *outs)
    _build.launch("hrm_step2_rows", ins[0],
                  *[t.data_ptr() for t in ins + outs], b, lq, ws, n_chrom, g,
                  int(undirectional))
    step2_rows.launches += 1
    return tuple(outs)


step2_rows.launches = 0
