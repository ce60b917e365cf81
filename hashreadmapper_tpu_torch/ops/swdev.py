"""Batched on-device SSW score passes, STEP-2 fine alignment (counterpart
of hashreadmapper_tpu/ops/swdev.py).

Forward pass (score1, ref_end, query_end, and the second best from the
per-column maxima), reverse pass on the reversed read prefix (begins,
terminate = score1), and the all-M diagonal certificate, over pair
tensors in the JAX package's transposed [L, P] layout.  All of it is
ops/swdev_kernel.py::sw_forward and sw_reverse (one CUDA launch each for
CUDA tensors, their plain versions for CPU tensors), which write their
rows of the [10, P] score tensor in place; the reverse pass ends with the
certificate.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .swdev_kernel import N_SCORE_ROWS, sw_forward, sw_reverse


def require_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises
    (nothing falls back to the CPU unless the caller asks for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: torch.cuda.is_available() "
                           "is False; pass device='cpu' to run the plain "
                           "PyTorch versions")
    return dev


def _forward_t(read_t, read_len, ref_tt, ref_len, mask_len, n_cols: int):
    """Forward byte-mode pass over [LQ, P] reads and [>= n_cols, P] refs,
    as named [P] fields."""
    out = sw_forward(read_t, read_len, ref_tt, ref_len, mask_len, n_cols)
    return {"score1": out[0], "ref_end": out[1], "query_end": out[2],
            "score2": out[3], "ref_end2": out[4], "overflowed": out[8] != 0}


def _reverse_t(read_t, ref_tt, score1, ref_end, query_end, n_cols: int):
    """Reverse byte-mode pass: the reversed read[:query_end+1] against
    ref[:ref_end+1], descending columns, terminate = score1, as named [P]
    fields."""
    out = sw_reverse(read_t, ref_tt, score1, ref_end, query_end, n_cols)
    return {"ref_begin": out[5], "query_begin": out[6],
            "flag2": out[7] != 0, "overflowed": out[8] != 0}


def ssw_score_packed_t(read_t, read_len, ref_tt, ref_len, mask_len,
                       n_cols: int) -> torch.Tensor:
    """Forward + reverse pass + diag certificate over transposed pairs
    (read_t [LQ, P], ref_tt [LR, P]).  One [10, P] int32 tensor; rows:
    score1, ref_end, query_end, score2, ref_end2, ref_begin, query_begin,
    flag2, overflowed (fwd | rev), diag."""
    out = torch.empty((N_SCORE_ROWS, read_t.shape[1]), dtype=torch.int32,
                      device=read_t.device)
    sw_forward(read_t, read_len, ref_tt, ref_len, mask_len, n_cols, out)
    sw_reverse(read_t, ref_tt, out[0], out[1], out[2], n_cols, out)
    return out


def ssw_score_packed(read_codes, read_len, ref_codes, ref_len, mask_len,
                     n_cols: int) -> torch.Tensor:
    """Row-major wrapper of ssw_score_packed_t ([P, LQ], [P, LR])."""
    return ssw_score_packed_t(read_codes.T.contiguous(), read_len,
                              ref_codes.T.contiguous(), ref_len, mask_len,
                              n_cols)


def ssw_score_dispatch(read_codes, read_len, ref_codes, ref_len, mask_len,
                       device) -> torch.Tensor:
    """Upload one chunk of numpy pairs to `device` and enqueue its score
    passes; returns the [10, P] tensor without synchronising."""
    device = require_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return ssw_score_packed(t(read_codes), t(read_len), t(ref_codes),
                            t(ref_len), t(mask_len),
                            int(ref_codes.shape[1]))


def unpack_scores(packed: np.ndarray) -> Dict[str, np.ndarray]:
    """[10, P] score rows -> named fields (swdev.ssw_score_collect)."""
    return {
        "score1": packed[0], "score2": packed[3],
        "ref_end": packed[1], "ref_end2": packed[4],
        "query_end": packed[2], "ref_begin": packed[5],
        "query_begin": packed[6],
        "flag": np.where(packed[7] != 0, 2, 0).astype(np.int32),
        "degenerate": (packed[0] == 0) | (packed[1] < 0),
        "host_fallback": packed[8].astype(bool),
        "diag": packed[9].astype(bool),
    }


def ssw_score_collect(packed_dev: torch.Tensor) -> Dict[str, np.ndarray]:
    """Fetch and unpack one dispatched chunk."""
    return unpack_scores(packed_dev.cpu().numpy())


def ssw_score_batch(read_codes, read_len, ref_codes, ref_len, mask_len,
                    device="cuda") -> Dict[str, np.ndarray]:
    """Forward + reverse over numpy pairs on `device` (the card unless the
    caller asks for "cpu"; raises without one), results as numpy."""
    return ssw_score_collect(ssw_score_dispatch(
        read_codes, read_len, ref_codes, ref_len, mask_len, device))
