"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit) and the bound arithmetic of a kernel: the least time the card
could take for the bytes it must move and the instructions it must issue.

The pipes are those that the port's integer kernels issue on (measured on
the H100 by the port's tools/int_rates.py): logic, shifts, compares and
selects on the ALU pipe, 64 lanes a clock a multiprocessor; multiply-adds
on the FMA pipe, 64; popcounts, 16; and four schedulers issue 128 lanes in
all, over the data sheet's clock (its 67 TFLOP/s of float32 are 132 SMs x
128 lanes x 2 operations x 1.98 GHz).  A copy of the port's chip smoke
arithmetic (chip_smoke.py::bound).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

MEM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 67e12 / (128 * 2)
PIPE_LANES = {"alu": 64, "fma": 64, "popc": 16}
ISSUE_LANES = 128


def bound_s(bytes_moved: float, instructions: Dict[str, float]
            ) -> Tuple[float, str]:
    """(seconds, 'bytes' or 'operations'): the larger of the bytes over the
    memory rate and the instructions' time, the largest of each pipe's
    count over its lanes and of all of them over the issue lanes."""
    t_bytes = bytes_moved / MEM_BYTES_PER_S
    clocks = max([instructions.get(k, 0) / n for k, n in PIPE_LANES.items()]
                 + [sum(instructions.values()) / ISSUE_LANES])
    t_ops = clocks / SM_CLOCKS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def vote_bound_s(f: int, n: int, c: int, out_cap: int) -> Tuple[float, str]:
    """The vote of one batch: [F, N, C] int64 candidate ids read once,
    ids [N, out_cap] int64, counts [N, out_cap] int32 and num_kept [N]
    int32 written once; merging the F ascending lists of C ids costs
    F*C*log2(F) 64-bit compare-and-selects (2 ALU operations each) a read,
    then a run-length count and a threshold test per id."""
    bytes_moved = 8 * f * n * c + n * out_cap * (8 + 4) + 4 * n
    alu = n * f * c * (2 * int(math.log2(f)) + 2)
    return bound_s(bytes_moved, {"alu": alu})
