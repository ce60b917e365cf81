"""Seconds of the chr1-scale index build on the card, by phase.

    python -m hashreadmapper_tpu_torch.tools.index_build_time [builds]

Run from the repository root: it takes chip_smoke.py's chr1-sized random
genome (seed 4, phase 4) and options (flagship with the at-scale caps).
It builds CoarseMapper `builds` times (default 3) after one build that
warms up (the kernels' build, CUDA's start), and prints each build's
seconds: the window table, the window signatures (bases, launches and
whatever joins them), the CSR index, its buckets and its cuckoo table,
each behind a synchronize, and the whole.  The phases are timed by
wrapping engine and index functions, so the same script times another
checkout of the package when run from that checkout's root.
"""

import functools
import os
import statistics
import sys
import time

import numpy as np
import torch


def timed(owner, name, label, spent):
    """Wrap owner.name so its seconds, behind a synchronize at each end,
    add to spent[label]."""
    fn = getattr(owner, name)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        spent[label] = spent.get(label, 0.0) + time.perf_counter() - t0
        return out
    setattr(owner, name, wrapper)


def main(argv):
    if not torch.cuda.is_available():
        print("index_build_time: no CUDA device", file=sys.stderr)
        return 1
    builds = int(argv[0]) if argv else 3
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from hashreadmapper_tpu_torch import cli
    from hashreadmapper_tpu_torch.index import minhash_index as mi
    from hashreadmapper_tpu_torch.io.genome import Genome
    from hashreadmapper_tpu_torch.pipeline import engine
    spent = {}
    timed(engine, "build_window_table", "table", spent)
    timed(engine.CoarseMapper, "_build_window_index", "sig+csr", spent)
    timed(engine.mi, "build_csr_index_device", "csr", spent)
    timed(mi.CsrIndex, "build_buckets", "buckets", spent)
    timed(mi.CsrIndex, "build_cuckoo", "cuckoo", spent)
    rng = np.random.default_rng(4)
    chrom = rng.integers(0, 4, size=cs.CHR1_LEN, dtype=np.int8)
    genome = Genome(["chr1"], [cs.ACGT[chrom].tobytes().decode()])
    opts, _ = cli.options_from_args(cs.FLAGSHIP + cs.AT_SCALE)
    rows = []
    for i in range(builds + 1):
        spent.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mapper = engine.CoarseMapper(genome, opts, "cuda")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        phases = {"table": spent.get("table", 0.0),
                  "signatures": spent["sig+csr"] - spent["csr"],
                  "csr": spent["csr"], "buckets": spent.get("buckets", 0.0),
                  "cuckoo": spent.get("cuckoo", 0.0), "total": total}
        windows = mapper.table.num_windows
        del mapper
        torch.cuda.empty_cache()
        if i == 0:
            continue                        # warm-up
        rows.append(phases)
        print(f"build {i}: " + ", ".join(f"{k} {v:.4f} s"
                                         for k, v in phases.items()))
    print(f"{windows} windows, {torch.cuda.get_device_name(0)}; medians: "
          + ", ".join(f"{k} {statistics.median(r[k] for r in rows):.4f} s"
                      for k in rows[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
