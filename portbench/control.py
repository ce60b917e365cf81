"""The control of the comparison that decides `correct`: the plain
reference put in the program's place with one guarantee of the
configuration broken, compared as a run's output is compared.

The configuration states 16 hash functions (32 tables in 3N); the control
keeps the first FUNCTIONS (8) of them, the cheaper and
coarser index that a later change might be tempted by.  It maps the cell's
checked pass (its reads, its batches) from the seed's inputs and reports
rows_differ and counters_differ against the reference as configured;
`correct` needs both at 0, so the control has to read above it.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

Runs on the card (the cell's own size); the benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from . import inputs, manifest
from .check import reference_options, rows_differ
from .reference import coarse

FUNCTIONS = 8


def checked_rows(mix: Dict) -> int:
    """Reads of the checked pass: the pass of a sam mix, the pool else."""
    return int(mix.get("pass_reads", mix["reads"]["pool"]))


def readings(config: Dict, mix: Dict, seed: int, device) -> Dict[str, int]:
    """rows_differ and counters_differ of the control against the
    reference on one seed's checked pass."""
    _, chroms = inputs.make_genome(config, seed, device)
    bases, lengths, _ = inputs.make_reads(mix["reads"], chroms, seed, device)
    n = checked_rows(mix)
    out = {}
    for label, override in (("reference", {}),
                            ("control", {"num_hash_functions": FUNCTIONS})):
        ropts = reference_options(config["options"], **override)
        mapper = coarse.ReferenceMapper(chroms, ropts, device)
        out[label] = mapper.map_reads(bases[:n], lengths[:n])
        del mapper
    (p_ref, o_ref), (p_ctl, o_ctl) = out["reference"], out["control"]
    p_ctl = p_ctl.astype(np.int64)
    p_ctl[:, 5] &= 0xFFFFFFFF
    return {"rows_differ": rows_differ(p_ctl, p_ref),
            "counters_differ": int(np.abs(o_ctl - o_ref).sum())}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    config = manifest.config(bench, cell["config"])
    mix = manifest.traffic(cell["traffic"])
    import torch
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        got = readings(config, mix, seed, torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "functions": FUNCTIONS, **got,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
