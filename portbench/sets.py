"""Runs of one cell for its bounds and its seeds: sets of runs on the same
seeds, then traced runs and further seeds, each run a process of its own
(python3 -m portbench.run), its output kept under --out.  Prints each
run's result, and for each set and end-to-end metric the median and the
spread (the distance between the first and third quartile of
statistics.quantiles(n=4), over the median), the spread with the run
farthest from the median left out, and last one JSON line of them all.

    python3 -m portbench.sets --workload chr1-3n.sam --seconds 20 \\
        --seeds 11 12 13 14 15 16 --sets 2 --traced 17 18 19 \\
        --extra 20 21 22 --out chiprun_out/sets

The bound of a metric is about five times the widest spread of a set.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional


def spread(values: List[float]) -> float:
    """Quartile distance over the median."""
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def trimmed_spread(values: List[float]) -> float:
    """The spread with the value farthest from the median left out."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def one_run(cell: str, seed: int, seconds: int, trace: int, out: str,
            tag: str) -> Optional[Dict]:
    """One run; returns its result object, or None."""
    base = os.path.join(out, f"{cell}.{tag}.{seed}.{trace}")
    t0 = time.perf_counter()
    with open(base + ".out", "w") as fo, open(base + ".err", "w") as fe:
        rc = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload", cell,
             "--seed", str(seed), "--seconds", str(seconds), "--trace",
             str(trace)], stdout=fo, stderr=fe).returncode
    wall = time.perf_counter() - t0
    with open(base + ".out") as fh:
        lines = fh.read().splitlines()
    res = json.loads(lines[-1]) if rc == 0 and lines else None
    brief = ({k: v["value"] for k, v in res["metrics"].items()}
             if res else None)
    print(f"RUN {cell} {tag} seed={seed} trace={trace} rc={rc} wall="
          f"{wall:.1f} correct={res['correct'] if res else None} {brief}",
          flush=True)
    if res is None:
        with open(base + ".err") as fh:
            print(fh.read()[-3000:], flush=True)
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.sets")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--traced", type=int, nargs="*", default=[])
    ap.add_argument("--extra", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    summary = {"workload": args.workload, "sets": [], "correct": [],
               "incorrect": []}
    for s in range(args.sets if args.seeds else 0):
        got: Dict[str, List[float]] = {}
        for seed in args.seeds:
            res = one_run(args.workload, seed, args.seconds, 0, args.out,
                          "AB"[s] if s < 2 else str(s))
            if res is None:
                summary["incorrect"].append(seed)
                continue
            summary["correct" if res["correct"] else "incorrect"].append(seed)
            for k, v in res["metrics"].items():
                got.setdefault(k, []).append(v["value"])
        stats = {k: {"median": statistics.median(v), "spread": spread(v),
                     "trimmed": trimmed_spread(v), "values": v}
                 for k, v in got.items() if len(v) >= 3}
        for k, v in stats.items():
            print(f"SET {s} {k}: median {v['median']} spread {v['spread']} "
                  f"trimmed {v['trimmed']}", flush=True)
        summary["sets"].append(stats)
    for trace, seeds in ((1, args.traced), (0, args.extra)):
        for seed in seeds:
            res = one_run(args.workload, seed, args.seconds, trace,
                          args.out, "T" if trace else "E")
            ok = res is not None and res["correct"]
            summary["correct" if ok else "incorrect"].append(seed)
    print(json.dumps(summary), flush=True)
    return 0 if not summary["incorrect"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
