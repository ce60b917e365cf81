"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Loads the cell of BENCHMARK.json, its configuration and its traffic mix,
makes the genome and the read pool from the seed on the card, builds the
port's index, warms the cell's own shapes, then runs passes of the mix's
entry (entries.py) until --seconds have passed, the window ending at the
first pass boundary after that.  With --trace 1 the window runs under
torch.profiler and the per-layer metrics are reported instead of the
end-to-end ones.  Then the program's state is freed and its outputs are
compared with the plain reference (check.py).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown when traced), and last the numbers
compared, each with its limit; those numbers are also the last lines of
standard error.  Exits non-zero without a result when there is no CUDA
card, fewer cards than the cell asks for, or when jax, jaxlib, flax or the
JAX package is loaded in this process once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from . import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hashreadmapper_tpu")
NOT_MEASURED = "not measured"
CACHE_DIR = os.path.join(manifest.ROOT, ".portbench_cache")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Record:
    """What a per-layer metric's reader reads from a traced run."""

    def __init__(self, spans, passes, device_trace, cards, opts):
        self.spans = spans              # trace.Spans of the run
        self.passes = passes            # [(reads, t0_ns, t1_ns)] the window
        self.device = device_trace      # trace.DeviceTrace, or None
        self.cards = cards              # card indices the run used
        self.opts = opts                # the program's options
        self.t0 = passes[0][1]
        self.t1 = passes[-1][2]

    @property
    def reads(self) -> int:
        return sum(n for n, _, _ in self.passes)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def span_s(self, name: str) -> float:
        return self.spans.total_s(name, self.t0, self.t1)


class Context:
    """The run's inputs and entry, as the check reads them."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"
    return out.stdout.strip().replace("\n", "; ")


def _build_entry(mix, config, opts, dev, seed, workdir, spans, log):
    """The inputs from the seed, the program's mapper and the entry."""
    from hashreadmapper_tpu_torch.io.genome import Genome
    from hashreadmapper_tpu_torch.io.readstore import ReadStorage, pack_rows
    from hashreadmapper_tpu_torch.parallel.sharded import ShardedCoarseMapper
    from hashreadmapper_tpu_torch.pipeline.driver import build_mesh
    from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper
    from . import entries, inputs

    t = time.perf_counter()
    names, chroms = inputs.make_genome(config, seed, dev)
    raw, lengths, truth = inputs.make_reads(mix["reads"], chroms, seed, dev)
    genome = Genome(names, inputs.genome_strings(chroms))
    pitch = -(-int(lengths.max()) // 16)
    reads = ReadStorage(pack_rows(raw, lengths, pitch), lengths,
                        ambiguous=lengths < 0)
    bases = reads.bases_matrix(opts.max_read_length).astype("int8")
    print(f"inputs: {sum(len(c) for c in chroms)} bp, {len(lengths)} reads "
          f"in {time.perf_counter() - t:.3f} s", file=log)
    t = time.perf_counter()
    mesh = build_mesh(opts, dev)
    mapper = (ShardedCoarseMapper(genome, opts, mesh) if mesh is not None
              else CoarseMapper(genome, opts, dev))
    print(f"index: {mapper.memory_bytes()} B in "
          f"{time.perf_counter() - t:.3f} s", file=log)
    common = (mix, mapper, opts, genome, bases, lengths, spans, workdir)
    if mix["entry"] == "sam":
        entry = entries.SamEntry(*common, reads=reads,
                                 genome_rc=genome.reverse_complement())
    elif mix["entry"] == "coarse":
        entry = entries.CoarseEntry(*common)
    else:
        raise ValueError(f"unknown entry {mix['entry']!r}")
    return entry, dict(names=names, chroms=chroms, bases=raw,
                       lengths=lengths, truth=truth)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: Optional[Dict] = None,
             config: Optional[Dict] = None, mix: Optional[Dict] = None,
             log=sys.stderr) -> Dict:
    """One run of a cell; returns the result object.  device 'cpu' is a
    rehearsal with the program's plain versions: it measures nothing and
    says so."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    bench = bench or manifest.load()
    cell = manifest.cell(bench, cell_name)
    config = config or manifest.config(bench, cell["config"])
    mix = mix or manifest.traffic(cell["traffic"])
    import torch
    from torch.profiler import ProfilerActivity, profile
    from hashreadmapper_tpu_torch import cli
    from . import check, trace as tr

    on_card = device == "cuda"
    chips = int(cell["chips"])
    cards = list(range(chips)) if on_card else []
    power = _power_limit() if on_card else NOT_MEASURED
    opts, dev = cli.options_from_args(list(config["options"])
                                      + ["--device", device])
    spans = tr.Spans()
    workdir = tempfile.mkdtemp(prefix="portbench-")
    entry = None
    try:
        entry, data = _build_entry(mix, config, opts, dev, seed, workdir,
                                   spans, log)

        def sync():
            for c in cards:
                torch.cuda.synchronize(c)
        entry.warm()
        sync()
        setup_s = time.perf_counter() - T_START
        print(f"set-up {setup_s:.3f} s; window of {seconds} s", file=log)
        prof = None
        if trace:
            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if on_card else []))
            prof.__enter__()
        t_window = time.perf_counter()
        passes = []
        p = 0
        while True:
            t0 = time.time_ns()
            with spans.span("pass"):
                n = entry.run_pass(p)
            passes.append((n, t0, time.time_ns()))
            p += 1
            if time.perf_counter() - t_window >= seconds:
                break
        sync()
        if prof is not None:
            prof.__exit__(None, None, None)
        rec = Record(spans, passes, None, cards, opts)
        if prof is not None and on_card:
            rec.device = tr.DeviceTrace.from_profiler(prof, rec.t0, rec.t1)
        del prof
        secs = sorted((b - a) / 1e9 for _, a, b in passes)
        print(f"window: {len(passes)} passes, {rec.reads} reads in "
              f"{rec.window_s:.6f} s; a pass {secs[0]:.4f} / "
              f"{secs[len(secs) // 2]:.4f} / {secs[-1]:.4f} s (min / median "
              "/ max)", file=log)
        peak = max((torch.cuda.max_memory_allocated(c) for c in cards),
                   default=0)
        # the program's state goes before the reference runs
        entry.mapper = entry.proxy = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        ctx = Context(config=config, mix=mix, seed=seed, entry=entry,
                      device=dev if on_card else "cpu", log=log, **data)
        t = time.perf_counter()
        numbers = check.run(ctx)
        print(f"check: {time.perf_counter() - t:.3f} s", file=log)
    finally:
        if entry is not None:
            entry.close()
        shutil.rmtree(workdir, ignore_errors=True)

    def metric(value, unit):
        return {"value": value if on_card else NOT_MEASURED, "unit": unit}
    metrics = {}
    if not trace:
        values = {"setup_s": setup_s,
                  mix["rate_metric"]: rec.reads / rec.window_s}
        for m in manifest.metrics_of(bench, cell_name, "end_to_end"):
            metrics[m["name"]] = metric(values[m["name"]], m["unit"])
    else:
        for m in manifest.metrics_of(bench, cell_name, "per_layer"):
            v = manifest.reader(m["name"])(rec)
            if v is None:
                continue
            top = 105 if m["unit"] == "%" else 1.05 if m["unit"] == "share" \
                else None
            if top is not None and v > top:
                raise AssertionError(f"{m['name']} reads {v} {m['unit']}: "
                                     "its count or its time is wrong")
            metrics[m["name"]] = metric(v, m["unit"])
    dev_out = {"platform": "gpu" if on_card else "cpu",
               "kind": (torch.cuda.get_device_name(0) if on_card
                        else NOT_MEASURED),
               "count": chips if on_card else 0,
               "memory_peak_bytes": peak if on_card else NOT_MEASURED,
               "power_limit": power}
    result = {"correct": all(v <= lim for _, v, lim in numbers),
              "attempted": rec.reads,
              "failed": sum(v for name, v, _ in numbers
                            if name.endswith("rows_differ")),
              "metrics": metrics, "device": dev_out}
    if trace and rec.device is not None:
        dt = rec.device
        dev_out["busy_s"] = sum(dt.busy_s(c) for c in cards) / len(cards)
        dev_out["window_s"] = dt.window_s
        result["breakdown"] = {
            "device_ops": dt.top_ops(10),
            "idle_gaps": [[{"pipelined_sw": "wait_workers"}.get(k, k), s]
                          for k, s in dt.labelled_gaps(spans, cards[0])]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in numbers}
    for name, v, lim in numbers:
        print(f"{name} {v} limit {lim}", file=log)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest.load()
    chips = int(manifest.cell(bench, args.workload)["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} card(s)", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", bench)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
