"""The batch steps as captured CUDA graphs (this checkout) beside another
checkout's steps (the parent commit's eager ones, say), on one card, in
one process, alternated.

    python -m hashreadmapper_tpu_torch.tools.graph_compare OTHER_DIR

Run it from the repo root: it takes chip_smoke.py's data (the flagship 8
Mbp genome and 49,152 planted reads, the four-strand reads of phase 5,
phase 6's 16,384 unconverted reads).  OTHER_DIR is the root of another
checkout; its hashreadmapper_tpu_torch is loaded under the name hrm_other
(tools/launch_host_compare.py's loader).  For the flagship 3N,
--undirectional, parity and --regions 4 runs it builds each side's mapper
through its CLI, checks that both map every read alike (packed rows,
stats and the fused STEP-2 bundle), then prints coarse and coarse +
STEP 2 reads/s in the order other, this, this, other, other, this
(medians of 3), and for each side the host's launches, the device's
launches and the card's busy share of one map_reads(with_scores=True)
under torch.profiler; then map_genome of the window stream alike, and
the flagship CLI's whole run alternated.  Every line names the card and
its power limit.
"""

import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .launch_host_compare import load_other

ORDER = ("other", "this", "this", "other", "other", "this")
FIELDS = ("orientation", "hamming", "shift", "chromosome_id", "position",
          "global_window_id", "bs_strand")


def alternated(fns, order=ORDER):
    """{side: [seconds]} of fns[side]() in `order`."""
    times = {side: [] for side in fns}
    for side in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[side]()
        times[side].append(time.perf_counter() - t0)
    return times


def same(label, a, b):
    ra, rb = (x[0] if isinstance(x, tuple) else x for x in (a, b))
    for f in FIELDS:
        if not np.array_equal(getattr(ra, f), getattr(rb, f)):
            raise AssertionError(f"{label}: {f} differs between checkouts")
    if ra.stats != rb.stats:
        raise AssertionError(f"{label}: stats {ra.stats} != {rb.stats}")
    if isinstance(a, tuple):
        for x, y in zip(a[1], b[1]):
            if not np.array_equal(x, y):
                raise AssertionError(f"{label}: the STEP-2 bundle differs")


def rates(label, n, times, what):
    rate = {side: n / statistics.median(t) for side, t in times.items()}
    secs = {k: [round(x, 6) for x in v] for k, v in times.items()}
    print(f"{label} {what}: other {rate['other']:.1f}, this "
          f"{rate['this']:.1f} ({rate['this'] / rate['other']:.4f}x; "
          f"seconds {secs})", flush=True)
    return rate


def main(argv):
    if not torch.cuda.is_available():
        print("graph_compare: no CUDA device", file=sys.stderr)
        return 1
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import importlib
    pkgs = {"other": load_other(argv[0]),
            "this": importlib.import_module("hashreadmapper_tpu_torch")}
    for name in ("hrm_other", "hashreadmapper_tpu_torch"):
        importlib.import_module(f"{name}._build").build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card {smi}; other checkout {os.path.abspath(argv[0])}",
          flush=True)
    cli = {side: importlib.import_module(f"{p.__name__}.cli")
           for side, p in pkgs.items()}
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(2)
        reads, _, _, chrom = cs.write_dataset(tmp, rng)
        four = cs.four_strand_reads(np.random.default_rng(5), chrom,
                                    cs.N_READS, cs.READ_LEN)[0]
        par = cs.unconverted_reads(np.random.default_rng(6), chrom,
                                   cs.N_PARITY, cs.READ_LEN)[0]
        cs.write_fastq(os.path.join(tmp, "four.fq.gz"), four)
        cs.write_fastq(os.path.join(tmp, "par.fq.gz"), par)
        flags_par = [f for f in cs.FLAGSHIP if f != "--threeN"]
        flags_par[flags_par.index("--minTableHits") + 1] = "2"
        genome_arg = ["--genomefile", os.path.join(tmp, "g.fa")]
        cases = (
            ("flagship 3N", cs.FLAGSHIP, "reads.fq.gz", reads),
            ("--undirectional", cs.FLAGSHIP + ["--undirectional"],
             "four.fq.gz", four),
            ("parity", flags_par, "par.fq.gz", par),
            ("--regions 4", cs.FLAGSHIP + ["--regions", "4"],
             "reads.fq.gz", reads))
        cli_argv = None
        for label, flags, fq, rd in cases:
            argv_c = flags + genome_arg + ["-i", os.path.join(tmp, fq)]
            cli_argv = cli_argv or argv_c
            n = len(rd)
            padded = np.zeros((n, 128), np.int8)
            padded[:, :cs.READ_LEN] = rd
            lens = np.full(n, cs.READ_LEN, np.int32)
            mappers = {side: cli[side].run(
                argv_c + ["-o", os.path.join(tmp, f"out_{side}")])["mapper"]
                for side in pkgs}
            outs = {side: m.map_reads(padded, lens, with_scores=True)
                    for side, m in mappers.items()}
            same(label, outs["other"], outs["this"])
            for side, m in mappers.items():
                m.map_reads(padded, lens)
            for what, kw in (("coarse reads/s", {}),
                             ("coarse + STEP 2 reads/s",
                              {"with_scores": True})):
                rates(label, n, alternated({
                    side: (lambda m=m: m.map_reads(padded, lens, **kw))
                    for side, m in mappers.items()}), what)
            n_batches = -(-n // 4096) * len(
                getattr(mappers["this"], "mappers", [None]))
            graphs = importlib.import_module(
                "hashreadmapper_tpu_torch.pipeline.graphs")
            caps = [round(st.capture_seconds, 4)
                    for m in getattr(mappers["this"], "mappers",
                                     [mappers["this"]])
                    for st in m._steps.values()]
            print(f"{label}: this checkout's captures {caps} s (warm-up "
                  f"included); the card's graph pool "
                  f"{graphs.pool_bytes('cuda')} B", flush=True)
            for side, m in mappers.items():
                cs.profiled(f"{label} {side}",
                            lambda: m.map_reads(padded, lens,
                                                with_scores=True),
                            f"map_reads(with_scores=True) of {n} reads",
                            n_batches, "4096-read batch")
            del mappers, outs
        # the window stream
        stream = {side: importlib.import_module(
            f"{p.__name__}.pipeline.window_stream") for side, p in
            pkgs.items()}
        gmod = {side: importlib.import_module(f"{p.__name__}.io.genome")
                for side, p in pkgs.items()}
        lens = np.full(cs.N_READS, cs.READ_LEN, np.int32)
        ws, genomes = {}, {}
        for side in pkgs:
            opts, _ = cli[side].options_from_args(cs.FLAGSHIP)
            genomes[side] = gmod[side].Genome.from_fasta(
                os.path.join(tmp, "g.fa"))
            ws[side] = stream[side].WindowStreamMapper(reads, lens, opts,
                                                       "cuda")
        got = {side: w.map_genome(genomes[side]) for side, w in ws.items()}
        same("window stream", got["other"], got["this"])
        rates("window stream", cs.N_READS, alternated({
            side: (lambda w=w, g=genomes[side]: w.map_genome(g))
            for side, w in ws.items()}), "map_genome reads/s")
        n_batches = sum(1 for _ in genomes["this"].iter_window_batches(
            16, 128, 4096))
        for side, w in ws.items():
            cs.profiled(f"window stream {side}",
                        lambda: w.map_genome(genomes[side]),
                        "map_genome", n_batches, "4096-window batch")
        del ws, got
        walls = alternated({side: (lambda s=side: cli[s].run(
            cli_argv + ["-o", os.path.join(tmp, f"cli_{s}")]))
            for side in pkgs}, ("other", "this", "this", "other"))
        print(f"flagship CLI whole run seconds (a new mapper each run): "
              f"{walls}; medians other {statistics.median(walls['other'])}"
              f", this {statistics.median(walls['this'])}", flush=True)
    print(f"card {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
