"""The data x table mesh over distinct cards, and the region merge with one
process a card over NCCL, at the flagship width.

    python -m hashreadmapper_tpu_torch.tools.mesh_cards [--reads 49152]
        [--genome 8000000] [--device cuda] [--cards N]

On every card of the machine (at least two): the flagship options (3N,
k 16, 16 hash functions, window 128, batch 4096, probe cap 16, kcap 8,
budgets pair 4 / tail 4 / head 18) on a random genome and planted reads
(100 bp, 1% substitutions, half reverse complemented, 90% C->T, 10% junk),
all from a seed.

  * For the meshes 1 x N, N x 1 and, with four cards or more, 2 x N/2:
    the mesh over N distinct cards against the same mesh with every
    position on cuda:0 (identical rows and counters), with the index
    bytes per card, the build seconds and coarse and coarse + STEP 2
    reads/s of both, beside the single mapper on cuda:0.  Each rate is
    taken with the batch steps as CUDA graph replays (over distinct cards
    a data shard's batch is a head, a probe step a card and a tail, each
    card's replays and copies on its own stream) and eager, the two
    alternated in one process, medians of 3; and, on the cards, one
    graph run under torch.profiler: the host's launches a mesh batch
    (kernel and graph launches, copies, fills) and each card's busy share
    of the call.
  * N processes, one a card, each mapping the reads against one region of
    an N-region window partition and merging over NCCL
    (parallel/multihost.py): the merged keys and payloads equal the
    single-process N-region RegionShardedMapper's on cuda:0.

--device cpu --cards N rehearses both on the CPU (every position the CPU,
the merge over gloo in N processes).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

READ_LEN = 100
FLAGSHIP = ["--threeN", "-k", "16", "-m", "16", "--windowSize", "128",
            "--minTableHits", "4", "--batchsize", "4096",
            "--maxHammingPercent", "0.05", "--probeCap", "16",
            "--candidatesPerRead", "8", "--maxReadLength", "128",
            "--shdPairBudget", "4", "--probeTailBudget", "4",
            "--probeHeadBudget", "18"]
FIELDS = ("orientation", "hamming", "shift", "chromosome_id", "position",
          "global_window_id", "bs_strand")


def dataset(genome_bp: int, n_reads: int, seed: int = 10):
    """(Genome, padded reads [N, 128] int8, lengths)."""
    from ..io.genome import Genome
    rng = np.random.default_rng(seed)
    chrom = rng.integers(0, 4, size=genome_bp, dtype=np.int8)
    starts = rng.integers(0, genome_bp - READ_LEN, size=n_reads)
    reads = chrom[starts[:, None] + np.arange(READ_LEN)[None, :]].copy()
    sub = rng.random(reads.shape) < 0.01
    reads[sub] = rng.integers(0, 4, size=int(sub.sum()))
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc][:, ::-1]
    reads[(reads == 1) & (rng.random(reads.shape) < 0.9)] = 3
    junk = rng.random(n_reads) < 0.10
    reads[junk] = rng.integers(0, 4, size=(int(junk.sum()), READ_LEN))
    padded = np.zeros((n_reads, 128), np.int8)
    padded[:, :READ_LEN] = reads
    genome = Genome(["chrB"], [np.frombuffer(b"ACGT", np.uint8)[chrom]
                               .tobytes().decode()])
    return genome, padded, np.full(n_reads, READ_LEN, np.int32)


def sync():
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


@contextlib.contextmanager
def eager_steps():
    """Every batch step eager (CapturedStep.run_eager in place of the
    graph's replay)."""
    from ..pipeline import graphs
    run = graphs.CapturedStep.run
    graphs.CapturedStep.run = graphs.CapturedStep.run_eager
    try:
        yield
    finally:
        graphs.CapturedStep.run = run


def rates(mapper, padded, lens):
    """{"graph" | "eager": [coarse reads/s, coarse + STEP 2 reads/s]}:
    medians of 3 after a warm-up call of each, the two sides alternated
    (eager, graph, graph, eager, eager, graph)."""
    out = {"graph": [], "eager": []}
    for scores in (False, True):
        run = lambda: mapper.map_reads(padded, lens, with_scores=scores)
        run()
        with eager_steps():
            run()
        times = {"graph": [], "eager": []}
        for side in ("eager", "graph", "graph", "eager", "eager", "graph"):
            with (eager_steps() if side == "eager"
                  else contextlib.nullcontext()):
                sync()
                t0 = time.perf_counter()
                run()
                times[side].append(time.perf_counter() - t0)
        for side, t in times.items():
            out[side].append(round(len(lens) / statistics.median(t), 1))
    return out


# the host's calls that put work on a card's queue (runtime and driver
# API names)
HOST_LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch|Memcpy|Memset)")


def profiled(mapper, padded, lens, n_batches):
    """One map_reads(with_scores=True) under torch.profiler: (host
    launches a batch, {card: busy share of the call}, wall seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mapper.map_reads(padded, lens, with_scores=True)
        sync()
        wall = time.perf_counter() - t0
    host, busy = 0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy[e.device_index] = (busy.get(e.device_index, 0)
                                    + e.time_range.elapsed_us())
        elif HOST_LAUNCH.match(e.name):
            host += 1
    return (round(host / n_batches, 1),
            {f"cuda:{i}": round(us / 1e6 / wall, 4)
             for i, us in sorted(busy.items())}, round(wall, 6))


def same(label, a, b):
    for f in FIELDS:
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{label}: {f} differs")
    if a.stats != b.stats:
        raise AssertionError(f"{label}: stats {a.stats} != {b.stats}")


def meshes(cards, genome, padded, lens, device):
    from .. import cli
    from ..parallel.sharded import ShardedCoarseMapper, make_mesh
    from ..pipeline.engine import CoarseMapper
    opts, _ = cli.options_from_args(FLAGSHIP + ["--device", device])
    n = len(cards)
    first = cards[0]
    single = CoarseMapper(genome, opts, first)
    ref = single.map_reads(padded, lens)
    print(f"single mapper on {first}: coarse, coarse + STEP 2 reads/s "
          f"{rates(single, padded, lens)}; stats {ref.stats}", flush=True)
    if device == "cuda":
        n_batches = -(-len(lens) // opts.batchsize)
        print(f"single mapper on {first}, graph, under torch.profiler: "
              f"(host launches a {opts.batchsize}-read batch, busy share "
              f"by card, wall s) {profiled(single, padded, lens, n_batches)}",
              flush=True)
    del single
    shapes = [(1, n), (n, 1)] + ([(2, n // 2)] if n >= 4 else [])
    for d, t in shapes:
        got = {}
        for label, devs in (("distinct", cards[:d * t]),
                            (f"all {first}", [first] * (d * t))):
            sync()
            t0 = time.perf_counter()
            mapper = ShardedCoarseMapper(genome, opts,
                                         make_mesh(d, t, devs))
            sync()
            build = time.perf_counter() - t0
            got[label] = mapper.map_reads(padded, lens)
            print(f"{d}x{t} mesh, {label}: built in {build:.3f} s, index "
                  f"bytes per device {mapper.index_memory_per_device()}; "
                  f"steps {sorted({k[0] for k in mapper._steps})}; coarse, "
                  f"coarse + STEP 2 reads/s {rates(mapper, padded, lens)}; "
                  f"stats {got[label].stats}", flush=True)
            if device == "cuda" and label == "distinct":
                batch = opts.batchsize * d
                prof = profiled(mapper, padded, lens, -(-len(lens) // batch))
                print(f"{d}x{t} mesh, {label}, graph, under torch.profiler: "
                      f"(host launches a {batch}-read mesh batch, busy share "
                      f"by card, wall s) {prof}", flush=True)
            del mapper
        same(f"{d}x{t} mesh over distinct devices", *got.values())
        print(f"{d}x{t} mesh: distinct devices == all on {first}: every "
              f"field and counter", flush=True)


def merge(cards, genome, padded, lens, device):
    """The region merge in len(cards) processes, one a card."""
    from .. import cli
    from ..parallel.region_sharded import RegionShardedMapper
    n = len(cards)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "padded.npy"), padded)
        with open(os.path.join(tmp, "g.fa"), "w") as fh:
            fh.write(">chrB\n" + genome.sequence_str(0) + "\n")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            coord = f"127.0.0.1:{s.getsockname()[1]}"
        env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "hashreadmapper_tpu_torch.tools.mesh_cards",
             "--worker", str(rank), str(n), coord, tmp, device],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for rank in range(n)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for rank, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"rank {rank} failed:\n{out[-4000:]}")
            print(out.strip().splitlines()[-1], flush=True)
        merged = np.load(os.path.join(tmp, "merged.npz"))
    opts, _ = cli.options_from_args(FLAGSHIP + ["--device", device])
    ref = RegionShardedMapper(genome, opts, n, devices=[cards[0]],
                              partition="window").map_reads(padded, lens)
    key = np.where(ref.orientation != 3,
                   (ref.hamming.astype(np.int64) << 40)
                   + ref.global_window_id64, np.int64(2**62))
    if not np.array_equal(merged["key"], key):
        raise AssertionError("the merged keys differ from the single "
                             "process regions'")
    for col, f in enumerate(("orientation", "hamming", "shift",
                             "chromosome_id", "position", "bs_strand")):
        if not np.array_equal(merged["payload"][:, col], getattr(ref, f)):
            raise AssertionError(f"the merged {f} differs")
    print(f"{n} processes, one region each: merged == the single-process "
          f"{n}-region RegionShardedMapper on {cards[0]} ({len(lens)} reads, "
          f"{int((ref.orientation != 3).sum())} mapped); {wall:.3f} s with "
          f"the processes' start", flush=True)


def worker(rank, world, coord, tmp, device):
    from .. import cli
    from ..io.genome import Genome
    from ..parallel import multihost
    from ..parallel.region_sharded import chrom_gwin_base, region_key_payload
    from ..parallel.segments import partition_windows
    from ..pipeline.engine import CoarseMapper
    rank, world = int(rank), int(world)
    if device == "cuda":
        torch.cuda.set_device(rank)
        card, backend = torch.device("cuda", rank), "nccl"
    else:
        card, backend = torch.device("cpu"), "gloo"
    multihost.initialize(coord, world, rank, backend=backend)
    genome = Genome.from_fasta(os.path.join(tmp, "g.fa"))
    padded = np.load(os.path.join(tmp, "padded.npy"))
    lens = np.full(len(padded), READ_LEN, np.int32)
    opts, _ = cli.options_from_args(FLAGSHIP + ["--device", device])
    mesh = multihost.region_mesh([card])
    region = partition_windows(genome, opts, mesh.num_regions)[
        mesh.region_offset]
    t0 = time.perf_counter()
    mapper = CoarseMapper(genome, opts, card, segments=region)
    mapper.ensure_empty_drops()
    packed, _, _ = mapper.map_reads_packed(padded, lens)
    key, payload, _ = region_key_payload(mapper, packed,
                                         chrom_gwin_base(genome, opts))
    sync()
    t1 = time.perf_counter()
    key, payload = multihost.merge_region_results(mesh, [key], [payload])
    t2 = time.perf_counter()
    if rank == 0:
        np.savez(os.path.join(tmp, "merged.npz"), key=key, payload=payload)
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f"rank {rank} on {card}: region {mesh.region_offset} of "
          f"{mesh.num_regions} built and mapped in {t1 - t0:.3f} s, merged "
          f"over {backend} in {t2 - t1:.3f} s", flush=True)
    return 0


def main(argv):
    if argv[:1] == ["--worker"]:
        return worker(*argv[1:])
    p = argparse.ArgumentParser(prog="mesh_cards", description=__doc__)
    p.add_argument("--reads", type=int, default=49_152)
    p.add_argument("--genome", type=int, default=8_000_000)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--cards", type=int, default=0,
                   help="positions of the CPU rehearsal (--device cpu)")
    args = p.parse_args(argv)
    if args.device == "cuda":
        n = torch.cuda.device_count()
        if n < 2:
            print(f"mesh_cards: needs two CUDA cards or more, have {n}",
                  file=sys.stderr)
            return 1
        cards = [torch.device("cuda", i) for i in range(n)]
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(f"cards: {[torch.cuda.get_device_name(i) for i in range(n)]}; "
              f"nvidia-smi: {smi.stdout.strip().splitlines()}", flush=True)
    else:
        cards = [torch.device("cpu")] * max(2, args.cards)
    genome, padded, lens = dataset(args.genome, args.reads)
    meshes(cards, genome, padded, lens, args.device)
    merge(cards, genome, padded, lens, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
