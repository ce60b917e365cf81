"""Coarse mapping of a synthetic GRCh38 on one card through the
region-sharded mapper, every region resident at once.

    python -m hashreadmapper_tpu_torch.tools.grch38_regions \\
        [--reads 1048576] [--device cuda] [--scale 1]

The genome has GRCh38's primary-assembly lengths (the table of
benchmarks/grch38_bench.py, copied: 24 nuclear chromosomes, chrM and three
unplaced-contig-sized sequences, 3.09 Gbp, more than 2**31 bases, so the
driver's automatic route takes regions), random bases from a seed.  Reads
follow the flagship recipe (100 bp, 1% substitutions, half reverse
complemented, 90% C->T in read space), planted by chromosome length.  The
options are the flagship's (3N, k 16, 16 hash functions, window 128,
minTableHits 4, batch 4096) with chip_smoke.py's chr1-scale caps (probe
128, kcap 32, pair budget 16, no tail or head budget); the reads are then
mapped again with a probe cap of 512 (mapped_delta_vs_higher_caps).

The regions are the driver's count, ceil(genome / SINGLE_MAPPER_BASE_CAP);
where they do not fit on the card (torch.cuda.OutOfMemoryError), the tool
says so, frees them and doubles the count.  Prints each region's build
seconds and resident bytes, max_memory_allocated, reads/s, the planted
mapped fraction and concordance, and one JSON line.  --scale S divides
every length by S and --device cpu runs the plain versions, for a
rehearsal.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

# GRCh38 primary-assembly chromosome lengths (GCA_000001405.15), as
# benchmarks/grch38_bench.py lists them
GRCH38_LENGTHS = {
    "chr1": 248956422, "chr2": 242193529, "chr3": 198295559,
    "chr4": 190214555, "chr5": 181538259, "chr6": 170805979,
    "chr7": 159345973, "chr8": 145138636, "chr9": 138394717,
    "chr10": 133797422, "chr11": 135086622, "chr12": 133275309,
    "chr13": 114364328, "chr14": 107043718, "chr15": 101991189,
    "chr16": 90338345, "chr17": 83257441, "chr18": 80373285,
    "chr19": 58617616, "chr20": 64444167, "chr21": 46709983,
    "chr22": 50818468, "chrX": 156040895, "chrY": 57227415,
    "chrM": 16569,
    # unplaced-contig-sized stress entries (GL000-class lengths)
    "chrUn_GL000195v1": 182896, "chrUn_GL000219v1": 179198,
    "chrUn_GL000220v1": 161802,
}
READ_LEN = 100
OPTIONS = ["--threeN", "-k", "16", "-m", "16", "--windowSize", "128",
           "--minTableHits", "4", "--batchsize", "4096",
           "--maxHammingPercent", "0.05", "--maxReadLength", "128",
           "--probeCap", "128", "--candidatesPerRead", "32",
           "--shdPairBudget", "16", "--probeTailBudget", "0",
           "--probeHeadBudget", "0"]
HIGHER_PROBE_CAP = 512


def log(*args):
    print(*args, flush=True)


def synthetic_genome(rng, scale: int):
    """A Genome of GRCh38's lengths (divided by scale), random bases."""
    from ..io.genome import Genome
    g = Genome.__new__(Genome)
    g.names, g.bases, g.seqs_ascii = [], [], []
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    for name, length in GRCH38_LENGTHS.items():
        b = rng.integers(0, 4, size=max(1000, length // scale),
                         dtype=np.int8)
        g.names.append(name)
        g.bases.append(b)
        g.seqs_ascii.append(lut[b])
    return g


def plant_reads(rng, genome, n_reads: int):
    """(reads [N, READ_LEN] int8, chromosome [N], start [N]): starts drawn
    by chromosome length over the sequences of 4 reads' length or more."""
    lengths = np.array([len(b) for b in genome.bases], dtype=np.int64)
    p = np.where(lengths >= 4 * READ_LEN, lengths, 0).astype(np.float64)
    chroms = rng.choice(len(lengths), size=n_reads, p=p / p.sum())
    starts = np.zeros(n_reads, np.int64)
    reads = np.zeros((n_reads, READ_LEN), np.int8)
    for c in np.unique(chroms):
        rows = np.nonzero(chroms == c)[0]
        starts[rows] = rng.integers(0, lengths[c] - READ_LEN, size=len(rows))
        reads[rows] = genome.bases[c][starts[rows, None]
                                      + np.arange(READ_LEN)[None, :]]
    sub = rng.random(reads.shape) < 0.01
    reads[sub] = rng.integers(0, 4, size=int(sub.sum()))
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc][:, ::-1]
    reads[(reads == 1) & (rng.random(reads.shape) < 0.9)] = 3
    return reads, chroms, starts


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def build(genome, opts, n_regions, device):
    """The RegionShardedMapper, or None when the card ran out of memory
    building it (printed)."""
    from ..parallel.region_sharded import RegionShardedMapper
    try:
        mapper = RegionShardedMapper(genome, opts, n_regions,
                                     devices=[device])
    except torch.cuda.OutOfMemoryError as err:
        log(f"{n_regions} regions do not fit on the card: out of memory "
            f"with max_memory_allocated {torch.cuda.max_memory_allocated()} "
            f"B ({str(err).splitlines()[0]})")
        return None
    for r, (m, secs) in enumerate(zip(mapper.mappers,
                                      mapper.build_seconds)):
        log(f"region {r}: {len(m.segments)} segments, "
            f"{m.table.num_windows} windows, built in {secs:.3f} s, "
            f"{m.resident_bytes()} B resident, cuckoo "
            f"{m.index.cuckoo_keys is not None}")
    return mapper


def main(argv=None) -> int:
    from ..cli import options_from_args
    from ..parallel.region_sharded import SINGLE_MAPPER_BASE_CAP
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reads", type=int, default=1 << 20)
    p.add_argument("--device", default="cuda")
    p.add_argument("--scale", type=int, default=1)
    args = p.parse_args(argv)
    opts, device = options_from_args(OPTIONS + ["--device", args.device])
    if device.type == "cuda":
        smi = __import__("subprocess").run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        log(f"card: {smi}")
    rng = np.random.default_rng(38)
    t0 = time.perf_counter()
    genome = synthetic_genome(rng, args.scale)
    total = sum(len(b) for b in genome.bases)
    reads, t_chrom, t_start = plant_reads(rng, genome, args.reads)
    padded = np.zeros((args.reads, opts.max_read_length), np.int8)
    padded[:, :READ_LEN] = reads
    lens = np.full(args.reads, READ_LEN, np.int32)
    log(f"genome: {total} bases in {genome.num_chromosomes} sequences "
        f"({total >= SINGLE_MAPPER_BASE_CAP and 'at or above' or 'below'} "
        f"SINGLE_MAPPER_BASE_CAP), {args.reads} reads, made in "
        f"{time.perf_counter() - t0:.1f} s")
    n_regions = max(1, -(-total // SINGLE_MAPPER_BASE_CAP))
    tried = []
    while True:
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        mapper = build(genome, opts, n_regions, device)
        tried.append(n_regions)
        if mapper is not None:
            break
        gc.collect()
        n_regions *= 2
    resident = [m.resident_bytes() for m in mapper.mappers]
    out = {"genome_bases": total, "sequences": genome.num_chromosomes,
           "reads": args.reads, "regions_tried": tried,
           "regions": mapper.n_regions,
           "build_s_per_region": mapper.build_seconds,
           "resident_bytes_per_region": resident,
           "resident_bytes": sum(resident),
           "cuckoo": [m.index.cuckoo_keys is not None
                      for m in mapper.mappers]}
    for label, cap in (("", opts.probe_cap), ("_higher_caps",
                                               HIGHER_PROBE_CAP)):
        opts.probe_cap = cap
        sync(device)
        t0 = time.perf_counter()
        res = mapper.map_reads(padded, lens)
        secs = time.perf_counter() - t0
        mapped = res.orientation != 3
        conc = mapped & (res.chromosome_id == t_chrom) & (
            np.abs(res.position.astype(np.int64) - t_start)
            <= opts.window_size)
        out.update({
            f"probe_cap{label}": cap, f"map_s{label}": secs,
            f"reads_per_s{label}": args.reads / secs,
            f"mapped_frac{label}": float(mapped.mean()),
            f"concordant_of_mapped{label}": float(conc.sum()
                                                  / max(1, mapped.sum())),
            f"stats{label}": res.stats})
        log(f"probe cap {cap}: map_reads {secs:.3f} s "
            f"({args.reads / secs:.1f} reads/s), planted mapped "
            f"{mapped.mean():.6f}, concordant of mapped "
            f"{out[f'concordant_of_mapped{label}']:.6f}, stats {res.stats}")
    out["mapped_delta_vs_higher_caps"] = (out["mapped_frac_higher_caps"]
                                          - out["mapped_frac"])
    if device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
