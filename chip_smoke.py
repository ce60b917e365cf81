"""On-card smoke test of the PyTorch/CUDA port (hashreadmapper_tpu_torch).

    python3 chip_smoke.py            # all phases, one CUDA card

Phase 0  card, torch and CUDA versions; builds the native host library
         and the kernels through the port's _build.
Phase 1  each of the seventeen CUDA kernels (the eight counterparts of
         the TPU kernels; the fused traceback, which runs the fill's passes
         and the walk in one launch; the forward and the reverse score
         pass, which take the pairs as the engine has them and do the
         striped layout, the flip and shifts and the second-best search
         around the column pass in the same launch; the coarse mapper's
         SHD stage, read planes to orientation, in one launch; its
         signature stage, raw bases to masked signatures, in one launch;
         the probe's lookup and gather, and the pair stage's selection and
         per-read best, which replace the JAX engine's XLA-fused
         probe_tables and coarse_pairs_best: the flagship's cuckoo probe
         with budgets, chr1's caps, the window stream's parity read index,
         --undirectional's pairs) against its
         plain PyTorch version at the main path's shapes (integers:
         exact), the score passes on short indel pairs and on
         flagship-like pairs, the vote also on the wide side of its
         2,048-id switch (lists filled as at chr1 caps, F 32 and 64),
         shd_best also on the main path's shift
         bounds, the fused SHD stage on planted reads, with
         three times (ms: the
         device's time a launch, calls back to back between two CUDA
         events; call_ms: one call on an idle card, the host's enqueue
         included; host_ms: the host's time to enqueue a call), the least
         time the card could take for the same work (bound_ms) and, where
         one PyTorch call computes the same function, that call's three
         times; sig_min_murmur against sigs_from_bases('fwd') and the row
         minimum of shd_hamming_matrix against shd_best.
Phase 2  the flagship 3N run through the port's CLI on an 8 Mbp genome and
         49,152 bisulfite reads, STEP 2 on the card: SAM/VCF checks,
         planted-read mapping and concordance, the eleven launch counts of
         the path; then the same run with STEP 2 on staged pairs and with
         host STEP 2 (byte-identical SAM and VCF), the STEP-2 pair counts,
         launches per batch, and every device launch of one
         map_reads(with_scores=True) counted under torch.profiler.
Phase 3  the same coarse mapper on the card and on the CPU (plain
         versions): identical packed rows and overflow vectors, and
         identical fused STEP-2 score rows and traceback entries.
Phase 5  --threeN --undirectional through the CLI at the same width on
         49,152 four-strand reads (a quarter each of forward C->T,
         reverse-complemented C->T, forward G->A and reverse-complemented
         G->A in read space): mapping and concordance over all strands and
         per PBAT strand, the directional run of the same reads beside
         it, launch counts, and card == CPU on the packed rows (strand
         column included) and the fused STEP-2 bundle of 1,024 reads.
Phase 6  parity mode (no --threeN) through the CLI on 16,384 unconverted
         reads: mapping and concordance, launch counts, and card == CPU
         packed rows of 1,024 reads.
Phase 7  the window stream (the read index resident, the genome's windows
         streamed through it) at the flagship width: 49,152 planted reads
         against the 8 Mbp genome, read-index build and map_genome times,
         reads/s and windows/s, launches per window batch (also under
         torch.profiler), overflow counters 0, planted mapping and
         concordance; card == CPU on a 1 Mbp prefix with 8,192 reads, 3N
         and --undirectional.
Phase 8  --regions 4 through the flagship CLI (a window partition of the
         chromosome, four mappers without cuckoo tables): SAM and VCF byte
         for byte phase 2's.
Phase 9  the data x table mesh at the flagship width, a logical 2 x 4
         mesh with every position cuda:0 (its numbers are a mesh's
         launches and copies on one card, not a scaling figure): build
         seconds, index bytes per position and per device, coarse and
         coarse + STEP 2 reads/s, hand-written launches per mesh batch and
         every device launch under torch.profiler, planted mapping and
         concordance; the single mapper's rows at --probeCap 256 without
         budgets; card == CPU on a 1 Mbp prefix (8,192 reads, 3N and
         --undirectional, the fused STEP-2 bundle too; 4 regions over a
         1 x 2 mesh); the CLI with --mesh 1 1 == the single run, byte for
         byte; two processes of 2 regions each, merged over gloo (the
         script runs itself with --region-worker), == the single-process
         4-region mapper; a 1 x 2 mesh over two cards where there are two
         (a head, a probe step a card and a tail: the split path).  A data
         shard's batch is a graph replay on the card's own stream.
Phase 10 the captured CUDA graphs of the batch steps (pipeline/graphs.py:
         a read batch, with its fused STEP 2, and a window batch are one
         replay each) against the same steps run eagerly, in every mode
         above (flagship 3N, --undirectional, parity, --regions 4, the
         window stream): every batch's packed rows, overflow, score rows,
         traceback entries and status (the window stream's rows) bit for
         bit; the CLI's SAM and VCF with every step eager byte for byte
         the graph run's; coarse and coarse + STEP 2 reads/s and
         map_genome reads/s, graph and eager alternated (medians of 3);
         host launches (kernel and graph launches, copies, fills), device
         launches and the card's busy share of each under torch.profiler;
         the captures' seconds, the card's one graph pool in bytes, and
         the flagship CLI's whole run graph and eager alternated.  The
         launch counts of every phase count a replay as the launches its
         capture recorded.
Phase 11 the logical 2 x 4 mesh's dispatch units (parallel/sharded.py: a
         data shard's batch one replay) against the same steps eager, in
         flagship 3N, --undirectional and parity on phase 10's reads: every
         data shard's packed rows, overflow, score rows, traceback entries
         and status bit for bit; coarse and coarse + STEP 2 reads/s graph
         and eager alternated (medians of 3); host launches, device
         launches and busy share a mesh batch under torch.profiler; the
         captures' seconds and the card's graph pool.
Phase 4  a chr1-sized (248,956,422 bp) window index resident on the card,
         coarse-mapping 49,152 planted reads (every device launch of one
         map_reads under torch.profiler); then the same genome in two
         window regions (per-read results equal the single mapper's), and
         streamed through the window stream's index of 1,048,576 planted
         reads (phase 7 at chr1 scale).

Any failure raises (non-zero exit).  The last line is the JSON device
record; the line before it is nvidia-smi's name and power limit; the one
before that the per-kernel JSON record.  Exits non-zero without a result
when no CUDA device is available.  Imports nothing of JAX and nothing of
the JAX package.
"""

import contextlib
import gzip
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ACGT = np.frombuffer(b"ACGT", np.uint8)
# bench.py's flagship 3N options
FLAGSHIP = ["--threeN", "-k", "16", "-m", "16", "--windowSize", "128",
            "--minTableHits", "4", "--batchsize", "4096",
            "--maxHammingPercent", "0.05", "--probeCap", "16",
            "--candidatesPerRead", "8", "--maxReadLength", "128",
            "--shdPairBudget", "4", "--probeTailBudget", "4",
            "--probeHeadBudget", "18", "-t", "4", "--pipelineChunk", "8192"]
# caps for a chr1-sized genome, whose CT-collapsed 16-mer space (3^16) is
# oversubscribed: no tail or head compaction (the flagship budgets drop
# candidates wholesale there), and the smallest power-of-two probe cap
# whose planted-mapped fraction on the H100 was within 0.5% of the
# uncapped ceiling (probe 32: 0.883, 64: 0.907, 128: 0.916, 512: 0.919)
AT_SCALE = ["--probeCap", "128", "--candidatesPerRead", "32",
            "--shdPairBudget", "16", "--probeTailBudget", "0",
            "--probeHeadBudget", "0"]
GENOME_LEN = 8_000_000
N_READS, READ_LEN = 49_152, 100
N_PARITY = 16_384
# ids a list of C 128 at chr1 caps, by bucket [lo, hi) with its share of
# lists, uniform inside a bucket: 2,097,152 lists of chr1-3n.coarse's
# reads on an H100 (chr1-pbat.coarse's 4,194,304 within 0.02 a bucket);
# 0.144 empty, a median of 5, 0.019 full
CHR1_LIST_FILL = ((0, 1, 0.1440), (1, 2, 0.1189), (2, 3, 0.0885),
                  (3, 4, 0.0692), (4, 5, 0.0557), (5, 8, 0.1178),
                  (8, 16, 0.1579), (16, 32, 0.1193), (32, 64, 0.0733),
                  (64, 128, 0.0368), (128, 129, 0.0186))
OVERFLOW_KEYS = ("probe_overflow", "vote_overflow", "pair_budget_overflow",
                 "probe_tail_overflow", "probe_head_overflow")
SENTINEL = 0xFFFFFFFF
CHR1_LEN = 248_956_422          # GRCh38 chr1
MESH = (2, 4)                   # phase 9's logical data x table mesh
# The card's peaks, for bound_ms: device memory 3.35 TB/s (H100 SXM data
# sheet); instructions by the pipe they issue on, in lanes a clock a
# multiprocessor, over the data sheet's clock (its 67 TFLOP/s of float32
# are 132 SMs x 128 lanes x 2 operations an FMA x 1.98 GHz).  The pipes,
# as hashreadmapper_tpu_torch/tools/int_rates.py measures them on the
# H100 (PERF.md section 6): logic, shifts, compares, selects, min / max
# and the s16x2 DPX instructions on the ALU pipe, 64 lanes; multiply-adds
# (IMAD) on the FMA pipe beside it, 64; popcounts on a pipe of their own,
# 16; an add on either of the first two, as the compiler places it; and
# four schedulers issue 128 lanes in all.  The time of a mix is the
# largest of its pipes' times and its issue time.
MEM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 67e12 / (128 * 2)
PIPE_LANES = {"alu": 64, "fma": 64, "popc": 16}
ISSUE_LANES = 128
# 32-bit instructions of one murmur64 fmix of (k-mer + hash id) kept
# against a running 64-bit minimum, as csrc/minhash.cu computes it on its
# input's range (k-mer and hash id below 2**32) and as its SASS shows
# (tools/kernel_build_report.py minhash_kernel): the first xor-shift is
# the identity there and (k-mer + id) * C1 = k-mer * C1 + id * C1, so a
# hash is the 64-bit add of the two products (an add with carry-out on the
# ALU, the carry-in add IMAD.X on the FMA pipe), two xor-shifts (a shift
# and a xor each, ALU), the second multiply (one wide product and two
# multiply-adds that take the high word's adds, FMA) and the
# compare-and-keep (2 compares, 2 selects, ALU): 9 ALU and 4 FMA; k-mer *
# C1 (a wide product and a multiply-add) is shared by the hash ids of a
# k-mer.  A wide product counts as one FMA instruction, though it issues
# at about a third of IMAD's rate (tools/int_rates.py).  The first design
# counted 19: both multiplies in full (8 multiply-adds), three xor-shifts
# and the compare-and-keep.
OPS_PER_HASH = {"alu": 9, "fma": 4}
OPS_PER_KMER = {"fma": 2}
# A read word of one shift of SHD: three logic operations, an add and a
# popcount (no shift: the read can be aligned once for each sub-word
# shift, and the anchor words then compared as they stand)
OPS_PER_SHD_WORD = {"alu": 3, "either": 1, "popc": 1}
# A cell of the striped SW pass.  The values fit int16, so Hopper's fused
# add-and-max instructions on s16x2 (DPX) take two cells each, and a word
# of two cells needs 8 of them: min(vh + score, 253); max with e; the
# running maximum of pre + j; h_main; two for e_new; the lazy-F max(corr -
# j, h, 0); the column maximum.  The per-column work of a pair is left out.
OPS_PER_SW_CELL = {"alu": 4}
# An in-band cell of a fill pass: the arithmetic of bandtb._row_core for
# one cell, with the gap runs as the recurrences they are (no scan steps,
# band masks, moves or shared-memory traffic, which are the kernel's and
# not the function's).  Scores: E = max(h_up - GO, e_up - GE) and F =
# max(h_left - GO, f_left - GE), 4 adds and 2 maxima; the diagonal h_diag
# + (ref == read ? MATCH : -MISMATCH), a compare, a select and an add;
# max(E, 0), a = max(., diagonal), max(F, 0), h = max(a, .) and the row's
# best, 5 maxima: 9 ALU and 5 adds.  Directions add 21 ALU and 5 adds: the
# two gap directions (2 compares on the adds above); dh (a maximum, 2
# compares, 2 selects and 2 adds); the M run (a compare, a select, an
# add), the I and D runs (a select and an add each); the run length by dh
# (2 compares, 3 selects), its cap (a minimum), dh | run << 3 (a shift and
# an or) and the zero of a run that is not positive (a compare, a select).
# The kernel issues more a cell, its scans, moves and shared-memory
# traffic included: hashreadmapper_tpu_torch/tools/fill_ops.py counts
# those from its SASS, and PERF.md reports them beside the bound.
OPS_PER_FILL_CELL = {"alu": 9, "either": 5}
OPS_PER_FILL_CELL_EMIT = {"alu": 30, "either": 10}


def ops(n, per=None):
    """Instructions of n units of work, by pipe: `per` a unit (a dict of
    OPS_PER_*), or n ALU instructions."""
    return {k: n * v for k, v in (per or {"alu": 1}).items()}


def add_ops(*counts):
    """The sum of instruction counts by pipe."""
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def hash_ops(hashes, kmers):
    """Instructions of `hashes` murmur hashes of `kmers` k-mers."""
    return add_ops(ops(hashes, OPS_PER_HASH), ops(kmers, OPS_PER_KMER))


def log(*args):
    print(*args, flush=True)


def device_ms(fn, launches=20, reps=3):
    """Device time of one fn() in ms: `launches` calls between two CUDA
    events, enqueued while the card spins in a sleep kernel so that the
    host is ahead and the calls run back to back; median of `reps`."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(8_000_000)        # a few ms: 20 calls' enqueue
        start.record()
        for _ in range(launches):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return statistics.median(times)


def host_ms(fn, calls=200):
    """The host's time to enqueue one fn() in ms: `calls` calls in a row
    without waiting for the card (what a dispatch-bound path pays)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    return enqueue / calls * 1e3


def time_ms(fn, reps=7, warmup=2):
    """Median CUDA-event time of one fn() in ms over `reps` after warm-up,
    the card idle before each: the host's time to enqueue is in it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(bytes_moved, instructions):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    the instructions' time, the largest of each pipe's over its lanes and
    all of them over the issue lanes (instructions: pipe -> count)."""
    t_bytes = bytes_moved / MEM_BYTES_PER_S * 1e3
    clocks = max([instructions.get(k, 0) / n for k, n in PIPE_LANES.items()]
                 + [sum(instructions.values()) / ISSUE_LANES])
    t_ops = clocks / SM_CLOCKS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations"))


def max_abs_err(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    return err


def planted_reads(rng, chrom, n_reads, read_len):
    """bench.py's recipe: 1% substitutions, half reverse-complemented,
    90% C->T in read space, 10% junk.  Returns (reads, starts, junk)."""
    starts = rng.integers(0, len(chrom) - read_len, size=n_reads)
    reads = chrom[starts[:, None] + np.arange(read_len)[None, :]].copy()
    sub = rng.random(reads.shape) < 0.01
    reads[sub] = rng.integers(0, 4, size=int(sub.sum()))
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc][:, ::-1]
    conv = (reads == 1) & (rng.random(reads.shape) < 0.9)
    reads[conv] = 3
    junk = rng.random(n_reads) < 0.10
    reads[junk] = rng.integers(0, 4, size=(int(junk.sum()), read_len),
                               dtype=np.int8)
    return reads.astype(np.int8), starts, junk


def four_strand_reads(rng, chrom, n_reads, read_len):
    """The undirectional scenario (tests/test_undirectional.py) in the
    flagship recipe: read i is of kind i % 4 = forward C->T, reverse-
    complemented C->T, forward G->A (PBAT), reverse-complemented G->A
    (PBAT), converted at 90% in read space; 1% substitutions, 10% junk.
    Returns (reads, starts, junk, kind)."""
    starts = rng.integers(0, len(chrom) - read_len, size=n_reads)
    reads = chrom[starts[:, None] + np.arange(read_len)[None, :]].copy()
    sub = rng.random(reads.shape) < 0.01
    reads[sub] = rng.integers(0, 4, size=int(sub.sum()))
    kind = np.arange(n_reads) % 4
    rc = (kind == 1) | (kind == 3)
    reads[rc] = 3 - reads[rc][:, ::-1]
    conv = rng.random(reads.shape) < 0.9
    reads[(reads == 1) & conv & (kind < 2)[:, None]] = 3
    reads[(reads == 2) & conv & (kind >= 2)[:, None]] = 0
    junk = rng.random(n_reads) < 0.10
    reads[junk] = rng.integers(0, 4, size=(int(junk.sum()), read_len),
                               dtype=np.int8)
    return reads.astype(np.int8), starts, junk, kind


def unconverted_reads(rng, chrom, n_reads, read_len):
    """Parity-mode reads: the flagship recipe without the conversion."""
    starts = rng.integers(0, len(chrom) - read_len, size=n_reads)
    reads = chrom[starts[:, None] + np.arange(read_len)[None, :]].copy()
    sub = rng.random(reads.shape) < 0.01
    reads[sub] = rng.integers(0, 4, size=int(sub.sum()))
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc][:, ::-1]
    junk = rng.random(n_reads) < 0.10
    reads[junk] = rng.integers(0, 4, size=(int(junk.sum()), read_len),
                               dtype=np.int8)
    return reads.astype(np.int8), starts, junk


def check_fractions(label, mapped, concordant, junk):
    planted = ~junk
    frac_mapped = float(mapped[planted].mean())
    frac_conc = float(concordant[planted & mapped].mean())
    log(f"{label}: planted mapped {frac_mapped:.6f}, concordant of mapped "
        f"{frac_conc:.6f}")
    if frac_mapped < 0.90:
        raise AssertionError(f"{label}: only {frac_mapped:.4f} of planted "
                             "reads mapped (< 0.90)")
    if frac_conc < 0.99:
        raise AssertionError(f"{label}: only {frac_conc:.4f} of mapped "
                             "planted reads concordant (< 0.99)")
    return frac_mapped, frac_conc


# ---------------------------------------------------------------------------
def phase0():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"phase0 card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    from hashreadmapper_tpu_torch import _build, native
    t0 = time.perf_counter()
    _build.build_native(verbose=True)
    native.get_lib()                 # raises with the compiler's output
    t1 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    t2 = time.perf_counter()
    log(f"phase0 build: native {t1 - t0:.3f} s "
        f"({os.path.basename(_build.native_library_path())}), CUDA kernels "
        f"{t2 - t1:.3f} s ({os.path.basename(_build.library_path())})")
    return smi


def phase1():
    """Kernel == plain at production shapes; returns per-kernel records
    (the first case of each kernel: its times, bound and library call)."""
    from hashreadmapper_tpu_torch.ops import minhash_kernel as mk
    from hashreadmapper_tpu_torch.ops import shd_kernel as sk
    from hashreadmapper_tpu_torch.ops import vote_kernel as vk
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    cases = []
    k = 16

    def n_valid(lens, maxlen):
        return int(np.maximum(np.minimum(lens, maxlen) - k + 1, 0).sum())

    def minhash_case(mode, n, maxlen, f, lengths):
        bases = torch.from_numpy(rng.integers(0, 4, size=(n, maxlen),
                                              dtype=np.int8)).to(dev)
        lens = torch.from_numpy(lengths.astype(np.int32)).to(dev)
        hid = torch.arange(f, dtype=torch.int64, device=dev)
        args = (bases, lens, k, hid, mode)
        kmers = n_valid(lengths, maxlen) * (2 if mode == "both" else 1)
        return dict(key="minhash", name="minhash",
                    shape=f"N={n} L={maxlen} F={f} mode={mode}",
                    kernel=lambda: mk.sigs_from_bases(*args),
                    plain=lambda: mk.sigs_from_bases_plain(*args),
                    bound=lambda out: (nbytes(bases, lens, hid, *out),
                                       hash_ops(kmers * f, kmers)))

    read_lens = np.full(4096, 100)
    read_lens[::97] = rng.integers(0, 128, size=len(read_lens[::97]))
    win_lens = np.full(4096, 128)
    win_lens[-5:] = [0, 15, 16, 17, 60]
    cases.append(minhash_case("both", 4096, 128, 16, read_lens))
    cases.append(minhash_case("fwd", 4096, 128, 16, win_lens))
    cases.append(minhash_case("canon", 4096, 128, 16, read_lens))

    def vote_case(f, n, c, cap, rng=rng, chr1_fill=False):
        ids = rng.integers(0, 600, size=(f, n, c)).astype(np.int64)
        fill = rng.integers(0, c + 1, size=(f, n, 1))
        if chr1_fill:
            # lists as the chr1 cells' probe fills them: window ids from
            # 2**21, each read's own window in every list that has any
            lo, hi, share = (np.array(x) for x in zip(*CHR1_LIST_FILL))
            bucket = rng.choice(len(share), size=(f, n, 1), p=share)
            fill = rng.integers(lo[bucket], hi[bucket])
            ids = rng.integers(0, 2**21, size=(f, n, c)).astype(np.int64)
            ids[:, :, 0] = rng.integers(0, 2**21, size=(1, n))
        ids = np.where(np.arange(c)[None, None, :] < fill, ids, 0xFFFFFFFF)
        cand = torch.from_numpy(np.sort(ids, axis=2)).to(dev)
        # merging F ascending lists of C ids: F*C*log2(F) 64-bit
        # compare-and-selects (2 operations each), then one run-length
        # count and one threshold test per id
        n_ops = n * f * c * (2 * int(np.log2(f)) + 2)
        return dict(key="vote", name="vote",
                    shape=f"F={f} N={n} C={c} cap={cap}",
                    kernel=lambda: vk.vote_candidates_fnc(cand, 4, cap),
                    plain=lambda: vk.vote_candidates_fnc_plain(cand, 4, cap),
                    bound=lambda out: (nbytes(cand, *out), ops(n_ops)))

    cases.append(vote_case(32, 4096, 16, 8))
    cases.append(vote_case(64, 4096, 16, 8))       # 4F under --undirectional
    cases.append(vote_case(32, 4096, 64, 32))
    # 4,096 ids, the wide side of the switch (a generator of its own, as
    # for the flagship-like pairs: the older cases keep their data)
    cases.append(vote_case(32, 1024, 128, 32, np.random.default_rng(11)))
    # chr1 caps at the cells' batch, lists filled as the probe fills them
    # there: F 32 (chr1-3n.coarse) and F 64 (chr1-pbat.coarse)
    for f in (32, 64):
        cases.append(vote_case(f, 4096, 128, 32, np.random.default_rng(f),
                               chr1_fill=True))

    p, wr, wa, n_shifts = 16384, 4, 10, 160
    r32 = lambda *s: torch.from_numpy(rng.integers(
        -2**31, 2**31, size=s, dtype=np.int64).astype(np.int32)).to(dev)
    bit0 = rng.integers(0, 32, size=p)
    bounds = np.stack([bit0, bit0 + rng.integers(28, 129, size=p)], axis=1)
    bounds[-300:] = -1
    planes = (r32(p, 2, wa), r32(p, 2, wa), r32(p, 2, wr), r32(p, 2, wr),
              r32(p, wr))
    tbounds = torch.from_numpy(bounds.astype(np.int32)).to(dev)
    shd_args = planes + (tbounds, n_shifts, wa, wr)
    shifts_run = int(np.where(bounds[:, 0] >= 0,
                              bounds[:, 1] - bounds[:, 0] + 1, 0).sum())
    cases.append(dict(
        key="shd_best", name="shd_best",
        shape=f"P={p} wr={wr} wa={wa} n_shifts={n_shifts}",
        kernel=lambda: sk.shd_best(*shd_args),
        plain=lambda: sk.shd_best_plain(*shd_args),
        bound=lambda out: (nbytes(*planes, tbounds, *out),
                           ops(2 * shifts_run * wr, OPS_PER_SHD_WORD))))
    # the main path's bounds: [bit0, bit0 + 128] (anchor 228 bases, read
    # 100), 40 shorter edge pairs, the 300 padded pairs (a generator of its
    # own: the other cases keep their data)
    g13 = np.random.default_rng(13)
    bit0_m = g13.integers(0, 32, size=p)
    bounds_m = np.stack([bit0_m, bit0_m + 128], axis=1)
    bounds_m[:40, 1] -= g13.integers(1, 129, size=40)
    bounds_m[-300:] = -1
    tbounds_m = torch.from_numpy(bounds_m.astype(np.int32)).to(dev)
    shd_args_m = planes + (tbounds_m, n_shifts, wa, wr)
    run_m = int(np.where(bounds_m[:, 0] >= 0,
                         bounds_m[:, 1] - bounds_m[:, 0] + 1, 0).sum())
    cases.append(dict(
        key="shd_best", name="shd_best",
        shape=f"P={p} wr={wr} wa={wa} n_shifts={n_shifts}, the main path's "
              "bounds [bit0, bit0 + 128]",
        kernel=lambda: sk.shd_best(*shd_args_m),
        plain=lambda: sk.shd_best_plain(*shd_args_m),
        bound=lambda out: (nbytes(*planes, tbounds_m, *out),
                           ops(2 * run_m * wr, OPS_PER_SHD_WORD))))

    # the two kernels without a caller on the main path, at its shapes
    n, npos, f = 4096, 128 - k + 1, 16
    bases_np = rng.integers(0, 4, size=(n, 128), dtype=np.int8)
    kmers_np = np.zeros((n, npos), np.int64)
    for i in range(k):
        kmers_np |= bases_np[:, i:i + npos].astype(np.int64) << (
            2 * (k - 1 - i))
    kmers = torch.from_numpy(kmers_np).to(dev)
    klens = torch.from_numpy(read_lens.astype(np.int32)).to(dev)
    hid = torch.arange(f, dtype=torch.int64, device=dev)
    sig_args = (kmers, klens, k, hid)
    # the k-mers as the caller holds them: int64 (the kernel reads each
    # element's low word, and the bound counts the whole element) or int32
    for words in (kmers, kmers.to(torch.int32)):
        cases.append(dict(
            key="sig_min_murmur", name="sig_min_murmur",
            shape=f"N={n} P={npos} (L=128, k={k}) F={f}, {words.dtype} "
                  "k-mers",
            kernel=lambda w=words: mk.sig_min_murmur(w, *sig_args[1:]),
            plain=lambda w=words: mk.sig_min_murmur_plain(w, *sig_args[1:]),
            bound=lambda out, w=words: (
                nbytes(w, klens, hid, *out),
                hash_ops(n_valid(read_lens, 128) * f,
                         n_valid(read_lens, 128)))))
    ham_args = planes + (n_shifts, wa, wr)
    cases.append(dict(
        key="shd_hamming_matrix", name="shd_hamming_matrix",
        shape=f"P={p} wa={wa} wr={wr} n_shifts={n_shifts}",
        kernel=lambda: sk.shd_hamming_matrix(*ham_args),
        plain=lambda: sk.shd_hamming_matrix_plain(*ham_args),
        bound=lambda out: (nbytes(*planes, *out),
                           ops(2 * p * n_shifts * wr, OPS_PER_SHD_WORD))))

    cases.extend(step2_cases(rng, dev))
    cases.append(shd_stage_case(dev))
    cases.extend(minhash_stage_cases(dev))
    cases.extend(probe_pair_cases(dev))
    records = {}
    for case in cases:
        name, shape = case["name"], case["shape"]
        view = case.get("view", lambda out: out)
        got = case["kernel"]()
        torch.cuda.synchronize()
        want = case["plain"]()
        err = max_abs_err(view(got), view(want))
        ms, call_ms = device_ms(case["kernel"]), time_ms(case["kernel"])
        plain_ms = time_ms(case["plain"], *case.get("plain_reps", ()))
        outs = got if isinstance(got, tuple) else (got,)
        bound_ms, bound_by = bound(*case["bound"](outs))
        library_ms = library_call_ms = library_host_ms = None
        kernel_host_ms = host_ms(case["kernel"])
        if "library" in case:
            lib_out = case["library"]()
            if max_abs_err(lib_out, view(got)) != 0:
                raise AssertionError(f"{name}: the library call computes "
                                     "another function")
            library_ms = device_ms(case["library"])
            library_call_ms = time_ms(case["library"])
            library_host_ms = host_ms(case["library"])
        note = case["note"](got) if "note" in case else ""
        log(f"phase1 {name} {shape}: max_abs_err {err} (exact required), "
            f"kernel {ms:.4f} ms on the device ({call_ms:.4f} ms one call on "
            f"an idle card, {kernel_host_ms:.4f} ms of the host to enqueue "
            f"it), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms by "
            f"{bound_by}, library "
            + ("none" if library_ms is None else
               f"{library_ms:.4f} ms on the device ({library_call_ms:.4f} ms "
               f"one call, {library_host_ms:.4f} ms of the host)") + note)
        if err != 0:
            raise AssertionError(f"{name} {shape}: kernel != plain "
                                 f"(max_abs_err {err})")
        times = {"ms": ms, "call_ms": call_ms, "host_ms": kernel_host_ms,
                 "plain_ms": plain_ms, "shape": shape, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": library_ms,
                 "library_call_ms": library_call_ms,
                 "library_host_ms": library_host_ms}
        # the record is the kernel's first case; the others stand beside it
        rec = records.setdefault(case["key"], {"max_abs_err": 0, **times,
                                               "other_cases": []})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if rec["shape"] != shape:
            rec["other_cases"].append(times)

    # the kernels that superseded the two, on the card; these launches
    # are the four kernels' count in the kernels line (sig_min_murmur and
    # shd_hamming_matrix have no caller, as in the JAX package; shd_best
    # and sigs_from_bases none on the main path, whose SHD and signature
    # stages are fused entries)
    mk.sig_min_murmur.launches = sk.shd_hamming_matrix.launches = 0
    sk.shd_best.launches = mk.sigs_from_bases.launches = 0
    want = mk.sigs_from_bases(torch.from_numpy(bases_np).to(dev), klens, k,
                              hid, "fwd")
    if not torch.equal(mk.sig_min_murmur(*sig_args), want):
        raise AssertionError("sig_min_murmur on the forward k-mer lows != "
                             "sigs_from_bases(mode='fwd')")
    inside = tbounds.clamp(max=n_shifts - 1)
    ham = sk.shd_hamming_matrix(*ham_args).to(torch.int64)
    s = torch.arange(n_shifts, device=dev)[None, None, :]
    ham = torch.where((s >= inside[:, 0, None, None])
                      & (s <= inside[:, 1, None, None]), ham, sk.BIG)
    best = ham.amin(dim=2)
    first = (ham == best[:, :, None]).to(torch.int64).argmax(dim=2)
    shift = torch.where(best < sk.BIG, first, inside[:, :1].to(torch.int64))
    got = torch.stack([best[:, 0], shift[:, 0], best[:, 1], shift[:, 1]],
                      dim=1).to(torch.int32)
    if not torch.equal(got, sk.shd_best(*planes, inside, n_shifts, wa, wr)):
        raise AssertionError("row minimum of shd_hamming_matrix != shd_best")
    torch.cuda.synchronize()
    log("phase1 cross-checks on the card: sig_min_murmur(forward k-mer "
        "lows) == sigs_from_bases('fwd'); min over [min_shift, max_shift] "
        "of shd_hamming_matrix, earliest shift on ties == shd_best")
    for key, fn in (("sig_min_murmur", mk.sig_min_murmur),
                    ("shd_hamming_matrix", sk.shd_hamming_matrix),
                    ("shd_best", sk.shd_best),
                    ("minhash", mk.sigs_from_bases)):
        records[key]["launches"] = fn.launches
    # the single-pass fill's and the unfused striped pass's launches so
    # far, all of this phase
    from hashreadmapper_tpu_torch.ops.bandtb_kernel import fill_pass
    from hashreadmapper_tpu_torch.ops.swdev_kernel import pass_batched
    records["fill_pass"]["own"] = fill_pass.launches
    records["sw_pass"]["own"] = pass_batched.launches
    return records


def shd_stage_case(dev):
    """The fused SHD stage (ops/shd.py::shd_pairs_best) at the flagship's
    shapes: 4,096 planted reads (the flagship recipe, 100 bases in rows of
    128) on a random 1 Mbp chromosome, 4 pairs a read (a window holding
    the read and 3 anywhere), window 128, 3N; the last 300 pairs invalid
    (a compacted batch's padding).  Held against the plain composition on
    the card (the torch operations around the shd_best kernel) and, once
    here, against the plain composition on the CPU."""
    from hashreadmapper_tpu_torch.ops import shd
    from hashreadmapper_tpu_torch.ops.shd_kernel import pack_genome_planes
    rng = np.random.default_rng(14)
    g_len, n, kb, ws = 1_000_000, 4096, 4, 128
    chrom = rng.integers(0, 4, size=g_len, dtype=np.int8)
    reads, starts, _ = planted_reads(rng, chrom, n, READ_LEN)
    rows = np.zeros((n, 128), np.int8)
    rows[:, :READ_LEN] = reads
    p = n * kb
    ridx = np.repeat(np.arange(n), kb)
    pos = rng.integers(0, g_len - ws, size=p)
    own = np.arange(p) % kb == 0
    pos[own] = np.clip(starts - rng.integers(0, ws - READ_LEN + 1, size=n),
                       0, g_len - ws)
    host = dict(bases=torch.from_numpy(rows),
                lens=torch.full((n,), READ_LEN, dtype=torch.int32),
                ridx=torch.from_numpy(ridx))
    loc = shd.extended_window_location(
        torch.from_numpy(pos), torch.full((p,), g_len),
        host["lens"].to(torch.int64)[host["ridx"]], ws)
    g_hi, g_lo = pack_genome_planes(torch.from_numpy(chrom))
    host.update(g_hi=g_hi, g_lo=g_lo, gstart=loc.start, alen=loc.length,
                aleft=loc.left, valid=torch.arange(p) < p - 300)
    card = {k: v.to(dev) for k, v in host.items()}
    params = shd.ShdParams(ws, ws + 128, 128, 0.05)
    args = lambda d: (d["bases"], d["lens"], d["ridx"], d["g_hi"], d["g_lo"],
                      d["gstart"], d["alen"], d["aleft"], d["valid"], params)
    got = shd.shd_pairs_best(*args(card), three_n=True)
    want = shd.shd_pairs_best_plain(*args(host), three_n=True)
    if max_abs_err(tuple(x.cpu() for x in got), want) != 0:
        raise AssertionError("shd_pairs_best on the card != its plain "
                             "composition on the CPU")
    n_shifts = ws + 32
    bit0 = loc.start & 31
    hi = torch.minimum(bit0 + loc.length - READ_LEN,
                       torch.tensor(n_shifts - 1))
    shifts_run = int((hi - bit0 + 1).clamp(min=0).sum())
    wr = 4
    nw = (n_shifts + 31) // 32 + wr
    words = ((loc.start.clamp(min=0) >> 5)[:, None] + torch.arange(nw)
             ).clamp(max=g_hi.shape[0] - 1)
    moved = (nbytes(card["bases"], card["lens"], card["ridx"], card["gstart"],
                    card["alen"], card["aleft"], card["valid"])
             + 8 * int(torch.unique(words).numel()))
    mapped = int((want.orientation != shd.NONE).sum())
    return dict(
        key="shd_pairs_best", name="shd_pairs_best",
        shape=f"P={p} pairs of {n} planted reads (L=128, read_len "
              f"{READ_LEN}), window {ws}, 3N; {mapped} pairs not NONE",
        kernel=lambda: shd.shd_pairs_best(*args(card), three_n=True),
        plain=lambda: shd.shd_pairs_best_plain(*args(card), three_n=True),
        bound=lambda out: (moved + nbytes(*out),
                           ops(2 * shifts_run * wr, OPS_PER_SHD_WORD)))


def probe_pair_cases(dev):
    """The probe's two kernels (ops/probe_kernel.py) and the pair stage's
    two (ops/pairs_kernel.py) at the main path's shapes, each against its
    plain version on the same card tensors: a flagship mapper's index over
    a random 8 Mbp genome (32 tables, cuckoo) probed with 4,096 planted
    reads' signatures, (a) as the flagship probes it (cuckoo, probe cap
    16, tail 4 and head 18 a read), (b) at phase 4's chr1 caps (the
    bucketed search, probe cap 128, no budgets); (c) the window stream's
    read-index probe in parity mode (a read index of 49,152 unconverted
    reads, 16 tables, the bucketed search with max_values_per_key, 4,096
    windows' signatures); the pair stage on the flagship's voted ids and,
    (d), on --undirectional's (4,096 four-strand reads, both query spaces
    probed, 64 lists voted), SHD between.  Bounds count bytes: the inputs
    and outputs once, and a 32-byte sector for each key, payload and value
    the lookups and gathers need (two for each window a slot or a read's
    best looks up)."""
    from hashreadmapper_tpu_torch import cli
    from hashreadmapper_tpu_torch.index import minhash_index as mi
    from hashreadmapper_tpu_torch.io.genome import Genome
    from hashreadmapper_tpu_torch.ops import minhash, shd
    from hashreadmapper_tpu_torch.ops import pairs_kernel as pk
    from hashreadmapper_tpu_torch.ops import probe_kernel as prk
    from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper
    from hashreadmapper_tpu_torch.pipeline.window_stream import \
        WindowStreamMapper
    rng = np.random.default_rng(16)
    chrom = rng.integers(0, 4, size=GENOME_LEN, dtype=np.int8)
    genome = Genome(["chrP"], [ACGT[chrom].tobytes().decode()])
    opts, _ = cli.options_from_args(FLAGSHIP)
    mapper = CoarseMapper(genome, opts, dev)
    mapper.ensure_empty_drops()
    idx, table = mapper.index, mapper.table
    n, k = opts.batchsize, opts.kmer_length

    def batch(reads):
        rows = np.zeros((n, 128), np.int8)
        rows[:, :READ_LEN] = reads
        return (torch.from_numpy(rows).to(dev),
                torch.full((n,), READ_LEN, dtype=torch.int32, device=dev))
    bases, lens = batch(planted_reads(rng, chrom, n, READ_LEN)[0])
    sigs, valid = minhash.signatures_3n_pair(bases, lens, k,
                                             mapper._hash_ids_dev)
    cuckoo = dict(cuckoo=(idx.cuckoo_keys, idx.cuckoo_payload),
                  cuckoo_bits=idx.cuckoo_bits, cuckoo_seeds=idx.cuckoo_seeds)
    bucketed = dict(bucket_start=idx.bucket_start,
                    probe_steps=idx.probe_steps)
    ws_opts, _ = cli.options_from_args([f for f in FLAGSHIP
                                        if f != "--threeN"])
    ws_reads = unconverted_reads(rng, chrom, N_READS, READ_LEN)[0]
    ws = WindowStreamMapper(ws_reads, np.full(N_READS, READ_LEN, np.int32),
                            ws_opts, dev)
    starts = rng.integers(0, GENOME_LEN - 128, size=n)
    win = torch.from_numpy(chrom[starts[:, None] + np.arange(128)]).to(dev)
    ws_sigs, ws_valid = minhash.minhash_signatures(
        win, torch.full((n,), 128, dtype=torch.int32, device=dev), k,
        ws._hash_ids_dev)
    wi = ws.index
    mvpk = ws_opts.max_results_per_map
    lookups = (
        ("flagship: cuckoo, probe cap 16, tail 4 / head 18 a read",
         (sigs, valid, idx), 16, 4, dict(dropped_keys=mapper.dropped,
                                         **cuckoo), (4 * n, 18 * n), 3),
        ("chr1 caps on the flagship index: bucketed, probe cap 128, no "
         "budgets", (sigs, valid, idx), 128, 128,
         dict(dropped_keys=mapper.dropped, **bucketed), (0, 0),
         idx.probe_steps + 3),
        (f"window stream, parity read index of {N_READS} reads: bucketed, "
         f"max_values_per_key {mvpk}, probe cap 16, tail 4 / head 18",
         (ws_sigs, ws_valid, wi), 16, 4,
         dict(bucket_start=wi.bucket_start, probe_steps=wi.probe_steps,
              max_values_per_key=mvpk), (4 * n, 18 * n),
         wi.probe_steps + 3))
    cases = []
    probes = {}
    for label, (q, qv, ix), cap, c1, kw, budgets, sectors in lookups:
        largs = (q, qv, ix.keys, ix.offsets, ix.num_keys, cap, c1)
        lk = prk.probe_lookup(*largs, **kw)
        gargs = (*lk, ix.values, cap, c1, *budgets)
        probes[label] = prk.probe_gather(*gargs)
        f_t = ix.num_tables
        extra = nbytes(*[t for t in (kw.get("dropped_keys") or ())])
        cases.append(dict(
            key="probe_lookup", name="probe_lookup",
            shape=f"F={f_t} N={n}, {label}",
            kernel=lambda a=largs, kw=kw: prk.probe_lookup(*a, **kw),
            plain=lambda a=largs, kw=kw: prk.probe_lookup_plain(*a, **kw),
            bound=lambda out, q=q, qv=qv, sec=sectors, f_t=f_t, e=extra: (
                nbytes(q, qv, *out) + e + 32 * sec * f_t * n,
                ops(0))))
        cand = probes[label][0]
        # the values a probe's rows need: 4 int64 a sector
        runs = (cand != SENTINEL).sum(dim=2)
        value_sectors = int(((runs + 3) // 4).sum())
        cases.append(dict(
            key="probe_gather", name="probe_gather",
            shape=f"F={f_t} N={n} C={cap}, {label}",
            kernel=lambda a=gargs: prk.probe_gather(*a),
            plain=lambda a=gargs: prk.probe_gather_plain(*a),
            bound=lambda out, a=gargs, vs=value_sectors: (
                nbytes(*a[:3], *out) + 32 * vs, ops(0))))

    # the pair stage on the voted ids: flagship, then --undirectional
    flag = "flagship: cuckoo, probe cap 16, tail 4 / head 18 a read"
    und_opts, _ = cli.options_from_args(FLAGSHIP + ["--undirectional"])
    ub, ul = batch(four_strand_reads(rng, chrom, n, READ_LEN)[0])
    us, uv = minhash.signatures_3n_pair(ub, ul, k, mapper._hash_ids_dev)
    us_m, _ = minhash.signatures_3n_pair(ub, ul, k, mapper._hash_ids_dev,
                                         mirror=True)
    budget_kw = dict(tail_budget=4 * n, head_budget=18 * n,
                     dropped_keys=mapper.dropped, **cuckoo)
    und = [mi.probe_tables_stats(idx.keys, idx.offsets, idx.values,
                                 idx.num_keys, s, uv, 16, **budget_kw)
           for s in (us, us_m)]
    kcap = opts.candidates_per_read_cap
    params = shd.ShdParams(opts.window_size, opts.window_size + 128, 128,
                           opts.max_hamming_percent)
    pair_inputs = (
        ("flagship 3N", opts, bases, lens, probes[flag][0],
         probes[flag][1][None]),
        ("--undirectional", und_opts, ub, ul,
         torch.cat([und[0][0], und[1][0]]),
         torch.stack([und[0][2], und[1][2]])))
    for label, o, rb, rl, cand, stats in pair_inputs:
        ids, _, num_kept = mi.vote_candidates_fnc_auto(
            cand, o.min_table_hits, kcap)
        sargs = (ids, rl, table.win_pos, table.win_chrom, table.chrom_offset,
                 table.chrom_len, o.window_size, o.shd_pairs_per_read_budget)
        sel = pk.pair_select(*sargs)
        p = sel[0].shape[0]
        res = [shd.shd_pairs_best(rb, rl, sel[1], table.genome_hi,
                                  table.genome_lo, sel[2], sel[3], sel[4],
                                  sel[5], params, three_n=True,
                                  undirectional=u)
               for u in ((False, True) if o.undirectional else (False,))]
        bargs = (res[0], res[1] if o.undirectional else None, sel[0],
                 sel[5], ids, table.win_pos, table.win_chrom, stats,
                 num_kept, sel[6])
        n_valid = int(sel[5].sum())
        cases.append(dict(
            key="pair_select", name="pair_select",
            shape=f"B={n} K={kcap} budget {o.shd_pairs_per_read_budget}: "
                  f"{p} slots, {n_valid} valid, {label}",
            kernel=lambda a=sargs: pk.pair_select(*a),
            plain=lambda a=sargs: pk.pair_select_plain(*a),
            bound=lambda out, ids=ids, rl=rl, p=p: (
                nbytes(ids, rl, *out) + 64 * p, ops(0))))
        shd_out = [t for r in res for t in r]
        cases.append(dict(
            key="read_best", name="read_best",
            shape=f"B={n} K={kcap}, {p} slots, {len(res)} SHD result(s), "
                  f"{label}",
            kernel=lambda a=bargs: pk.read_best(*a),
            plain=lambda a=bargs: pk.read_best_plain(*a),
            bound=lambda out, a=bargs, so=shd_out: (
                nbytes(*so, a[2], a[3], a[4], a[7], a[8], a[9], *out)
                + 64 * n, ops(0))))
    return cases


def minhash_stage_cases(dev):
    """The fused signature stage (ops/minhash_kernel.py::signature_stage)
    at the main path's shapes: a batch of 4,096 planted reads (the flagship
    recipe, 100 bases in rows of 128; every 97th of another length) in
    directional 3N, the mirrored spaces of --undirectional and parity
    mode's canonical k-mers, and 4,096 windows of 128 bases in the 3N index
    build's 'pair' mode; F 16, k 16.  Each against its plain composition
    on the card (the collapse, sigs_from_bases' plain version, the mask and
    SENTINEL rows, the swap) and, once here, the directional case against
    the plain composition on the CPU."""
    from hashreadmapper_tpu_torch.ops import minhash_kernel as mk
    rng = np.random.default_rng(15)
    n, maxlen, k, f = 4096, 128, 16, 16
    chrom = rng.integers(0, 4, size=1_000_000, dtype=np.int8)
    reads, _, _ = planted_reads(rng, chrom, n, READ_LEN)
    rows = np.zeros((n, maxlen), np.int8)
    rows[:, :READ_LEN] = reads
    lens = np.full(n, READ_LEN, np.int32)
    lens[::97] = rng.integers(0, maxlen + 1, size=len(lens[::97]))
    starts = rng.integers(0, len(chrom) - maxlen, size=n)
    windows = chrom[starts[:, None] + np.arange(maxlen)[None, :]]
    win_lens = np.full(n, maxlen, np.int32)
    win_lens[-5:] = [0, 15, 16, 17, 60]
    hid = torch.arange(f, dtype=torch.int64, device=dev)
    host = (torch.from_numpy(rows), torch.from_numpy(lens))
    got = mk.signature_stage(host[0].to(dev), host[1].to(dev), k, hid,
                             "both", "ct")
    want = mk.signature_stage_plain(*host, k, hid.cpu(), "both", "ct")
    if max_abs_err(tuple(x.cpu() for x in got), want) != 0:
        raise AssertionError("signature_stage on the card != its plain "
                             "composition on the CPU")
    cases = []
    for label, b, ln, mode, collapse, mirror in (
            ("reads, 3N directional", rows, lens, "both", "ct", False),
            ("reads, 3N mirrored (--undirectional)", rows, lens, "both", "ga",
             True),
            ("reads, parity (canonical)", rows, lens, "canon", None, False),
            ("windows, 3N index build", windows, win_lens, "pair", None,
             False)):
        tb = torch.from_numpy(np.ascontiguousarray(b, np.int8)).to(dev)
        tl = torch.from_numpy(ln).to(dev)
        args = (tb, tl, k, hid, mode, collapse, mirror)
        streams = 2 if mode in ("both", "pair") else 1
        kmers = int(np.maximum(np.minimum(ln, maxlen) - k + 1, 0).sum()
                    ) * streams
        cases.append(dict(
            key="minhash_stage", name="minhash_stage",
            shape=f"N={n} L={maxlen} F={f} k={k}, {label}: mode={mode} "
                  f"collapse={collapse} mirror={mirror}",
            kernel=lambda a=args: mk.signature_stage(*a),
            plain=lambda a=args: mk.signature_stage_plain(*a),
            bound=lambda out, tb=tb, tl=tl, kmers=kmers: (
                nbytes(tb, tl, hid, *out), hash_ops(kmers * f, kmers))))
    return cases


def indel_pairs(rng, n, lq=128, lr=128):
    """tests/test_bandtb.py's recipe: reads of 25-40 bases cut from a
    40-128 base ref with substitutions, deletions or insertions of 1-3
    bases, and every fourth pair random.  Codes 0..4, 4-padded."""
    rc = np.full((n, lq), 4, np.int8)
    fc = np.full((n, lr), 4, np.int8)
    rls = np.zeros(n, np.int32)
    fls = np.zeros(n, np.int32)
    for i in range(n):
        fl = int(rng.integers(40, lr + 1))
        ref = rng.integers(0, 4, fl).astype(np.int8)
        if i % 4 == 3:
            read = rng.integers(0, 5, int(rng.integers(20, lq + 1)))
        else:
            start = int(rng.integers(0, max(1, fl - 30)))
            seg = list(ref[start:start + int(rng.integers(25, 40))])
            for _ in range(int(rng.integers(0, 5))):
                seg[int(rng.integers(0, len(seg)))] = int(rng.integers(0, 4))
            if i % 4 == 1 and len(seg) > 6:
                d = int(rng.integers(1, 4))
                p = int(rng.integers(1, len(seg) - d))
                seg = seg[:p] + seg[p + d:]
            elif i % 4 == 2:
                p = int(rng.integers(1, len(seg)))
                seg = seg[:p] + list(rng.integers(0, 4, int(
                    rng.integers(1, 4)))) + seg[p:]
            read = np.array(seg, np.int8)
        rc[i, :len(read)] = read
        fc[i, :fl] = ref
        rls[i] = len(read)
        fls[i] = fl
    return rc, rls, fc, fls


def flagship_like_pairs(rng, n, lq=128, lr=128, read_len=100):
    """STEP-2 pairs as the flagship run makes them: 100-base reads planted
    in 128-base windows with 1% substitutions, a quarter of the pairs
    unrelated (the other orientation's pair of a mapped read), and a few
    with read_len 0 or ref_len 0.  Codes 0..3 (C already T), 4-padded."""
    fc = rng.integers(0, 4, size=(n, lr)).astype(np.int8)
    fc[fc == 1] = 3
    start = rng.integers(0, lr - read_len + 1, size=n)
    reads = fc[np.arange(n)[:, None], start[:, None] + np.arange(read_len)]
    sub = rng.random(reads.shape) < 0.01
    reads[sub] = rng.choice([0, 2, 3], size=int(sub.sum()))
    unrelated = np.arange(n) % 4 == 3
    reads[unrelated] = rng.choice([0, 2, 3], size=(int(unrelated.sum()),
                                                   read_len))
    rc = np.full((n, lq), 4, np.int8)
    rc[:, :read_len] = reads
    rls = np.full(n, read_len, np.int32)
    fls = np.full(n, lr, np.int32)
    rls[5::1000], rc[5::1000] = 0, 4
    fls[7::1000], fc[7::1000] = 0, 4
    return rc, rls, fc, fls


def fused_sw_cases(dev, label, pairs, lq):
    """sw_forward and sw_reverse (all-M certificate included) on one set
    of pairs, int8 codes as the engine hands them over, each against its
    plain version and with the bound of the cells its pairs need."""
    from hashreadmapper_tpu_torch.ops import swdev_kernel as swk
    rc, rls, fc, fls = pairs
    p = len(rls)
    read_t = torch.from_numpy(rc).to(dev).T.contiguous()
    ref_t = torch.from_numpy(fc).to(dev).T.contiguous()
    rl = torch.from_numpy(rls).to(dev)
    fl = torch.from_numpy(fls).to(dev)
    ml = (rl // 2).clamp(min=15)
    fwd_rows, rev_rows = [0, 1, 2, 3, 4, 8], [5, 6, 7, 8, 9]
    fwd = swk.sw_forward_plain(read_t, rl, ref_t, fl, ml, lq)
    s1, re, qe = fwd["score1"], fwd["ref_end"], fwd["query_end"]
    rev = swk.sw_reverse_plain(read_t, ref_t, s1, re, qe, lq)
    # OPS_PER_SW_CELL a cell, as for sw_pass.  Forward: ref_len columns
    # of read_len cells (no pair here saturates before its last column);
    # reverse: query_end + 1 cells a column, from ref_end down to the
    # column where the score reaches score1, or to column 0
    i64 = lambda t: t.to(torch.int64)
    cells_f = int((i64(rl) * i64(fl)).sum())
    cols_r = torch.where(rev["flag2"], re + 1, re - rev["ref_begin"] + 1)
    cells_r = int((i64(qe + 1) * i64(cols_r)).sum())
    shape = f"P={p} LQ=n_cols={lq} int8, {label}"
    out_f = torch.zeros((10, p), dtype=torch.int32, device=dev)
    out_r = torch.zeros_like(out_f)

    def stack(d, keys):
        return torch.stack([d[k].to(torch.int32) for k in keys])

    def reverse_plain():
        d = swk.sw_reverse_plain(read_t, ref_t, s1, re, qe, lq)
        d["diag"] = swk.diag_fastpath_plain(
            read_t, ref_t, s1, d["ref_begin"], re, d["query_begin"], qe,
            d["overflowed"], lq)
        return stack(d, ("ref_begin", "query_begin", "flag2", "overflowed",
                         "diag"))
    return [
        dict(key="sw_forward", name="sw_forward", shape=shape,
             kernel=lambda: swk.sw_forward(read_t, rl, ref_t, fl, ml, lq,
                                           out_f),
             plain=lambda: stack(swk.sw_forward_plain(
                 read_t, rl, ref_t, fl, ml, lq),
                 ("score1", "ref_end", "query_end", "score2", "ref_end2",
                  "overflowed")),
             view=lambda out: out[fwd_rows] if out.shape[0] == 10 else out,
             plain_reps=(2, 1),
             bound=lambda out: (nbytes(read_t, ref_t, rl, fl, ml)
                                + 4 * p * len(fwd_rows),
                                ops(cells_f, OPS_PER_SW_CELL))),
        dict(key="sw_reverse", name="sw_reverse", shape=shape,
             kernel=lambda: swk.sw_reverse(read_t, ref_t, s1, re, qe, lq,
                                           out_r),
             plain=reverse_plain,
             view=lambda out: out[rev_rows] if out.shape[0] == 10 else out,
             plain_reps=(2, 1),
             bound=lambda out: (nbytes(read_t, ref_t, s1, re, qe)
                                + 4 * p * len(rev_rows),
                                ops(cells_r, OPS_PER_SW_CELL)))]


def step2_cases(rng, dev):
    """The STEP-2 kernels at the fused path's shapes: P = 8,192 pairs
    (one 4,096-read batch), LQ = n_cols = NL = 128."""
    from hashreadmapper_tpu_torch.ops import bandtb_kernel as bk
    from hashreadmapper_tpu_torch.ops import swdev
    from hashreadmapper_tpu_torch.ops import swdev_kernel as swk
    p, lq = 8192, 128
    rc, rls, fc, fls = indel_pairs(rng, p)
    read_t = torch.from_numpy(rc).to(dev).to(torch.int32).T.contiguous()
    ref_t = torch.from_numpy(fc).to(dev).to(torch.int32).T.contiguous()
    rl = torch.from_numpy(rls).to(dev)
    fl = torch.from_numpy(fls).to(dev)
    read_at, seg = swk._striped_layout_t(read_t, rl, lq)
    sat = torch.full((p,), swk.SAT, dtype=torch.int32, device=dev)
    fwd = (read_at, rl, seg, ref_t, fl, sat, 0, lq, True)
    score1 = swk.pass_batched_plain(*fwd)[0]
    rev = (read_at, rl, seg, ref_t.flip(0).contiguous(), fl, score1, 1, lq,
           False)
    # per pair, rl query cells in each column it runs: all fl of the
    # forward pass (no pair here saturates), of the reverse pass those up
    # to the first whose maximum equals score1
    hit = swk.pass_batched_plain(*rev[:8], True)[3] == score1
    hit &= torch.arange(lq, device=dev)[:, None] < fl
    cols = {"forward": fl, "reverse": torch.where(
        hit.any(dim=0), hit.to(torch.int32).argmax(dim=0).to(torch.int32) + 1,
        fl)}
    cells = {k: int((rl.to(torch.int64) * c.to(torch.int64)).sum())
             for k, c in cols.items()}
    cases = [dict(key="sw_pass", name=f"sw_pass {name}",
                  shape=f"P={p} S=8 n_cols={lq} int32, indel pairs of 25-40 "
                        "bases",
                  kernel=lambda a=a: swk.pass_batched(*a),
                  plain=lambda a=a: swk.pass_batched_plain(*a),
                  bound=lambda out, a=a, n=cells[name.split(",")[0]]: (
                      nbytes(*a[:6], *out), ops(n, OPS_PER_SW_CELL)))
             for name, a in (("forward, max_column", fwd),
                             ("reverse, terminate=score1", rev))]
    cases += fused_sw_cases(dev, "indel pairs of 25-40 bases",
                            (rc, rls, fc, fls), lq)
    cases += fused_sw_cases(dev, "flagship-like pairs of 100 bases",
                            flagship_like_pairs(np.random.default_rng(12), p,
                                                lq, lq), lq)
    begin = torch.from_numpy(rng.integers(-1, lq + 1, p).astype(
        np.int32)).to(dev)
    # the one PyTorch call: a gather over the input padded with code 4,
    # by the index that the shift amounts give
    eff = begin.to(torch.int64) & bk.shift_bits_mask(2 * lq)
    src = torch.arange(lq, device=dev)[:, None] + eff[None, :]
    read_t8 = read_t.to(torch.int8)
    # first the form the traceback takes (int8 codes as the engine hands
    # them over, pair-major uint8 rows out), then the JAX functions' form
    for x, pair_major, form in ((read_t8, True, "int8 -> [P, size] uint8"),
                                (read_t, False, "int32 -> [size, P] int32")):
        padded = torch.cat([x, torch.full_like(x, 4), torch.full_like(x, 4)])
        cases.append(dict(
            key="shift_sub", name="shift_sub",
            shape=f"L={lq} P={p} size={lq} {form}, begins in [-1, 128]",
            kernel=lambda x=x, pm=pair_major: bk.shift_sub(x, begin, lq, pm),
            plain=lambda x=x, pm=pair_major: bk.shift_sub_plain(x, begin, lq,
                                                                pm),
            view=(lambda out: out.T) if pair_major else (lambda out: out),
            library=lambda padded=padded: torch.gather(padded, 0, src),
            bound=lambda out, x=x: (nbytes(x, begin, *out), ops(lq * p))))
    return cases + bandtb_cases(dev, bandtb_inputs(dev))


def bandtb_inputs(dev, seed=8):
    """The pairs of the banded traceback's phase-1 cases: P = 8,192 indel
    pairs (seed `seed`), their score rows (score1, bounds, need mask),
    subregion codes as int32 [128, P] rows, the first band width bw0 =
    |r - m| + 1, a widening of 1, 2 or 4 a pair and the fill's done mask
    (the pairs that need no traceback and a quarter of the others).
    tools/fill_compare.py takes the same."""
    from hashreadmapper_tpu_torch.ops import bandtb_kernel as bk
    from hashreadmapper_tpu_torch.ops import swdev
    rng = np.random.default_rng(seed)
    p, lq = 8192, 128
    rc, rls, fc, fls = indel_pairs(rng, p)
    read_t = torch.from_numpy(rc).to(dev).to(torch.int32).T.contiguous()
    ref_t = torch.from_numpy(fc).to(dev).to(torch.int32).T.contiguous()
    rl = torch.from_numpy(rls).to(dev)
    fl = torch.from_numpy(fls).to(dev)
    s10 = swdev.ssw_score_packed_t(read_t, rl, ref_t, fl,
                                   (rl // 2).clamp(min=15), lq)
    qb, qe, rb, re = s10[6], s10[2], s10[5], s10[1]
    need = ~((s10[9] != 0) | (s10[8] != 0) | (s10[0] == 0) | (re < 0))
    m, r = qe - qb + 1, re - rb + 1
    widen = torch.from_numpy(rng.choice([1, 2, 4], p).astype(np.int32))
    done = (~need | torch.from_numpy(
        rng.random(p) < 0.25).to(dev)).to(torch.int32)
    return dict(p=p, lq=lq, read_t=read_t, ref_t=ref_t, s10=s10, qb=qb,
                rb=rb, need=need, m=m, r=r, bw0=(r - m).abs() + 1,
                widen=widen.to(dev), done=done,
                sub_q=bk.shift_sub(read_t, qb, lq),
                sub_r=bk.shift_sub(ref_t, rb, lq))


def fill_cases(inp):
    """(label, fill_pass arguments) of phase 1's fill_pass cases: bands
    widened 1, 2 or 4 times, score only and emitting; first bands only,
    int8 codes (mostly 8- and 16-lane segments); bands of at least 64
    (2 bw + 1 > NL: absolute lanes)."""
    a = inp
    lq, bw0 = a["lq"], a["bw0"]
    q8, r8 = a["sub_q"].to(torch.int8), a["sub_r"].to(torch.int8)
    common = (a["m"], a["r"])
    out = []
    for label, q, ref, bw, emit in (
            ("bands widened 1, 2 or 4 times, score only", a["sub_q"],
             a["sub_r"], bw0 * a["widen"], False),
            ("bands widened 1, 2 or 4 times, emitting", a["sub_q"],
             a["sub_r"], bw0 * a["widen"], True),
            ("first bands, int8 codes, score only", q8, r8, bw0, False),
            ("bands of bw0 + 63 (absolute lanes), score only", a["sub_q"],
             a["sub_r"], bw0 + 63, False)):
        out.append((label, (q, ref, *common, bw, a["done"], lq, emit)))
    return out


def traceback_modes(inp):
    """(label, arguments, keywords) of phase 1's traceback cases: the
    pairs as pair-major uint8 rows (shift_sub of int8 codes), in the fused
    mode (48 uint8 entries, runs cut at 63, the need mask) and the staged
    one (64 int16 entries, every pair)."""
    from hashreadmapper_tpu_torch.ops import bandtb_kernel as bk
    lq = inp["lq"]
    args = (bk.shift_sub(inp["read_t"].to(torch.int8), inp["qb"], lq, True),
            bk.shift_sub(inp["ref_t"].to(torch.int8), inp["rb"], lq, True),
            inp["m"], inp["r"], inp["s10"][0])
    return [("fused: 48 uint8 entries, runs cut at 63, need mask", args,
             dict(n_entries=48, need=inp["need"], run_cap=63,
                  entry_dtype=torch.uint8)),
            ("staged: 64 int16 entries, every pair", args,
             dict(n_entries=64))]


def cells_of(m, r, width, mask, lq):
    """In-band cells of rows i < m at band width `width` (band [max(0, i
    - width), min(r - 1, i + width)]), summed over the pairs of `mask`."""
    i = torch.arange(lq, device=m.device)[None, :]
    mm, rr, bb = (x.to(torch.int64)[:, None] for x in (m, r, width))
    band = (torch.minimum(rr - 1, i + bb) - (i - bb).clamp(min=0)
            + 1).clamp(min=0)
    return int(torch.where((i < mm) & mask[:, None], band, 0).sum())


def bandtb_cases(dev, inp):
    """fill_pass (the cases of fill_cases) and the fused traceback (both
    entry modes) at the fused path's shapes."""
    from hashreadmapper_tpu_torch.ops import bandtb_kernel as bk
    p, lq, s10 = inp["p"], inp["lq"], inp["s10"]
    m, r, need, done = inp["m"], inp["r"], inp["need"], inp["done"]
    live = done == 0
    n_live = int(live.sum())
    cases = []

    def view(out):
        # the kernel never writes a done pair's directions
        best, dirs = out
        return best if dirs is None else (best, dirs[live])

    def fill_bound(out, args):
        """Each input read once: the scalars, and of each pair not done
        the codes its rows need (read rows i < m, ref positions j <
        min(r, NL)); best and, when emitting, the pair's [m_max, NL]
        directions written once (the bytes the kernel stores: it writes
        no done pair's).  The in-band cells of rows i < m,
        OPS_PER_FILL_CELL a cell or OPS_PER_FILL_CELL_EMIT."""
        q, _, _, _, bw, _, _, emit = args
        codes = int((m.clamp(0, lq) + r.clamp(0, lq))[live].sum())
        moved = (nbytes(m, r, bw, done, out[0]) + codes * q.element_size()
                 + (n_live * 2 * lq * lq if emit else 0))
        return moved, ops(cells_of(m, r, bw, live, lq),
                          OPS_PER_FILL_CELL_EMIT if emit
                          else OPS_PER_FILL_CELL)
    for label, args in fill_cases(inp):
        cases.append(dict(key="fill_pass", name="fill_pass",
                          shape=f"P={p} m_max=NL={lq} {label}, {n_live} "
                                "pairs not done",
                          kernel=lambda a=args: bk.fill_pass(*a),
                          plain=lambda a=args: bk.fill_pass_plain(*a),
                          view=view,
                          bound=lambda out, a=args: fill_bound(out, a)))

    # the whole traceback in one launch, both entry modes
    modes = traceback_modes(inp)
    sub_q8, sub_r8 = modes[0][1][:2]
    bw0 = inp["bw0"]

    def tb_bound(out, run):
        """The same work whatever implements it: codes of the pairs that
        run and every scalar read once, entries, status and widths written
        once; the in-band cells of every pass the doubling rule requires
        (widths bw0, 2 bw0, ... up to this run's final width),
        OPS_PER_FILL_CELL a cell and OPS_PER_FILL_CELL_EMIT in the last,
        which also gives the directions.  No direction array: no caller
        needs it."""
        ents, status, bw_f = out[:3]
        n_run = int(run.sum())
        moved = (nbytes(m, r, s10[0], ents, status, bw_f) + p
                 + n_run * (lq + lq))
        plain, emit, width = 0, 0, bw0.clone()
        for _ in range(bk.n_band_passes(lq, lq) + 1):
            plain += cells_of(m, r, width, run & (width < bw_f), lq)
            emit += cells_of(m, r, width, run & (width == bw_f), lq)
            width = width * 2
        return moved, add_ops(ops(plain, OPS_PER_FILL_CELL),
                              ops(emit, OPS_PER_FILL_CELL_EMIT))

    def tb_note(kw):
        def note(out):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            *_, bw_f, spilled = bk.traceback(sub_q8, sub_r8, m, r, s10[0],
                                             return_spilled=True, **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
            run = kw.get("need", torch.ones_like(live))
            passes = torch.where(run, torch.log2(bw_f / bw0).round() + 1, 0)
            return (f"; {int(run.sum())} pairs run, "
                    f"{int(passes.sum())} passes in all (most "
                    f"{int(passes.max())} a pair), {int(spilled)} pairs' "
                    f"directions spilled to device memory, peak "
                    f"{peak} B allocated by the call (a [P, m_max, NL] "
                    f"int16 array would be {2 * p * lq * lq} B)")
        return note
    for mode, args, kw in modes:
        run = kw.get("need", torch.ones_like(live))
        cases.append(dict(
            key="traceback", name="traceback",
            shape=f"P={p} LQ=NL={lq} {mode}",
            kernel=lambda kw=kw: bk.traceback(*args, **kw),
            plain=lambda kw=kw: bk.traceback_plain(*args, **kw),
            plain_reps=(2, 1), note=tb_note(kw),
            bound=lambda out, run=run: tb_bound(out, run)))
    return cases


def write_fastq(path, reads):
    seqs = ACGT[reads]
    qual = b"I" * reads.shape[1]
    with gzip.open(path, "wb", compresslevel=1) as fh:
        fh.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(), qual)
                          for i in range(len(reads))))


def write_dataset(tmp, rng):
    """8 Mbp genome FASTA + 49,152 planted reads FASTQ.gz."""
    chrom = rng.integers(0, 4, size=GENOME_LEN, dtype=np.int8)
    text = ACGT[chrom].tobytes()
    with open(os.path.join(tmp, "g.fa"), "wb") as fh:
        fh.write(b">chrB synthetic 8 Mbp\n")
        fh.write(b"\n".join(text[i:i + 80] for i in range(0, len(text), 80)))
        fh.write(b"\n")
    reads, starts, junk = planted_reads(rng, chrom, N_READS, READ_LEN)
    write_fastq(os.path.join(tmp, "reads.fq.gz"), reads)
    return reads, starts, junk, chrom


def kernel_wrappers():
    """The wrappers of the eleven kernels on the CLI's path, by the names
    of the kernels JSON.  The fill's launch on that path is the fused
    traceback (all passes and the walk in one), the striped pass's the
    forward and the reverse score pass (the column pass with what stands
    around it in one launch each).  The SHD and signature stages are
    their fused entries, shd_kernel.shd_pairs_best and
    minhash_kernel.signature_stage: the direct shd_best and
    sigs_from_bases have no caller there.  The probe is two launches
    (probe_lookup, probe_gather), the pair stage two around the SHD
    (pair_select, read_best)."""
    from hashreadmapper_tpu_torch.ops.bandtb_kernel import shift_sub, traceback
    from hashreadmapper_tpu_torch.ops.minhash_kernel import signature_stage
    from hashreadmapper_tpu_torch.ops.pairs_kernel import (pair_select,
                                                           read_best)
    from hashreadmapper_tpu_torch.ops.probe_kernel import (probe_gather,
                                                           probe_lookup)
    from hashreadmapper_tpu_torch.ops.shd_kernel import shd_pairs_best
    from hashreadmapper_tpu_torch.ops.swdev_kernel import (sw_forward,
                                                           sw_reverse)
    from hashreadmapper_tpu_torch.ops.vote_kernel import vote_candidates_fnc
    return {"minhash_stage": signature_stage, "probe_lookup": probe_lookup,
            "probe_gather": probe_gather, "vote": vote_candidates_fnc,
            "pair_select": pair_select, "shd_pairs_best": shd_pairs_best,
            "read_best": read_best, "sw_forward": sw_forward,
            "sw_reverse": sw_reverse, "shift_sub": shift_sub,
            "traceback": traceback}


def counted(label, fn, path_kernels=None):
    """fn() with the eleven kernels' launch counts set to 0 just before
    and read just after: (result, seconds, launches).  Fails when a kernel
    of the path (path_kernels: names of kernel_wrappers(), all eleven by
    default) was never launched, when the path went through the
    unfused striped pass (which builds the striped read tensor and the
    per-column maxima in device memory), the direct shd_best kernel (the
    SHD stage as torch operations around it) or the direct
    sigs_from_bases (the signature stage as torch operations around it),
    or when jax or the JAX package got imported."""
    from hashreadmapper_tpu_torch.ops.minhash_kernel import sigs_from_bases
    from hashreadmapper_tpu_torch.ops.shd_kernel import shd_best
    from hashreadmapper_tpu_torch.ops.swdev_kernel import pass_batched
    kernels = kernel_wrappers()
    for k in kernels.values():
        k.launches = 0
    unfused = pass_batched.launches
    shd_best.launches = sigs_from_bases.launches = 0
    t0 = time.perf_counter()
    res = fn()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"{label} kernel launches: {launches}; the direct shd_best: "
        f"{shd_best.launches}, sigs_from_bases: {sigs_from_bases.launches}")
    if sigs_from_bases.launches != 0:
        raise AssertionError(f"{label}: the signature stage went through "
                             f"sigs_from_bases ({sigs_from_bases.launches} "
                             "launches), not the fused entry")
    if shd_best.launches != 0:
        raise AssertionError(f"{label}: the SHD stage went through the "
                             f"direct shd_best ({shd_best.launches} "
                             "launches), not the fused entry")
    if launches["shift_sub"] != 2 * launches["traceback"]:
        raise AssertionError(f"{label}: a traceback is two shift_sub "
                             f"launches and one of its own: {launches}")
    if launches["sw_forward"] != launches["sw_reverse"] \
            or pass_batched.launches != unfused:
        raise AssertionError(
            f"{label}: a batch's scores are one sw_forward and one "
            f"sw_reverse launch and no sw_pass: {launches}, sw_pass "
            f"{pass_batched.launches - unfused}")
    if min(launches[k] for k in (path_kernels or launches)) <= 0:
        raise AssertionError(f"{label}: a kernel of the path never "
                             f"launched: {launches}")
    launches["shd_best_direct"] = shd_best.launches
    launches["sigs_from_bases_direct"] = sigs_from_bases.launches
    check_no_jax()
    return res, wall, launches


# the index build's signature stage alone, by configuration: (windows,
# launches, seconds); printed in the kernels line
INDEX_SIGNATURES = {}


def index_signatures(label, mapper):
    """One run of the index build's signature stage on the card
    (mapper.window_signatures: every superbatch's window gather and its
    one launch): windows, launches and seconds."""
    from hashreadmapper_tpu_torch.ops.minhash_kernel import (
        signature_stage, sigs_from_bases)
    torch.cuda.synchronize()
    signature_stage.launches = sigs_from_bases.launches = 0
    t0 = time.perf_counter()
    mapper.window_signatures()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    w = mapper.table.num_windows
    log(f"{label} index build's window signatures: {w} windows, "
        f"{signature_stage.launches} launches of the signature stage "
        f"(sigs_from_bases {sigs_from_bases.launches}), {secs:.4f} s")
    if sigs_from_bases.launches or not signature_stage.launches:
        raise AssertionError(f"{label}: the index build's signatures did not "
                             "go through the fused stage")
    INDEX_SIGNATURES[label] = {"windows": w,
                               "launches": signature_stage.launches,
                               "seconds": secs}


def check_no_jax():
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "hashreadmapper_tpu")]
    if bad:
        raise AssertionError(f"imported: {bad}")


def sam_fractions(label, sam_path, n_reads, starts, junk):
    """The SAM checks: header, one row per read, planted mapped and
    concordant fractions (asserted); returns (mapped, concordant) [N]."""
    with open(sam_path) as fh:
        sam = fh.read()
    if not sam.startswith("@HD\tVN:1.4"):
        raise AssertionError("SAM header does not start with @HD\\tVN:1.4")
    rows = [ln.split("\t") for ln in sam.split("\n")
            if ln and not ln.startswith("@")]
    if len(rows) != n_reads:
        raise AssertionError(f"{len(rows)} SAM rows for {n_reads} reads")
    ids = np.array([int(r[0]) for r in rows])
    mapped = np.zeros(n_reads, bool)
    concordant = np.zeros(n_reads, bool)
    mapped[ids] = [r[11].startswith("Yf:i:") and "YZ:A:" in r[11]
                   for r in rows]
    concordant[ids] = [r[2].split()[0] == "chrB"
                       and abs(int(r[3]) - int(starts[i])) <= 128
                       for r, i in zip(rows, ids)]
    frac = check_fractions(label, mapped, concordant, junk)
    return mapped, concordant, frac


def launches_per_batch(label, mapper, padded, lens):
    """Launch counts of one steady map_reads(with_scores) over the pool,
    per 4,096-read batch (a batch is a graph replay, which counts the
    launches its capture recorded), and how many of its tracebacks' pairs
    kept their directions in shared memory, from the eager step of the
    same batches (a replay calls no wrapper to ask)."""
    from hashreadmapper_tpu_torch.ops import bandtb
    kernels = kernel_wrappers()
    mapper.map_reads(padded, lens, with_scores=True)
    for k in kernels.values():
        k.launches = 0
    mapper.map_reads(padded, lens, with_scores=True)
    n_batches = -(-len(lens) // mapper.opts.batchsize)
    per = {name: k.launches / n_batches for name, k in kernels.items()}
    real, seen = bandtb.traceback, []

    def asking_for_spills(*args, need=None, **kw):
        *out, spilled = real(*args, need=need, return_spilled=True, **kw)
        seen.append((need.sum(), spilled))
        return tuple(out)
    bandtb.traceback = asking_for_spills
    try:
        b, l, v, n_pad = mapper.stage_reads_device(padded, lens)
        bsz = mapper.opts.batchsize
        for s in range(0, n_pad, bsz):
            mapper._batch_step(b[s:s + bsz], l[s:s + bsz], v[s:s + bsz],
                               with_scores=True)
    finally:
        bandtb.traceback = real
    ran, spilled = (sum(int(x) for x in col) for col in zip(*seen))
    log(f"{label} launches per {mapper.opts.batchsize}-read batch "
        f"(map_reads with scores, {n_batches} batches, one graph replay "
        f"each): {per}; of the {ran} pairs its {len(seen)} tracebacks ran "
        f"(the eager step of the same batches), {spilled} spilled their "
        f"directions to device memory")
    return per


def profiled_launches(label, mapper, padded, lens):
    """Every device launch (kernels, copies, fills) of one steady
    map_reads(with_scores=True) over the pool, under torch.profiler: the
    count per 4,096-read batch, the host's launches, the device time and
    the card's busy share of the call."""
    return profiled(label, lambda: mapper.map_reads(padded, lens,
                                                    with_scores=True),
                    f"map_reads(with_scores=True) of {len(lens)} reads",
                    -(-len(lens) // mapper.opts.batchsize),
                    f"{mapper.opts.batchsize}-read batch")


# the host's calls that put work on the card's queue: kernel and graph
# launches, copies and fills (runtime and driver API names)
HOST_LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch|Memcpy|Memset)")


def profiled(label, fn, what, n_batches, unit):
    """Every device launch of one fn() under torch.profiler: the count per
    batch (`unit`), the host's launches per batch (kernel and graph
    launches, copies and fills it enqueued), the device time, the card's
    busy share of the call and the hand-written kernels by name.  Returns
    {"device": device launches a batch, "host": host launches a batch,
    "busy": busy share}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    if not on_device:
        raise AssertionError(f"{label}: the profiler saw no device activity")
    host = {}
    for e in events:
        if e.device_type == DeviceType.CPU and HOST_LAUNCH.match(e.name):
            host[e.name] = host.get(e.name, 0) + 1
    n_host = sum(host.values())
    device_s = sum(e.time_range.elapsed_us() for e in on_device) / 1e6
    by_name = {}
    for e in on_device:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    # the hand-written kernels, whatever their rank (their names carry the
    # sources' anonymous namespace and no other)
    own = {k.split("::")[-1].split("(")[0]: (n, round(t / 1e3, 3))
           for k, (n, t) in by_name.items()
           if "(anonymous namespace)::" in k and "at::" not in k}
    log(f"{label} torch.profiler, {what}: {len(on_device)} device launches "
        f"({len(on_device) / n_batches:.1f} per {unit}), host launches "
        f"{n_host} ({n_host / n_batches:.1f} per {unit}: {host}), device "
        f"time {device_s * 1e3:.3f} ms, wall under the "
        f"profiler {wall * 1e3:.3f} ms, card busy {device_s / wall:.4f} of "
        f"the call; most device time: "
        f"{[(k[:48], n, round(t / 1e3, 3)) for k, (n, t) in top]} "
        f"(name, launches, ms); the hand-written kernels: {own}")
    return {"device": len(on_device) / n_batches,
            "host": n_host / n_batches, "busy": device_s / wall}


def phase2(tmp):
    from hashreadmapper_tpu_torch import cli
    from hashreadmapper_tpu_torch.pipeline.driver import run_pipeline
    rng = np.random.default_rng(2)
    reads, starts, junk, chrom = write_dataset(tmp, rng)
    out = os.path.join(tmp, "out")
    argv = FLAGSHIP + ["--genomefile", os.path.join(tmp, "g.fa"), "-i",
                       os.path.join(tmp, "reads.fq.gz")]
    torch.cuda.reset_peak_memory_stats()
    res, wall, launches = counted("phase2 CLI run",
                                  lambda: cli.run(argv + ["-o", out]))
    log(f"phase2 whole CLI run, device STEP 2: {wall:.3f} s, phase timers "
        f"{res['timers']}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")

    # the same run with STEP 2 on staged pairs (no pipelining), and with
    # host STEP 2: byte-identical SAM and VCF
    for label, extra, step2_device in (
            ("device STEP 2 on staged pairs", ["--pipelineChunk", "0"], True),
            ("host STEP 2", [], False)):
        other = os.path.join(tmp, "out_other")
        opts, device = cli.options_from_args(argv + extra + ["-o", other])
        opts.step2_device = step2_device
        t0 = time.perf_counter()
        res_other = run_pipeline(opts, device)
        log(f"phase2 whole run, {label}: {time.perf_counter() - t0:.3f} s, "
            f"phase timers {res_other['timers']}")
        for ext in (".SAM", ".VCF"):
            with open(out + ext, "rb") as a, open(other + ext, "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"{ext}: {label} differs")
        log(f"phase2 SAM and VCF: fused device STEP 2 == {label}, byte for "
            "byte")

    if not os.path.exists(out + ".VCF"):
        raise AssertionError("no VCF written")
    _, _, frac = sam_fractions("phase2", out + ".SAM", N_READS, starts, junk)

    mapper = res["mapper"]
    index_signatures("phase2 flagship", mapper)
    lens = np.full(N_READS, READ_LEN, np.int32)
    padded = np.zeros((N_READS, 128), np.int8)
    padded[:, :READ_LEN] = reads
    mapper.map_reads(padded[:4096], lens[:4096])
    coarse_s, step2_s = [], []
    for _ in range(3):
        t = time.perf_counter()
        r = mapper.map_reads(padded, lens)
        coarse_s.append(time.perf_counter() - t)
    for _ in range(3):
        t = time.perf_counter()
        r2, (sc, _, st) = mapper.map_reads(padded, lens, with_scores=True)
        step2_s.append(time.perf_counter() - t)
    t_coarse = statistics.median(coarse_s)
    t_step2 = statistics.median(step2_s)
    log(f"phase2 coarse {N_READS / t_coarse:.1f} reads/s (median of 3: "
        f"{[round(s, 6) for s in coarse_s]} s); coarse + device STEP 2 "
        f"(scores, traceback, bundle to the host) "
        f"{N_READS / t_step2:.1f} reads/s (median of 3: "
        f"{[round(s, 6) for s in step2_s]} s), {t_coarse / t_step2:.4f} of "
        f"the coarse rate; overflow {r.stats}")
    if not np.array_equal(r2.position, r.position):
        raise AssertionError("map_reads with scores moved coarse results")
    mapped = np.repeat(r2.orientation != 3, 2)
    diag, ovf = sc[9] != 0, sc[8] != 0
    degen = (sc[0] == 0) | (sc[1] < 0)
    need = ~(diag | ovf | degen)
    counts = {"pairs of mapped reads": int(mapped.sum()),
              "diag-certified": int((mapped & diag).sum()),
              "host fallback (saturated)": int((mapped & ovf).sum()),
              "degenerate": int((mapped & degen & ~ovf).sum()),
              "need the traceback": int((mapped & need).sum()),
              "walk status 1 (failed)": int((mapped & (st == 1)).sum()),
              "walk status 2 (over 48 entries)":
                  int((mapped & (st == 2)).sum())}
    log(f"phase2 STEP-2 pairs: {counts}")
    per_batch = launches_per_batch("phase2", mapper, padded, lens)
    per_batch["every device launch"] = profiled_launches(
        "phase2", mapper, padded, lens)["device"]
    GRAPH_CASES.append(("flagship 3N", mapper, padded, lens, argv, out))
    return launches, per_batch, res, reads, chrom, starts, junk


def build_mappers(label, genome, flags, devices=("cuda", "cpu")):
    """One CoarseMapper per device over the same genome and flags."""
    from hashreadmapper_tpu_torch import cli
    from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper
    mappers = {}
    for dev in devices:
        opts, _ = cli.options_from_args(flags + ["--device", dev])
        t0 = time.perf_counter()
        mappers[dev] = CoarseMapper(genome, opts, dev)
        log(f"{label} {dev}: index built in {time.perf_counter() - t0:.3f} s")
    return mappers


def card_equals_cpu(label, mappers, reads, n, n_step2):
    """The same reads through the card's mapper and the CPU's (plain
    versions): identical packed [B, 7] rows (strand column included) and
    [5] overflow vectors of the first n reads, and, with n_step2 > 0,
    identical fused STEP-2 bundles of the first n_step2 reads."""
    from hashreadmapper_tpu_torch.pipeline.engine import fused_step2_scores
    devices = list(mappers)
    n = min(n, len(reads))
    n_step2 = min(n_step2, n, min(m.opts.batchsize for m in mappers.values()))
    lens = np.full(n, READ_LEN, np.int32)
    outs, step2 = {}, {}
    for dev, m in mappers.items():
        t0 = time.perf_counter()
        b, l, v, n_pad = m.stage_reads_device(reads[:n], lens)
        bsz = m.opts.batchsize
        parts = [m._map_batch(b[s:s + bsz], l[s:s + bsz], v[s:s + bsz])
                 for s in range(0, n_pad, bsz)]
        outs[dev] = [(p.cpu(), o.cpu()) for p, o in parts]
        t1 = time.perf_counter()
        if n_step2:
            k = slice(0, n_step2)
            step2[dev] = [x.cpu() for x in fused_step2_scores(
                m.opts, m.table.chrom_offset, m.table.chrom_len,
                m.genome_s2(), b[k], l[k], parts[0][0][k])]
        log(f"{label} {dev}: {n} reads in {t1 - t0:.3f} s, fused STEP 2 of "
            f"{n_step2} reads in {time.perf_counter() - t1:.3f} s")
    card, host = (outs[d] for d in devices)
    for i, ((pc, oc), (pp, op)) in enumerate(zip(card, host)):
        if not torch.equal(pc, pp) or not torch.equal(oc, op):
            bad = int((pc != pp).any(dim=1).sum())
            raise AssertionError(f"{label} batch {i}: card != CPU ({bad} "
                                 f"rows differ; overflow {oc.tolist()} vs "
                                 f"{op.tolist()})")
    rows = torch.cat([p for p, _ in card])[:n]
    log(f"{label} card == CPU: {len(card)} batches of [B, 7] rows "
        f"and [5] overflow vectors identical; overflow "
        f"{[o.tolist() for _, o in card]}; mapped "
        f"{int((rows[:, 0] != 3).sum())} of {n}, strand column set in "
        f"{int((rows[:, 6] != 0).sum())} rows")
    if not n_step2:
        return rows
    names = ("scores [10, 2B]", "tb_ops [2B, 48]", "tb_status [2B]")
    for name, c, h in zip(names, *(step2[d] for d in devices)):
        if c.dtype != h.dtype or not torch.equal(c, h):
            raise AssertionError(f"{label} fused STEP 2 {name}: card != CPU")
    sc, _, st = step2[devices[0]]
    ga = (rows[:n_step2, 6] != 0) & (rows[:n_step2, 0] == 1)
    log(f"{label} card == CPU: fused STEP 2 of the first {n_step2} reads, "
        f"{names} identical ({int((sc[9] == 0).sum())} pairs not "
        f"diag-certified, walk status counts "
        f"{torch.bincount(st.to(torch.int64), minlength=3).tolist()}, "
        f"{int(ga.sum())} reads with G->A pairs)")
    return rows


def phase3(res, reads):
    mappers = build_mappers("phase3", res["genome"], FLAGSHIP)
    card_equals_cpu("phase3", mappers, reads, 8192, 1024)
    return mappers


def phase5(tmp, res, chrom, mappers):
    """--threeN --undirectional at the flagship width on four-strand
    reads; the directional run of the same reads beside it."""
    from hashreadmapper_tpu_torch import cli
    rng = np.random.default_rng(5)
    reads, starts, junk, kind = four_strand_reads(rng, chrom, N_READS,
                                                  READ_LEN)
    fq = os.path.join(tmp, "reads_und.fq.gz")
    write_fastq(fq, reads)
    argv = FLAGSHIP + ["--genomefile", os.path.join(tmp, "g.fa"), "-i", fq]
    out = os.path.join(tmp, "out_und")
    res_u, wall, launches = counted(
        "phase5 --undirectional CLI run",
        lambda: cli.run(argv + ["--undirectional", "-o", out]))
    stats = res_u["results"].stats
    log(f"phase5 whole CLI run, --threeN --undirectional, device STEP 2: "
        f"{wall:.3f} s, phase timers {res_u['timers']}; overflow counters "
        f"{ {k: stats[k] for k in OVERFLOW_KEYS} }")
    mapped, concordant, frac = sam_fractions("phase5 all four strands",
                                             out + ".SAM", N_READS, starts,
                                             junk)
    out_d = os.path.join(tmp, "out_dir")
    t0 = time.perf_counter()
    cli.run(argv + ["-o", out_d])
    log(f"phase5 the directional run of the same reads: "
        f"{time.perf_counter() - t0:.3f} s")
    with open(out_d + ".SAM") as fh:
        rows = [ln.split("\t") for ln in fh.read().split("\n")
                if ln and not ln.startswith("@")]
    mapped_d = np.zeros(N_READS, bool)
    mapped_d[[int(r[0]) for r in rows]] = [r[11].startswith("Yf:i:")
                                           for r in rows]
    names = ("forward C->T", "reverse-complemented C->T", "forward G->A "
             "(PBAT)", "reverse-complemented G->A (PBAT)")
    per_strand = {}
    for k, name in enumerate(names):
        sel = (kind == k) & ~junk
        und_k, dir_k = float(mapped[sel].mean()), float(mapped_d[sel].mean())
        per_strand[name] = (und_k, dir_k)
        log(f"phase5 {name}: planted mapped {und_k:.6f} with "
            f"--undirectional, {dir_k:.6f} directional; concordant of "
            f"mapped {float(concordant[sel & mapped].mean()):.6f}")
        if k >= 2 and und_k < 0.85:
            raise AssertionError(f"phase5 {name}: only {und_k:.4f} of "
                                 "planted reads mapped (< 0.85)")
        if k >= 2 and dir_k > 0.5 * und_k:
            raise AssertionError(f"phase5 {name}: the directional mode maps "
                                 f"{dir_k:.4f} of them: nothing for "
                                 "--undirectional to add")
    bs = res_u["results"].bs_strand
    ori = res_u["results"].orientation
    log(f"phase5 strand column: {int((bs != 0).sum())} reads in the mirrored "
        f"space, {int(((bs != 0) & (ori == 1)).sum())} of them FORWARD "
        "(their STEP-2 pairs are G->A)")

    lens = np.full(N_READS, READ_LEN, np.int32)
    padded = np.zeros((N_READS, 128), np.int8)
    padded[:, :READ_LEN] = reads
    per_batch = launches_per_batch("phase5", res_u["mapper"], padded, lens)
    per_batch["every device launch"] = profiled_launches(
        "phase5", res_u["mapper"], padded, lens)["device"]
    GRAPH_CASES.append(("--undirectional", res_u["mapper"], padded, lens,
                        argv + ["--undirectional"], out))
    # card == CPU on the directional mappers' indexes (the 2F tables are
    # the same), switched to the undirectional step
    for m in mappers.values():
        m.opts.undirectional = True
    try:
        rows = card_equals_cpu("phase5", mappers, reads, 1024, 1024)
    finally:
        for m in mappers.values():
            m.opts.undirectional = False
    if not (rows[:, 6] != 0).any():
        raise AssertionError("phase5: no row carries the mirrored strand")
    return launches, per_batch, frac, per_strand


def phase6(tmp, res, chrom):
    """Parity mode (canonical k-mers, F tables, no --threeN) on 16,384
    unconverted reads of the same genome."""
    from hashreadmapper_tpu_torch import cli
    rng = np.random.default_rng(6)
    reads, starts, junk = unconverted_reads(rng, chrom, N_PARITY, READ_LEN)
    fq = os.path.join(tmp, "reads_par.fq.gz")
    write_fastq(fq, reads)
    # parity mode has F = 16 tables where 3N has 2F = 32: the vote keeps
    # the flagship threshold's share of the tables (4 of 32 -> 2 of 16)
    flags = [f for f in FLAGSHIP if f != "--threeN"]
    flags[flags.index("--minTableHits") + 1] = "2"
    out = os.path.join(tmp, "out_par")
    res_p, wall, launches = counted(
        "phase6 parity CLI run",
        lambda: cli.run(flags + ["--genomefile", os.path.join(tmp, "g.fa"),
                                 "-i", fq, "-o", out]))
    stats = res_p["results"].stats
    log(f"phase6 whole CLI run, parity mode, device STEP 2: {wall:.3f} s, "
        f"phase timers {res_p['timers']}; {res_p['mapper'].index.num_tables}"
        f" tables; overflow counters "
        f"{ {k: stats[k] for k in OVERFLOW_KEYS} }")
    _, _, frac = sam_fractions("phase6", out + ".SAM", N_PARITY, starts, junk)
    # the flagship's own threshold (4 of 16 tables), for comparison only
    lens = np.full(N_PARITY, READ_LEN, np.int32)
    padded = np.zeros((N_PARITY, 128), np.int8)
    padded[:, :READ_LEN] = reads
    res_p["mapper"].opts.min_table_hits = 4
    r4 = res_p["mapper"].map_reads(padded, lens)
    res_p["mapper"].opts.min_table_hits = 2
    log(f"phase6 with --minTableHits 4 instead: planted mapped "
        f"{float((r4.orientation != 3)[~junk].mean()):.6f}")
    GRAPH_CASES.append(("parity", res_p["mapper"], padded, lens,
                        flags + ["--genomefile", os.path.join(tmp, "g.fa"),
                                 "-i", fq], out))
    mappers = build_mappers("phase6", res["genome"], flags)
    card_equals_cpu("phase6", mappers, reads, 1024, 0)
    return launches, frac


def phase4(device="cuda"):
    from hashreadmapper_tpu_torch import cli
    from hashreadmapper_tpu_torch.io.genome import Genome
    from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper
    rng = np.random.default_rng(4)
    chrom = rng.integers(0, 4, size=CHR1_LEN, dtype=np.int8)
    genome = Genome(["chr1"], [ACGT[chrom].tobytes().decode()])
    reads, starts, junk = planted_reads(rng, chrom, N_READS, READ_LEN)
    opts, _ = cli.options_from_args(FLAGSHIP + AT_SCALE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mapper = CoarseMapper(genome, opts, device)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    index_signatures("phase4 chr1-size", mapper)
    lens = np.full(N_READS, READ_LEN, np.int32)
    padded = np.zeros((N_READS, 128), np.int8)
    padded[:, :READ_LEN] = reads
    mapper.map_reads(padded[:4096], lens[:4096])
    times = []
    for _ in range(3):
        t = time.perf_counter()
        r = mapper.map_reads(padded, lens)
        times.append(time.perf_counter() - t)
    t_map = statistics.median(times)
    log(f"phase4 chr1-size: {mapper.table.num_windows} windows, "
        f"{mapper.index.num_tables} tables, cuckoo "
        f"{mapper.index.cuckoo_keys is not None}, index build {t_build:.3f} s, "
        f"index+genome {mapper.resident_bytes()} B on the card, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
        f"coarse {N_READS / t_map:.1f} reads/s (median of 3: "
        f"{[round(s, 6) for s in times]} s), caps {AT_SCALE}, "
        f"overflow {r.stats}")
    profiled("phase4 chr1-size", lambda: mapper.map_reads(padded, lens),
             f"map_reads of {N_READS} reads", -(-N_READS // opts.batchsize),
             f"{opts.batchsize}-read batch")

    # the flagship (8 Mbp) caps at this scale, for comparison only
    for flag, attr in (("--probeCap", "probe_cap"),
                       ("--candidatesPerRead", "candidates_per_read_cap"),
                       ("--shdPairBudget", "shd_pairs_per_read_budget"),
                       ("--probeTailBudget", "probe_tail_budget_per_read"),
                       ("--probeHeadBudget", "probe_head_budget_per_read")):
        setattr(mapper.opts, attr, int(FLAGSHIP[FLAGSHIP.index(flag) + 1]))
    r_flag = mapper.map_reads(padded, lens)
    m_flag, _ = window_fractions(r_flag, starts)
    log(f"phase4 with the flagship caps instead: planted mapped "
        f"{float(m_flag[~junk].mean()):.6f}, overflow {r_flag.stats}")
    check_fractions("phase4", *window_fractions(r, starts), junk)
    for flag, attr in (("--probeCap", "probe_cap"),
                       ("--candidatesPerRead", "candidates_per_read_cap"),
                       ("--shdPairBudget", "shd_pairs_per_read_budget"),
                       ("--probeTailBudget", "probe_tail_budget_per_read"),
                       ("--probeHeadBudget", "probe_head_budget_per_read")):
        setattr(mapper.opts, attr, int(AT_SCALE[AT_SCALE.index(flag) + 1]))
    return dict(genome=genome, chrom=chrom, padded=padded, lens=lens,
                results=r, overflowed=overflowed_reads(mapper, padded, lens))


# the window stream's kernels (its pair stage is torch operations)
WS_KERNELS = ("minhash_stage", "probe_lookup", "probe_gather", "vote",
              "shd_pairs_best")


def window_fractions(res, starts):
    """(mapped, concordant) of coarse results against reads planted in
    chromosome 0 at `starts`."""
    mapped = res.orientation != 3
    concordant = (res.chromosome_id == 0) & (np.abs(
        res.position.astype(np.int64) - starts) <= 128)
    return mapped, concordant


RESULT_FIELDS = ("orientation", "hamming", "shift", "chromosome_id",
                 "position", "global_window_id", "bs_strand")


def same_results(label, a, b):
    """Raise unless the CoarseResults a and b agree on every field and
    stat."""
    for f in RESULT_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{label}: {f} differs in "
                                 f"{int((x != y).sum())} of {len(x)} reads")
    if a.stats != b.stats:
        raise AssertionError(f"{label}: stats {a.stats} != {b.stats}")


def phase7(res, reads, starts, junk):
    """The window stream (read index resident, the genome's windows
    streamed through it) at the flagship width: 49,152 planted reads,
    window_stream_bench.py's options (the flagship's); then card == CPU on
    a 1 Mbp prefix with 8,192 reads, 3N and --undirectional."""
    from hashreadmapper_tpu_torch import cli
    from hashreadmapper_tpu_torch.io.genome import Genome
    from hashreadmapper_tpu_torch.ops.minhash_kernel import signature_stage
    from hashreadmapper_tpu_torch.pipeline.window_stream import \
        WindowStreamMapper
    genome = res["genome"]
    opts, _ = cli.options_from_args(FLAGSHIP)
    lens = np.full(N_READS, READ_LEN, np.int32)
    torch.cuda.synchronize()
    signature_stage.launches = 0
    t0 = time.perf_counter()
    mapper = WindowStreamMapper(reads, lens, opts, "cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    build_sigs = signature_stage.launches
    n_win = genome.total_num_windows(opts.kmer_length, opts.window_size)
    n_batches = sum(1 for _ in genome.iter_window_batches(
        opts.kmer_length, opts.window_size, opts.batchsize))
    r, wall, launches = counted("phase7 window stream map_genome",
                                lambda: mapper.map_genome(genome),
                                WS_KERNELS)
    # the launches of the steady runs (one replay a window batch; the first
    # run's count holds the capture's warm-up)
    kernels = kernel_wrappers()
    for k in kernels.values():
        k.launches = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        mapper.map_genome(genome)
        times.append(time.perf_counter() - t0)
    t_map = statistics.median(times)
    per_batch = {k: kernels[k].launches / (3 * n_batches)
                 for k in WS_KERNELS}
    log(f"phase7 window stream, flagship: read index of {N_READS} reads "
        f"built in {t_build:.4f} s ({build_sigs} signature launches, "
        f"{mapper.index.num_tables} tables, cuckoo "
        f"{mapper.index.cuckoo_keys is not None}, "
        f"{mapper.resident_bytes()} B resident); map_genome of {n_win} "
        f"windows in {n_batches} batches: first {wall:.4f} s, then "
        f"{N_READS / t_map:.1f} reads/s and {n_win / t_map:.1f} windows/s "
        f"(median of 3: {[round(t, 6) for t in times]} s); launches per "
        f"window batch {per_batch}; overflow {r.stats}")
    for k in ("pair_budget_overflow", "probe_tail_overflow",
              "probe_head_overflow"):
        if r.stats[k]:
            raise AssertionError(f"phase7: {k} = {r.stats[k]}")
    per_batch["every device launch"] = profiled(
        "phase7", lambda: mapper.map_genome(genome),
        f"map_genome of {n_win} windows", n_batches,
        f"{opts.batchsize}-window batch")["device"]
    frac = check_fractions("phase7 flagship window stream",
                           *window_fractions(r, starts), junk)
    eng = res["mapper"].map_reads(
        np.pad(reads, ((0, 0), (0, 128 - READ_LEN))), lens)
    same = (eng.orientation == r.orientation) & (
        (r.orientation == 3) | ((eng.position == r.position)
                                & (eng.hamming == r.hamming)))
    log(f"phase7 against the inverted engine on the same reads: "
        f"{int(same.sum())} of {N_READS} reads with the same orientation, "
        f"position and hamming; engine overflow {eng.stats}")
    WINDOW_CASES.append(("window stream", mapper, genome))
    del mapper

    # card == CPU: a 1 Mbp prefix, 8,192 reads planted in it
    rng = np.random.default_rng(71)
    chrom = np.asarray(genome.bases[0][:1_000_000], np.int8)
    small = Genome(["chrB"], [ACGT[chrom].tobytes().decode()])
    n = 8192
    cases = (("3N", FLAGSHIP, planted_reads(rng, chrom, n, READ_LEN)[0]),
             ("--undirectional", FLAGSHIP + ["--undirectional"],
              four_strand_reads(rng, chrom, n, READ_LEN)[0]))
    for label, flags, rd in cases:
        outs = {}
        for dev in ("cuda", "cpu"):
            o, _ = cli.options_from_args(flags + ["--device", dev])
            t0 = time.perf_counter()
            outs[dev] = WindowStreamMapper(
                rd, np.full(len(rd), READ_LEN, np.int32), o,
                dev).map_genome(small)
            log(f"phase7 {label} {dev}: {n} reads against 1 Mbp in "
                f"{time.perf_counter() - t0:.3f} s")
        same_results(f"phase7 {label} card == CPU", outs["cuda"],
                     outs["cpu"])
        c = outs["cuda"]
        log(f"phase7 {label} card == CPU: every field and stat identical; "
            f"mapped {int((c.orientation != 3).sum())} of {n}, strand "
            f"column set in {int((c.bs_strand != 0).sum())}, overflow "
            f"{c.stats}")
    return launches, per_batch, frac


def phase7_chr1(chr1):
    """The window stream at chr1 scale: 1,048,576 planted reads resident,
    phase 4's 248,956,422 bp genome streamed through, phase 4's caps."""
    from hashreadmapper_tpu_torch import cli
    from hashreadmapper_tpu_torch.pipeline.window_stream import \
        WindowStreamMapper
    rng = np.random.default_rng(72)
    n = 1 << 20
    reads, starts, junk = planted_reads(rng, chr1["chrom"], n, READ_LEN)
    opts, _ = cli.options_from_args(FLAGSHIP + AT_SCALE)
    genome = chr1["genome"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mapper = WindowStreamMapper(reads, np.full(n, READ_LEN, np.int32), opts,
                                "cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = mapper.map_genome(genome)
    t_map = time.perf_counter() - t0
    n_win = genome.total_num_windows(opts.kmer_length, opts.window_size)
    log(f"phase7 chr1 scale: read index of {n} reads built in "
        f"{t_build:.3f} s ({mapper.index.num_tables} tables, cuckoo "
        f"{mapper.index.cuckoo_keys is not None}), read index and reads "
        f"{mapper.resident_bytes()} B resident, map_genome of {n_win} "
        f"windows {t_map:.3f} s ({n / t_map:.1f} reads/s, "
        f"{n_win / t_map:.1f} windows/s), max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B, caps {AT_SCALE}, overflow "
        f"{r.stats}")
    return check_fractions("phase7 chr1 window stream",
                           *window_fractions(r, starts), junk)


def overflowed_reads(mapper, padded, lens):
    """[N] bool: the reads of which a probe (any table) finds more windows
    than the probe cap in `mapper`'s index, or whose vote keeps more than
    the candidate cap (directional 3N).  Only such a read can map otherwise
    in regions: a region's index holds fewer windows a key and a region's
    vote fewer candidates, so a region keeps windows that the whole
    genome's caps dropped."""
    from hashreadmapper_tpu_torch.index import minhash_index as mi
    from hashreadmapper_tpu_torch.ops import minhash
    opts, idx = mapper.opts, mapper.index
    out = []
    for s in range(0, len(lens), opts.batchsize):
        rb = torch.from_numpy(padded[s:s + opts.batchsize]).to(mapper.device)
        rl = torch.from_numpy(lens[s:s + opts.batchsize]).to(mapper.device)
        sigs, valid = minhash.signatures_3n_pair(rb, rl, opts.kmer_length,
                                                 mapper._hash_ids_dev)
        cand, counts, _, _ = mi.probe_tables(
            idx.keys, idx.offsets, idx.values, idx.num_keys, sigs, valid,
            opts.probe_cap, bucket_start=idx.bucket_start,
            probe_steps=idx.probe_steps)
        _, _, kept = mi.vote_candidates_fnc_auto(
            cand, opts.min_table_hits, opts.candidates_per_read_cap)
        out.append(((counts > opts.probe_cap).any(dim=0)
                    | (kept > opts.candidates_per_read_cap)).cpu().numpy())
    return np.concatenate(out)


def sam_rows(path):
    """{read id: SAM row} of a SAM file."""
    with open(path) as fh:
        return {int(ln.split("\t", 1)[0]): ln for ln in fh.read().split("\n")
                if ln and not ln.startswith("@")}


def regions_against_single(label, differs, over, stats):
    """The check of a region run against the single mapper's: every read
    that differs is one of the reads with a probe or a vote over its cap
    (overflowed_reads), and no budget of the regions dropped a pair or a
    probe."""
    bad = np.nonzero(differs & ~over)[0]
    log(f"{label}: {int(differs.sum())} of {len(differs)} reads differ from "
        f"the single mapper's, all among its {int(over.sum())} reads with a "
        f"probe or a vote over its cap" if not len(bad) else
        f"{label}: reads {bad[:10].tolist()} differ without a probe or a "
        "vote over its cap")
    if len(bad):
        raise AssertionError(f"{label}: {len(bad)} reads without a probe or a "
                             "vote over its cap differ from the single "
                             "mapper's")
    for k in ("pair_budget_overflow", "probe_tail_overflow",
              "probe_head_overflow"):
        if stats[k]:
            raise AssertionError(f"{label}: {k} = {stats[k]} in the regions")


def phase8(tmp, res, reads):
    """--regions 4 through the flagship CLI: a window partition of the one
    chromosome, four CoarseMappers without cuckoo tables, the fused STEP 2
    in each.  At the flagship caps a read differs from phase 2's
    single-mapper SAM only where one of its probes finds more windows than
    the cap in the whole genome (a region's index holds fewer a key) or its
    vote more candidates; at a probe cap that no probe exceeds, SAM and VCF
    are byte for byte the single mapper's."""
    from hashreadmapper_tpu_torch import cli
    from hashreadmapper_tpu_torch.parallel.region_sharded import \
        RegionShardedMapper
    argv = FLAGSHIP + ["--genomefile", os.path.join(tmp, "g.fa"), "-i",
                       os.path.join(tmp, "reads.fq.gz")]
    out = os.path.join(tmp, "out_regions")
    res_r, wall, launches = counted(
        "phase8 --regions 4 CLI run",
        lambda: cli.run(argv + ["--regions", "4", "-o", out]))
    mapper = res_r["mapper"]
    if not isinstance(mapper, RegionShardedMapper) or mapper.n_regions != 4:
        raise AssertionError("phase8: --regions 4 did not build four regions")
    if any(m.index.cuckoo_keys is not None for m in mapper.mappers):
        raise AssertionError("phase8: four regions on one card built a "
                             "cuckoo table")
    n_batches = -(-N_READS // mapper.opts.batchsize) * mapper.n_regions
    per_batch = {k: v / n_batches for k, v in launches.items()
                 if k in kernel_wrappers()}
    log(f"phase8 --regions 4 CLI run: {wall:.3f} s, phase timers "
        f"{res_r['timers']}, regions "
        f"{[[(s.chrom_id, s.win_start, s.win_stop) for s in r] for r in mapper.regions]}, "
        f"resident bytes per region "
        f"{[m.resident_bytes() for m in mapper.mappers]}, stats "
        f"{res_r['results'].stats}; launches per read batch of a region "
        f"{per_batch}")
    single_rows = sam_rows(os.path.join(tmp, "out.SAM"))
    region_rows = sam_rows(out + ".SAM")
    differs = np.array([single_rows[i] != region_rows[i]
                        for i in range(N_READS)])
    lens = np.full(N_READS, READ_LEN, np.int32)
    padded = np.zeros((N_READS, 128), np.int8)
    padded[:, :READ_LEN] = reads
    over = overflowed_reads(res["mapper"], padded, lens)
    with open(os.path.join(tmp, "out.VCF"), "rb") as a, \
            open(out + ".VCF", "rb") as b:
        vcf_same = a.read() == b.read()
    log(f"phase8 --regions 4 at the flagship caps: SAM rows of "
        f"{int(differs.sum())} reads differ, VCF "
        f"{'byte for byte the same' if vcf_same else 'differs'}")
    regions_against_single("phase8 --regions 4 SAM", differs, over,
                           res_r["results"].stats)
    GRAPH_CASES.append(("--regions 4", mapper, padded, lens,
                        argv + ["--regions", "4"], out))

    # a probe cap that no probe of these reads exceeds: byte for byte
    cap = ["--probeCap", "256"]
    outs = {}
    for label, extra in (("single", []), ("--regions 4", ["--regions", "4"])):
        outs[label] = os.path.join(tmp, f"out_cap_{len(extra)}")
        t0 = time.perf_counter()
        r = cli.run(argv + cap + extra + ["-o", outs[label]])
        log(f"phase8 {label} with {cap}: {time.perf_counter() - t0:.3f} s, "
            f"stats {r['results'].stats}")
        st = r["results"].stats
        if label == "single" and (st["probe_overflow"] or st["vote_overflow"]):
            raise AssertionError(f"phase8: probes or votes over the caps "
                                 f"remain at {cap}: {st}")
    for ext in (".SAM", ".VCF"):
        with open(outs["single"] + ext, "rb") as a, \
                open(outs["--regions 4"] + ext, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"phase8: --regions 4 {ext} differs "
                                     f"from the single mapper's at {cap}")
    log(f"phase8 SAM and VCF at {cap}: --regions 4 == single, byte for byte")
    return launches, per_batch


def phase8_chr1(chr1):
    """Phase 4's chr1 genome in two window regions on the card (cuckoo
    tables in both): every read without a probe or a vote over its cap in
    phase 4's single mapper has its results, and global_window_id64 its
    global_window_id."""
    from hashreadmapper_tpu_torch import cli
    from hashreadmapper_tpu_torch.parallel.region_sharded import \
        RegionShardedMapper
    opts, _ = cli.options_from_args(FLAGSHIP + AT_SCALE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mapper = RegionShardedMapper(chr1["genome"], opts, 2, partition="window")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    r, wall, launches = counted(
        "phase8 chr1 two regions map_reads",
        lambda: mapper.map_reads(chr1["padded"], chr1["lens"]), WS_KERNELS)
    single = chr1["results"]
    differs = np.zeros(len(single.orientation), bool)
    for f in RESULT_FIELDS:
        differs |= getattr(r, f) != getattr(single, f)
    regions_against_single("phase8 chr1 two regions", differs,
                           chr1["overflowed"], r.stats)
    mapped = single.orientation != 3
    same = ~differs & mapped
    if not np.array_equal(r.global_window_id64[same],
                          single.global_window_id[same].astype(np.int64)):
        raise AssertionError("phase8: global_window_id64 differs from the "
                             "single mapper's global_window_id")
    log(f"phase8 chr1 scale, two window regions: built in {t_build:.3f} s "
        f"({[round(x, 3) for x in mapper.build_seconds]} s a region), "
        f"resident bytes per region "
        f"{[m.resident_bytes() for m in mapper.mappers]}, cuckoo "
        f"{[m.index.cuckoo_keys is not None for m in mapper.mappers]}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
        f"map_reads {wall:.3f} s; stats {r.stats} against the single "
        f"mapper's {single.stats} (the probe cap counts per region); "
        f"planted-read results of the mapped reads equal: "
        f"{int(same.sum())}, global_window_id64 == global_window_id there")
    return launches


def mesh_card_equals_cpu(label, genome, flags, reads, mesh_shape, regions=0,
                         with_scores=True):
    """The same reads through a logical mesh on the card and on the CPU
    (every position that device): every field and stat, and with_scores
    the fused STEP-2 bundle, identical.  regions > 0: a
    RegionShardedMapper of that many regions over the mesh."""
    from hashreadmapper_tpu_torch import cli
    from hashreadmapper_tpu_torch.parallel.region_sharded import \
        RegionShardedMapper
    from hashreadmapper_tpu_torch.parallel.sharded import (
        ShardedCoarseMapper, make_mesh)
    n = len(reads)
    padded = np.zeros((n, 128), np.int8)
    padded[:, :READ_LEN] = reads
    lens = np.full(n, READ_LEN, np.int32)
    outs = {}
    for dev in ("cuda:0", "cpu"):
        opts, _ = cli.options_from_args(flags + ["--device",
                                                 dev.split(":")[0]])
        mesh = make_mesh(*mesh_shape, [dev] * (mesh_shape[0] * mesh_shape[1]))
        t0 = time.perf_counter()
        mapper = (RegionShardedMapper(genome, opts, regions, mesh=mesh)
                  if regions else ShardedCoarseMapper(genome, opts, mesh))
        t1 = time.perf_counter()
        outs[dev] = mapper.map_reads(padded, lens, with_scores=with_scores)
        log(f"{label} {dev}: built in {t1 - t0:.3f} s, {n} reads mapped in "
            f"{time.perf_counter() - t1:.3f} s")
    card, host = outs["cuda:0"], outs["cpu"]
    if with_scores:
        (card, c_bundle), (host, h_bundle) = card, host
        for name, c, h in zip(("scores", "tb_ops", "tb_status"), c_bundle,
                              h_bundle):
            if c.dtype != h.dtype or not np.array_equal(c, h):
                raise AssertionError(f"{label}: fused STEP 2 {name}: card "
                                     "!= CPU")
    same_results(f"{label} card == CPU", card, host)
    log(f"{label} card == CPU: every field and stat identical"
        f"{', and the fused STEP-2 bundle' if with_scores else ''}; mapped "
        f"{int((card.orientation != 3).sum())} of {n}, strand column set in "
        f"{int((card.bs_strand != 0).sum())}, overflow {card.stats}")


def region_worker(rank, world, coord, tmp):
    """One rank of phase 9's two-process region merge: its 2 of the
    flagship's 4 window regions on the card, the merge over gloo with the
    other rank; rank 0 writes the merged key and payload to tmp."""
    from hashreadmapper_tpu_torch import cli
    from hashreadmapper_tpu_torch.io.genome import Genome
    from hashreadmapper_tpu_torch.parallel import multihost
    from hashreadmapper_tpu_torch.parallel.region_sharded import (
        chrom_gwin_base, region_key_payload)
    from hashreadmapper_tpu_torch.parallel.segments import partition_windows
    from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper
    rank, world = int(rank), int(world)
    multihost.initialize(coord, world, rank, backend="gloo")
    genome = Genome.from_fasta(os.path.join(tmp, "g.fa"))
    padded = np.load(os.path.join(tmp, "padded.npy"))
    lens = np.full(len(padded), READ_LEN, np.int32)
    opts, _ = cli.options_from_args(FLAGSHIP)
    mesh = multihost.region_mesh(["cuda:0", "cuda:0"])
    regions = partition_windows(genome, opts, mesh.num_regions)
    gwin_base = chrom_gwin_base(genome, opts)
    keys, payloads = [], []
    t0 = time.perf_counter()
    for r, dev in enumerate(mesh.local_devices):
        mapper = CoarseMapper(genome, opts, dev,
                              segments=regions[mesh.region_offset + r],
                              build_direct_probe=False)
        mapper.ensure_empty_drops()
        packed, _, _ = mapper.map_reads_packed(padded, lens)
        key, payload, _ = region_key_payload(mapper, packed, gwin_base)
        keys.append(key)
        payloads.append(payload)
    t1 = time.perf_counter()
    key, payload = multihost.merge_region_results(mesh, keys, payloads)
    t2 = time.perf_counter()
    if rank == 0:
        np.savez(os.path.join(tmp, "merged.npz"), key=key, payload=payload)
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f"REGION_WORKER {rank}: regions {mesh.region_offset}.."
          f"{mesh.region_offset + len(keys) - 1} of {mesh.num_regions}, "
          f"mapped in {t1 - t0:.3f} s, merged over gloo in {t2 - t1:.3f} s",
          flush=True)
    return 0


def two_process_merge(tmp, genome, padded, lens):
    """Phase 9 (e): 2 processes, each with 2 of the flagship's 4 window
    regions on the card, merged over gloo (host tensors: NCCL refuses two
    ranks on one card) == the single-process 4-region
    RegionShardedMapper."""
    import socket
    from hashreadmapper_tpu_torch import cli
    from hashreadmapper_tpu_torch.parallel.region_sharded import \
        RegionShardedMapper
    opts, _ = cli.options_from_args(FLAGSHIP)
    np.save(os.path.join(tmp, "padded.npy"), padded)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"),
         "--region-worker", str(rank), "2", coord, tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"phase9 region worker {rank} failed:\n"
                                 f"{out[-4000:]}")
        log(out.strip().splitlines()[-1])
    merged = np.load(os.path.join(tmp, "merged.npz"))
    ref = RegionShardedMapper(genome, opts, 4, devices=["cuda:0"],
                              partition="window").map_reads(padded, lens)
    want_key = np.where(ref.orientation != 3,
                        (ref.hamming.astype(np.int64) << 40)
                        + ref.global_window_id64, np.int64(2**62))
    if not np.array_equal(merged["key"], want_key):
        raise AssertionError("phase9: the two-process merge's keys differ "
                             "from the single-process regions'")
    for col, f in enumerate(("orientation", "hamming", "shift",
                             "chromosome_id", "position", "bs_strand")):
        if not np.array_equal(merged["payload"][:, col], getattr(ref, f)):
            raise AssertionError(f"phase9: the two-process merge's {f} "
                                 "differs from the single-process regions'")
    log(f"phase9 two processes x 2 regions on the card, merged over gloo on "
        f"host tensors (NCCL takes one rank a card): {wall:.3f} s with both "
        f"processes' start; keys and the 6 payload fields of all {len(lens)} "
        f"reads equal the single-process 4-region RegionShardedMapper's "
        f"(mapped {int((ref.orientation != 3).sum())})")


def phase9(tmp, res, reads, starts, junk):
    """The data x table mesh at the flagship width (a logical 2 x 4 mesh on
    the one card: every position cuda:0, so its numbers are a mesh's
    launches and copies, not a scaling figure), the regions over a mesh,
    and the two-process region merge."""
    from hashreadmapper_tpu_torch import cli
    from hashreadmapper_tpu_torch.io.genome import Genome
    from hashreadmapper_tpu_torch.parallel.sharded import (
        ShardedCoarseMapper, make_mesh)
    from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper
    genome, single = res["genome"], res["mapper"]
    opts, _ = cli.options_from_args(FLAGSHIP)
    lens = np.full(N_READS, READ_LEN, np.int32)
    padded = np.zeros((N_READS, 128), np.int8)
    padded[:, :READ_LEN] = reads
    d_n, t_n = MESH
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mapper = ShardedCoarseMapper(genome, opts,
                                 make_mesh(d_n, t_n, ["cuda:0"] * d_n * t_n))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    (r, _), wall, launches = counted(
        f"phase9 {d_n}x{t_n} mesh map_reads(with_scores=True)",
        lambda: mapper.map_reads(padded, lens, with_scores=True))
    n_batches = -(-N_READS // (opts.batchsize * d_n))
    per_batch = {k: v / n_batches for k, v in launches.items()
                 if k in kernel_wrappers()}
    coarse_s, step2_s = [], []
    for _ in range(3):
        t = time.perf_counter()
        mapper.map_reads(padded, lens)
        coarse_s.append(time.perf_counter() - t)
    for _ in range(3):
        t = time.perf_counter()
        mapper.map_reads(padded, lens, with_scores=True)
        step2_s.append(time.perf_counter() - t)
    t_coarse, t_step2 = (statistics.median(x) for x in (coarse_s, step2_s))
    ref = single.map_reads(padded, lens)
    log(f"phase9 {d_n}x{t_n} logical mesh on one card, flagship: built in "
        f"{t_build:.3f} s; index bytes per position "
        f"{mapper.index_memory_per_position()}, per device "
        f"{mapper.index_memory_per_device()}; coarse "
        f"{N_READS / t_coarse:.1f} reads/s (median of 3: "
        f"{[round(s, 6) for s in coarse_s]} s), coarse + device STEP 2 "
        f"{N_READS / t_step2:.1f} reads/s (median of 3: "
        f"{[round(s, 6) for s in step2_s]} s); hand-written launches per "
        f"mesh batch of {opts.batchsize * d_n} reads ({n_batches} batches) "
        f"{per_batch}; overflow {r.stats} against the single mapper's "
        f"{ref.stats} (the tail budget counts per table shard, no head "
        f"budget on the mesh)")
    per_batch["every device launch"] = profiled(
        "phase9", lambda: mapper.map_reads(padded, lens, with_scores=True),
        f"{d_n}x{t_n} mesh map_reads(with_scores=True) of {N_READS} reads",
        n_batches, f"{opts.batchsize * d_n}-read mesh batch")["device"]
    frac = check_fractions("phase9 flagship mesh",
                           *window_fractions(r, starts), junk)
    del mapper

    # (b) where no cap or budget is over, the single mapper's rows
    exact = FLAGSHIP + ["--probeCap", "256", "--shdPairBudget", "0",
                        "--probeTailBudget", "0", "--probeHeadBudget", "0"]
    opts_x, _ = cli.options_from_args(exact)
    a = CoarseMapper(genome, opts_x, "cuda").map_reads(padded, lens)
    b = ShardedCoarseMapper(genome, opts_x, make_mesh(
        d_n, t_n, ["cuda:0"] * d_n * t_n)).map_reads(padded, lens)
    if any(a.stats[k] for k in OVERFLOW_KEYS):
        raise AssertionError(f"phase9: counters over at {exact[-8:]}: "
                             f"{a.stats}")
    same_results("phase9 mesh == single at probe cap 256, no budgets", b, a)
    log(f"phase9 {d_n}x{t_n} mesh == single mapper at {exact[-8:]}: every "
        f"field of {N_READS} reads and every counter (all 0) identical")

    # (a) card == CPU on a 1 Mbp prefix, 8,192 reads, 3N and undirectional
    rng = np.random.default_rng(91)
    chrom = np.asarray(genome.bases[0][:1_000_000], np.int8)
    small = Genome(["chrB"], [ACGT[chrom].tobytes().decode()])
    mesh_card_equals_cpu("phase9 3N 2x4 mesh", small, FLAGSHIP,
                         planted_reads(rng, chrom, 8192, READ_LEN)[0], MESH)
    mesh_card_equals_cpu("phase9 --undirectional 2x4 mesh", small,
                         FLAGSHIP + ["--undirectional"],
                         four_strand_reads(rng, chrom, 8192, READ_LEN)[0],
                         MESH)
    # (d) 4 regions over a logical 1 x 2 mesh, card == CPU
    mesh_card_equals_cpu("phase9 4 regions over a 1x2 mesh", small, FLAGSHIP,
                         planted_reads(rng, chrom, 4096, READ_LEN)[0], (1, 2),
                         regions=4, with_scores=False)

    # (c) the CLI: --mesh 1 1 without the head budget == the single run
    argv = FLAGSHIP + ["--probeHeadBudget", "0", "--genomefile",
                       os.path.join(tmp, "g.fa"), "-i",
                       os.path.join(tmp, "reads.fq.gz")]
    outs = {}
    for label, extra in (("single", []), ("--mesh 1 1", ["--mesh", "1", "1"])):
        outs[label] = os.path.join(tmp, f"out_mesh_{len(extra)}")
        t0 = time.perf_counter()
        rc = cli.run(argv + extra + ["-o", outs[label]])
        log(f"phase9 CLI {label} --probeHeadBudget 0: "
            f"{time.perf_counter() - t0:.3f} s, mapper "
            f"{type(rc['mapper']).__name__}, stats {rc['results'].stats}")
    for ext in (".SAM", ".VCF"):
        with open(outs["single"] + ext, "rb") as x, \
                open(outs["--mesh 1 1"] + ext, "rb") as y:
            if x.read() != y.read():
                raise AssertionError(f"phase9: --mesh 1 1 {ext} differs from "
                                     "the single CLI run's")
    log("phase9 SAM and VCF: --mesh 1 1 == single, byte for byte")

    # (e) two processes, two regions each, merged over gloo
    two_process_merge(tmp, genome, padded, lens)

    # distinct cards, where the machine has them
    if torch.cuda.device_count() >= 2:
        mesh2 = make_mesh(1, 2)
        m2 = ShardedCoarseMapper(genome, opts, mesh2)
        r2 = m2.map_reads(padded, lens)
        steps = sorted({k[0] for k in m2._steps})
        if steps != ["head", "probe", "tail"]:
            raise AssertionError(f"phase9 1x2 mesh over two cards ran the "
                                 f"steps {steps}, not the split path")
        same_results("phase9 1x2 mesh over two cards == the logical mesh",
                     r2, ShardedCoarseMapper(genome, opts, make_mesh(
                         1, 2, ["cuda:0"] * 2)).map_reads(padded, lens))
        log(f"phase9 1x2 mesh over {mesh2.devices[0]}, split at the cards "
            f"({len(m2._steps)} steps: {steps}): identical to the logical "
            f"1x2 mesh on cuda:0")
        del m2
    else:
        log(f"phase9 1x2 mesh over distinct cards: skipped, "
            f"{torch.cuda.device_count()} card on this machine")
    return launches, per_batch, frac


# the graph phase's cases, stashed by the phases that ran them: (label,
# mapper, padded reads, lengths, the CLI's arguments, its output prefix)
# and (label, window-stream mapper, genome)
GRAPH_CASES = []
WINDOW_CASES = []
STEP_OUTPUTS = ("packed [B, 7]", "overflow [5]", "scores [10, 2B]",
                "tb_ops [2B, 48]", "tb_status [2B]")


@contextlib.contextmanager
def eager_steps():
    """Every batch step eager on the card (CapturedStep.run_eager in place
    of the graph's replay): the same steps launch by launch, as the port
    ran them before its graphs."""
    from hashreadmapper_tpu_torch.pipeline import graphs
    run = graphs.CapturedStep.run
    graphs.CapturedStep.run = graphs.CapturedStep.run_eager
    try:
        yield
    finally:
        graphs.CapturedStep.run = run


def graph_equals_eager(label, mapper, padded, lens):
    """Each CoarseMapper of the case (every region's) over the staged
    reads: _map_reads_device_scored, one graph replay a batch, against
    the eager step of each batch: packed rows, overflow, score rows,
    traceback entries and status, bit for bit."""
    batches = 0
    for m in getattr(mapper, "mappers", [mapper]):
        m.ensure_empty_drops()
        b, l, v, n_pad = m.stage_reads_device(padded, lens)
        bsz = m.opts.batchsize
        graph = m._map_reads_device_scored(b, l, v, n_pad, bsz)
        overflow = torch.zeros_like(graph[1])
        for s in range(0, n_pad, bsz):
            eager = m._batch_step(b[s:s + bsz], l[s:s + bsz], v[s:s + bsz],
                                  with_scores=True)
            overflow += eager[1]
            p = slice(2 * s, 2 * (s + bsz))
            for name, g, e in zip(STEP_OUTPUTS,
                                  (graph[0][s:s + bsz], None,
                                   graph[2][:, p], graph[3][p], graph[4][p]),
                                  eager):
                if g is not None and (g.dtype != e.dtype
                                      or not torch.equal(g, e)):
                    raise AssertionError(f"phase10 {label} batch "
                                         f"{s // bsz}: {name} graph != eager")
            batches += 1
        if not torch.equal(graph[1], overflow):
            raise AssertionError(f"phase10 {label}: overflow graph != eager")
    log(f"phase10 {label}: graph == eager, bit for bit, over {batches} "
        f"batches: {', '.join(STEP_OUTPUTS)}")


def timed_alternately(fns, order=("eager", "graph", "graph", "eager",
                                  "eager", "graph")):
    """{side: [seconds]} of each fns[side]() in the given order, the
    eager side under eager_steps()."""
    times = {side: [] for side in fns}
    for side in order:
        ctx = eager_steps() if side == "eager" else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[side]()
            times[side].append(time.perf_counter() - t0)
    return times


def graph_case(tmp, label, mapper, padded, lens, argv, out):
    """One case of phase 10: graph == eager; the CLI's SAM and VCF with
    every step eager against the graph run's, byte for byte; coarse and
    coarse + STEP 2 reads/s, graph and eager alternated (medians of 3);
    host launches, device launches and busy share of each under
    torch.profiler; the steps' capture seconds."""
    from hashreadmapper_tpu_torch import cli
    graph_equals_eager(label, mapper, padded, lens)
    n = len(lens)
    eager_out = os.path.join(tmp, "out_eager")
    with eager_steps():
        t0 = time.perf_counter()
        cli.run(argv + ["-o", eager_out])
        eager_wall = time.perf_counter() - t0
    for ext in (".SAM", ".VCF"):
        with open(out + ext, "rb") as a, open(eager_out + ext, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"phase10 {label}: {ext} of the graph "
                                     "run != the eager run's")
    log(f"phase10 {label}: CLI SAM and VCF, graph == eager, byte for byte "
        f"(the eager CLI run {eager_wall:.3f} s)")
    rec = {}
    for what, kw in (("coarse", {}), ("coarse + STEP 2",
                                      {"with_scores": True})):
        run = lambda: mapper.map_reads(padded, lens, **kw)
        run()
        with eager_steps():
            run()
        times = timed_alternately({"graph": run, "eager": run})
        rate = {side: n / statistics.median(t) for side, t in times.items()}
        rec[what] = rate
        log(f"phase10 {label} {what}: graph {rate['graph']:.1f} reads/s, "
            f"eager {rate['eager']:.1f} (medians of 3, alternated: "
            f"{ {k: [round(x, 6) for x in v] for k, v in times.items()} } s)"
            f", {rate['graph'] / rate['eager']:.4f}x")
    n_batches = -(-n // mapper.opts.batchsize) * len(
        getattr(mapper, "mappers", [mapper]))
    unit = f"{mapper.opts.batchsize}-read batch" + (
        " of a region" if hasattr(mapper, "mappers") else "")
    for side in ("graph", "eager"):
        ctx = eager_steps() if side == "eager" else contextlib.nullcontext()
        with ctx:
            rec[side] = profiled(
                f"phase10 {label} {side}",
                lambda: mapper.map_reads(padded, lens, with_scores=True),
                f"map_reads(with_scores=True) of {n} reads", n_batches,
                unit)
    caps = [round(st.capture_seconds, 4)
            for m in getattr(mapper, "mappers", [mapper])
            for st in m._steps.values()]
    from hashreadmapper_tpu_torch.pipeline import graphs
    rec["capture_s"] = caps
    rec["pool_bytes"] = graphs.pool_bytes("cuda")
    log(f"phase10 {label}: {len(caps)} steps captured, warm-up and capture "
        f"{caps} s; the card's graph pool now {rec['pool_bytes']} B (every "
        f"live graph of the card's phases so far)")
    return rec, eager_wall


def window_case(label, ws, genome):
    """The window stream: every window batch's replay against the eager
    step (the [B*K, 5] rows and overflow, bit for bit); map_genome reads/s
    graph and eager alternated; launches and busy share of each."""
    ws.map_genome(genome)
    step = next(iter(ws._steps.values()))
    _, meta = ws._batch_table(genome)
    meta_dev = torch.from_numpy(meta).cuda()
    for i in range(len(meta)):
        got = [x.clone() for x in step.run(ws._window_step, meta_dev[i])]
        for name, g, e in zip(("rows [B*K, 5]", "overflow [5]"), got,
                              ws._window_step(meta_dev[i])):
            if g.dtype != e.dtype or not torch.equal(g, e):
                raise AssertionError(f"phase10 {label} batch {i}: {name} "
                                     "graph != eager")
    with eager_steps():
        eager = ws.map_genome(genome)
    same_results(f"phase10 {label} map_genome graph == eager",
                 ws.map_genome(genome), eager)
    log(f"phase10 {label}: graph == eager over {len(meta)} window batches, "
        f"rows and overflow bit for bit; map_genome's results equal")
    run = lambda: ws.map_genome(genome)
    times = timed_alternately({"graph": run, "eager": run})
    rate = {side: ws.num_reads / statistics.median(t)
            for side, t in times.items()}
    log(f"phase10 {label} map_genome: graph {rate['graph']:.1f} reads/s, "
        f"eager {rate['eager']:.1f} (medians of 3, alternated: "
        f"{ {k: [round(x, 6) for x in v] for k, v in times.items()} } s), "
        f"{rate['graph'] / rate['eager']:.4f}x; capture "
        f"{round(step.capture_seconds, 4)} s")
    rec = {"map_genome": rate, "capture_s": [round(step.capture_seconds, 4)]}
    for side in ("graph", "eager"):
        ctx = eager_steps() if side == "eager" else contextlib.nullcontext()
        with ctx:
            rec[side] = profiled(
                f"phase10 {label} {side}", run,
                f"map_genome of {len(meta)} window batches", len(meta),
                f"{ws.opts.batchsize}-window batch")
    return rec


def phase10(tmp):
    """The captured graphs of the batch steps against the eager steps, in
    every mode the earlier phases ran: flagship 3N, --undirectional,
    parity, --regions 4 and the window stream; the flagship CLI's
    whole-run seconds graph and eager alternated; the captures' seconds
    and the card's graph pool."""
    from hashreadmapper_tpu_torch import cli
    from hashreadmapper_tpu_torch.pipeline import graphs
    out = {}
    for label, mapper, padded, lens, argv, prefix in GRAPH_CASES:
        out[label], _ = graph_case(tmp, label, mapper, padded, lens, argv,
                                   prefix)
    for label, ws, genome in WINDOW_CASES:
        out[label] = window_case(label, ws, genome)
    label, _, _, _, argv, _ = GRAPH_CASES[0]
    prefix = os.path.join(tmp, "out_alt")
    walls = timed_alternately({side: lambda: cli.run(argv + ["-o", prefix])
                               for side in ("graph", "eager")},
                              ("eager", "graph", "graph", "eager"))
    out["cli_seconds"] = walls
    n_cap, cap_s = graphs.capture_stats("cuda")
    out["pool_bytes"] = graphs.pool_bytes("cuda")
    log(f"phase10 {label} whole CLI run (a new mapper each, its graphs "
        f"captured in the run): graph {walls['graph']} s, eager "
        f"{walls['eager']} s (alternated); {n_cap} graphs captured on the "
        f"card so far in {cap_s:.3f} s; the card's graph pool "
        f"{out['pool_bytes']} B, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    GRAPH_CASES.clear()
    WINDOW_CASES.clear()
    return out


def mesh_graph_equals_eager(label, mapper, padded, lens):
    """The mesh's _map_reads_device_scored, a replay a data shard's batch,
    against the eager step (_map_shard_batch) of every data shard's batch:
    packed rows, overflow, score rows, traceback entries and status, bit
    for bit.  Returns the batches compared."""
    mapper.ensure_read_drops(padded, lens)
    mapper.ensure_empty_drops()
    staged = mapper.stage_reads_device(padded, lens)
    bases, ln, valid, _ = staged
    graph = mapper._map_reads_device_scored(*staged, mapper.opts.batchsize)
    d_n = len(bases)
    eager = [mapper._map_shard_batch(d, bases[d][i], ln[d][i], valid[d][i],
                                     with_scores=True)
             for i in range(bases[0].shape[0]) for d in range(d_n)]
    want = (torch.cat([e[0] for e in eager]),
            torch.stack([e[1] for e in eager]).sum(dim=0),
            torch.cat([e[2] for e in eager], dim=1),
            torch.cat([e[3] for e in eager]),
            torch.cat([e[4] for e in eager]))
    for name, g, e in zip(STEP_OUTPUTS, graph, want):
        if g.dtype != e.dtype or not torch.equal(g, e):
            raise AssertionError(f"phase11 {label}: {name} graph != eager")
    return len(eager)


def phase11(cases):
    """The logical 2x4 mesh's dispatch units as CUDA graphs (a replay a
    data shard's batch on the card's own stream) against the same steps
    eager, in the modes of phase 10's single mappers (flagship 3N,
    --undirectional, parity; their genomes, options and reads): bit for
    bit; coarse and coarse + STEP 2 reads/s of both, alternated, medians
    of 3; host launches, device launches and busy share a mesh batch of
    each under torch.profiler; the steps' capture seconds and the card's
    graph pool."""
    from hashreadmapper_tpu_torch.parallel.sharded import (
        ShardedCoarseMapper, make_mesh)
    from hashreadmapper_tpu_torch.pipeline import graphs
    d_n, t_n = MESH
    out = {}
    for label, genome, opts, padded, lens in cases:
        n = len(lens)
        mapper = ShardedCoarseMapper(
            genome, opts, make_mesh(d_n, t_n, ["cuda:0"] * d_n * t_n))
        batches = mesh_graph_equals_eager(label, mapper, padded, lens)
        log(f"phase11 {d_n}x{t_n} mesh {label}: graph == eager, bit for bit, "
            f"over {batches} data shards' batches: {', '.join(STEP_OUTPUTS)}")
        rec = {}
        for what, kw in (("coarse", {}), ("coarse + STEP 2",
                                          {"with_scores": True})):
            run = lambda: mapper.map_reads(padded, lens, **kw)
            run()
            times = timed_alternately({"graph": run, "eager": run})
            rate = {side: n / statistics.median(t)
                    for side, t in times.items()}
            rec[what] = rate
            log(f"phase11 {d_n}x{t_n} mesh {label} {what}: graph "
                f"{rate['graph']:.1f} reads/s, eager {rate['eager']:.1f} "
                f"(medians of 3, alternated: "
                f"{ {k: [round(x, 6) for x in v] for k, v in times.items()} }"
                f" s), {rate['graph'] / rate['eager']:.4f}x")
        n_batches = -(-n // (opts.batchsize * d_n))
        for side in ("graph", "eager"):
            with (eager_steps() if side == "eager"
                  else contextlib.nullcontext()):
                rec[side] = profiled(
                    f"phase11 {d_n}x{t_n} mesh {label} {side}",
                    lambda: mapper.map_reads(padded, lens, with_scores=True),
                    f"map_reads(with_scores=True) of {n} reads", n_batches,
                    f"{opts.batchsize * d_n}-read mesh batch")
        rec["capture_s"] = [round(st.capture_seconds, 4)
                            for st in mapper._steps.values()]
        rec["pool_bytes"] = graphs.pool_bytes("cuda")
        log(f"phase11 {d_n}x{t_n} mesh {label}: {len(rec['capture_s'])} steps "
            f"captured (a data shard's batch coarse and with STEP 2, each "
            f"shared by the rows of the one card), warm-up and capture "
            f"{rec['capture_s']} s; the card's graph pool now "
            f"{rec['pool_bytes']} B")
        out[label] = rec
        del mapper
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import hashreadmapper_tpu_torch  # noqa: F401  (fails outside the repo)
    if sys.argv[1:2] == ["--region-worker"]:
        return region_worker(*sys.argv[2:])
    t_start = time.perf_counter()
    smi = phase0()
    records = phase1()
    with tempfile.TemporaryDirectory() as tmp:
        launches, per_batch, res, reads, chrom, starts, junk = phase2(tmp)
        mappers = phase3(res, reads)
        launches_und, per_batch_und, _, _ = phase5(tmp, res, chrom, mappers)
        del mappers
        launches_par, _ = phase6(tmp, res, chrom)
        launches_ws, per_batch_ws, _ = phase7(res, reads, starts, junk)
        launches_reg, per_batch_reg = phase8(tmp, res, reads)
        launches_mesh, per_batch_mesh, _ = phase9(tmp, res, reads, starts,
                                                  junk)
        # phase 11's cases: the single mappers' genomes, options and reads
        mesh_cases = [(label, m.genome, m.opts, padded, lens)
                      for label, m, padded, lens, _, _ in GRAPH_CASES
                      if label in ("flagship 3N", "--undirectional", "parity")]
        graph_rec = phase10(tmp)
        graph_rec["mesh"] = phase11(mesh_cases)
        del mesh_cases
    del res
    chr1 = phase4()
    phase8_chr1(chr1)
    phase7_chr1(chr1)
    del chr1
    from hashreadmapper_tpu_torch.pipeline import graphs
    n_cap, cap_s = graphs.capture_stats("cuda")
    graph_rec["captures_in_all"] = n_cap
    graph_rec["capture_seconds_in_all"] = cap_s
    graph_rec["pool_bytes_end"] = graphs.pool_bytes("cuda")
    log(f"graphs: {n_cap} captured on the card in all, {cap_s:.3f} s of "
        f"warm-up and capture; the card's graph pool at the end "
        f"{graph_rec['pool_bytes_end']} B")
    check_no_jax()
    log(f"chip_smoke: every phase in {time.perf_counter() - t_start:.1f} s")
    src = "hashreadmapper_tpu_torch/csrc/"
    ref = "hashreadmapper_tpu/ops/"
    meta = {"minhash": (src + "minhash.cu", ref + "minhash_pallas.py:171"),
            "vote": (src + "vote.cu", ref + "vote_pallas.py:147"),
            "shd_best": (src + "shd.cu", ref + "shd_pallas.py:217"),
            "sig_min_murmur": (src + "minhash.cu",
                               ref + "minhash_pallas.py:241"),
            "shd_hamming_matrix": (src + "shd.cu", ref + "shd_pallas.py:256"),
            "sw_pass": (src + "swdev.cu", ref + "swdev_pallas.py:237"),
            # the same pallas_call with what swdev.py builds around it: the
            # striped layout and second-best search (swdev.py:334-366), the
            # flip and barrel shifts of the reverse pass (:384-430)
            "sw_forward": (src + "swdev.cu", ref + "swdev_pallas.py:237"),
            "sw_reverse": (src + "swdev.cu", ref + "swdev_pallas.py:237"),
            "shift_sub": (src + "bandtb.cu", ref + "bandtb.py:123"),
            "fill_pass": (src + "bandtb.cu", ref + "bandtb.py:355"),
            # the same pallas_call with the two scans around it
            # (bandtb.py:516-528, :548-581)
            "traceback": (src + "bandtb.cu", ref + "bandtb.py:355"),
            # the same pallas_call with what shd.py builds around it:
            # pack_read_planes (:330), the per-pair gathers and
            # shd_pairs_packed_planes (:364)
            "shd_pairs_best": (src + "shd.cu", ref + "shd_pallas.py:217"),
            # the same pallas_call with what minhash.py builds around it:
            # the 3N collapse, the k < 16 mask and SENTINEL rows (:165-171)
            # and the mirrored halves of signatures_3n_pair
            "minhash_stage": (src + "minhash.cu",
                              ref + "minhash_pallas.py:171"),
            # no pallas_call behind these four: the XLA fusions of the JAX
            # functions they replace
            "probe_lookup": (src + "probe.cu", "hashreadmapper_tpu/index/"
                             "minhash_index.py:372"),
            "probe_gather": (src + "probe.cu", "hashreadmapper_tpu/index/"
                             "minhash_index.py:372"),
            "pair_select": (src + "pairs.cu",
                            "hashreadmapper_tpu/pipeline/engine.py:149"),
            "read_best": (src + "pairs.cu",
                          "hashreadmapper_tpu/pipeline/engine.py:149")}
    from hashreadmapper_tpu_torch.ops.bandtb_kernel import fill_pass
    from hashreadmapper_tpu_torch.ops.swdev_kernel import pass_batched
    # the fill's launch on the main path is the fused traceback (one a
    # traceback, where the single-pass kernel took nine); the striped
    # pass's are the forward and the reverse score pass
    counted_as = {"fill_pass": ("traceback",),
                  "sw_pass": ("sw_forward", "sw_reverse")}
    kernels = []
    for name, (source, replaces) in meta.items():
        rec = records[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces}
        names = counted_as.get(name, (name,))
        if names[0] in launches:
            # counted over the directional flagship CLI run; the other two
            # paths' counts and the per-batch counts beside it
            path = "flagship --threeN CLI run"
            if name == "fill_pass":
                path += (": the fused traceback's launches (hrm_traceback "
                         "runs every pass of the fill and the walk in one "
                         "launch, on the row function it shares with "
                         "hrm_fill_pass); the single-pass kernel's own "
                         f"launches there: {fill_pass.launches - rec['own']}")
            if name == "sw_pass":
                path += (": the launches of hrm_sw_forward and "
                         "hrm_sw_reverse, which run the column pass they "
                         "share with hrm_sw_pass on pairs they lay out "
                         "themselves; hrm_sw_pass's own launches there: "
                         f"{pass_batched.launches - rec['own']}")
            total = lambda d: sum(d[n] for n in names)
            entry.update(
                launches=total(launches), path=path,
                launches_undirectional=total(launches_und),
                launches_parity=total(launches_par),
                launches_per_batch=total(per_batch),
                launches_per_batch_undirectional=total(per_batch_und),
                launches_window_stream=sum(launches_ws.get(n, 0)
                                           for n in names),
                launches_per_window_batch=sum(per_batch_ws.get(n, 0)
                                              for n in names),
                launches_regions=total(launches_reg),
                launches_per_region_batch=total(per_batch_reg),
                launches_mesh=total(launches_mesh),
                launches_per_mesh_batch=total(per_batch_mesh))
        else:
            # no caller on the main path: counted over phase 1's
            # cross-checks against the kernels that superseded it
            path = "kernel phase cross-check (no caller on the main path)"
            if name == "shd_best":
                entry["launches_main_path"] = [
                    d["shd_best_direct"]
                    for d in (launches, launches_und, launches_par)]
                path += ("; the main path's SHD stage is hrm_shd_pairs_best, "
                         "which runs the pair loop (warp_best) it shares "
                         "with hrm_shd_best on planes it builds itself; "
                         "hrm_shd_best's own launches in the three CLI runs "
                         "are launches_main_path")
            if name == "minhash":
                entry["launches_main_path"] = [
                    d["sigs_from_bases_direct"]
                    for d in (launches, launches_und, launches_par)]
                path += ("; the main path's signature stage is "
                         "minhash_stage, the same kernel (minhash_kernel) "
                         "launched with the collapse, mask, SENTINEL rows "
                         "and mirror inside; sigs_from_bases' own launches "
                         "in the three CLI runs are launches_main_path")
            entry.update(launches=rec["launches"], path=path)
        entry.update({k: rec[k] for k in (
            "max_abs_err", "ms", "call_ms", "host_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_call_ms", "library_host_ms",
            "shape", "other_cases")})
        kernels.append(entry)
    print(json.dumps({
        "kernels": kernels,
        "index_build_signatures": INDEX_SIGNATURES,
        "device_launches_per_batch": per_batch["every device launch"],
        "device_launches_per_batch_undirectional":
            per_batch_und["every device launch"],
        "device_launches_per_window_batch":
            per_batch_ws["every device launch"],
        "device_launches_per_mesh_batch":
            per_batch_mesh["every device launch"],
        "graphs": graph_rec}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
