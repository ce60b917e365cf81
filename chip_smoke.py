"""On-card smoke test of the PyTorch/CUDA port (hashreadmapper_tpu_torch).

    python3 chip_smoke.py            # all phases, one CUDA card

Phase 0  card, torch and CUDA versions; builds native/ and the kernels.
Phase 1  each CUDA kernel against its plain PyTorch version at the main
         path's shapes (integers: exact), with CUDA-event times.
Phase 2  the flagship 3N run through the port's CLI on an 8 Mbp genome and
         49,152 bisulfite reads, STEP 2 on the card: SAM/VCF checks,
         planted-read mapping and concordance, the six kernels' launch
         counts; then the same run with STEP 2 on staged pairs and with
         host STEP 2 (byte-identical SAM and VCF), and the STEP-2 pair
         counts.
Phase 3  the same coarse mapper on the card and on the CPU (plain
         versions): identical packed rows and overflow vectors, and
         identical fused STEP-2 score rows and traceback entries.
Phase 4  a chr1-sized (248,956,422 bp) window index resident on the card,
         coarse-mapping 49,152 planted reads.

Any failure raises (non-zero exit).  The last line is the JSON device
record; the line before it is nvidia-smi's name and power limit; the one
before that the per-kernel JSON record.  Exits non-zero without a result
when no CUDA device is available.  Imports nothing of JAX.
"""

import gzip
import json
import os
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
N_READS, READ_LEN = 49_152, 100
CHR1_LEN = 248_956_422          # GRCh38 chr1


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps=7, warmup=2):
    """Median CUDA-event time of fn() in ms over `reps` after warm-up."""
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
    t0 = time.perf_counter()
    make = subprocess.run(["make", "-C", os.path.join(REPO, "native"), "-j8"],
                          capture_output=True, text=True)
    if make.returncode != 0:
        log(make.stdout + make.stderr)
        raise RuntimeError(f"make native failed ({make.returncode})")
    t1 = time.perf_counter()
    from hashreadmapper_tpu import native
    if not native.available():
        raise RuntimeError("native/libhrm_native.so built but does not load")
    from hashreadmapper_tpu_torch import _build
    _build.build(verbose=True)
    _build.load()
    t2 = time.perf_counter()
    log(f"phase0 build: native {t1 - t0:.3f} s, CUDA kernels "
        f"{t2 - t1:.3f} s ({os.path.basename(_build.library_path())})")
    return smi


def phase1():
    """Kernel == plain at production shapes; returns per-kernel records."""
    from hashreadmapper_tpu_torch.ops import minhash_kernel as mk
    from hashreadmapper_tpu_torch.ops import shd_kernel as sk
    from hashreadmapper_tpu_torch.ops import vote_kernel as vk
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    cases = []

    def minhash_case(name, mode, n, maxlen, f, lengths):
        bases = torch.from_numpy(rng.integers(0, 4, size=(n, maxlen),
                                              dtype=np.int8)).to(dev)
        lens = torch.from_numpy(lengths.astype(np.int32)).to(dev)
        hid = torch.arange(f, dtype=torch.int64, device=dev)
        args = (bases, lens, 16, hid, mode)
        return (name, f"N={n} L={maxlen} F={f} mode={mode}",
                lambda: mk.sigs_from_bases(*args),
                lambda: mk.sigs_from_bases_plain(*args))

    read_lens = np.full(4096, 100)
    read_lens[::97] = rng.integers(0, 128, size=len(read_lens[::97]))
    win_lens = np.full(4096, 128)
    win_lens[-5:] = [0, 15, 16, 17, 60]
    cases.append(("minhash",) + minhash_case("minhash", "both", 4096, 128,
                                              16, read_lens))
    cases.append(("minhash",) + minhash_case("minhash", "fwd", 4096, 128,
                                              16, win_lens))

    def vote_case(f, n, c, cap):
        ids = rng.integers(0, 600, size=(f, n, c)).astype(np.int64)
        fill = rng.integers(0, c + 1, size=(f, n, 1))
        ids = np.where(np.arange(c)[None, None, :] < fill, ids, 0xFFFFFFFF)
        cand = torch.from_numpy(np.sort(ids, axis=2)).to(dev)
        return ("vote", f"F={f} N={n} C={c} cap={cap}",
                lambda: vk.vote_candidates_fnc(cand, 4, cap),
                lambda: vk.vote_candidates_fnc_plain(cand, 4, cap))

    cases.append(("vote",) + vote_case(32, 4096, 16, 8))
    cases.append(("vote",) + vote_case(32, 4096, 64, 32))

    p, wr, wa, n_shifts = 16384, 4, 10, 160
    r32 = lambda *s: torch.from_numpy(rng.integers(
        -2**31, 2**31, size=s, dtype=np.int64).astype(np.int32)).to(dev)
    bit0 = rng.integers(0, 32, size=p)
    bounds = np.stack([bit0, bit0 + rng.integers(28, 129, size=p)], axis=1)
    bounds[-300:] = -1
    shd_args = (r32(p, 2, wa), r32(p, 2, wa), r32(p, 2, wr), r32(p, 2, wr),
                r32(p, wr), torch.from_numpy(bounds.astype(np.int32)).to(dev),
                n_shifts, wa, wr)
    cases.append(("shd_best", "shd_best",
                  f"P={p} wr={wr} wa={wa} n_shifts={n_shifts}",
                  lambda: sk.shd_best(*shd_args),
                  lambda: sk.shd_best_plain(*shd_args)))

    cases.extend(step2_cases(rng, dev))
    records = {}
    for key, name, shape, kernel, plain, *rest in cases:
        view = rest[0] if rest else (lambda out: out)
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        err = max_abs_err(view(got), view(want))
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        log(f"phase1 {name} {shape}: max_abs_err {err} (exact required), "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if err != 0:
            raise AssertionError(f"{name} {shape}: kernel != plain "
                                 f"(max_abs_err {err})")
        rec = records.setdefault(key, {"max_abs_err": 0, "ms": ms,
                                       "plain_ms": plain_ms, "shape": shape})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
    return records


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
    read_at, seg = swdev._striped_layout_t(read_t, rl, lq)
    sat = torch.full((p,), swk.SAT, dtype=torch.int32, device=dev)
    fwd = (read_at, rl, seg, ref_t, fl, sat, 0, lq, True)
    score1 = swk.pass_batched_plain(*fwd)[0]
    rev = (read_at, rl, seg, ref_t.flip(0).contiguous(), fl, score1, 1, lq,
           False)
    cases = [("sw_pass", f"sw_pass {name}", f"P={p} S=8 n_cols={lq}",
              lambda a=a: swk.pass_batched(*a),
              lambda a=a: swk.pass_batched_plain(*a))
             for name, a in (("forward, max_column", fwd),
                             ("reverse, terminate=score1", rev))]
    begin = torch.from_numpy(rng.integers(-1, lq + 1, p).astype(
        np.int32)).to(dev)
    cases.append(("shift_sub", "shift_sub", f"L={lq} P={p} size={lq} "
                  "begins in [-1, 128]",
                  lambda: bk.shift_sub(read_t, begin, lq),
                  lambda: bk.shift_sub_plain(read_t, begin, lq)))
    s10 = swdev.ssw_score_packed_t(read_t, rl, ref_t, fl,
                                   (rl // 2).clamp(min=15), lq)
    qb, qe, rb, re = s10[6], s10[2], s10[5], s10[1]
    need = ~((s10[9] != 0) | (s10[8] != 0) | (s10[0] == 0) | (re < 0))
    sub_q = bk.shift_sub(read_t, qb, lq)
    sub_r = bk.shift_sub(ref_t, rb, lq)
    m, r = qe - qb + 1, re - rb + 1
    widen = torch.from_numpy(rng.choice([1, 2, 4], p).astype(np.int32))
    bw = ((r - m).abs() + 1) * widen.to(dev)
    done = (~need | torch.from_numpy(
        rng.random(p) < 0.25).to(dev)).to(torch.int32)
    live = done == 0

    def view(out):
        # the kernel never writes a done pair's directions
        best, dirs = out
        return best if dirs is None else (best, dirs[live])
    for emit in (False, True):
        args = (sub_q, sub_r, m, r, bw, done, lq, emit)
        cases.append(("fill_pass", "fill_pass",
                      f"P={p} m_max=NL={lq} emit_dirs={emit}, "
                      f"{int(live.sum())} pairs not done",
                      lambda a=args: bk.fill_pass(*a),
                      lambda a=args: bk.fill_pass_plain(*a), view))
    return cases


def write_dataset(tmp, rng):
    """8 Mbp genome FASTA + 49,152 planted reads FASTQ.gz."""
    chrom = rng.integers(0, 4, size=8_000_000, dtype=np.int8)
    text = ACGT[chrom].tobytes()
    with open(os.path.join(tmp, "g.fa"), "wb") as fh:
        fh.write(b">chrB synthetic 8 Mbp\n")
        fh.write(b"\n".join(text[i:i + 80] for i in range(0, len(text), 80)))
        fh.write(b"\n")
    reads, starts, junk = planted_reads(rng, chrom, N_READS, READ_LEN)
    seqs = ACGT[reads]
    qual = b"I" * READ_LEN
    with gzip.open(os.path.join(tmp, "reads.fq.gz"), "wb",
                   compresslevel=1) as fh:
        fh.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(), qual)
                          for i in range(N_READS)))
    return reads, starts, junk


def kernel_wrappers():
    """The six kernels' wrappers, by the names of the kernels JSON."""
    from hashreadmapper_tpu_torch.ops.bandtb_kernel import fill_pass, shift_sub
    from hashreadmapper_tpu_torch.ops.minhash_kernel import sigs_from_bases
    from hashreadmapper_tpu_torch.ops.shd_kernel import shd_best
    from hashreadmapper_tpu_torch.ops.swdev_kernel import pass_batched
    from hashreadmapper_tpu_torch.ops.vote_kernel import vote_candidates_fnc
    return {"minhash": sigs_from_bases, "vote": vote_candidates_fnc,
            "shd_best": shd_best, "sw_pass": pass_batched,
            "shift_sub": shift_sub, "fill_pass": fill_pass}


def phase2(tmp):
    from hashreadmapper_tpu_torch import cli
    from hashreadmapper_tpu_torch.pipeline.driver import run_pipeline
    kernels = kernel_wrappers()
    rng = np.random.default_rng(2)
    reads, starts, junk = write_dataset(tmp, rng)
    out = os.path.join(tmp, "out")
    argv = FLAGSHIP + ["--genomefile", os.path.join(tmp, "g.fa"), "-i",
                       os.path.join(tmp, "reads.fq.gz")]
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = cli.run(argv + ["-o", out])
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"phase2 kernel launches in the CLI run: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
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

    with open(out + ".SAM") as fh:
        sam = fh.read()
    if not sam.startswith("@HD\tVN:1.4"):
        raise AssertionError("SAM header does not start with @HD\\tVN:1.4")
    rows = [ln.split("\t") for ln in sam.split("\n")
            if ln and not ln.startswith("@")]
    if len(rows) != N_READS:
        raise AssertionError(f"{len(rows)} SAM rows for {N_READS} reads")
    if not os.path.exists(out + ".VCF"):
        raise AssertionError("no VCF written")
    ids = np.array([int(r[0]) for r in rows])
    mapped = np.zeros(N_READS, bool)
    concordant = np.zeros(N_READS, bool)
    mapped[ids] = [r[11].startswith("Yf:i:") and "YZ:A:" in r[11]
                   for r in rows]
    concordant[ids] = [r[2].split()[0] == "chrB"
                       and abs(int(r[3]) - int(starts[i])) <= 128
                       for r, i in zip(rows, ids)]
    frac = check_fractions("phase2", mapped, concordant, junk)

    mapper = res["mapper"]
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
        f"{[round(s, 6) for s in step2_s]} s); overflow {r.stats}")
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
    return launches, res, reads, frac


def phase3(res, reads, devices=("cuda", "cpu")):
    from hashreadmapper_tpu_torch import cli
    from hashreadmapper_tpu_torch.pipeline.engine import (CoarseMapper,
                                                          fused_step2_scores)
    n, n_step2 = 8192, 1024
    lens = np.full(n, READ_LEN, np.int32)
    outs, step2 = {}, {}
    for dev in devices:
        opts, _ = cli.options_from_args(FLAGSHIP + ["--device", dev])
        t0 = time.perf_counter()
        m = CoarseMapper(res["genome"], opts, dev)
        b, l, v, n_pad = m.stage_reads_device(reads[:n], lens)
        bsz = opts.batchsize
        parts = [m._map_batch(b[s:s + bsz], l[s:s + bsz], v[s:s + bsz])
                 for s in range(0, n_pad, bsz)]
        outs[dev] = [(p.cpu(), o.cpu()) for p, o in parts]
        t1 = time.perf_counter()
        k = slice(0, n_step2)
        step2[dev] = [x.cpu() for x in fused_step2_scores(
            opts, m.table.chrom_offset, m.table.chrom_len, m.genome_s2(),
            b[k], l[k], parts[0][0][k])]
        log(f"phase3 {dev}: index + {n} reads in {t1 - t0:.3f} s, fused "
            f"STEP 2 of {n_step2} reads in {time.perf_counter() - t1:.3f} s")
    card, host = (outs[d] for d in devices)
    for i, ((pc, oc), (pp, op)) in enumerate(zip(card, host)):
        if not torch.equal(pc, pp) or not torch.equal(oc, op):
            bad = int((pc != pp).any(dim=1).sum())
            raise AssertionError(f"phase3 batch {i}: card != CPU ({bad} rows "
                                 f"differ; overflow {oc.tolist()} vs "
                                 f"{op.tolist()})")
    log(f"phase3 card == CPU: {len(card)} batches of [B, 7] rows "
        f"and [5] overflow vectors identical; overflow "
        f"{[o.tolist() for _, o in card]}")
    names = ("scores [10, 2B]", "tb_ops [2B, 48]", "tb_status [2B]")
    for name, c, h in zip(names, *(step2[d] for d in devices)):
        if c.dtype != h.dtype or not torch.equal(c, h):
            raise AssertionError(f"phase3 fused STEP 2 {name}: card != CPU")
    sc, _, st = step2[devices[0]]
    log(f"phase3 card == CPU: fused STEP 2 of the first {n_step2} reads, "
        f"{names} identical ({int((sc[9] == 0).sum())} pairs not "
        f"diag-certified, walk status counts "
        f"{torch.bincount(st.to(torch.int64), minlength=3).tolist()})")


def phase4(device="cuda"):
    from hashreadmapper_tpu.io.genome import Genome
    from hashreadmapper_tpu_torch import cli
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

    def fractions(res):
        mapped = res.orientation != 3
        concordant = (res.chromosome_id == 0) & (np.abs(
            res.position.astype(np.int64) - starts) <= 128)
        return mapped, concordant
    # the flagship (8 Mbp) caps at this scale, for comparison only
    for flag, attr in (("--probeCap", "probe_cap"),
                       ("--candidatesPerRead", "candidates_per_read_cap"),
                       ("--shdPairBudget", "shd_pairs_per_read_budget"),
                       ("--probeTailBudget", "probe_tail_budget_per_read"),
                       ("--probeHeadBudget", "probe_head_budget_per_read")):
        setattr(mapper.opts, attr, int(FLAGSHIP[FLAGSHIP.index(flag) + 1]))
    r_flag = mapper.map_reads(padded, lens)
    m_flag, _ = fractions(r_flag)
    log(f"phase4 with the flagship caps instead: planted mapped "
        f"{float(m_flag[~junk].mean()):.6f}, overflow {r_flag.stats}")
    frac = check_fractions("phase4", *fractions(r), junk)
    return frac


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import hashreadmapper_tpu_torch  # noqa: F401  (fails outside the repo)
    smi = phase0()
    records = phase1()
    with tempfile.TemporaryDirectory() as tmp:
        launches, res, reads, _ = phase2(tmp)
        phase3(res, reads)
    phase4()
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    meta = {"minhash": ("cuda", "hashreadmapper_tpu_torch/csrc/minhash.cu",
                        "hashreadmapper_tpu/ops/minhash_pallas.py:171"),
            "vote": ("cuda", "hashreadmapper_tpu_torch/csrc/vote.cu",
                     "hashreadmapper_tpu/ops/vote_pallas.py:147"),
            "shd_best": ("cuda", "hashreadmapper_tpu_torch/csrc/shd.cu",
                         "hashreadmapper_tpu/ops/shd_pallas.py:217"),
            "sw_pass": ("cuda", "hashreadmapper_tpu_torch/csrc/swdev.cu",
                        "hashreadmapper_tpu/ops/swdev_pallas.py:237"),
            "shift_sub": ("cuda", "hashreadmapper_tpu_torch/csrc/bandtb.cu",
                          "hashreadmapper_tpu/ops/bandtb.py:123"),
            "fill_pass": ("cuda", "hashreadmapper_tpu_torch/csrc/bandtb.cu",
                          "hashreadmapper_tpu/ops/bandtb.py:355")}
    kernels = [{"name": name, "route": route, "source": src,
                "replaces": rep, "launches": launches[name],
                **{k: records[name][k]
                   for k in ("max_abs_err", "ms", "plain_ms")}}
               for name, (route, src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
