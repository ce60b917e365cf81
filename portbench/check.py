"""The comparison that decides `correct`: what the timed path produced,
against the plain reference under portbench/reference/, at the timed
sizes.

Every cell: the coarse rows of every read of the checked pass (the
window's first; for a coarse entry also its last) and the pass's five
overflow counters, against the reference mapper over the same reads in
the same batches.  A sam entry also: the SAM row and @SQ line of the
pass's first `vcf_reads` reads and of `sam_sample` more drawn from the
seed, against the reference's STEP 2 from the reference's coarse rows; of
every row of the pass the fields that follow from its coarse row alone;
and the VCF lines that STEP 3 writes while it walks the reference's rows
of the first `vcf_reads` reads, against the program's VCF lines written
while it walked those reads (a line names the row whose walk wrote it).
Each number is a count of differences with the limit 0.
"""

from __future__ import annotations

import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .entries import pack, stats_vector
from .reference import coarse, step2

# the configuration's flags that the coarse stage reads, and their fields
_FLAGS = {"-k": "kmer_length", "-m": "num_hash_functions",
          "--windowSize": "window_size", "--minTableHits": "min_table_hits",
          "--batchsize": "batchsize",
          "--maxHammingPercent": "max_hamming_percent",
          "--probeCap": "probe_cap",
          "--candidatesPerRead": "candidates_per_read_cap",
          "--shdPairBudget": "shd_pairs_per_read_budget",
          "--maxReadLength": "max_read_length"}


def reference_options(flags: Sequence[str], **override
                      ) -> coarse.MapperOptions:
    """MapperOptions from a configuration's command-line flags, read here
    and not through the program's parser."""
    kw = {}
    for i, f in enumerate(flags):
        if f in _FLAGS:
            field = _FLAGS[f]
            kw[field] = (float(flags[i + 1]) if field == "max_hamming_percent"
                         else int(flags[i + 1]))
    if "--threeN" not in flags:
        raise ValueError("the reference maps in the 3N modes only")
    kw["undirectional"] = "--undirectional" in flags
    kw.update(override)
    return coarse.MapperOptions(**kw)


def rows_differ(a: np.ndarray, b: np.ndarray) -> int:
    """Rows of two [N, 7] packings that differ (all of them when the
    shapes do)."""
    b = b.astype(np.int64)
    b[:, 5] &= 0xFFFFFFFF
    if a.shape != b.shape:
        return max(len(a), len(b))
    return int((a != b).any(axis=1).sum())


def _sam_parse(text: str) -> Tuple[Dict[int, str], Dict[int, str]]:
    """({read id: @SQ line}, {read id: row}) of a SAM text."""
    sq, rows = {}, {}
    for line in text.split("\n"):
        if line.startswith("@SQ\t"):
            sq[int(line[7:line.index("\t", 4)])] = line
        elif line and not line.startswith("@"):
            rows[int(line[:line.index("\t")])] = line
    return sq, rows


def _vcf_body(text: str) -> List[str]:
    return [ln for ln in text.split("\n") if ln and not ln.startswith("#")]


def _fields_differ(ctx, rows: Dict[int, str], sq: Dict[int, str],
                   packed_ref: np.ndarray, r0: int, ws: int) -> int:
    """Rows of the whole pass whose fields that follow from the coarse row
    alone (QNAME, RNAME, the window, SEQ, QUAL, the @SQ length) differ
    from the reference's."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    bad = 0
    for i, (ori, _, _, chrom, pos, _, _) in enumerate(packed_ref.tolist()):
        row = rows.get(i)
        if row is None:
            continue
        codes = ctx.chroms[chrom]
        wlen = ws if pos + ws < len(codes) else len(codes) - pos
        read = ctx.bases[r0 + i, :int(ctx.lengths[r0 + i])]
        if ori == coarse.REVERSE_COMPLEMENT:
            read = 3 - read[::-1]
        f = row.split("\t")
        want = (str(i), ctx.names[chrom],
                acgt[codes[pos:pos + wlen].view(np.uint8)].tobytes().decode(),
                acgt[read.view(np.uint8)].tobytes().decode(), "*")
        if (f[0], f[2], f[6], f[9], f[10]) != want or sq.get(i) != \
                f"@SQ\tSN:{i}\tLN:{wlen}":
            bad += 1
    return bad


def sam_numbers(ctx, packed_ref: np.ndarray, r0: int, r1: int, ws: int,
                workers: int) -> List[Tuple[str, int, int]]:
    """sam_fields_differ (every row), sam_rows_differ (the compared rows
    and @SQ lines whole, and rows missing or extra) and
    vcf_lines_differ."""
    mix = ctx.mix["check"]
    sq, rows = _sam_parse(ctx.entry.kept["sam"])
    n = r1 - r0
    missing = abs(len(rows) - n) + abs(len(sq) - n)
    fields_bad = _fields_differ(ctx, rows, sq, packed_ref, r0, ws)
    m = min(n, int(mix["vcf_reads"]))
    rng = np.random.default_rng(int(ctx.seed) % (1 << 63))
    compared = np.union1d(np.arange(m), rng.choice(
        n, size=min(n, int(mix["sam_sample"])), replace=False))
    items = []
    for i in compared:
        ori, _, _, chrom, pos, _, bs = (int(x) for x in packed_ref[i])
        codes = ctx.chroms[chrom]
        window, window_rc, wlen = step2.window_views(codes, pos, ws)
        read = "".join(step2.ACGT[b] for b in
                       ctx.bases[r0 + i, :int(ctx.lengths[r0 + i])])
        items.append((int(i), read, ori, pos, ctx.names[chrom], window,
                      window_rc, wlen, bs))
    shares = [items[k::workers] for k in range(workers)]
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as ex:
        done = list(ex.map(step2.sam_lines_batch, shares))
    want = {it[0]: got for share, res in zip(shares, done)
            for it, got in zip(share, res)}
    bad = sum(sq.get(i) != want[i][0] or rows.get(i) != want[i][1]
              for i in want)
    # STEP 3 over the reference's own rows of the first m reads
    ref_lines = step2.vcf_lines([want[i][1] for i in range(m)],
                                [int(packed_ref[i, 4]) for i in range(m)])
    # a line carries the id of the row whose walk wrote it
    body = _vcf_body(ctx.entry.kept["vcf"])
    got = [ln for ln in body if int(ln.split("\t")[2]) < m]
    vcf_bad = sum(a != b for a, b in zip(ref_lines, got)) + abs(
        len(ref_lines) - len(got))
    print(f"check: {len(want)} SAM rows whole, {len(ref_lines)} VCF lines "
          f"from the first {m} reads, {len(got)} in the program's "
          f"({len(body)} in the pass's VCF)", file=ctx.log)
    return [("sam_fields_differ", int(fields_bad + missing), 0),
            ("sam_rows_differ", int(bad + missing), 0),
            ("vcf_lines_differ", int(vcf_bad), 0)]


def run(ctx) -> List[Tuple[str, int, int]]:
    """(name, value, limit) of every number compared."""
    ropts = reference_options(ctx.config["options"])
    t = time.perf_counter()
    ref = coarse.ReferenceMapper(ctx.chroms, ropts, ctx.device)
    t_index = time.perf_counter() - t
    r0, r1 = ctx.entry.checked_rows()
    packed_ref, over_ref = ref.map_reads(ctx.bases[r0:r1],
                                         ctx.lengths[r0:r1])
    del ref
    print(f"check: reference index {t_index:.3f} s, {r1 - r0} reads "
          f"{time.perf_counter() - t - t_index:.3f} s", file=ctx.log)
    first = ctx.entry.kept["first"]
    prog = pack(first)
    out = [("rows_differ", rows_differ(prog, packed_ref), 0),
           ("counters_differ", int(np.abs(stats_vector(first.stats)
                                          - over_ref).sum()), 0)]
    if "last" in ctx.entry.kept:
        out.append(("last_pass_rows_differ",
                    rows_differ(pack(ctx.entry.kept["last"]), packed_ref), 0))
    planted = ~ctx.truth["junk"][r0:r1]
    mapped = packed_ref[:, 0] != coarse.NONE
    print(f"check: reference maps {float(mapped[planted].mean()):.6f} of the "
          f"planted reads, overflow {over_ref.tolist()}", file=ctx.log)
    if ctx.mix["entry"] == "sam":
        out += sam_numbers(ctx, packed_ref, r0, r1, ropts.window_size,
                           max(1, min(8, os.cpu_count() or 1)))
    return out
