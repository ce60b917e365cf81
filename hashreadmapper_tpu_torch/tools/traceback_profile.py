"""Where the fused traceback kernel's time goes on the flagship's pairs.

    python -m hashreadmapper_tpu_torch.tools.traceback_profile

Needs a CUDA card; run from the repository root (it takes its dataset
from chip_smoke.py).  It runs the flagship 3N CLI once on chip_smoke's
8 Mbp genome and 49,152 reads, keeps the pairs and score rows of one
4,096-read batch as fused_traceback_t receives them, and prints

- how the pairs that need the traceback are spread: subregion rows m,
  final band widths, passes a pair, rows x passes (the row loop's work),
  entries a walk uses, pairs whose directions spill to device memory;
- the kernel's device time (launches back to back between two CUDA
  events, behind a sleep kernel so the host is ahead) over launch
  shapes: blocks a multiprocessor x int16 direction cells of shared
  memory a warp;
- the same over subsets (pairs of one pass, of at most two, none, the one
  pair with the most rows x passes alone) and over pair orders (heaviest
  first or last), which tells a tail of slow pairs from a card that is
  busy throughout;
- shift_sub beside torch.gather on the batch's own begins.
"""

import os
import sys
import tempfile

import numpy as np
import torch

from ..ops import bandtb, bandtb_kernel as bk
from ..pipeline import engine


def device_ms(fn, launches=20):
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(30_000_000)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / launches


def flagship_batch(index=3):
    """(pair_q_t, pair_ref_t, s10) of batch `index` of the flagship run."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from .. import cli
    captured = []
    real = bandtb.fused_traceback_t

    def keep(q, ref, s10, *args, **kw):
        captured.append((q.clone(), ref.clone(), s10.clone()))
        return real(q, ref, s10, *args, **kw)
    engine.bandtb.fused_traceback_t = keep
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cs.write_dataset(tmp, np.random.default_rng(2))
            cli.run(cs.FLAGSHIP + [
                "--genomefile", os.path.join(tmp, "g.fa"), "-i",
                os.path.join(tmp, "reads.fq.gz"), "-o",
                os.path.join(tmp, "out")])
    finally:
        engine.bandtb.fused_traceback_t = real
    return captured[index]


def main():
    if not torch.cuda.is_available():
        print("traceback_profile: no CUDA device", file=sys.stderr)
        return 1
    q, ref, s10 = flagship_batch()
    need = ~((s10[9] != 0) | (s10[8] != 0) | (s10[0] == 0) | (s10[1] < 0))
    qb, qe, rb, re = s10[6], s10[2], s10[5], s10[1]
    m, r = qe - qb + 1, re - rb + 1
    lq, nl = q.shape[0], ref.shape[0]
    read_s = bk.shift_sub(q, qb, lq, True)
    ref_s = bk.shift_sub(ref, rb, nl, True)
    kw = dict(n_entries=bandtb.FUSED_ENTRIES, need=need, run_cap=63,
              entry_dtype=torch.uint8)
    run = lambda a=(read_s, ref_s, m, r, s10[0]), k=kw: bk.traceback(*a, **k)
    ents, _, bw_f, spilled = bk.traceback(read_s, ref_s, m, r, s10[0],
                                          return_spilled=True, **kw)
    bw0 = (r - m).abs() + 1
    passes = torch.where(need, torch.log2(bw_f / bw0).round() + 1, 0).long()
    work = torch.where(need, m.clamp(min=0) * passes, -1)
    pct = lambda t, qs: np.percentile(t.cpu().numpy(), qs).tolist()
    print(f"card {torch.cuda.get_device_name(0)}; batch of {q.shape[1]} "
          f"pairs ({q.dtype} codes), {int(need.sum())} need the traceback, "
          f"{int(spilled)} of them spill at {bk.TB_SMEM_CELLS} cells a warp")
    print("rows m: min, 10%, median, 90%, max", pct(m[need], [0, 10, 50, 90,
                                                              100]))
    print("final band width: median, 90%, 99%, max",
          pct(bw_f[need], [50, 90, 99, 100]))
    print("pairs by passes (index = passes)",
          torch.bincount(passes[need]).tolist())
    print(f"rows x passes: sum {int(work[need].sum())}, max "
          f"{int(work.max())}, 99% {pct(work[need], [99])[0]}")
    print("entries a walk uses: median, 90%, 99%, max",
          pct((ents != 0).sum(1)[need], [50, 90, 99, 100]))

    shape = (bk.TB_BLOCKS_PER_SM, bk.TB_SMEM_CELLS)
    for blocks, cells in ((4, 6656), (4, 4096), (2, 4096), (8, 2048),
                          (12, 1024), (16, 512)):
        bk.TB_BLOCKS_PER_SM, bk.TB_SMEM_CELLS = blocks, cells
        n = bk.traceback(read_s, ref_s, m, r, s10[0], return_spilled=True,
                         **kw)[3]
        print(f"{blocks} blocks a multiprocessor, {cells} cells a warp: "
              f"{device_ms(run):.4f} ms, {int(n)} pairs spill")
    bk.TB_BLOCKS_PER_SM, bk.TB_SMEM_CELLS = shape

    hardest = torch.zeros_like(need)
    hardest[work.argmax()] = True
    for name, mask in (("every needed pair", need),
                       ("pairs of one pass", need & (passes == 1)),
                       ("pairs of at most two", need & (passes <= 2)),
                       ("no pair", need & False),
                       (f"the heaviest pair alone (m {int(m[work.argmax()])},"
                        f" {int(passes[work.argmax()])} passes)", hardest)):
        k = dict(kw, need=mask)
        print(f"{name} ({int(mask.sum())}): {device_ms(lambda: run(k=k)):.4f}"
              " ms")
    for name, key in (("heaviest first", -work), ("heaviest last", work)):
        o = torch.argsort(key, stable=True)
        a = tuple(x[o].contiguous() for x in (read_s, ref_s, m, r, s10[0]))
        k = dict(kw, need=need[o].contiguous())
        print(f"pairs ordered {name}: {device_ms(lambda: run(a, k)):.4f} ms")

    eff = qb.to(torch.int64) & bk.shift_bits_mask(2 * lq)
    src = torch.arange(lq, device=q.device)[:, None] + eff[None, :]
    padded = torch.cat([q, torch.full_like(q, 4), torch.full_like(q, 4)])
    shift_ms = device_ms(lambda: bk.shift_sub(q, qb, lq, True), 50)
    gather_ms = device_ms(lambda: torch.gather(padded, 0, src), 50)
    print(f"shift_sub (pair-major) {shift_ms:.4f} ms, torch.gather "
          f"{gather_ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
