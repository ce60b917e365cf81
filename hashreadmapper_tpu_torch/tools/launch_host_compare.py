"""The host's time to enqueue a kernel launch in this checkout beside
another checkout's (the parent commit's, say), on one card, in one
process: what the launch path around the ctypes call costs, the device
guard of _build.launch included.

    python -m hashreadmapper_tpu_torch.tools.launch_host_compare OTHER_DIR

It times the enqueue as chip_smoke.py's host_ms does (200 calls in a row
without waiting for the card), median of 5.  OTHER_DIR is the root of
another checkout; its hashreadmapper_tpu_torch is loaded under the name
hrm_other with its own _build, and both kernel libraries are built first.
For four kernels at phase 1's main-path shapes (the vote, shift_sub, the
fused SHD stage and the forward score pass) it checks that the two give
the same outputs and prints the host ms a launch in the order other,
this, this, other, with the mean of each side's two; then the guard's
own parts: a device query, and a switch to the current device and back.
"""

import importlib
import importlib.util
import os
import statistics
import sys
import time

import numpy as np
import torch


def load_other(root):
    """OTHER_DIR/hashreadmapper_tpu_torch as the package hrm_other."""
    pkg = os.path.join(os.path.abspath(root), "hashreadmapper_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "hrm_other", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["hrm_other"] = mod
    spec.loader.exec_module(mod)
    return mod


def cases(dev):
    """(name, module path, function name, args) at phase 1's shapes
    (random codes: the host's enqueue does not depend on them)."""
    rng = np.random.default_rng(3)
    t = lambda a: torch.from_numpy(a).to(dev)
    cand = np.sort(rng.integers(0, 2**20, (32, 4096, 16)), axis=2)
    x = t(rng.integers(0, 4, (128, 8192)).astype(np.int8))
    sh = t(rng.integers(0, 128, 8192).astype(np.int32))
    reads = t(rng.integers(0, 4, (128, 8192)).astype(np.int8))
    refs = t(rng.integers(0, 4, (128, 8192)).astype(np.int8))
    lens = t(np.full(8192, 100, np.int32))
    g = t(rng.integers(0, 2**31, 8 * 2**20 // 32).astype(np.int32))
    p = 16384
    ridx = t(np.arange(p) % 4096)
    return [
        ("vote F 32, N 4096, C 16, cap 8", "ops.vote_kernel",
         "vote_candidates_fnc", (t(cand), 4, 8)),
        ("shift_sub L 128, P 8192", "ops.bandtb_kernel", "shift_sub",
         (x, sh, 128, True)),
        ("shd_pairs_best 16,384 pairs", "ops.shd_kernel", "shd_pairs_best",
         (t(rng.integers(0, 4, (4096, 128)).astype(np.int8)),
          t(np.full(4096, 100, np.int32)), ridx, g, g,
          t(rng.integers(0, 2**22, p)), t(np.full(p, 228)),
          t(np.full(p, 50)), t(np.ones(p, bool)), 160, 0.05, 1)),
        ("sw_forward P 8192, LQ 128", "ops.swdev_kernel", "sw_forward",
         (reads, lens, refs, lens, lens // 2, 128)),
    ]


def written(out):
    """The outputs a launch writes, as a tuple (sw_forward leaves rows 5-7
    and 9 of its [10, P] output as they were)."""
    if not isinstance(out, tuple):
        return (out[[0, 1, 2, 3, 4, 8]] if out.shape[0] == 10 else out,)
    return out


def host_ms(fn, calls=200, reps=5):
    """Median over reps of the host's ms to enqueue one fn()."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def main(argv):
    if not torch.cuda.is_available():
        print("launch_host_compare: no CUDA device", file=sys.stderr)
        return 1
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    from hashreadmapper_tpu_torch import _build
    load_other(argv[0])
    importlib.import_module("hrm_other._build").build()
    _build.build()
    dev = torch.device("cuda")
    print(f"card {torch.cuda.get_device_name(0)}; other checkout "
          f"{os.path.abspath(argv[0])}", flush=True)
    for label, path, name, args in cases(dev):
        fns = {side: getattr(importlib.import_module(f"{pkg}.{path}"), name)
               for side, pkg in (("other", "hrm_other"),
                                 ("this", "hashreadmapper_tpu_torch"))}
        outs = {side: written(fn(*args)) for side, fn in fns.items()}
        for a, b in zip(*outs.values()):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: the checkouts differ")
        got = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            got[side].append(host_ms(lambda: fns[side](*args)))
        mean = {k: sum(v) / 2 for k, v in got.items()}
        delta_us = (mean["this"] - mean["other"]) * 1e3
        print(f"{label}: host ms a launch, other {got['other'][0]:.5f} / "
              f"{got['other'][1]:.5f}, this {got['this'][0]:.5f} / "
              f"{got['this'][1]:.5f}; means {mean['other']:.5f} -> "
              f"{mean['this']:.5f} ({delta_us:+.3f} us)", flush=True)
    idx = torch.cuda.current_device()
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        _ = idx == torch.cuda.current_device()
    t1 = time.perf_counter()
    for _ in range(n):
        with torch.cuda.device(idx):
            pass
    t2 = time.perf_counter()
    print(f"the guard's parts: a device query {(t1 - t0) / n * 1e6:.4f} us, "
          f"a switch and back {(t2 - t1) / n * 1e6:.4f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
