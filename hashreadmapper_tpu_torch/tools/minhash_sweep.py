"""The minhash kernels' launch shape on the card: the device time of
csrc/minhash.cu built with each launch shape (kG hash ids a thread, kSplit
threads sharing them, kThreads threads a block), for each mode of
hrm_minhash_stage (the signature stage) and for hrm_sig_min_murmur, at the
main path's shapes (4,096 rows of 128 bases, 100-base reads or 128-base
windows, F 16, k 16), each output held against the plain version first;
then the stage's time against rows at the shape the source fixes.

    python -m hashreadmapper_tpu_torch.tools.minhash_sweep

Run from the repository root (it times with chip_smoke.py's device_ms).
Compiles one copy of csrc/minhash.cu a shape, with the package's nvcc
flags, into a temporary directory; needs nvcc and one card.
"""

import ctypes
import os
import re
import sys
import tempfile

import numpy as np
import torch

from .. import _build
from ..ops import minhash_kernel as mk

SHAPES = [(g, split, t) for g in (1, 2, 4) for split in (1, 2, 4)
          for t in (64, 128)]
CONSTANTS = ("kG", "kSplit", "kThreads")


def shaped_source(src: str, shape) -> str:
    """src with its launch-shape constants set to `shape`."""
    for name, value in zip(CONSTANTS, shape):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"csrc/minhash.cu: {name} not found once")
    return src


def build_shapes(tmp):
    """{shape: the library of csrc/minhash.cu built with it}."""
    with open(os.path.join(_build.CSRC_DIR, "minhash.cu")) as fh:
        src = fh.read()
    libs, cmds = {}, []
    for shape in SHAPES:
        stem = os.path.join(tmp, "minhash_{}_{}_{}".format(*shape))
        with open(stem + ".cu", "w") as fh:
            fh.write(shaped_source(src, shape))
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                     _build.CSRC_DIR, "-shared", "-o", stem + ".so",
                     stem + ".cu"])
        libs[shape] = stem + ".so"
    _build._run(cmds, verbose=False)
    for shape, path in libs.items():
        lib = ctypes.CDLL(path)
        for name in ("hrm_minhash_stage", "hrm_sig_min_murmur"):
            getattr(lib, name).argtypes = _build._SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        libs[shape] = lib
    return libs


def checked(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def main():
    if not torch.cuda.is_available():
        print("minhash_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from chip_smoke import device_ms
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    n, maxlen, k, f = 4096, 128, 16, 16
    bases = torch.from_numpy(rng.integers(0, 4, size=(n, maxlen),
                                          dtype=np.int8)).to(dev)
    read_lens = np.full(n, 100, np.int32)
    read_lens[::97] = rng.integers(0, 128, size=len(read_lens[::97]))
    lens = {"reads": torch.from_numpy(read_lens).to(dev),
            "windows": torch.full((n,), maxlen, dtype=torch.int32,
                                  device=dev)}
    hid = torch.arange(f, dtype=torch.int64, device=dev)
    stream = _build.stream(bases)
    print(f"card: {torch.cuda.get_device_name(0)}; N {n}, L {maxlen}, "
          f"k {k}, F {f}; device ms a launch (median of 5 x 20) by "
          f"(kG, kSplit, kThreads)")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_shapes(tmp)
        for mode, collapse, mirror, which in (
                ("both", "ct", False, "reads"), ("both", "ga", True, "reads"),
                ("canon", None, False, "reads"),
                ("fwd", None, False, "windows"),
                ("pair", None, False, "windows")):
            ln = lens[which]
            want = mk.signature_stage_plain(bases, ln, k, hid, mode,
                                            collapse, mirror)
            sig, valid = torch.empty_like(want[0]), torch.empty_like(want[1])
            row = []
            for shape, lib in libs.items():
                def call(lib=lib):
                    checked(lib.hrm_minhash_stage(
                        bases.data_ptr(), ln.data_ptr(), hid.data_ptr(),
                        sig.data_ptr(), valid.data_ptr(), n, maxlen, k, f,
                        mk.STAGE_MODES[mode], mk.COLLAPSES[collapse], 1,
                        int(mirror), stream), "hrm_minhash_stage")
                call()
                torch.cuda.synchronize()
                if not (torch.equal(sig, want[0])
                        and torch.equal(valid, want[1])):
                    raise AssertionError(f"{mode} {shape}: kernel != plain")
                row.append(f"{shape} {device_ms(call, reps=5):.4f}")
            print(f"stage {mode} collapse={collapse} mirror={mirror} "
                  f"({which}): " + ", ".join(row))
        npos = maxlen - k + 1
        kmers = torch.from_numpy(rng.integers(0, 2**32, size=(n, npos),
                                              dtype=np.int64)).to(dev)
        ln = lens["reads"]
        for dtype in (torch.int64, torch.int32):
            km = kmers if dtype == torch.int64 else kmers.to(torch.int32)
            want = mk.sig_min_murmur_plain(km, ln, k, hid)
            out = torch.empty_like(want)
            row = []
            for shape, lib in libs.items():
                def call(lib=lib):
                    checked(lib.hrm_sig_min_murmur(
                        km.data_ptr(), km.element_size(), ln.data_ptr(),
                        hid.data_ptr(), out.data_ptr(), n, npos, k, f,
                        stream), "hrm_sig_min_murmur")
                call()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"sig_min_murmur {dtype} {shape}: "
                                         "kernel != plain")
                row.append(f"{shape} {device_ms(call, reps=5):.4f}")
            print(f"sig_min_murmur {dtype}: " + ", ".join(row))
    # time against rows at the source's shape: the launch's fixed cost and
    # the cost a hash (reads of 100 bases, 'both', C->T)
    row = []
    for rows in (1, 132, 1024, 2048, 4096, 8192, 16384):
        b = bases.repeat(4, 1)[:rows].contiguous()
        ln = lens["reads"].repeat(4)[:rows].contiguous()
        out = (torch.empty((rows, 2 * f), dtype=torch.int64, device=dev),
               torch.empty((rows,), dtype=torch.bool, device=dev))

        def call(b=b, ln=ln, out=out):
            mk.signature_stage(b, ln, k, hid, "both", "ct", out=out)
        row.append(f"N {rows} {device_ms(call, reps=5):.4f}")
    print("stage both collapse=ct (reads), by rows: " + ", ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
