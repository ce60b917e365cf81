"""Build and bind the hand-written CUDA kernels of csrc/, and build the
native host library from the repository's native/*.cpp.

Each csrc/*.cu file is compiled by its own nvcc for sm_90a, all at once,
and the objects are linked into ONE shared library with a plain C
interface, loaded with ctypes (no PyTorch headers: seconds to build, not
minutes).  The library lands in build/ under a name that carries the hash
of the sources and flags, so an edited kernel is rebuilt on its first use
and an unchanged one is reused.  Nothing is built or loaded at import:
the first CUDA launch calls load().

The native host library (SSW finish, rescore, emitters, cuckoo table build,
FASTA/FASTQ reader) is compiled by build_native() the same way with g++:
one compiler per source, objects and library under per-process temporary
names, the library moved into place with os.replace, so concurrent
builds each produce a whole file and no process loads a partial one.
native.py binds it.

Every entry point takes device pointers and the CUDA stream as c_void_p,
sizes as c_int or c_longlong (a float32 parameter as c_float), launches on that stream
without synchronising, and returns cudaGetLastError(); launch() runs it
on the card of the tensors it is given and raises when that is not
cudaSuccess.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import weakref

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NATIVE_DIR = os.path.abspath(os.path.join(PKG_DIR, os.pardir, "native"))
# native/Makefile's flags (less -Wall)
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17")
CXX_LIBS = ("-lz",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# entry point -> argtypes (pointers and the stream as c_void_p, ints c_int)
_SIGNATURES = {
    # bases, lengths, hash_ids, out, valid, n, maxlen, k, f, mode,
    # collapse, finish, mirror, stream
    "hrm_minhash_stage": [_P] * 5 + [_I] * 8 + [_P],
    # cand, ids, counts, num_kept, scratch, tally, f, n, c, min_hits,
    # out_cap, stream
    "hrm_vote": [_P] * 6 + [_I] * 5 + [_P],
    # a_hi, a_lo, r_hi, r_lo, mask, bounds, out, p, wa, wr, n_shifts, stream
    "hrm_shd_best": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # read_at, read_bytes, eff_len, seg_len, ref_t, ref_bytes, ref_len,
    # terminate, out, max_column, s, p, n_cols, ref_dir, want_mc, stream
    "hrm_sw_pass": [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                    _I, _P],
    # read_t, read_bytes, read_len, ref_t, ref_bytes, ref_len, mask_len, out,
    # lq, p, n_cols, stream
    "hrm_sw_forward": [_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P],
    # read_t, read_bytes, ref_t, ref_bytes, score1, ref_end, query_end, out,
    # lq, p, n_cols, lq_mask, nc_mask, dg_mask, stream
    "hrm_sw_reverse": [_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _P],
    # x, sh, out, l, p, size, mask, elem_bytes, pair_major, stream
    "hrm_shift_sub": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # read_t, read_stride, ref_t, ref_stride, elem_bytes, m, r, bw, done,
    # best, dirs, p, m_max, nl, emit, stream
    "hrm_fill_pass": [_P, _I, _P, _I, _I] + [_P] * 6 + [_I] * 4 + [_P],
    # read_s, ref_s, m, r, score1, need, entries, status, bw, scratch,
    # counters, p, m_max, nl, n_entries, run_cap, entry_bytes, n_passes,
    # smem_cells, blocks, stream
    "hrm_traceback": [_P] * 11 + [_I] * 9 + [_P],
    # kmer, elem_bytes, lengths, hash_ids, out, n, npos, k, f, stream
    "hrm_sig_min_murmur": [_P, _I, _P, _P, _P] + [_I] * 4 + [_P],
    # a_hi, a_lo, r_hi, r_lo, mask, out, p, wa, wr, n_shifts, stream
    "hrm_shd_hamming_matrix": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # bases, read_len, ridx, g_hi, g_lo, gstart, alen, aleft, valid, ham,
    # shift, ori, p, l, g_words, n_shifts, max_pct, mode, stream
    "hrm_shd_pairs_best": [_P] * 12 + [_I] * 4 + [_F, _I, _P],
    # sigs, sig_stride, sig_valid, keys, offsets, num_keys, u, bucket_start,
    # bucket_bits, steps, ck, cp, cuckoo_bits, seed1, seed2, dkeys, dnum,
    # d_cols, counts, off0, tallies, f, n, mode, max_values_per_key,
    # probe_cap, c1, nblk, stream
    "hrm_probe_lookup": [_P, _L, _P, _P, _P, _P, _L, _P, _I, _I, _P, _P, _I,
                         _L, _L, _P, _P, _L, _P, _P, _P, _I, _I, _I, _L, _I,
                         _I, _I, _P],
    # counts, off0, tallies, values, v_cols, cand, stats, f, n, probe_cap,
    # c1, tail_budget, head_budget, nblk, stream
    "hrm_probe_gather": [_P, _P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _L, _L,
                         _I, _P],
    # ids, read_len, win_pos, win_chrom, chrom_offset, chrom_len, pair_sel,
    # ridx, gstart, length, left, valid, drops, b, k, n_win, n_chrom,
    # window_size, budget, stream
    "hrm_pair_select": [_P] * 13 + [_L] * 6 + [_P],
    # ham, shift, ori, ham_u, shift_u, ori_u, pair_sel, sel_valid, ids,
    # win_pos, win_chrom, stats, num_kept, pair_drops, packed, ori_out,
    # overflow, p, b, k, n_win, n_stats, stream
    "hrm_read_best": [_P] * 17 + [_L] * 5 + [_P],
    # bases, read_len, packed, offset, chrom_len, letters, translate,
    # complement, pair_q_t, pair_ref_t, q, rcq, win, win_rc, wlen, q3, win3,
    # b, lq, ws, n_chrom, g, undirectional, stream
    "hrm_step2_rows": [_P] * 17 + [_L] * 5 + [_I, _P],
}

_lock = threading.Lock()
_native_lock = threading.Lock()
_lib = None


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libhrm_kernels_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built")


def _run(cmds, verbose: bool, what: str = "nvcc") -> None:
    """Run the commands concurrently; raise with the output of a failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n(code {proc.returncode})\n{out}")
        elif verbose and out:
            print(out)
    if failed:
        raise RuntimeError(f"{what} failed:\n" + "\n".join(failed))


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu (one nvcc per file, in parallel) and link them,
    unless the library for these sources exists."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    nvcc = _nvcc()
    srcs = [s for s in sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    ptxas = ("-Xptxas", "-v") if verbose else ()
    try:
        _run([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", o, s]
              for s, o in zip(srcs, objs)], verbose)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]], verbose)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, out)
    return out


def native_sources():
    return sorted(glob.glob(os.path.join(NATIVE_DIR, "*.cpp"))
                  + glob.glob(os.path.join(NATIVE_DIR, "*.h"))
                  + glob.glob(os.path.join(NATIVE_DIR, "*.hpp")))


def _cpu_tag() -> str:
    """What -march=native resolves to here: the CPU's feature flags, so a
    build directory carried to another machine is not reused there."""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return platform.machine() + platform.processor()


def native_library_path(build_dir: str = BUILD_DIR) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + CXX_LIBS).encode())
    h.update(_cpu_tag().encode())
    for path in native_sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(build_dir, f"libhrm_native_{h.hexdigest()[:16]}.so")


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("no C++ compiler found (CXX, g++, c++, clang++): "
                       "the native host library cannot be built")


def build_native(build_dir: str = BUILD_DIR, verbose: bool = False) -> str:
    """Compile native/*.cpp (one compiler per file, in parallel) and link
    them into build_dir, unless the library for these sources exists.
    Safe under concurrent builds: see the module docstring."""
    out = native_library_path(build_dir)
    with _native_lock:
        if os.path.exists(out):
            return out
        srcs = [s for s in native_sources() if s.endswith(".cpp")]
        if not srcs:
            raise RuntimeError(f"no C++ sources under {NATIVE_DIR}")
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        cxx = _cxx()
        objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
        try:
            _run([[cxx, *CXX_FLAGS, "-c", "-o", o, s]
                  for s, o in zip(srcs, objs)], verbose, cxx)
            _run([[cxx, "-shared", "-o", tmp, *objs, *CXX_LIBS]], verbose,
                 cxx)
            os.replace(tmp, out)
        finally:
            for path in (*objs, tmp):
                if os.path.exists(path):
                    os.remove(path)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.hrm_cuda_error_string.argtypes = [_I]
            lib.hrm_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, on: torch.Tensor, *args) -> None:
    """Call one C entry point on the card that holds `on`, with that card's
    current stream appended as the last argument; raise on a non-zero
    cudaError_t.  The entry points launch on the CUDA runtime's current
    device (and set their kernels' shared-memory attributes there), so a
    tensor on another card makes its card the current one for the call;
    where it already is, the switch is skipped (it costs the host a
    device query a launch)."""
    lib = load()
    fn = getattr(lib, name)
    idx = on.device.index
    if idx == torch.cuda.current_device():
        rc = fn(*args, stream(on))
    else:
        with torch.cuda.device(idx):
            rc = fn(*args, stream(on))
    if rc != 0:
        msg = lib.hrm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as a c_void_p value (the raw
    handle: building a torch.cuda.Stream object for it costs the host
    about as much as a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


# CUDA tensors whose range check_range has passed, by id: (weak
# reference, version)
_checked = {}


def check_range(name: str, what: str, t: torch.Tensor, lo: int,
                hi: int) -> None:
    """Raise unless every value of t lies in [lo, hi] (where a kernel
    narrows what its plain version keeps whole).  A CUDA tensor is read
    back once per version of it, not at every call."""
    if t.numel() == 0:
        return
    cuda = t.device.type == "cuda"
    key = (id(t), lo, hi)
    if cuda and key in _checked:
        ref, version = _checked[key]
        if ref() is t and version == t._version:
            return
    vals = t.to(torch.int64)
    got_lo, got_hi = int(vals.min()), int(vals.max())
    if got_lo < lo or got_hi > hi:
        raise ValueError(f"{name}: {what} must lie in [{lo}, {hi}], got "
                         f"[{got_lo}, {got_hi}]")
    if cuda:
        _checked[key] = (weakref.ref(
            t, lambda _, k=key: _checked.pop(k, None)), t._version)


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Kernel inputs must be contiguous and on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA "
                             f"device (got {t.device} and {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
