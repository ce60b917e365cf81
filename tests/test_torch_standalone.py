"""The port stands on its own: it imports nothing of the JAX package, and
its native host library builds safely when several processes build at
once."""

import os
import subprocess
import sys

import pytest

from hashreadmapper_tpu_torch import _build, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, *args, timeout=600):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen([sys.executable, "-c", code, *args], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def test_port_imports_nothing_of_the_jax_package():
    """Every module of hashreadmapper_tpu_torch, and chip_smoke as a
    module, imported in a fresh interpreter: no jax, no hashreadmapper_tpu."""
    code = """
import importlib, pkgutil, sys
import hashreadmapper_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "hashreadmapper_tpu" or m.startswith("hashreadmapper_tpu."))
assert not bad, bad
assert len(names) >= 30, names
for mod in ("parallel.segments", "parallel.region_sharded",
            "pipeline.window_stream", "parallel.sharded",
            "parallel.multihost", "eval.analysis", "utils.tracing"):
    assert pkg.__name__ + "." + mod in names, mod
print("IMPORTED", len(names))
"""
    proc = _run(code)
    out = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, out[-3000:]
    assert "IMPORTED" in out


def test_no_source_line_imports_the_jax_package():
    """The same, read off the sources (what the subprocess cannot see: an
    import inside a function that it never calls)."""
    import re
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|hashreadmapper_tpu)"
                     r"(\.|\s|$)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "hashreadmapper_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = []
    for path in files:
        with open(path) as fh:
            hits += [f"{path}:{i}: {line.strip()}"
                     for i, line in enumerate(fh, 1) if pat.match(line)]
    assert not hits, hits


def test_native_build_is_safe_under_contention(tmp_path):
    """Four processes build into one empty build directory at once; each
    loads a whole library that answers hrm_nw_distance, and what is left is
    one library and no temporary file."""
    build_dir = str(tmp_path / "build")
    code = """
import ctypes, sys
from hashreadmapper_tpu_torch import _build
path = _build.build_native(build_dir=sys.argv[1])
lib = ctypes.CDLL(path)
lib.hrm_nw_distance.restype = ctypes.c_int
lib.hrm_nw_distance.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                ctypes.c_char_p, ctypes.c_int]
d = lib.hrm_nw_distance(b"ACGTACGT", 8, b"ACGAACGTT", 9)
assert hasattr(lib, "hrm_sam_emit") and hasattr(lib, "hrm_cuckoo_build")
print("DISTANCE", d, path)
"""
    procs = [_run(code, build_dir) for _ in range(4)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert "DISTANCE 2 " in out, out[-1000:]
    left = sorted(os.listdir(build_dir))
    assert left == [os.path.basename(_build.native_library_path(build_dir))]


def test_native_library_name_carries_sources_and_flags(tmp_path, monkeypatch):
    a = _build.native_library_path(str(tmp_path))
    monkeypatch.setattr(_build, "CXX_FLAGS", _build.CXX_FLAGS + ("-DX",))
    b = _build.native_library_path(str(tmp_path))
    assert a != b and os.path.dirname(a) == str(tmp_path)
    assert os.path.basename(a).startswith("libhrm_native_")


def test_failed_native_build_raises_with_the_compilers_output(tmp_path,
                                                              monkeypatch):
    """No compiler: build_native raises, get_lib raises with that message,
    available() is False."""
    monkeypatch.setenv("CXX", "")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        _build.build_native(build_dir=str(tmp_path / "none"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "none"))
    monkeypatch.setattr(
        _build, "build_native",
        lambda build_dir=str(tmp_path / "none"), verbose=False:
        (_ for _ in ()).throw(RuntimeError("g++ failed:\nerror: boom")))
    with pytest.raises(RuntimeError, match="boom"):
        native.get_lib()
    assert native.available() is False
    with pytest.raises(RuntimeError, match="boom"):      # remembered
        native.emit_available()


def test_a_broken_source_fails_the_build(tmp_path, monkeypatch):
    src = tmp_path / "native"
    src.mkdir()
    (src / "bad.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_build, "NATIVE_DIR", str(src))
    with pytest.raises(RuntimeError, match="failed"):
        _build.build_native(build_dir=str(tmp_path / "build"))
    assert not [n for n in os.listdir(tmp_path / "build")
                if n.endswith(".so")]
