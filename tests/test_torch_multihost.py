"""Port parity: the multi-process region merge
(parallel/multihost.py::merge_region_results over torch.distributed)
against the JAX package's region-mesh collective, in one process over 4
regions; two gloo processes over localhost (tests/torch_multihost_worker.py)
against the port's single-process mappers; and process_read_slice."""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from hashreadmapper_tpu.parallel import multihost as jax_multihost
from hashreadmapper_tpu_torch.parallel import multihost


def test_merge_equals_the_jax_region_mesh():
    """Seeded keys and payloads of 4 regions: ties between regions,
    unmapped rows (2**62 in every region), negative payload fields and
    ordinals beyond 2**31; bit-equal to the JAX merge over a 4-device
    region mesh."""
    if len(jax.devices()) < 4:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    rng = np.random.default_rng(10)
    n, p, r = 300, 6, 4
    ham = rng.integers(0, 9, (r, n))
    gwin = rng.integers(0, 2**34, (r, n))
    keys = (ham << 40) + gwin
    keys[:, :40] = keys[0, :40]                      # ties in every region
    keys[1:3, 40:80] = keys[1, 40:80]                # ties in two
    keys[:, 80:120] = 2**62                          # unmapped everywhere
    keys[rng.random((r, n)) < 0.2] = 2**62
    pays = rng.integers(-2**31, 2**31, (r, n, p)).astype(np.int32)
    pays[:, 80:120] = [3, 0, 0, 0, 0, 0]
    ref_key, ref_pay = jax_multihost.merge_region_results(
        jax_multihost.region_mesh(jax.devices()[:r]), list(keys), list(pays))
    mesh = multihost.region_mesh(["cpu"] * r)
    assert (mesh.region_offset, mesh.num_regions) == (0, r)
    key, pay = multihost.merge_region_results(mesh, list(keys), list(pays))
    assert key.dtype == np.int64 and pay.dtype == np.int32
    np.testing.assert_array_equal(key, ref_key)
    np.testing.assert_array_equal(pay, ref_pay)
    np.testing.assert_array_equal(key, keys.min(axis=0))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_merge_to_the_single_process_result():
    """2 processes x 2 regions of a 4-region window partition, merged over
    gloo on localhost: both equal the single-process whole-genome mapper
    and the 4-region RegionShardedMapper (the worker asserts it)."""
    worker = os.path.join(os.path.dirname(__file__),
                          "torch_multihost_worker.py")
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, worker, str(rank), "2", coord],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for rank in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=180)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        assert f"TORCH_MULTIHOST_OK {rank}" in out, out[-4000:]


@pytest.mark.parametrize("n,procs,want", [
    (103, 4, [(0, 26), (26, 52), (52, 78), (78, 103)]),
    (3, 4, [(0, 1), (1, 2), (2, 3), (3, 3)]),
    (0, 2, [(0, 0), (0, 0)]),
    (10, 1, [(0, 10)])])
def test_process_read_slice(n, procs, want):
    got = [multihost.process_read_slice(n, procs, p) for p in range(procs)]
    assert got == want
    assert got == [jax_multihost.process_read_slice(n, procs, p)
                   for p in range(procs)]
