"""The repo-root conftest.py gives each process that runs tests its share of
the cores.

The share is the cores this process may run on divided by the xdist
worker count, at least 1: six workers on eight cores get one thread each.
A value of MKL_NUM_THREADS or OMP_NUM_THREADS set before the run wins over
the share.
"""

import os
import subprocess
import sys

import torch


def _expected(threads_given):
    if threads_given is not None:
        return int(threads_given)
    cores = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
             else os.cpu_count())
    return max(1, cores // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                              "1")))


def test_worker_torch_threads_are_its_share(threads_given):
    threads = int(os.environ["MKL_NUM_THREADS"])
    assert threads == _expected(threads_given)
    assert torch.get_num_threads() == threads
    assert torch.get_num_interop_threads() == threads


def test_spawned_python_inherits_the_share(threads_given):
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch; print(torch.get_num_threads())"],
        env=dict(os.environ), capture_output=True, text=True, timeout=120,
        check=True)
    assert int(out.stdout) == int(os.environ["MKL_NUM_THREADS"])
    assert int(out.stdout) == _expected(threads_given)
