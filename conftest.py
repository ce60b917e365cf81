"""Thread pools of the processes that run the tests.

torch's default is every core in every process, so under xdist each worker
ran as many OpenMP and inter-op threads as the host has cores: six workers'
spin-waiting pools on eight cores made the suite several times slower.
Each process that runs tests gives its OpenMP, MKL and torch thread pools
its share of the cores instead (pytest_configure).  A value of
OMP_NUM_THREADS or MKL_NUM_THREADS set before the run wins over the share.
"""

import os

import pytest

_THREADS_GIVEN = pytest.StashKey[str | None]()


def pytest_configure(config):
    # xdist's controller runs no tests, and its workers start from its
    # environment: what it set there would look like the developer's own.
    if config.getoption("dist", "no") != "no":
        return
    cores = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
             else os.cpu_count())
    share = max(1, cores // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                               "1")))
    config.stash[_THREADS_GIVEN] = os.environ.get(
        "MKL_NUM_THREADS", os.environ.get("OMP_NUM_THREADS"))
    # The environment carries the share to the subprocesses tests spawn.
    # torch reads MKL_NUM_THREADS over OMP_NUM_THREADS.
    os.environ.setdefault("OMP_NUM_THREADS", str(share))
    threads = int(os.environ.setdefault("MKL_NUM_THREADS",
                                        os.environ["OMP_NUM_THREADS"]))
    import torch
    torch.set_num_threads(threads)
    torch.set_num_interop_threads(threads)


@pytest.fixture
def threads_given(request):
    """MKL_NUM_THREADS, else OMP_NUM_THREADS, as set before the run; None
    where this process's share of the cores sized the thread pools."""
    return request.config.stash.get(_THREADS_GIVEN, None)
