"""Profiling scopes and trace capture (NVTX ranges; counterpart of
hashreadmapper_tpu/utils/tracing.py).

The reference wraps every pipeline stage in nvtx ranges
(reference: include/hpc_helpers/include/nvtx_markers.cuh:18-56,
src/gpu/main_gpu.cu:484-775).  Here a scope is a torch.profiler
record_function (a named span in the profiler's trace) and, with a card,
the same NVTX range; trace_session captures a torch.profiler trace.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def scoped_range(name: str, color: int = 0):
    """nvtx::ScopedRange equivalent; color accepted for API parity."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


def annotate(name: str):
    """Decorator version for stage functions."""
    def deco(fn):
        def wrapped(*args, **kwargs):
            with scoped_range(name):
                return fn(*args, **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", name)
        return wrapped
    return deco


@contextlib.contextmanager
def trace_session(logdir: str):
    """Profile the enclosed region (the host, and the cards where there
    are any) and write its Chrome trace to logdir/trace.json."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
