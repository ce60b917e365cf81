"""The program's spans, and profiling scopes (scoped_range is the
counterpart of hashreadmapper_tpu/utils/tracing.py's).

span(name, parent=None, **attrs) marks one layer's work: a chunk of the
driver, STEP 2 on a worker, the engine's staging, replays and fetch, the
emitters, the index build.  The tracer is off by default: a span then
tests one flag and returns a shared null context, recording nothing.
After enable() each span records a Span (name, thread name, start and end
in time.time_ns(), its id, its parent's id, its attributes) into one list
that snapshot() returns and reset() clears, and opens a
torch.profiler.record_function of its name, so a trace exported meanwhile
shows it.  time.time_ns() is the clock of the profiler's events, so a
device operation can be placed inside the spans open on the host.

A span's parent is the innermost span open on its thread, or the id given
as parent= (a span opened on another thread: current() there).  Counts
are attributes of the span at whose boundary the work is counted; those
that cost work to compute are computed only when enabled().

The reference wraps every pipeline stage in nvtx ranges
(reference: include/hpc_helpers/include/nvtx_markers.cuh:18-56,
src/gpu/main_gpu.cu:484-775); scoped_range is such a range, always on.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    thread: str
    t0_ns: int
    t1_ns: int
    id: int
    parent: Optional[int]
    attrs: Dict


_NULL = contextlib.nullcontext()
_on = False
_spans: List[Span] = []
_ids = itertools.count(1)
_open = threading.local()       # .stack: ids of the spans open on a thread


def enable() -> None:
    """Record every span from now on."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def snapshot() -> List[Span]:
    """The spans ended so far, in the order they ended."""
    return list(_spans)


def reset() -> None:
    _spans.clear()


def current() -> Optional[int]:
    """The id of the innermost span open on this thread (None when the
    tracer is off or none is open)."""
    stack = getattr(_open, "stack", None)
    return stack[-1] if stack else None


class _Recording:
    __slots__ = ("name", "parent", "attrs", "id", "t0", "_range")

    def __init__(self, name: str, parent: Optional[int], attrs: Dict):
        self.name, self.parent, self.attrs = name, parent, attrs

    def __enter__(self) -> "_Recording":
        stack = _open.__dict__.setdefault("stack", [])
        self.id = next(_ids)
        if self.parent is None and stack:
            self.parent = stack[-1]
        stack.append(self.id)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        self._range.__exit__(*exc)
        _open.stack.pop()
        _spans.append(Span(self.name, threading.current_thread().name,
                           self.t0, t1, self.id, self.parent, self.attrs))
        return False


def span(name: str, parent: Optional[int] = None, **attrs):
    """A context manager around one layer's work (see the module
    docstring); entering it gives the recording, with its .id, or None
    when the tracer is off."""
    if not _on:
        return _NULL
    return _Recording(name, parent, attrs)


@contextlib.contextmanager
def scoped_range(name: str, color: int = 0):
    """nvtx::ScopedRange equivalent; color accepted for API parity."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
