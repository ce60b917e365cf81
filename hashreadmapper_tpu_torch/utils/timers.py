"""Phase timers (counterpart of hashreadmapper_tpu/utils/timers.py, whose
phases open jax.profiler scopes).

Prints "TIMING: <seconds> s : <label>" like the JAX package; each phase is
also a span of utils/tracing.py (recorded when the tracer is on).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

from . import tracing


class PhaseTimers:
    def __init__(self) -> None:
        self._totals: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def phase(self, label: str):
        start = time.perf_counter()
        try:
            with tracing.span(label):
                yield
        finally:
            self._totals.append((label, time.perf_counter() - start))

    def totals(self) -> Dict[str, float]:
        return dict(self._totals)

    def print_all(self) -> None:
        for label, seconds in self._totals:
            print(f"TIMING: {seconds:.6f} s : {label}")
