"""Phase timers (counterpart of hashreadmapper_tpu/utils/timers.py, whose
phases open jax.profiler scopes).

Prints "TIMING: <seconds> s : <label>" like the JAX package; each phase is
also a torch.profiler range, visible in a trace taken around the run.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch


class PhaseTimers:
    def __init__(self) -> None:
        self._totals: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def phase(self, label: str):
        start = time.perf_counter()
        try:
            with torch.profiler.record_function(label):
                yield
        finally:
            self._totals.append((label, time.perf_counter() - start))

    def totals(self) -> Dict[str, float]:
        return dict(self._totals)

    def print_all(self) -> None:
        for label, seconds in self._totals:
            print(f"TIMING: {seconds:.6f} s : {label}")
