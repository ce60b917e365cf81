"""Progress reporting (ProgressThread equivalent).

Reference: ProgressThread during file parsing
(chunkedreadstorageconstruction.hpp:63-67) and the every-100k-windows
counter behind --showProgress (main_gpu.cu:1114-1119).
"""

from __future__ import annotations

import sys
import time


class ProgressReporter:
    def __init__(self, total: int, label: str = "", enabled: bool = True,
                 min_interval_s: float = 1.0):
        self.total = total
        self.label = label
        self.enabled = enabled
        self.min_interval_s = min_interval_s
        self.count = 0
        self._start = time.perf_counter()
        self._last = self._start

    def add(self, n: int) -> None:
        self.count += n
        if not self.enabled:
            return
        now = time.perf_counter()
        if now - self._last >= self.min_interval_s or self.count >= self.total:
            pct = 100.0 * self.count / self.total if self.total else 0.0
            rate = self.count / max(now - self._start, 1e-9)
            sys.stderr.write(
                f"\r{self.label}: {self.count}/{self.total} ({pct:.1f}%) "
                f"{rate:,.0f}/s")
            sys.stderr.flush()
            self._last = now

    def finish(self) -> None:
        if self.enabled:
            elapsed = time.perf_counter() - self._start
            sys.stderr.write(
                f"\r{self.label}: {self.count}/{self.total} done "
                f"in {elapsed:.1f}s\n")
            sys.stderr.flush()
