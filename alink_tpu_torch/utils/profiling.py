"""Per-phase wall-clock accounting (counterpart of
``alink_tpu/utils/profiling.py``).

CUDA work is asynchronous: a phase on a CUDA device synchronises it before
its clock stops, so the phase is charged its own device work and not the
next phase's first wait.  Profiler traces are taken with ``torch.profiler``
directly; the JAX ``trace`` helper is not ported.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Timings:
    """Accumulated per-phase wall times."""

    def __init__(self, device: torch.device | str | None = None):
        self.device = torch.device(device) if device is not None else None
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:>20s}: {t:8.3f}s total, {c:5d} calls, "
                         f"{1e3 * t / max(c, 1):8.2f} ms/call")
        return "\n".join(lines)

    def as_dict(self) -> dict[str, float]:
        return dict(self.totals)
