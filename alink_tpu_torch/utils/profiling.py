"""Per-phase wall-clock accounting (counterpart of
``alink_tpu/utils/profiling.py``).

CUDA work is asynchronous: a phase on a CUDA device synchronises it before
its clock stops, so the phase is charged its own device work and not the
next phase's first wait.  ``trace`` wraps ``torch.profiler`` (the
counterpart of ``jax.profiler.trace``) and writes a Chrome trace, viewable
in Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
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

    def timed(self, name: str, fn, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` and charge its wall time, its CUDA
        work synchronised, to ``name``."""
        with self.phase(name):
            return fn(*args, **kwargs)

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:>20s}: {t:8.3f}s total, {c:5d} calls, "
                         f"{1e3 * t / max(c, 1):8.2f} ms/call")
        return "\n".join(lines)

    def as_dict(self) -> dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (host ops, and CUDA kernels when a
    card is present) into ``<log_dir>/trace.json``; yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
