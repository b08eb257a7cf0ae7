"""Per-phase wall-clock accounting, spans and counters (counterpart of
``alink_tpu/utils/profiling.py``).

CUDA work is asynchronous: a phase on a CUDA device synchronises it before
its clock stops, so the phase is charged its own device work and not the
next phase's first wait.  ``trace`` wraps ``torch.profiler`` (the
counterpart of ``jax.profiler.trace``) and writes a Chrome trace, viewable
in Perfetto or ``chrome://tracing``, and the counts made while it was open.

``span(name)`` marks a stretch of the program as ``alink/<name>`` on the
profiler's clock, nested under the span that opened it; it records only
while a profiler records, and otherwise costs one check of the profiler's
flag.  ``count(name, n)`` adds a host integer to a process-wide registry
that ``counters()`` reads, with the kernels' launch counts beside it
(``_build.launch`` makes them); ``counting()`` gives the counts made
inside a ``with`` block.  ``count_on_device(name, t)`` adds a count the
device holds (a data-dependent one) to a total kept on that device, with
no sync: ``counters()`` reads those totals, and only it waits for the
device.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch

from alink_tpu_torch import _build

SPAN_PREFIX = "alink/"

_recording = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_COUNTS: dict[str, int] = defaultdict(int)
_ON_DEVICE: dict[tuple[str, torch.device], torch.Tensor] = {}


def span(name: str):
    """A context manager: ``record_function("alink/" + name)`` while a
    ``torch.profiler`` records, else a shared no-op."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(SPAN_PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``.  ``n`` is a host integer the caller
    already holds (a loop count, ``numel()``, a shape), never a tensor:
    reading one would wait for the device."""
    if not isinstance(n, int):
        raise TypeError(f"count({name!r}) takes a host int, not "
                        f"{type(n).__name__}")
    _COUNTS[name] += n


def count_on_device(name: str, n: torch.Tensor) -> None:
    """Add the integer tensor ``n`` (one element) to counter ``name``'s
    total on ``n``'s device, without reading it."""
    key = (name, n.device)
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.zeros((), dtype=torch.int64, device=n.device)
    _ON_DEVICE[key] += n.reshape(())


def counters() -> dict[str, int]:
    """A snapshot of every counter (those kept on a device read now, which
    waits for it), with the kernel library's launch counts
    (``launches.k1`` to ``launches.k4``, ``launches.bn_act``,
    ``launches.bn_act_backward``, ``launches.attn``,
    ``launches.wattn``, ``launches.nms``, ``launches.ln``;
    ``_build``)."""
    out = dict(_COUNTS)
    for (name, _), total in _ON_DEVICE.items():
        out[name] = out.get(name, 0) + int(total)
    out.update(_build.launch_counts())
    return out


@contextlib.contextmanager
def counting():
    """A context manager that yields a dict; when the block ends, the dict
    holds the counts made inside the block, for every key of
    ``counters()`` (0 where nothing was counted)."""
    before = counters()
    made: dict[str, int] = {}
    try:
        yield made
    finally:
        made.update((k, v - before.get(k, 0))
                    for k, v in sorted(counters().items()))


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
        """Time the block, its device work included, as phase ``name``
        (and ``span(name)`` over the same stretch)."""
        self._sync()
        with span(name):
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
    """Capture a ``torch.profiler`` trace (host ops and spans, and CUDA
    kernels when a card is present) into ``<log_dir>/trace.json``, and the
    counts made meanwhile into ``<log_dir>/counters.json``; yields the
    profiler."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with counting() as made, \
            torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(made, f, indent=1)
