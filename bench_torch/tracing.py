"""The profiler reader: device busy time, kernels by name, launches, the
device time inside the harness's own spans, and the longest idle gaps,
from one ``torch.profiler`` window.

Spans are ``torch.profiler.record_function`` ranges named ``bench/<name>``
that the harness opens around its calls into a layer (``Span``).  A
span's device time is the device time of every kernel launched inside
it, on the host's side of the range, through the profiler's tree of
host events.

Recording every host operation slows the host several-fold on a path
that launches thousands of kernels a batch, so a traced run profiles two
stretches of the same traffic: the card alone (busy and idle time,
kernels, launches) and then the card with the host (spans, and the
idle gaps named by what the host was doing).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

PREFIX = "bench/"


class Span:
    """A named range that opens in one hook and closes in another."""

    def __init__(self, name: str):
        self.name = PREFIX + name
        self._rf = None

    def begin(self) -> None:
        if self._rf is None:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()

    def end(self) -> None:
        if self._rf is not None:
            rf, self._rf = self._rf, None
            rf.__exit__(None, None, None)


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on a CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _is_device(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CUDA


def _is_annotation(evt) -> bool:
    return bool(getattr(evt, "is_user_annotation", False)) or \
        evt.name.startswith(PREFIX)


def _union(intervals) -> tuple[float, list[tuple[float, float]]]:
    """(total length, merged intervals) of (start, end) pairs."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


class Trace:
    """One profiled window.  Times are seconds; ``window_s`` is the host
    clock from the profiler's start to its stop, after a synchronise."""

    def __init__(self, prof, window_s: float):
        self.window_s = window_s
        events = list(prof.events())
        self.device = [e for e in events
                       if _is_device(e) and not _is_annotation(e)]
        self.host = [e for e in events if not _is_device(e)]
        busy_us, self.segments = _union(
            (e.time_range.start, e.time_range.end) for e in self.device)
        self.busy_s = busy_us * 1e-6
        self._span_us = self._span_device_us()

    # -- kernels ---------------------------------------------------------

    @staticmethod
    def _is_kernel(evt) -> bool:
        n = evt.name.lower()
        return not (n.startswith("memcpy") or n.startswith("memset"))

    def launches(self) -> int:
        """Kernels that ran on the device (copies and fills left out)."""
        return sum(1 for e in self.device if self._is_kernel(e))

    def kernel(self, pattern: str) -> tuple[float, int]:
        """(device seconds, launches) of kernels whose name holds
        ``pattern``."""
        hits = [e for e in self.device if pattern in e.name]
        return (sum(e.time_range.end - e.time_range.start for e in hits)
                * 1e-6, len(hits))

    def top_ops(self, k: int = 10) -> list[list]:
        """The ``k`` device operations (by name) that took most time."""
        totals: dict[str, float] = {}
        for e in self.device:
            totals[e.name] = totals.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) * 1e-6
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
        return [[name, sec] for name, sec in top]

    # -- spans -----------------------------------------------------------

    def _span_device_us(self) -> dict[str, float]:
        """Device microseconds of the kernels launched inside each span,
        summed over the span's occurrences."""

        def kernels_us(evt) -> float:
            own = sum(k.duration for k in getattr(evt, "kernels", ()))
            return own + sum(kernels_us(c) for c in evt.cpu_children)

        out: dict[str, float] = {}
        for e in self.host:
            if e.name.startswith(PREFIX):
                name = e.name[len(PREFIX):]
                out[name] = out.get(name, 0.0) + kernels_us(e)
        return out

    def span_device_s(self, name: str) -> float | None:
        """Device seconds inside span ``name``, or None if it never
        opened in the window."""
        us = self._span_us.get(name)
        return None if us is None else us * 1e-6

    # -- idle gaps -------------------------------------------------------

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The ``k`` longest gaps between device activity, each named by
        the innermost harness span and host operation running at its
        midpoint."""
        segs = self.segments
        gaps = sorted(((segs[i + 1][0] - segs[i][1], segs[i][1],
                        segs[i + 1][0]) for i in range(len(segs) - 1)),
                      reverse=True)[:k]
        out = []
        for length, s, e in gaps:
            mid = 0.5 * (s + e)
            span, op = None, None
            for h in self.host:
                if h.time_range.start <= mid <= h.time_range.end:
                    dur = h.time_range.end - h.time_range.start
                    if h.name.startswith(PREFIX):
                        if span is None or dur < span[0]:
                            span = (dur, h.name[len(PREFIX):])
                    elif op is None or dur < op[0]:
                        op = (dur, h.name)
            label = "/".join(x[1] for x in (span, op) if x) or "host"
            out.append([label, length * 1e-6])
        return out


def profiled(fn: Callable[[], object], device: torch.device,
             host: bool = True) -> tuple[object, Trace]:
    """Run ``fn`` under ``torch.profiler`` and read the window: the card's
    activity, and with ``host`` the host's operations and the harness's
    spans too (which slows the host's side of the window)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host or device.type != "cuda" else []
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = fn()
        sync(device)
        window = time.perf_counter() - t0
    return result, Trace(prof, window)
