"""The program's own spans and counters, for the per-layer readers.

Spans are the ``record_function`` ranges named ``alink/<name>`` that the
program opens while a profiler records (``alink_tpu_torch.utils.
profiling.span``); they are read from the host-traced profiled stretch
(``run.spans``).  A span's device-idle time is its wall interval less
that interval's overlap with the stretch's device activity.  Counters
are the program's process-wide registry (``profiling.counters``): the
cell's own traffic from set-up to the profiled stretches.  A program
without spans or counters gives None.
"""

from __future__ import annotations

from bisect import bisect_left

PREFIX = "alink/"


def intervals(trace, name: str) -> list[tuple[float, float]]:
    """(start, end) in microseconds of each occurrence of span ``name``."""
    full = PREFIX + name
    return [(e.time_range.start, e.time_range.end) for e in trace.host
            if e.name == full]


def busy_us(segments, start: float, end: float) -> float:
    """Microseconds of the merged, sorted device ``segments`` that lie in
    [start, end]."""
    i = max(bisect_left(segments, (start,)) - 1, 0)
    total = 0.0
    for s, e in segments[i:]:
        if s >= end:
            break
        total += max(0.0, min(e, end) - max(s, start))
    return total


def idle_ms(run, name: str) -> float | None:
    """Mean device-idle ms of span ``name`` over its occurrences in the
    host-traced stretch, or None where it never opened."""
    trace = getattr(run, "spans", None)
    spans = intervals(trace, name) if trace is not None else []
    if not spans:
        return None
    idle = sum((e - s) - busy_us(trace.segments, s, e) for s, e in spans)
    return 1e-3 * idle / len(spans)


def counters() -> dict[str, int] | None:
    """The program's counters, or None where it keeps none."""
    try:
        from alink_tpu_torch.utils.profiling import counters as read
    except ImportError:
        return None
    return read()


def ratio(num: str, den: str) -> float | None:
    """Counter ``num`` over counter ``den``, or None where either is
    missing or the base is 0."""
    c = counters()
    if not c or not c.get(den) or num not in c:
        return None
    return c[num] / c[den]
