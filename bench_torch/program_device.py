"""Device time of the kernels the program launches inside its own spans
(``alink/<name>``, ``alink_tpu_torch.utils.profiling.span``), read from
the host-traced profiled stretch (``run.spans``) through the profiler's
tree of host events, as ``tracing.Trace`` reads the harness's ``bench/``
spans.  None where the span never opened (a program without it)."""

from __future__ import annotations

from bench_torch.program_spans import PREFIX


def _kernels_us(evt) -> float:
    own = sum(k.duration for k in getattr(evt, "kernels", ()))
    return own + sum(_kernels_us(c) for c in evt.cpu_children)


def span_device_s(run, name: str) -> float | None:
    """Device seconds of the kernels inside every occurrence of span
    ``name``."""
    trace = getattr(run, "spans", None)
    hits = [e for e in trace.host if e.name == PREFIX + name] \
        if trace is not None else []
    if not hits:
        return None
    return 1e-6 * sum(_kernels_us(e) for e in hits)


def ms_per_unit(run, name: str) -> float | None:
    """Device ms inside span ``name`` per unit (call) of the stretch."""
    s = span_device_s(run, name)
    return None if s is None or not run.spans.units else \
        1e3 * s / run.spans.units
