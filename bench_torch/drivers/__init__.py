"""Drivers: the general generators that a traffic file names
(``"driver"``).  Each reads its parameters from the traffic file, makes
its inputs and arrivals from the seed, drives the program's entry for the
window, and checks what the window produced against the references.

A driver has ``setup()``, ``window(seconds) -> Window``, ``tail()`` (a
fixed stretch of the same traffic for the profiler, returning the units
it ran: batches or slabs), ``release()`` and ``check(nx)``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Window:
    metrics: dict        # end-to-end metric name -> value
    attempted: int
    failed: int
    counters: dict       # what the per-layer readers need
