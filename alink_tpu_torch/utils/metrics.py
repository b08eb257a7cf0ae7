"""Structured metrics logging (counterpart of
``alink_tpu/utils/metrics.py``).

Greenfield (SURVEY.md section 5.5): the reference streams losses to stdout
with ``\\r`` status lines (siamese.py:110-111) and prints the active count
per iteration (ALINK.py:204).  ``MetricsLogger`` writes JSONL records (one
object per event) and optionally mirrors a compact line to stdout, so runs
are machine-parseable after the fact.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Any


class MetricsLogger:
    def __init__(self, path: str | None = None, echo: bool = True):
        self.echo = echo
        self._fh: IO[str] | None = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")
        self._start = time.time()

    def log(self, event: str, **fields: Any) -> None:
        record = {"event": event, "t": round(time.time() - self._start, 3),
                  **fields}
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self.echo:
            compact = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[{record['t']:9.2f}s] {event}: {compact}")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
