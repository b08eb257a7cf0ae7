"""Device-feed prefetching: overlap host decode and transfer with compute
(counterpart of ``alink_tpu/data/prefetch.py``).

The pool-resident A-LINK loop needs no streaming, but epoch training over
datasets larger than host memory and the serving ingest path do.  The
host -> device copy and the decode are the parts of the pipeline that the
device's own stream cannot overlap for you; a read-ahead queue does it.

``DevicePrefetcher`` wraps any host batch iterator with a background thread
that stays ``depth`` batches ahead.  On a CUDA device each batch is staged
in pinned host memory and copied with ``non_blocking=True`` on a side
stream (``copy_stream``); the consumer's stream waits on an event recorded
after the copy, and each tensor is ``record_stream``-ed on the consumer's
stream so the caching allocator does not reuse its memory early.  On the
CPU the batches become CPU tensors (copies, as a transfer would make).
With ``sharding`` (``parallel.batch_sharding(mesh, ndim)``) only this
rank's rows are copied, and each leaf lands as a ``DTensor`` sharded over
the mesh's ``data`` axis.  A custom ``transfer`` owns placement instead,
and ``transfer=None`` disables it.  Order is preserved, source exceptions
re-raise at the consumer, and the queue bounds host memory to ``depth``
batches.

Typical use::

    with DevicePrefetcher(decode_batches(paths), depth=2) as batches:
        for x in batches:
            state = train_step(state, x)   # the copy of the next x overlaps
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator

import torch

from alink_tpu_torch.utils.tree import map_leaves


class DevicePrefetcher:
    """Background-thread batch prefetcher with device placement.

    Args:
        iterable: source of host batches (nested dicts, tuples and lists of
            numpy arrays or tensors; other leaves pass through).
        depth: batches to stay ahead (>= 1).  2 double-buffers: one batch
            computing, one in flight.
        device: where batches land (default ``"cuda"``, the current CUDA
            device, or the device type of ``sharding``'s mesh; a missing
            card raises, there is no CPU fallback).  ``"cpu"`` gives CPU
            tensors.
        sharding: an optional ``parallel.mesh.Sharding``
            (``batch_sharding(mesh, ndim)``): each array leaf lands as a
            ``DTensor``, this rank's rows on its device.
        transfer: a function that places a batch in place of the default
            placement, or None for no placement (the thread still
            overlaps the source's own work).  Mutually exclusive with
            ``sharding``: a custom transfer owns placement entirely.
    """

    # Sentinels (private instances so user values can never collide).
    _DONE = object()
    _PLACE = object()

    def __init__(self, iterable: Iterable[Any], depth: int = 2,
                 device=None, sharding=None,
                 transfer: Callable[[Any], Any] | None = _PLACE):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if sharding is not None and transfer is not self._PLACE:
            # Honouring both is ambiguous (whose placement wins?); make the
            # caller choose instead of silently dropping one.
            raise ValueError("pass either sharding or a custom transfer,"
                             " not both")
        self._sharding = sharding
        self._transfer = transfer
        self.device = None
        self.copy_stream = None
        if transfer is self._PLACE:
            self._init_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(iter(iterable),), daemon=True)
        self._thread.start()

    def _init_device(self, device) -> None:
        mesh_type = (self._sharding.mesh.device_type
                     if self._sharding is not None else None)
        self.device = torch.device(device if device is not None
                                   else mesh_type or "cuda")
        if mesh_type is not None and self.device.type != mesh_type:
            raise ValueError(f"device {self.device} is not on the "
                             f"sharding's {mesh_type} mesh")
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("DevicePrefetcher: no CUDA device; pass "
                                   "device='cpu' to prefetch on the CPU")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self.copy_stream = torch.cuda.Stream(self.device)
        elif self.device.type != "cpu":
            raise ValueError(f"no prefetch to {self.device}")

    def _leaf(self, x, copy: Callable[[torch.Tensor], torch.Tensor]):
        """One array leaf placed by ``copy``: whole, or this rank's rows
        as a ``DTensor`` under the sharding."""
        if self._sharding is None:
            return copy(torch.as_tensor(x))
        from alink_tpu_torch.parallel.mesh import from_local, local_rows

        local, shape = local_rows(x, self._sharding)
        return from_local(copy(local), self._sharding, shape)

    def _place(self, item):
        """(batch placed, the copy's event or None)."""
        if self._transfer is None:
            return item, None
        if self._transfer is not self._PLACE:
            return self._transfer(item), None
        if self.copy_stream is None:
            return map_leaves(lambda x: self._leaf(
                x, lambda t: t.detach().cpu().clone()), item), None

        def stage(t):
            host = t if t.is_pinned() else t.pin_memory()
            return host.to(self.device, non_blocking=True)

        with torch.cuda.stream(self.copy_stream):
            out = map_leaves(lambda x: self._leaf(x, stage), item)
            event = torch.cuda.Event()
            event.record(self.copy_stream)
        return out, event

    def _worker(self, it: Iterator[Any]) -> None:
        try:
            for item in it:
                placed = self._place(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(placed, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(self._DONE)
        except BaseException as exc:  # noqa: BLE001 — re-raised at consumer
            self._q.put(exc)

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Any:
        if self._done:
            # Sticky: every next() after exhaustion/close terminates,
            # including calls after the _DONE sentinel was consumed.
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            # The worker died delivering this: it will never produce
            # again, so the iterator is exhausted (a consumer that catches
            # the error and keeps iterating must terminate, not block
            # forever on the empty queue).
            self._done = True
            raise item
        out, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            map_leaves(lambda t: _local(t).record_stream(consumer), out)
        return out

    def close(self) -> None:
        """Stop the worker (for abandoning an iteration early)."""
        self._stop.set()
        # Drain until the worker is actually dead: a worker mid-put can
        # still land one item AFTER a single drain pass (it only checks the
        # stop flag after the put succeeds), which on a full queue would
        # swallow the _DONE sentinel below and leave a later consumer
        # blocked forever in __next__.
        deadline = time.monotonic() + 10.0
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
        # Deadline path: a daemon worker wedged inside a transfer is
        # abandoned rather than hanging close() too.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # Worker dead (or abandoned) + queue drained: any consumer blocked
        # in __next__ wakes into StopIteration.
        self._done = True
        try:
            self._q.put_nowait(self._DONE)
        except queue.Full:  # only reachable on the abandoned-worker path
            pass

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local part, or the tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def prefetch_to_device(iterable, depth: int = 2, device=None, **kwargs):
    """Functional spelling of ``DevicePrefetcher`` (flax idiom); keywords
    (``sharding``, ``transfer``) pass through."""
    return DevicePrefetcher(iterable, depth=depth, device=device, **kwargs)
