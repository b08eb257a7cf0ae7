"""Batched verification / identification serving API (counterpart of
``alink_tpu/serving.py``).

- ``Verifier.verify_pairs`` — P(genuine) for batched image pairs;
- ``Verifier.enroll``       — embed faces into a gallery that stays on the
  device as one tensor;
- ``Verifier.identify``     — top-k gallery matches per probe (fused scorer);
- ``Verifier.score_matrix`` — all-pairs scores over one face set, over a
  (data, model) mesh when one is given;
- ``MicroBatcher``          — concurrent single-image requests coalesce
  into one padded batch call.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence

import torch

from alink_tpu_torch.ops import pairwise


class MicroBatcher:
    """Dynamic request batching with power-of-two shape buckets.

    Requests queue until ``max_batch`` are waiting or ``max_delay_s`` has
    passed since the oldest arrived; the batch pads up to the next bucket;
    one worker thread calls ``fn`` on it and fans the rows back out to the
    requests' futures (padding rows are dropped).  An ``fn`` failure fails
    every future of that batch.  Results are rows of ``fn``'s output, on
    its device.
    """

    def __init__(self, fn: Callable, max_batch: int = 64,
                 max_delay_s: float = 0.005):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.fn = fn
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.buckets = []
        b = 1
        while b < max_batch:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(max_batch)
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        # Guards the closed flag with the enqueue: a submit racing close()
        # must not land behind the shutdown sentinel.
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, item) -> Future:
        """Enqueue one request; the Future resolves to its result row."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._q.put((item, fut, time.monotonic()))
        return fut

    def __call__(self, item):
        """Blocking convenience: submit + wait."""
        return self.submit(item).result()

    def _drain(self, first):
        """Collect up to max_batch requests within the delay window, which
        counts from the first request's arrival."""
        batch = [first]
        deadline = first[2] + self.max_delay_s
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-signal shutdown for the outer loop
                break
            batch.append(nxt)
        return batch

    def _worker(self) -> None:
        while True:
            first = self._q.get()
            if first is None:
                return
            batch = self._drain(first)
            # Everything per batch stays inside the guard: a bad request
            # fails its batch's futures, never the worker thread.
            try:
                items = [torch.as_tensor(it) for it, _, _ in batch]
                n = len(items)
                bucket = next(b for b in self.buckets if b >= n)
                padded = torch.stack(items + [items[-1]] * (bucket - n))
                out = self.fn(padded)
                results = [out[i] for i in range(n)]
            except Exception as exc:  # noqa: BLE001 — fan out to futures
                for _, fut, _ in batch:
                    if not fut.cancelled():
                        fut.set_exception(exc)
                continue
            for res, (_, fut, _) in zip(results, batch):
                if not fut.cancelled():
                    fut.set_result(res)

    def close(self) -> None:
        """Flush pending requests and stop the worker."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._thread.join(timeout=30.0)

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Verifier:
    """Face verification / identification service.

    Args:
        featurize: batched ``(N, H, W, C) -> (N, D)`` embedding function,
            typically ``FaceModel(...).process``.
        head: the siamese verification head (``SiameseHead`` module).
        mesh: an optional (data, model) mesh (``parallel.create_mesh``);
            ``score_matrix`` then runs the sharded grid
            (``pairwise.score_matrix_sharded``).
    """

    def __init__(self, featurize: Callable, head, mesh=None):
        self.featurize = featurize
        self.head = head
        self.mesh = mesh
        self._gallery_feats: torch.Tensor | None = None
        self._gallery_labels: list = []
        # enroll() is read-concat-write and identify() reads features and
        # labels together: both hold the lock, so concurrent requests can
        # neither lose rows nor see labels out of step with features.
        self._gallery_lock = threading.Lock()

    def embed(self, images) -> torch.Tensor:
        return self.featurize(images)

    @torch.no_grad()
    def verify_pairs(self, left_images, right_images) -> torch.Tensor:
        """(N,) P(genuine) for image pairs."""
        return pairwise.pair_scores(self.head, self.embed(left_images),
                                    self.embed(right_images))

    @property
    def gallery_size(self) -> int:
        with self._gallery_lock:
            return len(self._gallery_labels)

    def enroll(self, images, labels: Sequence) -> None:
        """Add faces to the device-resident gallery (thread-safe)."""
        if len(labels) != len(images):
            raise ValueError("labels must match the image batch")
        feats = self.embed(images)
        with self._gallery_lock:
            if self._gallery_feats is None:
                self._gallery_feats = feats
            else:
                self._gallery_feats = torch.cat([self._gallery_feats, feats])
            self._gallery_labels.extend(labels)

    def identify(self, probe_images, k: int = 1):
        """Top-k gallery identities per probe: (labels (N, k) list of
        lists, scores (N, k) numpy array)."""
        with self._gallery_lock:
            feats, labels = self._gallery_feats, list(self._gallery_labels)
        if feats is None:
            raise ValueError("gallery is empty — enroll faces first")
        probes = self.embed(probe_images)
        k = min(k, len(labels))
        scores, idx = pairwise.identification_topk(self.head, probes,
                                                   feats.to(probes.device),
                                                   k=k)
        idx = idx.cpu().numpy()
        return ([[labels[j] for j in row] for row in idx],
                scores.cpu().numpy())

    def score_matrix(self, images_or_feats, *, precomputed: bool = False
                     ) -> torch.Tensor:
        """All-pairs P(genuine) over one face set; the mesh-sharded grid
        when the verifier has a mesh."""
        feats = (torch.as_tensor(images_or_feats) if precomputed
                 else self.embed(images_or_feats))
        if self.mesh is not None:
            return pairwise.score_matrix_sharded(self.mesh, self.head, feats,
                                                 feats)
        return pairwise.score_matrix(self.head, feats, feats)
