"""Closed-loop bulk embedding of aligned chips: back-to-back
``FaceModel.get_feature`` calls on batches of seeded 112 x 112 chips,
each call synchronised before the next (a bulk job that stores its
embeddings: template evaluation, re-indexing a gallery).

Traffic parameters: ``batch`` chips a call, ``pool_batches`` distinct
batches cycled through, ``chip`` (h, w, c), ``capture_calls`` calls drawn
from the seed among the first ``capture_within`` for the check,
``tail_calls`` calls for the profiler.

``faces_per_s``: chips (a face is an aligned chip here) completed in the
window over the time from its start to the last synchronised completion.

The check, for each captured call: the reference Swin
(``reference/swin.py``) embeds every chip of the call (``embed_gap``, the
widest L2 distance between the unit embeddings); the reference windowed
core, teacher-forced with the program's own qkv in the blocks the system
captured, gives ``wattn_gap``: the widest |program - reference| of the
core's output over the widest |reference|.  ``substitute``: the control,
the reference in that (lower) precision in the program's place, the
embeddings and the cores' outputs both.
"""

from __future__ import annotations

import random
import time

import torch

from bench_torch.drivers import Window
from bench_torch.drivers.serving_check import merge
from bench_torch.reference import swin as ref_swin
from bench_torch.reference.numerics import Numerics
from bench_torch.tracing import sync

BLOCK = 64        # chips a reference pass takes


class Driver:
    def __init__(self, system, traffic: dict, seed: int,
                 device: torch.device):
        self.sys = system
        self.t = traffic
        self.seed = seed
        self.device = device
        self.captured: list[dict] = []

    def setup(self) -> None:
        t = self.t
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed + 1)
        h, w, c = t["chip"]
        self.pool = torch.randint(0, 256, (t["pool_batches"], t["batch"], h,
                                           w, c), generator=g,
                                  device=self.device).float()
        rng = random.Random(self.seed)
        self.capture_at = set(rng.sample(range(t["capture_within"]),
                                         t["capture_calls"]))
        for i in range(2):  # builds the kernels, warms every shape
            self.sys.model.get_feature(self.pool[i % t["pool_batches"]])
        sync(self.device)
        self.sys.capture.calls.clear()

    def _call(self, i: int, capture: bool):
        cap = self.sys.capture
        cap.armed = capture
        emb = self.sys.model.get_feature(self.pool[i % self.t["pool_batches"]])
        cap.armed = False
        if capture:
            self.captured.append(cap.calls[-1])
        return emb

    def window(self, seconds: float) -> Window:
        bad = torch.zeros((), dtype=torch.long, device=self.device)
        calls = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        end = t0
        while time.perf_counter() < deadline:
            emb = self._call(calls, calls in self.capture_at)
            bad += (~torch.isfinite(emb).all(dim=1)).sum()
            sync(self.device)
            end = time.perf_counter()
            calls += 1
        faces = calls * self.t["batch"]
        return Window({"faces_per_s": faces / (end - t0)}, faces, int(bad),
                      {"batches": calls, "faces": faces,
                       "window_s": end - t0})

    def tail(self) -> int:
        for i in range(self.t["tail_calls"]):
            self._call(i, False)
            sync(self.device)
        return self.t["tail_calls"]

    def release(self) -> None:
        self.sys.release()

    def check(self, nx, substitute=None) -> dict:
        if not self.captured:
            raise RuntimeError("no embedding call was captured in the window")
        return merge([check_call(self.sys, rec, nx, substitute)
                      for rec in self.captured])


def core_gap(qkv, table, shift, window, out, nx: Numerics,
             substitute: Numerics | None = None) -> float:
    """Widest |program - reference| over widest |reference| of one core,
    ``BLOCK`` chips at a time (the program's output replaced by the
    reference in ``substitute``'s precision for the control)."""
    gap, top = 0.0, 0.0
    for i in range(0, qkv.shape[0], BLOCK):
        part = qkv[i:i + BLOCK]
        ref = ref_swin.core(part, table, shift, window, nx)
        got = out[i:i + BLOCK].float() if substitute is None else \
            ref_swin.core(part, table, shift, window, substitute)
        gap = max(gap, float((got - ref).abs().max()))
        top = max(top, float(ref.abs().max()))
    return gap / top


def check_call(system, rec: dict, nx: Numerics,
               substitute: Numerics | None = None) -> dict:
    w = system.weights["embed"]
    window = system.cfg["embedder"]["window_size"]
    chips, emb = rec["embed"]
    cores = [v for k, v in rec.items() if k.startswith("wattn.")]
    if not cores:
        raise RuntimeError("no windowed core was captured in the call")
    if substitute is not None:
        emb = ref_swin.embed(w, chips, window, substitute, BLOCK)
    ref_emb = ref_swin.embed(w, chips, window, nx, BLOCK)
    return {"embed_gap": float(torch.linalg.vector_norm(
                emb.float() - ref_emb, dim=1).max()),
            "wattn_gap": max(core_gap(*c, nx, substitute) for c in cores),
            "faces": chips.shape[0]}
