"""Closed-loop bulk serving: back-to-back ``FaceModel.pipeline`` calls on
batches of seeded photos, each call synchronised before the next (a bulk
caller that consumes its embeddings).

Traffic parameters: ``batch`` photos a call, ``pool_batches`` distinct
batches cycled through, ``photo`` (h, w, c), ``capture_calls`` calls
drawn from the seed among the first ``capture_within`` for the check,
``tail_calls`` calls for the profiler.

``faces_per_s``: photos completed in the window over the time from its
start to the last synchronised completion.
"""

from __future__ import annotations

import random
import time

import torch

from bench_torch.tracing import sync
from bench_torch.drivers import Window, serving_check


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
        h, w, c = t["photo"]
        self.pool = torch.randint(0, 256, (t["pool_batches"], t["batch"], h,
                                           w, c), generator=g,
                                  device=self.device).float()
        rng = random.Random(self.seed)
        self.capture_at = set(rng.sample(range(t["capture_within"]),
                                         t["capture_calls"]))
        for i in range(2):  # builds the kernels, warms every shape
            self.sys.model.pipeline(self.pool[i % t["pool_batches"]])
        sync(self.device)
        self.sys.capture.calls.clear()

    def _call(self, i: int, capture: bool):
        x = self.pool[i % self.t["pool_batches"]]
        cap = self.sys.capture
        cap.armed = capture
        emb = self.sys.model.pipeline(x)
        cap.armed = False
        if capture:
            cap.calls[-1]["photos"] = x
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
        self.calls = calls
        return Window({"faces_per_s": faces / (end - t0)}, faces, int(bad),
                      {"batches": calls, "faces": faces,
                       "window_s": end - t0})

    def tail(self) -> int:
        for i in range(self.t["tail_calls"]):
            self._call(i, False)
            sync(self.device)
        return self.t["tail_calls"]

    def k2_input_bytes(self) -> list[float]:
        """Per pool batch, the photo bytes K2 needs: the distinct in-image
        pixels under the four bilinear taps of every chip pixel, for the
        landmarks the reference cascade finds (teacher-forced) on that
        batch.  Run after the window, for the roofline reader."""
        from bench_torch.reference import mtcnn as ref_mtcnn

        cap, ccfg = self.sys.capture, self.sys.cfg["cascade"]
        out = []
        for i in range(self.t["pool_batches"]):
            x = self.pool[i]
            cap.armed = True
            self.sys.model.pipeline(x)
            cap.armed = False
            rec = cap.calls.pop()
            towers = {"pnet": [o for _, o in rec["pnet"]],
                      "rnet": rec["rnet"][1], "onet": rec["onet"][1]}
            _, marks, found = ref_mtcnn.cascade(x, ccfg, towers)
            mats = ref_mtcnn.similarity(marks, ref_mtcnn.template(
                tuple(ccfg["output_size"])))
            pixels = ref_mtcnn.footprint(mats[found], x.shape[1], x.shape[2],
                                         tuple(ccfg["output_size"]))
            out.append(float(pixels) * x.shape[3] * x.element_size())
        return out

    def release(self) -> None:
        self.sys.release()

    def check(self, nx, substitute=None) -> dict:
        if not self.captured:
            raise RuntimeError("no pipeline call was captured in the window")
        return serving_check.merge([
            serving_check.check_call(self.sys, rec, nx, substitute)
            for rec in self.captured])
