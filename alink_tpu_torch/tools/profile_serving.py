"""Where the time of ``FaceModel.process`` goes, on one CUDA card.

    python -m alink_tpu_torch.tools.profile_serving

Builds the serving slice as ``chip_smoke.py`` does (ArcFace r100 in bf16 with
seeded random weights, the MTCNN cascade with typical budgets and open
thresholds, 160x160 photos, batch 64, seed 0) and prints, one line each:

- ``process`` windows in 3 rounds: each round times windows fresh (or after
  the previous round), after one 256-photo batch, and after
  ``torch.cuda.empty_cache()``.  A window gives the wall ms per batch and
  the main thread's CPU ms per batch (``time.thread_time``): when the two
  are close the host thread that issues the kernels sets the pace;
- the median ms per batch of each stage: cascade stages 1-3, detect, align
  (umeyama + the warp kernel), embed, and process end to end;
- the device's busy ms per batch from ``torch.profiler`` (the union of the
  kernels' device intervals) and the idle share it leaves of the median
  wall time;

and last one JSON object with all of it.  Numbers are the card's own;
print them with the card's name and power limit (the first line).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from alink_tpu_torch.detect import cascade

BATCH = 64
ROUNDS = 3
SEED = 0

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def windows(fn, dev: torch.device, n_windows: int = 3,
            iters: int = 10) -> list[tuple[float, float]]:
    """(wall ms, main-thread CPU ms) per call of ``fn``, one pair per window
    of ``iters`` synchronised calls, after one warm call."""
    fn()
    out = []
    for _ in range(n_windows):
        _sync(dev)
        t0, c0 = time.perf_counter(), time.thread_time()
        for _ in range(iters):
            fn()
        _sync(dev)
        out.append(((time.perf_counter() - t0) * 1e3 / iters,
                    (time.thread_time() - c0) * 1e3 / iters))
    return out


def summary(ws: list[tuple[float, float]]) -> dict[str, float]:
    """Median, min and max wall ms and the median CPU ms of ``windows``."""
    wall = [w for w, _ in ws]
    return {"median_ms": statistics.median(wall), "min_ms": min(wall),
            "max_ms": max(wall),
            "cpu_median_ms": statistics.median(c for _, c in ws)}


@torch.no_grad()
def stage_breakdown(fm, x: torch.Tensor, n_windows: int = 3,
                    iters: int = 5) -> dict[str, float]:
    """Median wall ms per batch of each stage of ``fm.process(x)``."""
    p, cfg = fm.cascade_params, fm.cfg
    b1, _, v1 = cascade._stage1(p, x, cfg)
    b2, _, v2 = cascade._stage2(p, x, b1, v1, cfg)
    lmk = cascade.detect_faces(p, x, cfg).landmarks[:, :1]
    chips = cascade.align_faces(x, lmk, cfg.output_size)[:, 0].contiguous()
    stages = {
        "stage1": lambda: cascade._stage1(p, x, cfg),
        "stage2": lambda: cascade._stage2(p, x, b1, v1, cfg),
        "stage3": lambda: cascade._stage3(p, x, b2, v2, cfg),
        "detect": lambda: cascade.detect_faces(p, x, cfg),
        "align": lambda: cascade.align_faces(x, lmk, cfg.output_size),
        "embed": lambda: fm.embedder(chips),
        "process": lambda: fm.process(x),
    }
    return {name: summary(windows(fn, x.device, n_windows, iters))["median_ms"]
            for name, fn in stages.items()}


def device_busy(fn, calls: int = 3) -> tuple[float, float]:
    """(busy ms, kernels) per call of ``fn`` on the card: the union of the
    device intervals of every kernel and copy that ``torch.profiler`` saw."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return busy_us / calls / 1e3, len(spans) / calls


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    from alink_tpu_torch.detect import (CascadeConfig, FaceModel,
                                        init_cascade_params)
    from alink_tpu_torch.models import ArcFaceResNet100

    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA card")
    dev = torch.device("cuda:0")
    card = _card()
    print(card, flush=True)
    g = torch.Generator().manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    fm = FaceModel(ArcFaceResNet100(generator=g, device=dev),
                   init_cascade_params(g, device=dev),
                   CascadeConfig.typical(thresholds=(0.0, 0.0, 0.0)))
    x = torch.as_tensor(rng.uniform(0, 255, (BATCH, 160, 160, 3)),
                        dtype=torch.float32, device=dev)
    photos = rng.uniform(0, 255, (256, 160, 160, 3)).astype(np.float32)

    def process():
        fm.process(x)

    report: dict = {"card": card, "batch": BATCH,
                    "host_cpus": len(os.sched_getaffinity(0)), "windows": []}

    def record(label: str) -> None:
        ws = windows(process, dev)
        report["windows"].append({
            "label": label, "wall_ms": [w for w, _ in ws],
            "cpu_ms": [c for _, c in ws],
            "reserved_gb": torch.cuda.memory_reserved(dev) / 1e9,
            "loadavg_1m": os.getloadavg()[0]})
        print(f"process {label}: wall "
              f"{', '.join(f'{w:.2f}' for w, _ in ws)} ms/batch, main-thread "
              f"CPU {', '.join(f'{c:.2f}' for _, c in ws)} ms/batch, "
              f"reserved {report['windows'][-1]['reserved_gb']:.2f} GB, "
              f"load {report['windows'][-1]['loadavg_1m']:.2f}", flush=True)

    for r in range(ROUNDS):
        record("fresh" if r == 0 else f"round {r + 1} start")
        fm.process(photos)
        _sync(dev)
        record(f"round {r + 1} after a 256-photo batch")
        torch.cuda.empty_cache()
        record(f"round {r + 1} after empty_cache")

    report["stages_ms"] = stage_breakdown(fm, x)
    print("stages ms/batch: " + ", ".join(
        f"{k} {v:.2f}" for k, v in report["stages_ms"].items()), flush=True)
    busy, kernels = device_busy(process)
    wall = statistics.median(w for win in report["windows"]
                             for w in win["wall_ms"])
    report.update(device_busy_ms=busy, kernels_per_batch=kernels,
                  process_median_ms=wall, idle_share=1.0 - busy / wall)
    print(f"device busy {busy:.2f} ms/batch over {kernels:.0f} kernels; "
          f"idle {100 * (1 - busy / wall):.1f} % of the median "
          f"{wall:.2f} ms/batch", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
