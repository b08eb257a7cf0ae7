"""Where the A-LINK training path spends its time on the card.

    python -m alink_tpu_torch.tools.profile_alink      # ~1 min on one H100

Prints (last line JSON):

- featurize (VGGFace-ResNet50, 224x224, bf16, random weights) at batch 128:
  wall ms per batch over windows of synchronised calls, the device's busy
  time and idle share (``torch.profiler``), and its device time split into
  kernel K3, cuDNN convolutions and everything else;
- one loop chunk of 64 pairs split into its steps: the committee's
  features of the clean pairs, the four-channel noise bank, the student's
  features of the noisy pairs, and the student's scores;
- the adversarial channels' steps: the one-pixel DE attack on 16 pairs
  (pixel_count 40, popsize 250, maxiter cut to 2) with its generations,
  s per generation, nfev and K3 launches, and FGSM on 64 pairs (forward
  plus backward through K3) in ms with its K3 launches.
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch

from alink_tpu_torch.tools.profile_serving import (_card, _sync,
                                                   device_busy, summary,
                                                   windows)

SEED = 0
BATCH = 128
CHUNK = 64
NOISE = ("gaussian", "saltpepper", "poisson", "speckle")
A2_DE_PAIRS = 16
A2_DE_MAXITER = 2     # the attack's default is 50


def chunk_breakdown(featurize, committee, head, left: torch.Tensor,
                    right: torch.Tensor, g: torch.Generator,
                    n_windows: int = 3, iters: int = 3) -> dict[str, float]:
    """Median wall ms of each step of one ``ALinkLoop`` chunk on the raw
    pairs ``left``/``right`` (N, H, W, 3) f32."""
    from alink_tpu_torch.ops.pairwise import pair_scores

    dev = left.device
    res = tuple(left.shape[1:3])
    noisy = committee.attack_model(g, left, right, res)
    flat = [t.reshape((-1,) + t.shape[2:]) for t in noisy]
    sl, sr = featurize(flat[0]), featurize(flat[1])
    steps = {
        "committee_features": lambda: committee.predict(featurize(left),
                                                        featurize(right)),
        "noise_bank": lambda: committee.attack_model(g, left, right, res),
        "student_features": lambda: (featurize(flat[0]), featurize(flat[1])),
        "student_scores": lambda: pair_scores(head, sl, sr),
    }
    with torch.no_grad():
        return {k: summary(windows(fn, dev, n_windows, iters))["median_ms"]
                for k, fn in steps.items()}


def a2_breakdown(predict, params, left: torch.Tensor, right: torch.Tensor,
                 labels: torch.Tensor, g: torch.Generator,
                 de_pairs: int = A2_DE_PAIRS,
                 maxiter: int = A2_DE_MAXITER, **de_kw) -> dict[str, float]:
    """The adversarial channels of one chunk: the one-pixel DE attack on the
    first ``de_pairs`` pairs (wall time of its init and of each generation,
    read from the solver's ``de.init`` and ``de.generation`` spans under a
    host profiler, generations from its ``de.generations`` counter, nfev,
    K3 launches) and FGSM on all pairs (ms, K3 launches), each run once
    after a warm-up FGSM call.  ``predict`` is the student end to end
    (``drivers.alink.make_adversarial_predict``)."""
    from torch.profiler import ProfilerActivity, profile

    from alink_tpu_torch.ops import attack
    from alink_tpu_torch.utils.profiling import SPAN_PREFIX, counting

    dev = left.device
    attack.fgsm_pairs(predict, params, left, right, labels)
    out: dict[str, float] = {}
    _sync(dev)
    with counting() as de, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            attack.one_pixel_attack_pairs(
                predict, params, left[:de_pairs], right[:de_pairs],
                labels[:de_pairs], g, maxiter=maxiter, **de_kw)
        _sync(dev)
        t1 = time.perf_counter()
    spans = {"de.init": [], "de.generation": []}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        name = e.name[len(SPAN_PREFIX):]
        if e.name.startswith(SPAN_PREFIX) and name in spans:
            spans[name].append(
                (e.time_range.end - e.time_range.start) * 1e-6)
    out.update(de_pairs=de_pairs, de_s=t1 - t0,
               de_init_s=spans["de.init"][0],
               de_generations=de["de.generations"],
               de_s_per_generation=spans["de.generation"],
               de_k3_launches=de["launches.k3"])
    _sync(dev)
    with counting() as fgsm:
        t0 = time.perf_counter()
        attack.fgsm_pairs(predict, params, left, right, labels)
        _sync(dev)
        t1 = time.perf_counter()
    out.update(fgsm_pairs=left.shape[0], fgsm_ms=(t1 - t0) * 1e3,
               fgsm_k3_launches=fgsm["launches.k3"])
    return out


def device_split(fn, calls: int = 3) -> dict[str, float]:
    """Device ms per call of ``fn`` by kernel family (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {"bottleneck (K3)": 0.0, "cudnn conv": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        name = ev.key.lower()
        if "bottleneck_kernel" in name:
            out["bottleneck (K3)"] += us
        elif any(s in name for s in ("conv", "cudnn", "xmma", "implicit")):
            out["cudnn conv"] += us
        else:
            out["other"] += us
    return {k: v / calls / 1e3 for k, v in out.items()}


def main() -> int:
    from alink_tpu_torch.active.committee import Committee
    from alink_tpu_torch.drivers.common import make_resnet50_featurizer
    from alink_tpu_torch.models import SiameseHead

    if not torch.cuda.is_available():
        raise SystemExit("profile_alink needs a CUDA card")
    dev = torch.device("cuda:0")
    card = _card()
    print(card, flush=True)
    featurize, _ = make_resnet50_featurizer(
        torch.Generator().manual_seed(SEED), device=dev)
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.uniform(0, 255, (BATCH, 224, 224, 3)),
                        dtype=torch.float32, device=dev)
    report: dict = {"card": card, "batch": BATCH}
    with torch.no_grad():
        ws = windows(lambda: featurize(x), dev, n_windows=7, iters=5)
        report["featurize_ms"] = summary(ws)
        wall = statistics.median(w for w, _ in ws)
        busy, kernels = device_busy(lambda: featurize(x))
        report.update(device_busy_ms=busy, kernels_per_batch=kernels,
                      idle_share=1.0 - busy / wall,
                      device_split_ms=device_split(lambda: featurize(x)))
    print(f"featurize batch {BATCH}: {BATCH * 1e3 / wall:.1f} images/s, "
          f"median {wall:.2f} ms/batch; device busy {busy:.2f} ms over "
          f"{kernels:.0f} kernels (idle {100 * (1 - busy / wall):.1f} %); "
          "device ms " + ", ".join(
              f"{k} {v:.2f}" for k, v in report["device_split_ms"].items()),
          flush=True)

    g = torch.Generator().manual_seed(SEED)
    heads = [SiameseHead(2048, generator=g, device=dev) for _ in range(2)]
    committee = Committee.from_param_list(
        heads[0], [h.state_dict() for h in heads], NOISE)
    pool = torch.as_tensor(rng.integers(0, 256, (2 * CHUNK, 224, 224, 3)),
                           dtype=torch.float32, device=dev)
    report["chunk_ms"] = chunk_breakdown(
        featurize, committee, heads[1], pool[:CHUNK], pool[CHUNK:],
        torch.Generator(dev).manual_seed(SEED))
    _sync(dev)
    print(f"chunk of {CHUNK} pairs, ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in report["chunk_ms"].items()), flush=True)

    from alink_tpu_torch.drivers.alink import make_adversarial_predict

    labels = torch.nn.functional.one_hot(torch.as_tensor(
        rng.integers(0, 2, CHUNK), device=dev), 2).float()
    a2 = a2_breakdown(make_adversarial_predict(featurize), heads[1],
                      pool[:CHUNK], pool[CHUNK:], labels,
                      torch.Generator(dev).manual_seed(SEED))
    report["a2"] = a2
    print(f"one-pixel DE on {a2['de_pairs']} pairs (maxiter cut 50 -> "
          f"{A2_DE_MAXITER}): {a2['de_s']:.3f} s, init {a2['de_init_s']:.3f} "
          f"s, {a2['de_generations']} generations at "
          + ", ".join(f"{v:.3f}" for v in a2["de_s_per_generation"])
          + f" s, K3 launches {a2['de_k3_launches']}; FGSM on "
          f"{a2['fgsm_pairs']} pairs {a2['fgsm_ms']:.2f} ms, K3 launches "
          f"{a2['fgsm_k3_launches']}", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
