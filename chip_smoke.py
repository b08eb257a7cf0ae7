#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; there is no CPU fallback):

a. device and build: require CUDA, print the card's name and power limit
   (``nvidia-smi``), build the CUDA kernels from ``alink_tpu_torch/csrc``;
b. each kernel against its plain PyTorch version on the card at the
   serving path's shapes, with max |diff| and CUDA-event times of both;
c. the slice at full width with seeded random weights: ArcFace r100 (bf16)
   behind the MTCNN cascade (typical budgets, open thresholds so every
   budget slot does work), 8 single-image requests through a
   ``MicroBatcher``, then ``Verifier`` pair verification, enrollment,
   identification and the score matrix.  The kernels' launch counters are
   zeroed just before and read just after; the aligned chips and the score
   matrix are then compared with the plain versions on the same tensors;
d. ``FaceModel.process`` faces/s at batch 64 (warm, synchronised): the
   median, min and max of 7 windows, and the main thread's CPU time.
   ``python -m alink_tpu_torch.tools.profile_serving`` breaks it down.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SEED = 0
IMG = 160          # pre-cropped face photos, as the JAX package's bench uses
BATCH = 64


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def maxdiff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|; NaN in both at the same places counts as equal, NaN in
    one only as infinitely far."""
    a, b = a.float(), b.float()
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return float("inf")
    return float(torch.where(nan_a, 0.0, a - b).abs().max())


# K1 against its plain version on the card.  Both round the operands to bf16
# and accumulate in f32, in different orders.  With float data the orders
# disagree in the last bits, and where a hidden value then rounds to bf16 the
# other way the scores differ by up to ~1e-3 once the logits span a few
# units.  So phase (b) feeds dyadic data: integer features and parameters
# that are small integers times 2^-7 or 2^-3, non-zero biases included.
# Every product and partial sum is then exact in f32, both sides round the
# same exact hidden values to bf16, and only the final sigmoid's rounding
# differs.  The output layer is scaled so the scores span most of [0, 1].
K1_LIMIT = 1e-5
# The slice feeds float embeddings (accumulation-order noise, see above).
K1_SLICE_LIMIT = 1e-3


def exact_head(kind: str, g: torch.Generator, dev):
    """The DFW (512, 64) ``SiameseHead`` with dyadic parameters."""
    from alink_tpu_torch.models import SiameseHead

    head = SiameseHead(512, (512, 64), head=kind, generator=g, device=dev)
    # (weight range, bias range, scale) per layer: hidden 0, hidden 1, out.
    spec = ((3, 64, 2.0 ** -7), (3, 32, 2.0 ** -7), (15, 8, 2.0 ** -3))
    with torch.no_grad():
        for lin, (wr, br, s) in zip([*head.hidden, head.out], spec):
            for p, r in ((lin.weight, wr), (lin.bias, br)):
                p.copy_(torch.randint(-r, r + 1, p.shape, generator=g) * s)
    return head


def face_transforms(rng, n: int, dev, jitter: float = 2.0) -> torch.Tensor:
    """Similarity transforms image -> ArcFace template, from seeded
    landmark jitter around a template placed in a 160x160 photo."""
    from alink_tpu_torch.detect.cascade import alignment_transforms
    from alink_tpu_torch.ops.umeyama import arcface_template

    tpl = arcface_template((112, 112)).numpy()
    s = rng.uniform(0.9, 1.5, n)
    th = rng.uniform(-0.35, 0.35, n)
    t = rng.uniform(-10.0, 10.0, (n, 2)) + 80.0
    rot = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                    np.stack([np.sin(th), np.cos(th)], -1)], 1)
    pts = (s[:, None, None] * np.einsum("nij,kj->nki", rot, tpl - 56.0)
           + t[:, None, :] + rng.normal(0.0, jitter, (n, 5, 2)))
    return alignment_transforms(torch.tensor(pts, dtype=torch.float32,
                                             device=dev))


def phase_kernels(dev, g, rng):
    """(b): kernels vs plain versions; returns per-kernel numbers."""
    from alink_tpu_torch.ops import image, pairwise

    # K1: fused pair scorer, the DFW head (512, 64) over 512-d features.
    head = exact_head("softmax", g, dev)
    sig = exact_head("sigmoid", g, dev)
    rows, cols = (torch.randint(-4, 5, (1000, 512), generator=g).float()
                  .to(dev) for _ in range(2))
    k1_err = 0.0
    for name, hd, r, c in (("1000x1000 softmax", head, rows, cols),
                           ("37x53 softmax", head, rows[:37], cols[:53]),
                           ("1000x1000 sigmoid", sig, rows, cols)):
        got = pairwise.score_matrix_kernel(hd, r, c)
        want = pairwise.score_matrix_reference(hd, r, c)
        torch.cuda.synchronize()
        err = maxdiff(got, want)
        q05, q95 = torch.quantile(want.flatten()[:100_000],
                                  torch.tensor([0.05, 0.95], device=dev))
        print(f"K1 pair_score {name}: max|diff| {err:.3e} (limit {K1_LIMIT}),"
              f" plain scores 5-95 % in [{q05:.3f}, {q95:.3f}]", flush=True)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"K1 {name}: bad output")
        check(err <= K1_LIMIT, f"K1 {name}: max|diff| {err} > {K1_LIMIT}")
        check(float(q95 - q05) >= 0.4, f"K1 {name}: scores too narrow to "
              "tell a faulty kernel from a right one")
        k1_err = max(k1_err, err)
    k1_ms = cuda_ms(lambda: pairwise.score_matrix_kernel(head, rows, cols))
    k1_plain = cuda_ms(
        lambda: pairwise.score_matrix_reference(head, rows, cols), iters=5)
    print(f"K1 1000x1000x512 (512, 64): kernel {k1_ms:.4f} ms, plain "
          f"{k1_plain:.4f} ms", flush=True)

    # K2: affine warp, 64 photos 160x160x3 -> 112x112 chips.
    imgs = torch.tensor(rng.uniform(0, 255, (BATCH, IMG, IMG, 3)),
                        dtype=torch.float32, device=dev)
    imgs_u8 = torch.round(imgs).to(torch.uint8)
    Ms = face_transforms(rng, BATCH, dev)
    extreme = torch.tensor([
        [[0.01, 0.0, 50.0], [0.0, 0.01, 50.0]],      # tiny span
        [[3.0, 0.5, 10.0], [-0.4, 2.5, 5.0]],        # giant span
        [[-1.0, 0.0, 150.0], [0.0, -1.0, 140.0]],    # half turn
        [[-1.0, 0.0, 111.0], [0.0, 1.0, 0.0]],       # mirror
        [[1.0, 0.0, 500.0], [0.0, 1.0, -500.0]],     # entirely outside
        [[0.0, 0.0, 56.0], [0.0, 0.0, 60.0]],        # singular: all NaN
        [[1.0, 1.0, 0.0], [1.0, 1.0, 10.0]],         # singular: NaN and inf
    ], device=dev)
    Mx = torch.cat([extreme, Ms[: BATCH - len(extreme)]])
    k2_err = 0.0
    for name, x, M in (("f32 faces", imgs, Ms), ("f32 extreme", imgs, Mx),
                       ("u8 faces", imgs_u8, Ms), ("u8 extreme", imgs_u8, Mx)):
        for border in ("zero", "nearest"):
            for interp in ("linear", "nearest"):
                got = image.affine_warp_batch_kernel(x, M, (112, 112), border,
                                                     interp)
                want = image.affine_warp_batch_reference(x, M, (112, 112),
                                                         border, interp)
                torch.cuda.synchronize()
                err = maxdiff(got, want)
                limit = 1.0 if x.dtype == torch.uint8 else 1e-3
                print(f"K2 affine_warp {name} border={border} "
                      f"interp={interp}: max|diff| {err:.3e} (limit {limit})",
                      flush=True)
                check(got.dtype == x.dtype and got.shape == want.shape,
                      f"K2 {name}: bad output")
                check(err <= limit, f"K2 {name} {border} {interp}: max|diff| "
                      f"{err} > {limit}")
                if x.dtype == torch.float32:
                    k2_err = max(k2_err, err)
    k2_ms = cuda_ms(lambda: image.affine_warp_batch_kernel(imgs, Ms,
                                                           (112, 112)))
    k2_plain = cuda_ms(lambda: image.affine_warp_batch_reference(
        imgs, Ms, (112, 112)))
    print(f"K2 64x160x160x3 -> 112x112 f32: kernel {k2_ms:.4f} ms, plain "
          f"{k2_plain:.4f} ms", flush=True)
    return head, {"pair_score": (k1_err, k1_ms, k1_plain),
                  "affine_warp": (k2_err, k2_ms, k2_plain)}


def phase_slice(dev, g, rng, head):
    """(c): the serving path at full width; returns (fm, launch counts)."""
    from alink_tpu_torch.detect import (CascadeConfig, FaceModel,
                                        init_cascade_params)
    from alink_tpu_torch.detect.cascade import alignment_transforms
    from alink_tpu_torch.models import ArcFaceResNet100
    from alink_tpu_torch.ops import image, pairwise
    from alink_tpu_torch.serving import MicroBatcher, Verifier

    t0 = time.perf_counter()
    fm = FaceModel(ArcFaceResNet100(generator=g, device=dev),
                   init_cascade_params(g, device=dev),
                   CascadeConfig.typical(thresholds=(0.0, 0.0, 0.0)))
    photos = rng.uniform(0, 255, (256, IMG, IMG, 3)).astype(np.float32)
    print(f"slice: r100 + cascade built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    kernels = (pairwise.score_matrix_kernel, image.affine_warp_batch_kernel)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with MicroBatcher(fm.process, max_batch=8, max_delay_s=0.05) as mb:
        futs = [None] * 8

        def ask(i):
            futs[i] = mb.submit(photos[i])

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        answers = [f.result(timeout=300) for f in futs]
    verifier = Verifier(fm.process, head)
    pairs = verifier.verify_pairs(photos[:32], photos[32:64])
    verifier.enroll(photos[:128], list(range(128)))
    labels, top = verifier.identify(photos[128:160], k=5)
    grid = verifier.score_matrix(photos[:256])
    torch.cuda.synchronize()
    counts = {"pair_score": pairwise.score_matrix_kernel.launches,
              "affine_warp": image.affine_warp_batch_kernel.launches}
    print(f"slice: requests + verify/enroll/identify/score_matrix in "
          f"{time.perf_counter() - t0:.1f} s; launches {counts}", flush=True)

    for a in answers:
        check(a.shape == (512,) and bool(torch.isfinite(a).all()),
              "request answer: bad embedding")
        check(abs(float(a.norm()) - 1.0) < 1e-3, "embedding not unit norm")
    check(pairs.shape == (32,) and bool(((pairs >= 0) & (pairs <= 1)).all()),
          "verify_pairs: scores outside [0, 1]")
    check(len(labels) == 32 and all(len(r) == 5 for r in labels)
          and top.shape == (32, 5) and np.isfinite(top).all()
          and bool((np.diff(top, axis=1) <= 0).all()), "identify: bad top-k")
    check(grid.shape == (256, 256) and bool(torch.isfinite(grid).all())
          and bool(((grid >= 0) & (grid <= 1)).all()), "score_matrix: bad grid")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched by the serving path")

    # identify's top-1 against the argmax of the probe x gallery scores.
    probes = fm.process(photos[128:160])
    pg = pairwise.score_matrix(head, probes, verifier._gallery_feats)
    best = pg.max(dim=1).values
    picked = pg[torch.arange(32, device=dev),
                torch.tensor([r[0] for r in labels], device=dev)]
    check(bool(torch.all(picked >= best - 1e-6)),
          "identify top-1 disagrees with the score matrix argmax")

    # Kernels on the path against their plain versions, same tensors.
    x = torch.as_tensor(photos[:BATCH], device=dev)
    det = fm.detect(x)
    check(bool(det.valid.any(dim=1).all()), "cascade found no face")
    best_i = torch.argmax(torch.where(det.valid, det.scores, -1.0), dim=1)
    lmk = det.landmarks[torch.arange(BATCH, device=dev), best_i]
    Ms = alignment_transforms(lmk)
    chips_k = image.affine_warp_batch(x, Ms, (112, 112))
    chips_p = image.affine_warp_batch_reference(x, Ms, (112, 112))
    err = maxdiff(chips_k, chips_p)
    print(f"slice: aligned chips kernel vs plain max|diff| {err:.3e}",
          flush=True)
    check(err <= 1e-3, f"aligned chips: max|diff| {err} > 1e-3")
    feats = fm.process(photos[:256])
    err = maxdiff(pairwise.score_matrix(head, feats, feats),
                  pairwise.score_matrix_reference(head, feats, feats))
    print(f"slice: score_matrix kernel vs plain max|diff| {err:.3e} "
          f"(limit {K1_SLICE_LIMIT})", flush=True)
    check(err <= K1_SLICE_LIMIT,
          f"score_matrix: max|diff| {err} > {K1_SLICE_LIMIT}")
    return fm, counts


def phase_speed(fm, x, smi: str) -> None:
    """(d): ``process`` at batch 64, 7 windows of 10 synchronised calls."""
    from alink_tpu_torch.tools.profile_serving import summary, windows

    out = fm.process(x)
    check(bool(torch.isfinite(out).all()), "process: non-finite embeddings")
    ws = windows(lambda: fm.process(x), x.device, n_windows=7, iters=10)
    s = summary(ws)
    print(f"process: {BATCH * 1e3 / s['median_ms']:.1f} faces/s at batch "
          f"{BATCH} (median of 7 windows {s['median_ms']:.2f} ms/batch, min "
          f"{s['min_ms']:.2f}, max {s['max_ms']:.2f}; main-thread CPU "
          f"{s['cpu_median_ms']:.2f} ms/batch), r100 bf16, typical budgets, "
          f"{IMG}x{IMG} input on {smi}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from alink_tpu_torch import _build

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    log = (_build.BUILD_DIR / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print("ptxas:", line.strip(), flush=True)

    g = torch.Generator().manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    head, numbers = phase_kernels(dev, g, rng)
    fm, counts = phase_slice(dev, g, rng, head)

    phase_speed(fm, torch.as_tensor(
        rng.uniform(0, 255, (BATCH, IMG, IMG, 3)), dtype=torch.float32,
        device=dev), smi)

    sources = {"pair_score": ("alink_tpu_torch/csrc/pair_score.cu",
                              "alink_tpu/ops/pairwise.py:134"),
               "affine_warp": ("alink_tpu_torch/csrc/affine_warp.cu",
                               "alink_tpu/ops/image.py:230")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": counts[name],
         "max_abs_err": err, "ms": ms, "plain_ms": plain}
        for name, (err, ms, plain) in numbers.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
