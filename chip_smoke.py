#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths, the A2 channel, the
int8 conv, the DFW evaluation chain, the loop's resume, supervision and
augmentation, the rest of detect and serving, the ArcFace driver, the
Multi-PIE driver with the classical-AL baselines, the identification
classifiers with the weight tools, and the parallel layer once on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; there is no CPU fallback):

a. device and build: require CUDA, print the card's name and power limit
   (``nvidia-smi``), build the CUDA kernels from ``alink_tpu_torch/csrc``;
b. K1 and K2 against their plain PyTorch versions on the card: K1 on
   dyadic data (limit 1e-5) at D 512 and 2,048 under heads (512, 64) and
   (128, 32), softmax and sigmoid, at H1 1,024, on ragged grids, and under
   the wide heads (512, 512) and (1024, 320) (a launch per 256 H2 columns,
   timed beside their bound); K2 in 24 border / interpolation / dtype
   (f32, uint8, bf16) / extreme-transform cases; with
   CUDA-event times of both (the kernel's as device time,
   ``bench_kernels.graph_ms``, whose capture is checked to have run the
   kernel, and per call from Python), K1 at 1000 x 1000 pairs of 512-d and
   of 2,048-d features;
c. the slice at full width with seeded random weights: ArcFace r100 (bf16)
   behind the MTCNN cascade (typical budgets, open thresholds so every
   budget slot does work), 8 single-image requests through a
   ``MicroBatcher``, then ``Verifier`` pair verification, enrollment,
   identification and the score matrix.  The kernels' launch counters are
   zeroed just before and read just after; the aligned chips and the score
   matrix are then compared with the plain versions on the same tensors;
d. ``FaceModel.process`` faces/s at batch 64 (warm, synchronised): the
   median, min and max of 7 windows, and the main thread's CPU time.
   ``python -m alink_tpu_torch.tools.profile_serving`` breaks it down;
e. K3 (fused stride-1 bottleneck) against its plain version at the five
   stride-1 block shapes of VGGFace-ResNet50 at 224x224, at batch 32, 64
   and 256 (each launch setup the paths use: clusters of 4 and of 2 at
   7x7, persistent blocks, one block per tile): on dyadic data (exact,
   limit 1e-6) and float data (relative 1e-2), and a chain of two blocks
   at widths the kernel runs zero-padded (32 -> 80 -> 200, 200 -> 48 ->
   200; dyadic, exact), and at Cm 576 and 1,024 (y1 and y2 in global
   scratch): each block exact on dyadic data, a two-block chain held to
   the float limit and timed; then
   the device time of the launch alone (``bench_kernels.graph_ms``: calls
   captured in a CUDA graph and replayed; the time per call from Python
   beside it) per shape and over the 13 blocks of one forward at batch 32
   and 256, beside the same block as an unfused bf16 cuDNN sequence (a
   yardstick only), with TFLOP/s;
f. the A-LINK training slice at full width: ``run_alink`` (synthetic DFW
   tree, VGGFace-ResNet50 (3, 4, 6, 3) bf16 with seeded random weights,
   ``SiameseHead`` (512, 64), the default noise bank without "adversarial",
   which phase (g) runs)
   with the counters zeroed just before and read just after (K3 must have
   run); then ``test_accuracy`` of the student over the plain features,
   with K1's counter zeroed just before and read just after.  Epochs,
   steps and people are cut (each cut is printed).  Then the featurizer
   with K3 against the same model with K3's plain version on 64 faces, and
   featurize images/s at batch 128 (7 windows);
g. the A2 channel at full width (VGGFace-ResNet50 (3, 4, 6, 3) 224x224 bf16
   with K3, ``SiameseHead`` (512, 64), random weights from the seed): the
   one-pixel DE attack on 8 pairs (pixel_count 40, popsize 250, maxiter cut
   to 3: at most 40 pixels change per pair, a pixel written once holds an
   integer in [0, 255], a pair that stopped early reaches its target; s per
   generation, nfev, K3 launches); FGSM on 32 pairs (ms), with K3's
   backward held block by block to the autograd of its plain arithmetic at
   the FGSM pass's inputs and upstream gradients (relative L2 2e-2, signs
   of the components above 1e-3 of the largest); one ``ALinkLoop``
   iteration with the default five-channel bank, built as ``run_alink``
   builds it (slab and maxiter cut), with its per-phase timings;
h. K4 (int8 3x3 conv on the flat layout) on its op path at the five
   LResNet100E-II stage shapes of ``benchmarks/bench_qconv.py``, batch 64,
   and a conv -> prelu_quant -> add_lead -> conv chain, with its counter
   zeroed just before and read just after; then the kernel on operands
   packed once (``pack_conv``) against its plain version (max |diff| 0 on
   bf16 and int8 outputs, relative 1e-5 on f32); the launch alone (device
   time, ``graph_ms``, and per call from Python), the op path call
   (packing included), plain and bf16 ``F.conv2d`` (``graph_ms``) ms,
   useful TOPS and the bound of the unpadded problem (Cin and Cout as they
   are, pixel rows only);
i. the DFW evaluation chain: ``tools.evaluate --prefix`` on a synthetic
   DFW test protocol at 224^2 (1,029 faces; DFW's list has 7,771) with
   VGGFace-ResNet50 and ``SiameseHead`` (512, 64), K1's and K3's counters
   zeroed just before and read just after, the grid held to the plain
   version; the DFW-size evaluation (7,770^2 x 2,048 grid, split + sweep
   and stats of the three ROC cases) timed by step as "DFW evaluation s";
   ``eval_regression`` on ``EVAL_r05.json``'s protocol with its stage
   AUC / EER and 15 ordering flags beside the file's (a flag that differs
   is reported, not hidden);
j. resume, restart and augment at full width, with (f)'s configuration and
   cuts (the M2 and committee that (f) saved loaded in every run):
   ``run_alink(augment=True, loop_checkpoint=A)`` with K2's and K3's
   counters zeroed just before and read just after (K2 six launches per
   finetune: 3 variants x 2 halves); the same run with ``max_restarts=1``
   and a RuntimeError injected into its second slab once that slab's
   finetune has trained M2 in place and moved both generators, whose end
   (counters, logs, M2 and optimizer state) must equal the first run's bit
   for bit;
   K2 against its plain version at augment's own shape (the first
   finetune's queried pairs, (q, 224, 224, 3) f32, nearest/nearest, max
   |diff| 0) and timed beside its bound; ``custom_train`` through a
   ``DevicePrefetcher`` (pinned host batches copied on a side stream) bit-
   equal to the same loop over the batches fed directly;
k. the rest of detect and serving, and the ArcFace driver, with (c)'s
   photos and batch and open thresholds: ``crowd()`` with totals that
   cover every candidate against ``worst_case()`` on f32 towers (valid
   equal, boxes and landmarks within 1e-3 px); the default ``crowd()``
   over budget, its stage-2 pool against a plain stable sort of the
   stage-1 scores, and ``crop_and_resize_gather``'s time and peak memory
   at that pool; ``FaceModel.process`` faces/s under ``typical()``,
   ``worst_case()`` and ``crowd()`` (7 windows) with K2's launches;
   ``accurate_landmark`` (every refined landmark inside its patch, K2's
   chips of them against the plain warp); ``detect_faces_limited`` from
   stage-1 boxes against ``detect_faces``; ``profile_cascade`` against the
   stages' valid sums and ``calibrate_budgets`` in smoke mode;
   ``GenderAgeResNet50`` on 64 aligned chips (ms, decoded ranges);
   ``Verifier.score_matrix`` over crowd-profile embeddings against K1's
   plain version (2e-2), K1 counted; then ``drivers.alink_arc``'s path at
   full width (ArcFace r100 (3, 13, 30, 3) 112^2 bf16, 512-d,
   ``SiameseHead`` (512, 64), the six-channel bank with perlin and the
   one-pixel DE; people, slabs and maxiter cut, each cut printed) with s
   per iteration and its split, DE on 8 pairs and FGSM on 32 through
   ArcFace.

l. the Multi-PIE cross-resolution path at full width:
   ``drivers.alink_mtp.run_alink_mtp`` on a synthetic Multi-PIE tree
   (VGGFace-ResNet50 (3, 4, 6, 3) 224^2 bf16 teacher on K3, ``SmallRes
   (2048)`` at 48^2 with dropout, ``SiameseHead`` (512, 64) committee,
   the adversarial-only bank; subjects, epochs, steps, slabs, queue and
   maxiter cut, each cut printed) with K3 counted, SmallRes pretraining
   ms/step, the loop iteration and its split; the top-1 tail again with
   K1 counted and timed, its grid against K1's plain version on the same
   embeddings (2e-2); SmallRes on the card against its f32 copy on the
   CPU (relative 2e-2); one dropout step's masks (keep share 0.75 +/-
   0.02, multipliers 0 and 1/0.75); one-pixel DE images/s at 48^2; then
   ``existing_al`` (DFW, K3 counted) and ``existing_al_mtp``, 2 rounds
   each, s/round.

m. the side models and the identification classifiers at full width:
   ``SENet50`` and ``VGGFace16`` at 224^2, bf16, batch 32 (random weights
   from the seed) against f32 copies of the same weights on the card
   (relative L2 2e-2, the relative max printed), images/s; a trainable VGGFace-ResNet50's K3
   launches per training forward (13) and, block by block at the inputs
   and upstream gradients of a training pass, every conv weight's and BN
   tensor's gradient through ``BottleneckS1`` (K3 forward, f32 recompute
   backward) against the plain chain's autograd (relative L2 2e-2);
   ``fit_classifier`` on ResNet50Classifier (K3 counted: 13 per forward),
   SENet50Classifier and VGG16Classifier (hid 512) at 224^2 bf16 batch 32
   and SmallResClassifier at 48^2 with dropout, out_dim 1,000, on 256
   synthetic class-separable images (the cuts printed): train step ms
   first and warm, images/s, every loss finite, every BN statistic of
   ResNet50Classifier moved; then a seeded r100-shaped MXNet ``.params``
   file through ``tools.convert_mxnet`` into ``ArcFaceResNet100``
   (strict), 64 chips embedded to finite unit-norm (1e-3) vectors.

n. the parallel layer at full width in a world-1 NCCL group (one card:
   NCCL refuses two ranks on one GPU): ``create_mesh()`` is 1 x 1;
   ``sharded_featurize`` over VGGFace-ResNet50 (3, 4, 6, 3) 224^2 bf16 on
   128 faces (K3 counted: 13), ``sharded_face_pipeline`` over r100
   ``typical`` on 64 photos of 160^2 (K2 counted),
   ``sharded_committee_probs`` (5 heads (512, 64), 1,024 pairs of 2,048-d
   features), ``score_matrix_sharded`` at 1000 x 1000 x 512 and
   ``Verifier(mesh=).score_matrix`` (K1 counted: 2), ``arcface_tp_apply``
   at model 1 (r100 bf16, 64 chips), each against its unsharded call on
   the same tensors (max |diff| 0; the committee 1e-6) and timed beside
   it (median of 7 synchronised windows, the two taking turns);
   ``DevicePrefetcher(sharding=batch_sharding(mesh, 4))`` landing its
   batches on cuda:0; then, on the host CPU, a spawned 2-rank gloo world
   running TP and PP (2 microbatches) of the full-depth r100 in f32 at
   batch 4, held to the local f32 forward within 5e-5.

The second-to-last line is a JSON object with one entry per kernel (its
device time ``ms`` and time per call from Python ``call_ms``, its bound
from the shapes, the card's peaks and memory rate); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

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
    """Mean milliseconds per call from CUDA events around back-to-back
    calls (``bench_kernels.cuda_ms``: windows of at least 25 ms)."""
    from alink_tpu_torch.tools.bench_kernels import cuda_ms as timed

    return timed(fn, iters, warmup)


def graph_ms(fn) -> float:
    """Device milliseconds per call of a library call (``bench_kernels.
    graph_ms``: calls captured in a CUDA graph and replayed, the host's
    work not timed, the replay held to an eager call)."""
    from alink_tpu_torch.tools.bench_kernels import graph_ms as timed

    return timed(fn, exact=False)


def kernel_ms(fn, counter, per_call: int = 1) -> tuple[float, float]:
    """A kernel wrapper's device ms per call and ms per call from Python
    (``bench_kernels.kernel_ms``: the capture must launch the kernel
    ``per_call`` times a call and the replay recompute its output)."""
    from alink_tpu_torch.tools.bench_kernels import kernel_ms as timed

    return timed(fn, counter, per_call=per_call)


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
# units.  So phase (b) feeds dyadic data: integer features in [-4, 4] and
# parameters that are small integers times a power of two, non-zero biases
# included.  The hidden layers' scales shrink with their fan-in (2^-7 at 512,
# 2^-8 at 2,048), which keeps every product and partial sum exact in f32 at
# D 2,048 and H1 1,024 (checked against f64 on the CPU), so both sides round
# the same exact hidden values to bf16 and only the final sigmoid's rounding
# differs.  The output bias is then set on the same grid to centre the
# logits, and the output layer scaled so the scores span most of [0, 1].
K1_LIMIT = 1e-5
# The slice feeds float embeddings (accumulation-order noise, see above).
K1_SLICE_LIMIT = 1e-3
# Phase (i) feeds VGGFace-ResNet50's random-weight features, 2,048-d and
# unnormalised: the logits span far more than the embeddings', so a hidden
# value that rounds to the other bf16 moves a score further.  Held to the
# JAX package's bound for its kernel against XLA on float features
# (tests/test_pairwise.py:59), with the share of pairs past 1e-3 printed.
K1_FLOAT_LIMIT = 2e-2
# (rows, cols, D, head widths, head kind): the serving grid (D 512) and the
# training one (D 2,048) under the DFW head (512, 64) and the SmallRes-sized
# head (128, 32), softmax and sigmoid; an H1 above 512 (passes of 256);
# ragged grids (D 98: the wrapper pads the features to a multiple of 4);
# the eval_regression stage grid (168^2 at D 64: a single slab of D).
K1_CASES = ((1000, 1000, 512, (512, 64), "softmax"),
            (1000, 1000, 512, (512, 64), "sigmoid"),
            (1000, 1000, 512, (128, 32), "softmax"),
            (1000, 1000, 512, (128, 32), "sigmoid"),
            (1000, 1000, 2048, (512, 64), "softmax"),
            (1000, 1000, 2048, (512, 64), "sigmoid"),
            (1000, 1000, 2048, (128, 32), "softmax"),
            (1000, 1000, 2048, (128, 32), "sigmoid"),
            (300, 300, 2048, (1024, 64), "softmax"),
            (37, 53, 100, (512, 64), "softmax"),
            (37, 53, 100, (128, 32), "sigmoid"),
            (37, 53, 98, (128, 32), "softmax"),
            (168, 168, 64, (512, 64), "softmax"))
# Shapes timed: the serving and the training grid under the DFW head.
K1_TIMED = ((1000, 1000, 512), (1000, 1000, 2048))
# Heads wider than 256 in H2 run as a launch per chunk of 256 columns (the
# chunks' logit differences summed in the output): dyadic data at D 2,048,
# held to the same limit, then timed.
K1_WIDE = ((1000, 1000, 2048, (512, 512), "softmax"),
           (1000, 1000, 2048, (1024, 320), "sigmoid"))
# K2 on bf16 photos: taps and blend in f32 on both sides with the same
# roundings, one rounding to bf16 on the store; held within one bf16 step
# at the top of the 0-255 range (1.0 between 128 and 256).
K2_BF16_LIMIT = 1.0


def exact_head(kind: str, g: torch.Generator, dev, d: int = 512,
               widths: tuple[int, int] = (512, 64), rows=None, cols=None):
    """A ``SiameseHead`` with dyadic parameters (see above); with sample
    features ``rows``/``cols``, its output bias centres their logits."""
    from alink_tpu_torch.models import SiameseHead
    from alink_tpu_torch.ops import pairwise

    head = SiameseHead(d, widths, head=kind, generator=g, device=dev)
    k1 = 7 + round(np.log2(d / 512) / 2)
    k2 = 7 + round(np.log2(widths[0] / 512) / 2)
    # The output layer's scale grows with H2 past 64, so the scores keep
    # spanning [0, 1].
    k3 = (3 if widths[1] >= 64 else 2) + max(
        0, round(np.log2(widths[1] / 64) / 2))
    # (weight range, bias range, scale) per layer: hidden 0, hidden 1, out.
    spec = ((3, 64, 2.0 ** -k1), (3, 32, 2.0 ** -k2), (15, 8, 2.0 ** -k3))
    with torch.no_grad():
        for lin, (wr, br, s) in zip([*head.hidden, head.out], spec):
            for p, r in ((lin.weight, wr), (lin.bias, br)):
                p.copy_(torch.randint(-r, r + 1, p.shape, generator=g) * s)
        if rows is not None:
            z = torch.special.logit(pairwise.score_matrix_reference(
                head, rows, cols).double())
            head.out.bias[-1] -= float(torch.round(torch.median(z) * 2 ** k3)
                                       * 2.0 ** -k3)
    return head


@torch.no_grad()
def k1_vs_f64(head, rows, cols, got, plain) -> dict:
    """How far K1's scores ``got``, the plain version's ``plain`` (f32 sums
    on the CUDA cores) and the plain version on the tensor cores (TF32
    products: exact for its bf16 operands, the sums in the tensor cores'
    f32 adders, as the kernel's) lie from two float64 evaluations of the
    head on ``rows`` x ``cols``: ``exact`` (no rounding at all) and
    ``rounded`` (operands and hidden values rounded to bf16 where every
    side rounds them, the sums in f64: what all three approximate, so only
    their f32 sums and the bf16 roundings those flip remain).  Max and mean
    |diff| of each side."""
    from alink_tpu_torch.ops import pairwise

    layers = pairwise.head_weights(head)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tensor_cores = pairwise.score_matrix_reference(head, rows, cols)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    def bf(x):
        return x.to(torch.bfloat16).double()

    def run(x, rnd):
        x = x.double()
        for w, b in layers[:-1]:
            w = bf(w.float()) if rnd else w.double()
            x = torch.relu((bf(x) if rnd else x) @ w + b.double())
        wo, bo = layers[-1]
        wo = bf(wo.float()) if rnd else wo.double()
        z = (bf(x) if rnd else x) @ wo + bo.double()
        return torch.sigmoid(z[..., 1] - z[..., 0])

    rb = max(1, (1 << 25) // (cols.shape[0] * cols.shape[1]))
    out = {}
    for rnd in (False, True):
        ref = torch.cat([run(torch.abs(rows[i:i + rb, None].float()
                                       - cols[None].float()), rnd)
                         for i in range(0, rows.shape[0], rb)])
        for side, s in (("kernel", got), ("plain", plain),
                        ("plain on tensor cores", tensor_cores)):
            d = (s.double() - ref).abs()
            out[(side, "rounded" if rnd else "exact")] = (float(d.max()),
                                                          float(d.mean()))
    return out


def f64_line(dist: dict) -> str:
    return "; ".join(f"{side} vs f64 {ref} max {mx:.3e} mean {mn:.3e}"
                     for (side, ref), (mx, mn) in dist.items())


def f64_check(dist: dict, name: str) -> None:
    """K1 as close to the exact f64 answer as the plain version (max and
    mean within 10 %), and on average no further from the rounded f64
    answer than twice the plain version on the same tensor cores."""
    for i, what in ((0, "max"), (1, "mean")):
        k, p = dist[("kernel", "exact")][i], dist[("plain", "exact")][i]
        check(k <= 1.1 * p, f"{name}: kernel's {what} |diff| from f64 "
              f"{k:.3e} > 1.1 x the plain version's {p:.3e}")
    k = dist[("kernel", "rounded")][1]
    p = dist[("plain on tensor cores", "rounded")][1]
    check(k <= 2 * p + 1e-6, f"{name}: kernel's mean |diff| from rounded "
          f"f64 {k:.3e} > twice the plain version's on tensor cores {p:.3e}")


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

    # K1: fused pair scorer on dyadic data at every case, then its device
    # time under the DFW head (512, 64) at the serving and training grids.
    feats = {}
    k1_err = 0.0
    for n, m, d, widths, kind in K1_CASES:
        if d not in feats:
            feats[d] = tuple(torch.randint(-4, 5, (1000, d), generator=g)
                             .float().to(dev) for _ in range(2))
        rows, cols = feats[d][0][:n], feats[d][1][:m]
        hd = exact_head(kind, g, dev, d, widths, rows[:64], cols[:64])
        name = f"{n}x{m}x{d} {widths} {kind}"
        got = pairwise.score_matrix_kernel(hd, rows, cols)
        want = pairwise.score_matrix_reference(hd, rows, cols)
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
    k1_t = {}
    for n, m, d in K1_TIMED:
        hd = exact_head("softmax", g, dev, d)
        rows, cols = feats[d][0][:n], feats[d][1][:m]
        ms, call = kernel_ms(
            lambda: pairwise.score_matrix_kernel(hd, rows, cols),
            pairwise.score_matrix_kernel)
        plain = cuda_ms(
            lambda: pairwise.score_matrix_reference(hd, rows, cols), iters=3)
        ops = n * m * (d + 2 * d * 512 + 2 * 512 * 64 + 2 * 64 * 2)
        nbytes = 4 * (n * d + m * d + n * m) + 2 * (d * 512 + 512 * 64 + 128)
        k1_t[d] = (ms, call, plain, ops, nbytes)
        tf = ops / ms / 1e9
        print(f"K1 {n}x{m}x{d} (512, 64): kernel {ms:.4f} ms ({call:.4f} per "
              f"call from Python), plain {plain:.4f} ms, {tf:.1f} TFLOP/s "
              f"({100 * tf / H100_BF16_TFLOPS:.1f} % of "
              f"{H100_BF16_TFLOPS:.0f} dense bf16)", flush=True)
    k1_wide(dev, g, feats)
    head = exact_head("softmax", g, dev)

    # K2: affine warp, 64 photos 160x160x3 -> 112x112 chips.
    imgs = torch.tensor(rng.uniform(0, 255, (BATCH, IMG, IMG, 3)),
                        dtype=torch.float32, device=dev)
    imgs_u8 = torch.round(imgs).to(torch.uint8)
    imgs_bf = imgs.to(torch.bfloat16)
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
    limits = {torch.float32: 1e-3, torch.uint8: 1.0,
              torch.bfloat16: K2_BF16_LIMIT}
    for name, x, M in (("f32 faces", imgs, Ms), ("f32 extreme", imgs, Mx),
                       ("u8 faces", imgs_u8, Ms), ("u8 extreme", imgs_u8, Mx),
                       ("bf16 faces", imgs_bf, Ms),
                       ("bf16 extreme", imgs_bf, Mx)):
        for border in ("zero", "nearest"):
            for interp in ("linear", "nearest"):
                got = image.affine_warp_batch_kernel(x, M, (112, 112), border,
                                                     interp)
                want = image.affine_warp_batch_reference(x, M, (112, 112),
                                                         border, interp)
                torch.cuda.synchronize()
                err = maxdiff(got, want)
                limit = limits[x.dtype]
                print(f"K2 affine_warp {name} border={border} "
                      f"interp={interp}: max|diff| {err:.3e} (limit {limit})",
                      flush=True)
                check(got.dtype == x.dtype and got.shape == want.shape,
                      f"K2 {name}: bad output")
                check(err <= limit, f"K2 {name} {border} {interp}: max|diff| "
                      f"{err} > {limit}")
                if x.dtype == torch.float32:
                    k2_err = max(k2_err, err)
    k2_ms, k2_call = kernel_ms(
        lambda: image.affine_warp_batch_kernel(imgs, Ms, (112, 112)),
        image.affine_warp_batch_kernel)
    k2_plain = cuda_ms(lambda: image.affine_warp_batch_reference(
        imgs, Ms, (112, 112)))
    print(f"K2 64x160x160x3 -> 112x112 f32: kernel {k2_ms:.4f} ms "
          f"({k2_call:.4f} per call from Python), plain {k2_plain:.4f} ms",
          flush=True)
    bf_ms, bf_call = kernel_ms(
        lambda: image.affine_warp_batch_kernel(imgs_bf, Ms, (112, 112)),
        image.affine_warp_batch_kernel)
    bf_bound = 2 * (imgs.numel() + BATCH * 112 * 112 * 3) / H100_BYTES_PER_S
    print(f"K2 64x160x160x3 -> 112x112 bf16: kernel {bf_ms:.4f} ms "
          f"({bf_call:.4f} per call from Python), bound "
          f"{bf_bound * 1e3:.4f} ms (bytes)", flush=True)
    # Bounds from the shapes: K1's head in bf16 on the tensor cores over
    # f32 features (the serving grid, D 512); K2 moves its f32 photos in and
    # chips out.
    k1_ms, k1_call, k1_plain, k1_ops, k1_bytes = k1_t[512]
    k2_bytes = 4 * (imgs.numel() + BATCH * 112 * 112 * 3)
    k2_ops = 8 * BATCH * 112 * 112 * 3
    return head, {
        "pair_score": kernel_numbers(k1_err, k1_ms, k1_call, k1_plain,
                                     k1_ops, H100_BF16_TFLOPS, k1_bytes),
        "affine_warp": kernel_numbers(k2_err, k2_ms, k2_call, k2_plain,
                                      k2_ops, H100_F32_TFLOPS, k2_bytes)}


def k1_wide(dev, g, feats) -> None:
    """K1 under heads wider than 256 in H2 (``K1_WIDE``): one launch per
    256-column chunk, held to the plain version on dyadic data, then the
    device time beside the bound and the plain version."""
    from alink_tpu_torch.ops import pairwise

    k1 = pairwise.score_matrix_kernel
    for n, m, d, (h1, h2), kind in K1_WIDE:
        rows, cols = feats[d][0][:n], feats[d][1][:m]
        hd = exact_head(kind, g, dev, d, (h1, h2), rows[:64], cols[:64])
        chunks = len(pairwise.head_chunks(h2))
        name = f"{n}x{m}x{d} ({h1}, {h2}) {kind}"
        before = k1.launches
        got = k1(hd, rows, cols)
        launched = k1.launches - before
        want = pairwise.score_matrix_reference(hd, rows, cols)
        torch.cuda.synchronize()
        err = maxdiff(got, want)
        q05, q95 = torch.quantile(want.flatten()[:100_000],
                                  torch.tensor([0.05, 0.95], device=dev))
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"K1 {name}: bad output")
        check(launched == chunks, f"K1 {name}: {launched} launches, "
              f"{chunks} chunks")
        check(err <= K1_LIMIT, f"K1 {name}: max|diff| {err} > {K1_LIMIT}")
        check(float(q95 - q05) >= 0.4, f"K1 {name}: scores too narrow")
        ms, call = kernel_ms(lambda: k1(hd, rows, cols), k1, per_call=chunks)
        plain = cuda_ms(lambda: pairwise.score_matrix_reference(hd, rows,
                                                                cols), iters=3)
        ops = n * m * (d + 2 * d * h1 + 2 * h1 * h2 + 2 * h2 * 2)
        nbytes = 4 * (n * d + m * d + n * m) + 2 * (d * h1 + h1 * h2 + 2 * h2)
        t_ops = ops / (H100_BF16_TFLOPS * 1e12) * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        print(f"K1 pair_score {name} dyadic, {chunks} chunks of H2: "
              f"max|diff| {err:.3e} (limit {K1_LIMIT}), plain scores 5-95 % "
              f"in [{q05:.3f}, {q95:.3f}]; kernel {ms:.4f} ms ({call:.4f} "
              f"per call from Python), plain {plain:.4f} ms, bound "
              f"{max(t_ops, t_bytes):.4f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'})",
              flush=True)


def kernel_numbers(err, ms, call, plain, ops, peak_tera, nbytes,
                   library=None):
    """One entry of the ``kernels`` line: the bound is the larger of the
    operations over the card's peak for their type and the bytes over its
    memory rate."""
    t_ops = ops / (peak_tera * 1e12) * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return {"err": err, "ms": ms, "call_ms": call, "plain_ms": plain,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library}


# K3 against its plain version on the card, at the five stride-1 block
# shapes of VGGFace-ResNet50 at 224x224 (bench_kernels.K3_SHAPES), at the
# batches whose launches differ: 32 (clusters of 4 at 7x7), 64 (clusters of
# 2: the featurizer check of (f)) and 256 (``featurize_stacks`` and the
# one-pixel DE's ``EVAL_BATCH``: one block per tile at 14x14 and 7x7,
# persistent blocks at 55x55 and 28x28, as at every batch).  The plain
# version is timed at batch 32.
K3_BATCH = 32
K3_CHECK_BATCHES = (32, 64, 256)
# Dyadic data (integer activations, weights in {-1, 0, 1}, BN scales
# {1, 2} x 2^-k and shifts on the same grid) keeps every f32 product and
# partial sum exact, so both sides round the same values to bf16: expect 0.
K3_EXACT_LIMIT = 1e-6
# Float data: f32 sums in other orders can round a y1/y2/out value to the
# neighbouring bf16; held relative to the largest output.
K3_FLOAT_LIMIT = 1e-2
# Chains at a Cm that pads past 512 (y1 and y2 in global scratch): 14x14
# at batch 32, a projected block then an identity block.  Each block alone
# on dyadic data is exact.  The second block of a chain reads the first's
# bf16 output, whose values span 2^-13 to ~2^4: its 3x3 sums over 9 x Cm
# terms then pass 2^24 units of that grid, so f32 sums in another order
# may round (the plain chain in f32 and in f64 differ at Cm 1,024 on the
# CPU), and the chain is held to the float limit.
K3_WIDE = ((576, ((512, 576, 1024, True), (1024, 576, 1024, False))),
           (1024, ((1024, 1024, 2048, True), (2048, 1024, 2048, False))))
K3_WIDE_HW = 14
H100_BF16_TFLOPS = 989.0
H100_F32_TFLOPS = 67.0          # outside the tensor cores
H100_BYTES_PER_S = 3.35e12


def k3_flops(n, hw, cin, cm, cout, proj) -> float:
    return 2.0 * n * hw * hw * (cin * cm + 9 * cm * cm + cm * cout
                                + (cin * cout if proj else 0))


def k3_weights(cin, cm, cout, proj, g, dev, exact: bool):
    """Random folded-BN bottleneck weights (dyadic when ``exact``) in the
    kernel's layout on ``dev``."""
    from alink_tpu_torch.ops.resblock import BottleneckWeights, kernel_weights

    def lg(v: float) -> int:
        return max(0, round(np.log2(v)) - 1)

    def mat(shape, fan_in):
        if exact:
            return torch.randint(-1, 2, shape, generator=g).float()
        return torch.randn(shape, generator=g) * fan_in ** -0.5

    def bn(c, k):
        if exact:
            s = torch.randint(1, 3, (c,), generator=g) * 2.0 ** -k
            return s, torch.randint(-3, 4, (c,), generator=g) * 2.0 ** -k
        return (torch.rand(c, generator=g) + 0.5,
                torch.randn(c, generator=g) * 0.1)

    # Scale exponents bring each accumulator (std ~ sqrt(K * E[a^2] E[w^2]))
    # back to a std of ~2, on a grid of 2^-(k1 + k2 + k3) at the output.
    k1, k2, k3 = lg((cin * 4 / 3) ** .5), lg((12 * cm) ** .5), lg(
        (cm * 4 / 3) ** .5)
    s1, b1 = bn(cm, k1)
    s2, b2 = bn(cm, k1 + k2)
    s3, b3 = bn(cout, k1 + k2 + k3)
    s2 = s2 * (2.0 ** k1 if exact else 1.0)
    s3 = s3 * (2.0 ** (k1 + k2) if exact else 1.0)
    wts = [mat((cin, cm), cin), s1, b1, mat((3, 3, cm, cm), 9 * cm), s2, b2,
           mat((cm, cout), cm), s3, b3]
    if proj:
        sp, bp = bn(cout, k1 + k2 + k3)
        sp = sp * (2.0 ** (k2 + k3) if exact else 1.0)   # x . Wp ~ acc1
        wts += [mat((cin, cout), cin), sp, bp]
    return kernel_weights(BottleneckWeights(*wts), dev)


def k3_wide(dev, g, gd) -> float:
    """K3 at a Cm that pads past 512 (``K3_WIDE``: y1 and y2 in the
    kernel's global scratch): each block against its plain version on
    dyadic data (exact), then the chain against the plain chain (float
    limit), with its device time beside the bound and the plain chain;
    returns the largest difference of the dyadic checks."""
    from alink_tpu_torch.ops import resblock

    k3 = resblock.bottleneck_s1_kernel
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    hw, worst = K3_WIDE_HW, 0.0
    for cm, blocks in K3_WIDE:
        ws = tuple(k3_weights(ci, c, co, proj, g, dev, True)
                   for ci, c, co, proj in blocks)
        cin, cout = blocks[0][0], blocks[-1][2]
        for (ci, c, co, p), w in zip(blocks, ws):
            plan = resblock.launch_plan(
                K3_BATCH, hw, hw, resblock.padded_width(ci),
                resblock.padded_width(c), resblock.padded_width(co), p, sms)
            xb = torch.randint(-2, 3, (K3_BATCH, hw, hw, ci), generator=gd,
                               device=dev).to(torch.bfloat16)
            got = resblock.bottleneck_s1_kernel(xb, w)
            want = resblock.bottleneck_s1_reference(xb, w)
            torch.cuda.synchronize()
            err = maxdiff(got, want)
            nonzero = float((want != 0).float().mean())
            print(f"K3 wide block {hw}x{hw} {ci}->{c}->{co}"
                  f"{' proj' if p else ''} batch {K3_BATCH} (Cm pads to "
                  f"{resblock.padded_width(c)}; y1/y2 in global scratch: "
                  f"{plan.global_act}; {plan.blocks} blocks, ring "
                  f"{plan.slots}) dyadic: max|diff| {err:.3e} (limit "
                  f"{K3_EXACT_LIMIT}), {100 * nonzero:.0f} % non-zero",
                  flush=True)
            check(plan.global_act, f"K3 Cm {c}: not on the global-scratch "
                  "path")
            check(got.shape == want.shape and got.dtype == torch.bfloat16,
                  f"K3 Cm {c}: bad output")
            check(err <= K3_EXACT_LIMIT and nonzero > 0.2,
                  f"K3 Cm {c}: max|diff| {err} > {K3_EXACT_LIMIT} or "
                  f"{100 * nonzero:.0f} % non-zero")
            worst = max(worst, err)
        x = torch.randint(-2, 3, (K3_BATCH, hw, hw, cin), generator=gd,
                          device=dev).to(torch.bfloat16)
        name = " -> ".join(f"{ci}->{c}->{co}{' proj' if p else ''}"
                           for ci, c, co, p in blocks)
        got = resblock.bottleneck_chain(x, ws)
        want = resblock.bottleneck_chain_reference(x, ws)
        torch.cuda.synchronize()
        err = maxdiff(got, want)
        rel = err / float(want.float().abs().max())
        ndiff = int((got != want).sum())
        check(got.shape == want.shape == (K3_BATCH, hw, hw, cout)
              and got.dtype == torch.bfloat16, f"K3 Cm {cm}: bad output")
        check(rel <= K3_FLOAT_LIMIT, f"K3 Cm {cm} chain: relative {rel} > "
              f"{K3_FLOAT_LIMIT}")
        ms, call = kernel_ms(lambda: resblock.bottleneck_chain(x, ws), k3,
                             per_call=len(ws))
        plain = cuda_ms(lambda: resblock.bottleneck_chain_reference(x, ws),
                        iters=3)
        ops = sum(k3_flops(K3_BATCH, hw, ci, c, co, p)
                  for ci, c, co, p in blocks)
        nbytes = 2 * sum(K3_BATCH * hw * hw * (ci + co) + sum(
            t.numel() for t in (w.w1, w.w3, w.w2, w.wp) if t is not None)
            for (ci, c, co, p), w in zip(blocks, ws))
        bound = max(ops / (H100_BF16_TFLOPS * 1e12),
                    nbytes / H100_BYTES_PER_S) * 1e3
        print(f"K3 wide chain Cm {cm} {hw}x{hw} batch {K3_BATCH} {name} "
              f"dyadic input: max|diff| {err:.3e}, relative {rel:.3e} (limit "
              f"{K3_FLOAT_LIMIT}), {ndiff} of {want.numel()} differ; kernel "
              f"{ms:.4f} ms "
              f"({call:.4f} per call from Python, {ops / ms / 1e9:.1f} "
              f"TFLOP/s), plain {plain:.4f} ms, bound {bound:.4f} ms",
              flush=True)
        del x, xb, got, want, ws
    return worst


def phase_k3(dev, g):
    """(e): K3 against its plain version at the featurizer's five stride-1
    block shapes, at batch 32, 64 and 256; then the launch alone at batch
    32 and 256 (the batch ``featurize_stacks`` and the one-pixel DE give
    it) beside the same block as an unfused bf16 cuDNN sequence (a
    yardstick, not ``library_ms``: no single call computes the block).
    Returns the numbers summed over the 13 blocks of one forward at batch
    32."""
    from alink_tpu_torch.ops import resblock
    from alink_tpu_torch.tools.bench_kernels import K3_SHAPES, bench_k3

    gd = torch.Generator(device=dev).manual_seed(SEED)   # activations
    err_all = 0.0
    plain_fwd = bound_fwd = ops_fwd = bytes_fwd = 0.0
    for batch in K3_CHECK_BATCHES:
        for hw, cin, cm, cout, proj, count in K3_SHAPES:
            name = f"{hw}x{hw} {cin}->{cm}->{cout}{' proj' if proj else ''}"
            plan = resblock.launch_plan(
                batch, hw, hw, cin, cm, cout, proj,
                torch.cuda.get_device_properties(dev).multi_processor_count)
            setup = (f"clusters of {plan.split}" if plan.split > 1 else
                     "persistent" if plan.blocks < plan.tiles else
                     "one block per tile")
            shape = (batch, hw, hw, cin)
            for exact in (True, False):
                wts = k3_weights(cin, cm, cout, proj, g, dev, exact)
                if exact:
                    x = torch.randint(-2, 3, shape, generator=gd, device=dev)
                else:
                    x = torch.relu(torch.randn(shape, generator=gd,
                                               device=dev))
                x = x.to(torch.bfloat16)
                got = resblock.bottleneck_s1_kernel(x, wts)
                want = resblock.bottleneck_s1_reference(x, wts)
                torch.cuda.synchronize()
                err = maxdiff(got, want)
                scale = float(want.float().abs().max())
                nonzero = float((want != 0).float().mean())
                check(got.shape == want.shape and got.dtype == torch.bfloat16
                      and bool(torch.isfinite(got.float()).all()),
                      f"K3 {name} batch {batch}: bad output")
                if exact:
                    print(f"K3 bottleneck {name} batch {batch} ({setup}, "
                          f"{plan.blocks} blocks) dyadic: max|diff| "
                          f"{err:.3e} (limit {K3_EXACT_LIMIT}); max|out| "
                          f"{scale:.1f}, {100 * nonzero:.0f} % non-zero",
                          flush=True)
                    check(err <= K3_EXACT_LIMIT, f"K3 {name} batch {batch} "
                          f"dyadic: max|diff| {err} > {K3_EXACT_LIMIT}")
                else:
                    rel = err / max(scale, 1e-30)
                    print(f"K3 bottleneck {name} batch {batch} float: "
                          f"max|diff| {err:.3e}, relative {rel:.3e} (limit "
                          f"{K3_FLOAT_LIMIT})", flush=True)
                    check(rel <= K3_FLOAT_LIMIT, f"K3 {name} batch {batch} "
                          f"float: relative {rel} > {K3_FLOAT_LIMIT}")
                check(nonzero > 0.2, f"K3 {name} batch {batch}: output "
                      "mostly zero")
                err_all = max(err_all, err)
            if batch == K3_BATCH:
                plain = cuda_ms(
                    lambda: resblock.bottleneck_s1_reference(x, wts), iters=5)
                print(f"K3 {name} batch {batch}: plain {plain:.4f} ms",
                      flush=True)
                plain_fwd += count * plain
                ops = k3_flops(batch, hw, cin, cm, cout, proj)
                nbytes = 2 * (x.numel() + batch * hw * hw * cout
                              + sum(t.numel() for t in (wts.w1, wts.w3,
                                                        wts.w2, wts.wp)
                                    if t is not None))
                t_ops = ops / (H100_BF16_TFLOPS * 1e12) * 1e3
                t_bytes = nbytes / H100_BYTES_PER_S * 1e3
                bound_fwd += count * max(t_ops, t_bytes)
                ops_fwd += count * t_ops
                bytes_fwd += count * t_bytes
            del x, got, want, wts
    # Widths the kernel runs zero-padded: a projected 32 -> 80 -> 200 block
    # and an identity 200 -> 48 -> 200 block, chained (the padded width
    # carried between them), on dyadic data: exact.
    ws = (k3_weights(32, 80, 200, True, g, dev, True),
          k3_weights(200, 48, 200, False, g, dev, True))
    x = torch.randint(-2, 3, (K3_BATCH, 28, 28, 32), generator=gd,
                      device=dev).to(torch.bfloat16)
    got = resblock.bottleneck_chain(x, ws)
    want = resblock.bottleneck_chain_reference(x, ws)
    torch.cuda.synchronize()
    err = maxdiff(got, want)
    nonzero = float((want != 0).float().mean())
    print(f"K3 padded widths 28x28 32->80->200 proj, 200->48->200 batch "
          f"{K3_BATCH} dyadic: max|diff| {err:.3e} (limit {K3_EXACT_LIMIT}); "
          f"{100 * nonzero:.0f} % non-zero", flush=True)
    check(got.shape == want.shape == (K3_BATCH, 28, 28, 200)
          and got.dtype == torch.bfloat16, "K3 padded widths: bad output")
    check(err <= K3_EXACT_LIMIT and nonzero > 0.2,
          f"K3 padded widths: max|diff| {err} > {K3_EXACT_LIMIT}")
    err_all = max(err_all, err)
    del x, got, want, ws
    err_all = max(err_all, k3_wide(dev, g, gd))
    torch.cuda.empty_cache()
    times = bench_k3(dev, (K3_BATCH, 256), g)
    for batch, res in times.items():
        flops = sum(c * k3_flops(int(batch), hw, cin, cm, cout, proj)
                    for hw, cin, cm, cout, proj, c in K3_SHAPES)
        tf = flops / (res["ms"] * 1e-3) / 1e12
        print(f"K3 13 blocks at batch {batch}: kernel {res['ms']:.4f} ms "
              f"({tf:.1f} TFLOP/s, {100 * tf / H100_BF16_TFLOPS:.1f} % of "
              f"{H100_BF16_TFLOPS:.0f} dense bf16), unfused bf16 cuDNN "
              f"sequence {res['unfused_ms']:.4f} ms (reference only)",
              flush=True)
    res = times[str(K3_BATCH)]
    print(f"K3 13 blocks of one forward, batch {K3_BATCH}: kernel "
          f"{res['ms']:.4f} ms ({res['call_ms']:.4f} per call from Python), "
          f"plain {plain_fwd:.4f} ms, bound {bound_fwd:.4f} ms", flush=True)
    return {"err": err_all, "ms": res["ms"], "call_ms": res["call_ms"],
            "plain_ms": plain_fwd, "bound_ms": bound_fwd,
            "bound_by": "operations" if ops_fwd >= bytes_fwd else "bytes",
            "library_ms": None}


# Phase (f): the A-LINK training slice at full width.  Cuts, each printed:
F_IMAGE = 224
F_PEOPLE = 12          # synthetic DFW people (DFW trains on ~1,000)
F_DIG_EPOCHS = 2       # ALinkConfig default 40
F_UNDIG_EPOCHS = 2     # ALinkConfig default 60
F_TRAIN_STEPS = 512    # samples per pretraining epoch, default 320,000
F_ALINK_BS = 4         # people per slab, default 16: 3 slabs of 160 pairs
F_BATCH_SEND = 4       # queue size that triggers a finetune, default 64
F_DEVICE_BATCH = 64    # pairs per chunk, default 1,024
F_NOISE = ("gaussian", "saltpepper", "poisson", "speckle")  # DE: phase (g)
F_FEAT_BATCH = 128
F_CUTS = (f"synthetic_people {F_PEOPLE} (DFW: ~1,000 people)",
          f"dig_epochs 40 -> {F_DIG_EPOCHS}",
          f"undig_epochs 60 -> {F_UNDIG_EPOCHS}",
          f"train_steps 320000 -> {F_TRAIN_STEPS}",
          f"alink_bs 16 -> {F_ALINK_BS}",
          f"batch_send 64 -> {F_BATCH_SEND}",
          f"device_batch 1024 -> {F_DEVICE_BATCH}",
          "noise: the default bank without 'adversarial' (phase g)")
# Featurizer with K3 against the same model with K3's plain version: both
# round at the same points, f32 sums in other orders.
F_FEAT_LIMIT = 1e-2


def phase_alink(dev, smi: str):
    """(f): ``run_alink`` at full width, then ``test_accuracy`` over the
    plain features; returns the kernels' launch counts in ``run_alink``, and
    its configuration and finetune s/iteration for phase (j)."""
    import tempfile

    from alink_tpu_torch import train as T
    from alink_tpu_torch.data import (load_person_stacks, make_synthetic_dfw,
                                      scan_dfw)
    from alink_tpu_torch.drivers import common
    from alink_tpu_torch.drivers.alink import parse_config, run_alink
    from alink_tpu_torch.models import SiameseHead, preprocess
    from alink_tpu_torch.ops import pairwise, resblock
    from alink_tpu_torch.tools.profile_serving import summary, windows

    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(prefix="alink_", dir=work))
    cfg = parse_config(
        ["--noise", ",".join(F_NOISE)], synthetic_people=F_PEOPLE,
        image_res=(F_IMAGE, F_IMAGE), dig_epochs=F_DIG_EPOCHS,
        undig_epochs=F_UNDIG_EPOCHS, train_steps=F_TRAIN_STEPS,
        alink_bs=F_ALINK_BS, batch_send=F_BATCH_SEND,
        device_batch=F_DEVICE_BATCH, seed=SEED,
        out_model=str(out / "postALINK"),
        ensemble_basepath=str(out / "ensemble"),
        disguised_basemodel=str(out / "disguisedModel"))
    for line in F_CUTS:
        print(f"alink cut: {line}", flush=True)
    t0 = time.perf_counter()
    featurize, model = common.make_resnet50_featurizer(
        torch.Generator().manual_seed(SEED), device=dev)
    print(f"alink: VGGFace-ResNet50 (3, 4, 6, 3) bf16 built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    k3, k1 = resblock.bottleneck_s1_kernel, pairwise.score_matrix_kernel
    k3.launches = k1.launches = 0
    t0 = time.perf_counter()
    state = run_alink(cfg, featurize=featurize, device=dev)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = {"bottleneck": k3.launches, "pair_score": k1.launches}
    print(f"alink: run_alink {t_run:.1f} s; launches {counts}", flush=True)
    check(counts["bottleneck"] > 0,
          "kernel bottleneck was not launched by run_alink")

    # test_accuracy of M2 over the plain features of the same tree (the
    # same seed writes the same files): K1 on the training side.
    tree = make_synthetic_dfw(str(out / "tree"), num_people=F_PEOPLE,
                              image_size=F_IMAGE,
                              train_folder=cfg.train_images_dir, seed=SEED)
    people = scan_dfw(tree, cfg.train_images_dir)
    res = (F_IMAGE, F_IMAGE)
    plain_raw = load_person_stacks([p.plain for p in people], res)
    dig_raw = load_person_stacks([p.disguised for p in people], res)
    pf = common.featurize_stacks(plain_raw, featurize, dev)
    mask = pf.mask()
    feats = pf.images[mask]
    labels = np.repeat(np.arange(pf.num_people), pf.counts)
    k1.launches = 0
    acc = T.test_accuracy(state.m2_state, feats, labels)
    torch.cuda.synchronize()
    print(f"alink: test_accuracy of M2 on {len(feats)} plain faces "
          f"{acc:.4f}; pair_score launches {k1.launches}", flush=True)
    check(k1.launches > 0, "kernel pair_score was not launched by "
          "test_accuracy")

    logs = state.logs
    per_slab = [10 * b * b for b in
                np.diff(np.r_[0:F_PEOPLE:F_ALINK_BS, F_PEOPLE])]
    check(len(logs) >= 2, f"only {len(logs)} loop iterations")
    check([lg.pairs for lg in logs] == per_slab[:len(logs)],
          f"pairs per slab {[lg.pairs for lg in logs]} != {per_slab}")
    check(state.un_size == sum(lg.pairs for lg in logs), "un_size")
    check(any(lg.finetuned for lg in logs), "no finetune ran")
    check(np.isfinite(feats).all() and feats.shape[1] == 2048,
          "non-finite or mis-shaped features")
    head = SiameseHead(2048, device=dev)
    head.load_state_dict(T.restore(cfg.out_model))
    p = head(torch.as_tensor(feats[:16], device=dev),
             torch.as_tensor(feats[16:32], device=dev))
    check(bool(torch.isfinite(p).all()) and p.shape == (16, 2),
          "saved post-A-LINK head gives bad probabilities")
    for lg in logs:
        print(f"alink: {lg}", flush=True)
    tm = state.timings.as_dict()
    n_it = len(logs)
    print(f"alink: one loop iteration {sum(tm.values()) / n_it:.3f} s "
          f"(mean of {n_it}); per-phase s/iteration "
          + ", ".join(f"{k} {v / n_it:.3f}" for k, v in
                      sorted(tm.items(), key=lambda kv: -kv[1])), flush=True)

    # The featurizer with K3 against the same model with K3's plain version,
    # on 64 faces of the tree.
    faces = np.concatenate([plain_raw.images[mask],
                            dig_raw.images[dig_raw.mask()]])
    xp = preprocess.vggface(torch.as_tensor(faces[:64], device=dev), version=2)
    got = model(xp)
    want = model(xp, chain=resblock.bottleneck_chain_reference)
    torch.cuda.synchronize()
    rel = maxdiff(got, want) / float(want.abs().max())
    print(f"alink: featurizer K3 vs plain chain on {len(xp)} faces: "
          f"relative max|diff| {rel:.3e} (limit {F_FEAT_LIMIT})", flush=True)
    check(got.shape == (len(xp), 2048) and bool(torch.isfinite(got).all()),
          "featurizer: bad output")
    check(rel < F_FEAT_LIMIT, f"featurizer: relative {rel} > {F_FEAT_LIMIT}")

    xb = torch.as_tensor(rng_images(F_FEAT_BATCH), device=dev)
    s = summary(windows(lambda: featurize(xb), dev, n_windows=7, iters=5))
    print(f"featurize: {F_FEAT_BATCH * 1e3 / s['median_ms']:.1f} images/s at "
          f"batch {F_FEAT_BATCH} (median of 7 windows {s['median_ms']:.2f} "
          f"ms/batch, min {s['min_ms']:.2f}, max {s['max_ms']:.2f}; "
          f"main-thread CPU {s['cpu_median_ms']:.2f} ms/batch), "
          f"VGGFace-ResNet50 bf16 {F_IMAGE}x{F_IMAGE} on {smi}", flush=True)
    finetuned = sum(lg.finetuned for lg in logs)
    return counts, cfg, tm.get("finetune", 0.0) / max(finetuned, 1)


# Phase (g): the A2 channel at full width.  Cuts, each printed:
G_DE_PAIRS = 8        # pairs under the one-pixel attack
G_DE_MAXITER = 3      # ALinkConfig / attack_all default 50
G_FGSM_PAIRS = 32
G_LOOP_PEOPLE = 1     # people in the loop's slab, default 16
G_LOOP_MAXITER = 2    # the loop's one-pixel generations, default 50
# K3's backward against the autograd of its plain arithmetic, block by block
# at the inputs and upstream gradients of the FGSM pass: relative L2 error,
# and the share of components above 1e-3 of the largest whose sign agrees.
G_DX_LIMIT = 2e-2
G_DX_SIGN = 0.9999


def _k3_tap():
    """A stride-1 chain through K3's autograd Function that records each
    block's input, weights and upstream gradient."""
    from alink_tpu_torch.ops import resblock

    recs = []

    def chain(x, blocks):
        for wts in blocks:
            rec = [x.detach(), wts, None]
            recs.append(rec)
            x = resblock.BottleneckS1.apply(x, *wts)
            x.register_hook(lambda gy, rec=rec: rec.__setitem__(2, gy))
        return x

    return chain, recs


def rand_pairs(rng, n: int, size: int, dev) -> tuple:
    """``n`` pairs of integer-valued (size, size, 3) f32 images."""
    x = rng.integers(0, 256, (2, n, size, size, 3))
    return (torch.as_tensor(x[0], dtype=torch.float32, device=dev),
            torch.as_tensor(x[1], dtype=torch.float32, device=dev))


def one_pixel_targets(predict, head, left, right) -> tuple:
    """(target, one-hot labels): the class the student does not predict for
    every other pair, the one it predicts for the rest."""
    with torch.no_grad():
        p0 = predict(head, left, right)
    n = left.shape[0]
    target = torch.argmax(p0, -1) ^ (torch.arange(n, device=left.device) % 2)
    return target, torch.nn.functional.one_hot(target, 2).float()


def timed_one_pixel(predict, head, left, right, labels, maxiter: int):
    """The one-pixel attack on pairs, synchronised and timed: (attacked
    left, right, the DE result read through a wrapper of the solver, s)."""
    from alink_tpu_torch.ops import attack

    seen = {}
    solver = attack.differential_evolution

    def recorded(*a, **k):
        seen["result"] = solver(*a, **k)
        return seen["result"]

    attack.differential_evolution = recorded
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            al, ar = attack.one_pixel_attack_pairs(
                predict, head, left, right, labels,
                torch.Generator(left.device).manual_seed(SEED),
                maxiter=maxiter)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
    finally:
        attack.differential_evolution = solver
    return al, ar, seen["result"], t


def timed_fgsm(predict, head, left, right, labels) -> tuple:
    """FGSM on pairs, a warm call then a synchronised timed one: (left,
    right, ms)."""
    from alink_tpu_torch.ops import attack

    attack.fgsm_pairs(predict, head, left, right, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fl, fr = attack.fgsm_pairs(predict, head, left, right, labels)
    torch.cuda.synchronize()
    return fl, fr, (time.perf_counter() - t0) * 1e3


def phase_a2(dev, smi: str) -> int:
    """(g): one-pixel DE, FGSM and one loop iteration with the default bank
    at full width; returns K3's launches in them."""
    from alink_tpu_torch.active.committee import Committee
    from alink_tpu_torch.active.loop import ALinkLoop
    from alink_tpu_torch.config import ALinkConfig
    from alink_tpu_torch.data import PersonStacks
    from alink_tpu_torch.drivers import common
    from alink_tpu_torch.drivers.alink import make_adversarial_predict
    from alink_tpu_torch.models import SiameseHead, preprocess
    from alink_tpu_torch.ops import resblock
    from alink_tpu_torch.train import TrainState

    for line in (f"one-pixel DE on {G_DE_PAIRS} pairs, maxiter 50 -> "
                 f"{G_DE_MAXITER} (pixel_count 40, popsize 250: m = 200)",
                 f"FGSM on {G_FGSM_PAIRS} pairs",
                 f"loop slab {G_LOOP_PEOPLE} person (alink_bs 16), one-pixel"
                 f" maxiter 50 -> {G_LOOP_MAXITER}"):
        print(f"a2 cut: {line}", flush=True)
    g = torch.Generator().manual_seed(SEED + 7)
    featurize, model = common.make_resnet50_featurizer(
        torch.Generator().manual_seed(SEED), device=dev)
    head = SiameseHead(2048, (512, 64), generator=g, device=dev)
    predict = make_adversarial_predict(featurize)
    rng = np.random.default_rng(SEED + 7)
    k3 = resblock.bottleneck_s1_kernel
    total = 0

    # One-pixel DE.
    left, right = rand_pairs(rng, G_DE_PAIRS, F_IMAGE, dev)
    target, labels = one_pixel_targets(predict, head, left, right)
    k3.launches = 0
    al, ar, res, t_de = timed_one_pixel(predict, head, left, right, labels,
                                        G_DE_MAXITER)
    de_launches = k3.launches
    total += de_launches
    gens = int(res.nit.max())
    check(res.population.shape == (G_DE_PAIRS, 200, 200),
          f"DE population {tuple(res.population.shape)}")
    diff_l = (al != left).any(-1)
    diff_r = (ar != right).any(-1)
    changed = diff_l.flatten(1).sum(1) + diff_r.flatten(1).sum(1)
    check(bool((changed <= 40).all()), f"DE wrote {changed.tolist()} pixels")
    # A pixel written once holds an integer in [0, 255]; one written twice
    # by the same candidate holds the mean of its writes (the JAX package's
    # semantics), still in [0, 255].
    px = res.x.to(torch.int32).reshape(G_DE_PAIRS, 40, 5)
    h2, wd = 2 * F_IMAGE, F_IMAGE
    lin = (px[..., 0].clamp(0, h2 - 1) * wd + px[..., 1].clamp(0, wd - 1))
    hits = torch.zeros(G_DE_PAIRS, h2 * wd, device=dev).scatter_add_(
        1, lin.long(), torch.ones_like(lin, dtype=torch.float32))
    both = torch.cat([al, ar], dim=1).reshape(G_DE_PAIRS, h2 * wd, 3)
    once = both[hits == 1]
    written = both[hits >= 1]
    check(bool((once == torch.round(once)).all()) and bool(
        ((written >= 0) & (written <= 255)).all()),
        "DE wrote values that are not integers in [0, 255]")
    check(bool((diff_l.flatten(1).sum(1) + diff_r.flatten(1).sum(1)
                <= (hits >= 1).sum(1)).all()),
          "DE changed pixels it did not write")
    with torch.no_grad():
        p1 = predict(head, al, ar)
    stopped = res.stopped_early
    check(bool((torch.argmax(p1, -1) == target)[stopped].all()),
          "a pair that stopped early does not reach its target")
    print(f"a2: one-pixel DE {G_DE_PAIRS} pairs: {t_de:.3f} s, {gens} "
          f"generation(s) (nit {res.nit.tolist()}), "
          f"{t_de / max(gens, 1):.3f} s/generation incl. init, nfev "
          f"{res.nfev.tolist()}, stopped early {stopped.tolist()}, pixels "
          f"changed {changed.tolist()}, K3 launches {de_launches}", flush=True)

    # FGSM, then K3's backward block by block against its plain arithmetic.
    left, right = rand_pairs(rng, G_FGSM_PAIRS, F_IMAGE, dev)
    labels = torch.nn.functional.one_hot(torch.as_tensor(
        rng.integers(0, 2, G_FGSM_PAIRS), device=dev), 2).float()
    k3.launches = 0
    fl, fr, ms_fgsm = timed_fgsm(predict, head, left, right, labels)
    total += k3.launches
    step = torch.cat([(fl - left).abs(), (fr - right).abs()])
    check(bool(torch.isfinite(step).all()) and float(step.max()) == 2.0,
          "FGSM step is not 2 pixels")
    print(f"a2: FGSM {G_FGSM_PAIRS} pairs (forward + backward through K3): "
          f"{ms_fgsm:.2f} ms; K3 launches {k3.launches} over 2 calls; "
          f"{100 * float((step == 2).float().mean()):.1f} % of pixels moved",
          flush=True)

    tap, recs = _k3_tap()
    feat_tap = make_adversarial_predict(
        lambda im: model(preprocess.vggface(im, version=2), chain=tap))
    lh, rh = left.clone().requires_grad_(True), right.clone().requires_grad_(
        True)
    p = feat_tap(head, lh, rh)
    torch.autograd.grad(-torch.mean(torch.sum(labels * torch.log(p + 1e-12),
                                              -1)), (lh, rh))
    worst_rel, worst_sign = 0.0, 1.0
    for x, wts, gy in recs:
        xa = x.clone().requires_grad_(True)
        (da,) = torch.autograd.grad(resblock.BottleneckS1.apply(xa, *wts),
                                    xa, gy)
        xb = x.float().clone().requires_grad_(True)
        (db,) = torch.autograd.grad(resblock._block_plain(xb, wts), xb,
                                    gy.float())
        da = da.float()
        rel = float((da - db).norm() / db.norm())
        big = db.abs() > 1e-3 * db.abs().max()
        agree = float((torch.sign(da) == torch.sign(db))[big].float().mean())
        worst_rel, worst_sign = max(worst_rel, rel), min(worst_sign, agree)
    print(f"a2: K3 backward vs autograd of its plain arithmetic, "
          f"{len(recs)} blocks of the FGSM pass: worst relative L2 "
          f"{worst_rel:.3e} (limit {G_DX_LIMIT}), worst sign agreement above "
          f"1e-3 of max {worst_sign:.6f} (limit {G_DX_SIGN})", flush=True)
    check(worst_rel <= G_DX_LIMIT, f"K3 dx relative {worst_rel}")
    check(worst_sign >= G_DX_SIGN, f"K3 dx sign agreement {worst_sign}")

    # The same FGSM gradient end to end, through K3 and through its plain
    # chain: printed, not held (the forward's bf16 differences move the
    # random head's near-cancelling |l - r| inputs and its ReLU masks).
    def input_grad(chain):
        pr = make_adversarial_predict(
            lambda im: model(preprocess.vggface(im, version=2), chain=chain))
        lq, rq = left.clone().requires_grad_(True), right.clone(
        ).requires_grad_(True)
        q = pr(head, lq, rq)
        return torch.cat([t.flatten() for t in torch.autograd.grad(
            -torch.mean(torch.sum(labels * torch.log(q + 1e-12), -1)),
            (lq, rq))])

    def plain_chain(x, blocks):
        for wts in blocks:
            x = resblock._block_plain(x, wts)
        return x

    ga, gb = input_grad(resblock.bottleneck_chain), input_grad(plain_chain)
    print(f"a2: FGSM input gradient, K3 path vs plain chain end to end: "
          f"relative L2 {float((ga - gb).norm() / gb.norm()):.3e}, sign "
          f"agreement {float((torch.sign(ga) == torch.sign(gb)).float().mean()):.4f}"
          " (reported only)", flush=True)

    # One loop iteration with the default bank, built as run_alink builds it.
    cfg = ALinkConfig(image_res=(F_IMAGE, F_IMAGE), seed=SEED)
    check(cfg.noise[-1] == "adversarial" and len(cfg.noise) == 5,
          f"default bank {cfg.noise}")
    heads = [SiameseHead(2048, generator=g, device=dev) for _ in range(2)]
    committee = Committee.from_param_list(
        heads[0], [h.state_dict() for h in heads], cfg.noise)
    loop = ALinkLoop(cfg, pool_uint8=True, featurize=featurize,
                     committee=committee, m2_state=TrainState(head),
                     host_generator=torch.Generator().manual_seed(SEED),
                     adversarial_predict=predict,
                     adversarial_kwargs={"maxiter": G_LOOP_MAXITER},
                     device=dev)
    img = rng.integers(0, 256, (2, G_LOOP_PEOPLE, 2, F_IMAGE, F_IMAGE, 3))
    stacks = [PersonStacks(img[i].astype(np.float32),
                           np.full(G_LOOP_PEOPLE, 2, np.int32))
              for i in range(2)]
    k3.launches = 0
    t0 = time.perf_counter()
    log = loop.run_iteration(*stacks)
    torch.cuda.synchronize()
    t_it = time.perf_counter() - t0
    total += k3.launches
    tm = loop.timings.as_dict()
    check(log.pairs > 0 and log.queried <= log.selected <= log.pairs,
          f"loop log {log}")
    print(f"a2: one loop iteration, default bank {cfg.noise}, {log.pairs} "
          f"pairs: {t_it:.3f} s; per phase s " + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(tm.items(),
                                                 key=lambda kv: -kv[1]))
          + f"; K3 launches {k3.launches}; {log}", flush=True)
    print(f"a2: K3 launches in (g) {total} on {smi}", flush=True)
    return total


# Phase (h): K4 against its plain version at LResNet100E-II's stage shapes
# (benchmarks/bench_qconv.py:57-59): (H, Cin, Cout), batch 64.
K4_F32_LIMIT = 1e-5     # relative, tests/test_qconv.py:27's bound
H100_INT8_TOPS = 1979.0


def phase_k4(dev, g, smi: str):
    """(h): K4's op path (``conv3x3_s1_int8`` at the five shapes and a
    conv -> prelu_quant -> add_lead -> conv chain at 14x14x256) with its
    counter zeroed just before and read just after, then the kernel on
    packed operands against its plain version on the same operands."""
    import torch.nn.functional as F

    from alink_tpu_torch.ops import qconv
    from alink_tpu_torch.tools.bench_kernels import (K4_BATCH, K4_SHAPES,
                                                     k4_case)

    k4 = qconv.conv3x3_s1_int8_flat_kernel
    cases = [k4_case(*s, g, dev) for s in K4_SHAPES]
    k4.launches = 0
    for x, w, scale, bias, *_ in cases:
        out = qconv.conv3x3_s1_int8(x, w, scale, bias)
        check(out.shape == x.shape[:3] + (w.shape[3],)
              and bool(torch.isfinite(out.float()).all()), "K4 op output")
    x, w, scale, bias, alpha, qs, lo = cases[2]
    q2 = qconv.conv3x3_s1_int8_flat(qconv.nhwc_to_flat(x, lo), w, scale,
                                    bias, lo, alpha=alpha, quant_scale=qs,
                                    epilogue="prelu_quant")
    chain_k = qconv.conv3x3_s1_int8_flat(qconv.add_lead(q2, lo), w, scale,
                                         bias, lo, out_dtype=torch.float32)
    torch.cuda.synchronize()
    launches = k4.launches
    print(f"K4 op path (5 shapes + chain): launches {launches}", flush=True)
    check(launches >= len(K4_SHAPES) + 2, "K4 was not launched by its path")

    ops = qconv._operands(qconv.nhwc_to_flat(x, lo), w, scale, bias, alpha, qs)
    q2_p = qconv.conv3x3_s1_int8_flat_reference(ops, lo, "prelu_quant")
    chain_p = qconv.conv3x3_s1_int8_flat_reference(
        ops._replace(x=qconv.add_lead(q2_p, lo)), lo, "affine",
        torch.float32)
    err = maxdiff(chain_k, chain_p)
    print(f"K4 chain conv -> prelu_quant -> add_lead -> conv 14x14 256->256: "
          f"int8 stage max|diff| {maxdiff(q2, q2_p):.3e}, f32 output max|diff| "
          f"{err:.3e}", flush=True)
    check(maxdiff(q2, q2_p) == 0 and err <= K4_F32_LIMIT * float(
        chain_p.abs().max()), "K4 chain disagrees with its plain version")

    err_all, rows = 0.0, []
    for (hw, cin, cout), (x, w, scale, bias, alpha, qs, lo) in zip(K4_SHAPES,
                                                                 cases):
        name = f"{hw}x{hw} {cin}->{cout}"
        xf = qconv.nhwc_to_flat(x, lo)
        packed = qconv.pack_conv(w, scale, bias, alpha, qs)
        ops = qconv._operands(xf, w, scale, bias, alpha, qs)
        for ep, dt in (("affine", torch.bfloat16), ("affine", torch.float32),
                       ("prelu_quant", torch.bfloat16)):
            got = k4(xf, packed, lo, ep, dt)
            want = qconv.conv3x3_s1_int8_flat_reference(ops, lo, ep, dt)
            torch.cuda.synchronize()
            e = maxdiff(got, want)
            limit = (K4_F32_LIMIT * float(want.abs().max())
                     if got.dtype == torch.float32 else 0.0)
            nz = float((want != 0).float().mean())
            print(f"K4 {name} {ep} {str(got.dtype)[6:]}: max|diff| {e:.3e} "
                  f"(limit {limit:.3e}), {100 * nz:.0f} % non-zero",
                  flush=True)
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"K4 {name}: bad output")
            check(e <= limit and nz > 0.2, f"K4 {name} {ep}: max|diff| {e}")
            err_all = max(err_all, e)
        ms, call = kernel_ms(lambda: k4(xf, packed, lo), k4)
        op = cuda_ms(lambda: qconv.conv3x3_s1_int8(x, w, scale, bias))
        plain = cuda_ms(lambda: qconv.conv3x3_s1_int8_flat_reference(
            ops, lo, "affine", torch.bfloat16), iters=5)
        xc = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        wc = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        lib = graph_ms(lambda: F.conv2d(xc, wc, padding=1))
        # The unpadded problem: pixel rows only, Cin and Cout as they are.
        npix = K4_BATCH * hw * hw
        useful = 2.0 * npix * 9 * cin * cout
        moved = npix * cin + 9 * cin * cout + npix * cout * 2
        t_ops = useful / (H100_INT8_TOPS * 1e12) * 1e3
        t_bytes = moved / H100_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        print(f"K4 {name} batch {K4_BATCH}, affine bf16: launch {ms:.4f} ms "
              f"({useful / ms / 1e9:.1f} useful TOPS; {call:.4f} per call "
              f"from Python), op path {op:.4f} ms, "
              f"plain {plain:.4f} ms, bf16 F.conv2d {lib:.4f} ms "
              f"({ms / lib:.2f}x), bound {bound:.4f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}; "
              f"{100 * bound / ms:.1f} % of it) on {smi}", flush=True)
        rows.append((ms, plain, lib, op, bound, call, t_ops >= t_bytes))
    ms, plain, lib, op, bound, call = (sum(r[i] for r in rows)
                                       for i in range(6))
    by = "operations" if sum(r[6] for r in rows) * 2 > len(rows) else "bytes"
    print(f"K4 five shapes summed: launch {ms:.4f} ms ({call:.4f} per call "
          f"from Python), op path {op:.4f} ms, plain {plain:.4f} ms, bf16 "
          f"F.conv2d {lib:.4f} ms, bound {bound:.4f} ms", flush=True)
    return launches, {"err": err_all, "ms": ms, "call_ms": call,
                      "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                      "library_ms": lib}


# Phase (i): the DFW evaluation chain at full width.  Cuts, each printed:
I_PEOPLE = 147           # synthetic test people at 224^2, 7 faces each
I_DFW_FACES = 7771       # DFW's test list
I_DFW_PEOPLE = 1110      # the DFW-size grid: 7,770 faces of the protocol
I_FEATURE_RES = 2048
I_BAND = 128             # rows of a grid held to the plain version and f64
I_EVAL_R05 = "EVAL_r05.json"


def phase_eval(dev, smi: str) -> dict:
    """(i): the DFW evaluation chain (``tools.evaluate`` through
    ``--prefix``) at 224^2 with the counters zeroed just before and read
    just after, its grid held to the plain version; the DFW-size
    evaluation by step; ``run_eval_regression`` on EVAL_r05.json's
    protocol.  Returns the kernels' launches on the evaluation path."""
    import contextlib
    import io
    import tempfile

    from alink_tpu_torch import train as T
    from alink_tpu_torch.data import make_synthetic_dfw_test
    from alink_tpu_torch.data.synth import dfw_test_mask, dfw_test_protocol
    from alink_tpu_torch.evaluation import (masked_scores, roc_stats,
                                            threshold_sweep)
    from alink_tpu_torch.models import SiameseHead
    from alink_tpu_torch.ops import pairwise, resblock
    from alink_tpu_torch.tools import eval_regression, evaluate
    from alink_tpu_torch.tools.generate_matrix import restore_head_and_score

    k1, k3 = pairwise.score_matrix_kernel, resblock.bottleneck_s1_kernel
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(prefix="eval_", dir=work))
    faces = 7 * I_PEOPLE
    print(f"eval cut: {faces} test faces ({I_PEOPLE} people x (3 plain + 3 "
          f"disguised + 1 impostor)); DFW's test set has {I_DFW_FACES}",
          flush=True)
    t0 = time.perf_counter()
    root, names, mask = make_synthetic_dfw_test(
        str(out / "dfw"), num_people=I_PEOPLE, plain_per_person=3,
        disguised_per_person=3, impostors_per_person=1, image_size=F_IMAGE,
        seed=SEED)
    print(f"eval: protocol written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    head = SiameseHead(I_FEATURE_RES, (512, 64), device=dev,
                       generator=torch.Generator().manual_seed(SEED + 11))
    ckpt = str(out / "head")
    T.save(ckpt, head.state_dict())

    # 1. tools.evaluate through --prefix: VGGFace-ResNet50 (K3), the grid
    # (K1), the split, the sweep and the stats of the three cases.
    k1.launches = k3.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        feats, scores = evaluate.main([
            "--model_ckpt", ckpt, "--prefix", root, "--mask",
            str(Path(root) / "updated_testing_mask.txt"), "--device",
            str(dev)])
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    counts = {"pair_score": k1.launches, "bottleneck": k3.launches}
    lines = [json.loads(line) for line in buf.getvalue().splitlines()
             if line.startswith("{")]
    print(f"eval: tools.evaluate --prefix ({faces} faces at {F_IMAGE}^2, "
          f"VGGFace-ResNet50 (3, 4, 6, 3) bf16, head (512, 64)): "
          f"{t_eval:.2f} s; launches {counts}", flush=True)
    for line in lines:
        print(f"eval: {json.dumps(line)}", flush=True)
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched by tools.evaluate")
    check([j["case"] for j in lines] == ["impersonation", "obfuscation",
                                         "overall"]
          and all(np.isfinite([j["auc"], j["eer"], j["gar_at_1pct_far"],
                               j["gar_at_01pct_far"]]).all() for j in lines),
          "evaluate: missing or non-finite AUC / EER / GAR lines")
    check(feats.shape == (faces, I_FEATURE_RES) and np.isfinite(feats).all(),
          "evaluate: bad features")
    ft = torch.as_tensor(feats, device=dev)
    want = pairwise.score_matrix_reference(head, ft, ft)
    err = maxdiff(scores, want)
    d = (scores - want).abs()
    lz = torch.special.logit(want.double(), eps=1e-12).abs()
    print(f"eval: grid {tuple(scores.shape)} kernel vs plain on the same "
          f"features: max|diff| {err:.3e} (limit {K1_FLOAT_LIMIT}), mean "
          f"{float(d.mean()):.3e}, {100 * float((d > 1e-3).float().mean()):.3f}"
          f" % of pairs past 1e-3; |logit| median {float(lz.median()):.2f}, "
          f"max {float(lz.max()):.2f}", flush=True)
    check(scores.shape == (faces, faces) and err <= K1_FLOAT_LIMIT,
          f"evaluate grid: max|diff| {err} > {K1_FLOAT_LIMIT}")
    # Both sides against float64 on a band of rows: where the kernel and the
    # plain version part, each should be as far from the f64 answer.
    band = slice(0, I_BAND)
    dist = k1_vs_f64(head, ft[band], ft, scores[band], want[band])
    print(f"eval: grid rows 0-{I_BAND - 1}: {f64_line(dist)}", flush=True)
    f64_check(dist, "evaluate grid")
    del ft, want, scores, d, lz

    # 2. The DFW-size evaluation: 7,770 seeded features, the protocol's mask
    # for 1,110 people (in memory), the grid, then cases 1-3; twice (the
    # first call also packs the head and warms the sort).
    kinds, persons = dfw_test_protocol(I_DFW_PEOPLE, 3, 3, 1)
    mask_t = torch.as_tensor(dfw_test_mask(kinds, persons), device=dev).to(
        torch.int8)
    n = mask_t.shape[0]
    fd = torch.randn((n, I_FEATURE_RES), device=dev,
                     generator=torch.Generator(dev).manual_seed(SEED))
    thresholds = np.linspace(0.0, 1.0, 10001)
    for run in ("first", "warm"):
        torch.cuda.synchronize()
        k1.launches = 0
        t0 = time.perf_counter()
        grid = restore_head_and_score(ckpt, fd, dev)
        torch.cuda.synchronize()
        t_grid = time.perf_counter() - t0
        launched = k1.launches
        t_sweep = t_stats = 0.0
        stats = {}
        for case in (1, 2, 3):
            t0 = time.perf_counter()
            gen, imp = masked_scores(grid, mask_t, case)
            tpr, fpr = threshold_sweep(gen, imp, thresholds)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            stats[case] = (roc_stats(tpr, fpr), gen.numel(), imp.numel())
            t_stats += time.perf_counter() - t1
            t_sweep += t1 - t0
        print(f"eval: DFW evaluation s ({run}; {n}^2 x {I_FEATURE_RES} grid "
              f"+ ROC for cases 1-3): grid {t_grid:.4f}, split + sweep "
              f"{t_sweep:.4f}, stats {t_stats:.4f}, total "
              f"{t_grid + t_sweep + t_stats:.4f} on {smi}; K1 launches "
              f"{launched}", flush=True)
    # The warm run's launches count (the first one is the same work again).
    counts["pair_score"] += launched
    check(launched > 0, "kernel pair_score was not launched by the DFW grid")
    check(grid.shape == (n, n) and bool(torch.isfinite(grid).all()),
          "DFW grid: bad output")
    # The grid against the plain version on its first and last rows (all
    # columns), and both against f64 on the first rows.
    head_d = SiameseHead(I_FEATURE_RES, device=dev)
    head_d.load_state_dict(T.restore(ckpt, head_d.state_dict()))
    for band in (slice(0, I_BAND), slice(n - I_BAND, n)):
        want = pairwise.score_matrix_reference(head_d, fd[band], fd)
        err = maxdiff(grid[band], want)
        print(f"eval: DFW grid rows {band.start}-{band.stop - 1} x {n} "
              f"kernel vs plain: max|diff| {err:.3e} (limit "
              f"{K1_FLOAT_LIMIT})", flush=True)
        check(err <= K1_FLOAT_LIMIT, f"DFW grid rows {band.start}-"
              f"{band.stop - 1}: max|diff| {err} > {K1_FLOAT_LIMIT}")
        if band.start == 0:
            dist = k1_vs_f64(head_d, fd[band], fd, grid[band], want)
            print(f"eval: DFW grid rows 0-{I_BAND - 1}: {f64_line(dist)}",
                  flush=True)
            f64_check(dist, "DFW grid")
    del want
    iu = torch.triu(torch.ones(n, n, dtype=torch.bool, device=dev), 1)
    for case, (st, ng, ni) in stats.items():
        gen_codes = {1: (1,), 2: (2,), 3: (1, 2)}[case]
        want_g = int((torch.isin(mask_t, torch.tensor(
            gen_codes, device=dev, dtype=torch.int8)) & iu).sum())
        print(f"eval: DFW case {case}: {ng} genuine, {ni} imposter pairs; "
              f"AUC {st.auc:.6f} EER {st.eer:.6f} GAR@1% "
              f"{st.gar_at_1pct_far:.6f} (random head and features)",
              flush=True)
        check(ng == want_g and ni > 0 and np.isfinite(list(st)).all(),
              f"DFW case {case}: bad split or statistics")
    del grid, mask_t, fd, iu

    # 3. run_eval_regression on EVAL_r05.json's protocol (the CLI's
    # defaults), on the card; each stage's grid is kept and held in full to
    # the plain version on the same head and features after the run.
    grids = []
    score_stage = eval_regression.restore_head_and_score

    def kept(model_ckpt, feats, device):
        out = score_stage(model_ckpt, feats, device)
        grids.append((model_ckpt, feats, out))
        return out

    eval_regression.restore_head_and_score = kept
    buf = io.StringIO()
    torch.cuda.synchronize()
    k1.launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            art = eval_regression.main(["--device", str(dev)])
        torch.cuda.synchronize()
    finally:
        eval_regression.restore_head_and_score = score_stage
    t_reg = time.perf_counter() - t0
    launched = k1.launches
    counts["pair_score"] += launched
    check(launched > 0, "kernel pair_score was not launched by "
          "run_eval_regression")
    check(len(grids) == 4, f"eval_regression scored {len(grids)} stages")
    for model_ckpt, feats, got in grids:
        ft = torch.as_tensor(feats, device=dev).float()
        hs = SiameseHead(ft.shape[1], device=dev)
        hs.load_state_dict(T.restore(model_ckpt, hs.state_dict()))
        want = pairwise.score_matrix_reference(hs, ft, ft)
        err = maxdiff(got, want)
        dist = k1_vs_f64(hs, ft, ft, got, want)
        stage = Path(model_ckpt).name
        print(f"eval: {stage} grid {tuple(got.shape)} x {ft.shape[1]} kernel "
              f"vs plain: max|diff| {err:.3e} (limit {K1_FLOAT_LIMIT}); "
              f"{f64_line(dist)}", flush=True)
        check(err <= K1_FLOAT_LIMIT, f"eval_regression {stage} grid: "
              f"max|diff| {err} > {K1_FLOAT_LIMIT}")
        f64_check(dist, f"eval_regression {stage} grid")
    ref = json.loads((Path(__file__).resolve().parent / I_EVAL_R05)
                     .read_text())
    print(f"eval: run_eval_regression, {I_EVAL_R05}'s protocol "
          f"({art['protocol']['train_people']} train / "
          f"{art['protocol']['test_people']} test people at "
          f"{art['protocol']['image_size']}^2, n_steps "
          f"{art['protocol']['n_steps']}): {t_reg:.1f} s; K1 launches "
          f"{launched}", flush=True)
    for stage, cases in art["stages"].items():
        o, r = cases["overall"], ref["stages"][stage]["overall"]
        print(f"eval: stage {stage} overall AUC {o['auc']:.6f} EER "
              f"{o['eer']:.6f} GAR@1% {o['gar_at_1pct_far']:.6f} queries "
              f"{o.get('oracle_queries', '-')} ({I_EVAL_R05}: AUC "
              f"{r['auc']:.6f} EER {r['eer']:.6f} GAR@1% "
              f"{r['gar_at_1pct_far']:.6f} queries "
              f"{r.get('oracle_queries', '-')})", flush=True)
        check(all(np.isfinite([v[k] for k in ("auc", "eer",
                                               "gar_at_1pct_far",
                                               "gar_at_01pct_far")]).all()
                  for v in cases.values()),
              f"eval_regression {stage}: non-finite metric")
    flags, want_flags = art["ordering"], ref["ordering"]
    check(sorted(flags) == sorted(want_flags) and len(flags) == 15,
          f"eval_regression: flags {sorted(flags)}")
    differ = [k for k in want_flags if flags[k] != want_flags[k]]
    for k in want_flags:
        print(f"eval: flag {k} {flags[k]} ({I_EVAL_R05}: {want_flags[k]})",
              flush=True)
    print(f"eval: flags that differ from {I_EVAL_R05}: {differ or 'none'}",
          flush=True)
    st = art["stages"]
    check(st["existing_al"]["overall"]["oracle_queries"]
          == st["alink"]["overall"]["oracle_queries"],
          "eval_regression: the baseline's budget differs from alink's")
    return counts

# Phase (j): resume, supervised restart and augment at full width: phase
# (f)'s configuration and cuts with augment=True and loop_checkpoint.  Every
# run loads the M2 and the committee that (f) pretrained and saved, so the
# staging (and the host generator's state when the loop starts) is the same
# in every run compared.  A resumed run equals an uninterrupted one only if
# every op of a chunk and of the finetune is deterministic from run to run:
# the hand-written kernels are, cudnn.benchmark stays off, and the noise
# bank's scatter-add (poisson) sums integer counts, exact in any order.
J_INJECTED = "injected fault after slab 2's finetune"
J_PREFETCH_STEPS = 16     # custom_train batches through the prefetcher
J_PREFETCH_BATCH = 256


def phase_resume(dev, smi: str, f_cfg, f_finetune_s: float) -> dict:
    """(j): ``run_alink(augment=True, loop_checkpoint=A)`` uninterrupted
    (K2 and K3 counted), the same run supervised with a fault injected into
    its second slab after its finetune (``max_restarts=1``) and held to the
    first bit for bit,
    K2 at augment's own shape against its plain version, and custom_train
    through a ``DevicePrefetcher`` held to the same loop fed directly.
    Returns the K2 and K3 launches of the uninterrupted run."""
    import dataclasses

    from alink_tpu_torch.active import loop as loop_mod
    from alink_tpu_torch.data import DevicePrefetcher
    from alink_tpu_torch.drivers import alink as alink_mod
    from alink_tpu_torch.drivers import common
    from alink_tpu_torch.models import SiameseHead
    from alink_tpu_torch.ops import augment, image, resblock
    from alink_tpu_torch.train import TrainState, custom_train

    t_phase = time.perf_counter()
    out = Path(f_cfg.out_model).parent
    for line in F_CUTS + ("augment=True, loop_checkpoint, checkpoint_every "
                          "1; M2 and committee loaded from (f)'s pretraining",):
        print(f"resume cut: {line}", flush=True)
    featurize, _ = common.make_resnet50_featurizer(
        torch.Generator().manual_seed(SEED), device=dev)
    cfg_a = dataclasses.replace(f_cfg, augment=True,
                                loop_checkpoint=str(out / "loop_a"),
                                out_model=str(out / "post_a"))
    k2 = image.affine_warp_batch_kernel
    k3 = resblock.bottleneck_s1_kernel

    # 1. Ground truth, uninterrupted; augment's inputs and matrices recorded.
    seen = []
    real_augment = loop_mod.augment_pairs

    def recorded(g, left, right, labels):
        draws = {}
        draw = augment.torch_draws(g)

        def keep(block, variant, side, n, h, w):
            draws[block, side] = (variant,) + draw(block, variant, side, n,
                                                   h, w)
            return draws[block, side][1:]

        seen.append((left, right, draws))
        return real_augment(g, left, right, labels, draw=keep)

    loop_mod.augment_pairs = recorded
    k2.launches = k3.launches = 0
    try:
        t0 = time.perf_counter()
        gt = alink_mod.run_alink(cfg_a, featurize=featurize, device=dev)
        torch.cuda.synchronize()
        t_gt = time.perf_counter() - t0
    finally:
        loop_mod.augment_pairs = real_augment
    counts = {"affine_warp": k2.launches, "bottleneck": k3.launches}
    n_ft = sum(lg.finetuned for lg in gt.logs)
    print(f"resume: run_alink(augment=True) {t_gt:.1f} s; launches {counts}; "
          f"{n_ft} finetune events", flush=True)
    check(n_ft > 0 and len(seen) == n_ft, "augment: no finetune ran")
    check(counts["affine_warp"] == 6 * n_ft,
          f"K2 launched {counts['affine_warp']} times, not 6 x {n_ft}")
    check(counts["bottleneck"] > 0, "K3 was not launched by the augmented run")
    tm = gt.timings.as_dict()
    n_it = len(gt.logs)
    print("resume: augmented per-phase s/iteration "
          + ", ".join(f"{k} {v / n_it:.4f}" for k, v in
                      sorted(tm.items(), key=lambda kv: -kv[1]))
          + f"; finetune s/event {tm['finetune'] / n_ft:.4f} (phase (f) "
          f"without augment {f_finetune_s:.4f}); save s/call "
          f"{tm['save'] / gt.timings.counts['save']:.4f} on {smi}",
          flush=True)

    # 2. Supervised restart: one RuntimeError in the second slab, after the
    # first checkpoint, raised once its finetune has trained M2 in place and
    # moved both generators; the second attempt resets them from the
    # driver's snapshots and resumes from the checkpoint.
    check(gt.logs[1].finetuned, "resume: slab 2 ran no finetune to fault in")
    attempts, faults = [], []

    class Flaky(loop_mod.ALinkLoop):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            attempts.append(self)

        def _finetune(self, *a, **k):
            super()._finetune(*a, **k)
            if len(self.logs) == 1 and not faults:
                faults.append(len(attempts))
                raise RuntimeError(J_INJECTED)

    cfg_b = dataclasses.replace(cfg_a, loop_checkpoint=str(out / "loop_b"),
                                out_model=str(out / "post_b"), max_restarts=1)
    alink_mod.ALinkLoop = Flaky
    k2.launches = k3.launches = 0
    try:
        t0 = time.perf_counter()
        sup = alink_mod.run_alink(cfg_b, featurize=featurize, device=dev)
        torch.cuda.synchronize()
        t_sup = time.perf_counter() - t0
    finally:
        alink_mod.ALinkLoop = loop_mod.ALinkLoop
    st = sup.timings
    print(f"resume: supervised run {t_sup:.1f} s, attempts {len(attempts)}, "
          f"'{J_INJECTED}' raised in attempt {faults}; K2 {k2.launches}, "
          f"K3 {k3.launches} launches; restore {st.totals['restore']:.4f} s, "
          f"save s/call {st.totals['save'] / st.counts['save']:.4f}",
          flush=True)
    check(len(attempts) == 2 and faults == [1] and sup is attempts[1].state,
          f"supervision: {len(attempts)} attempts, faults in {faults}")
    check(sup.logs == gt.logs[len(gt.logs) - len(sup.logs):]
          and len(sup.logs) == len(gt.logs) - 1,
          f"resumed logs {sup.logs} != the tail of {gt.logs}")
    for f in ("active_count", "un_size", "pool_cursor", "replay_draws"):
        check(getattr(sup, f) == getattr(gt, f),
              f"{f}: {getattr(sup, f)} != {getattr(gt, f)}")
    ga = gt.m2_state.module.state_dict()
    gb = sup.m2_state.module.state_dict()
    deltas = {k: maxdiff(ga[k], gb[k]) for k in ga}
    oa = gt.m2_state.optimizer.state_dict()
    ob = sup.m2_state.optimizer.state_dict()
    opt_same = oa["param_groups"] == ob["param_groups"] and all(
        torch.equal(oa["state"][i][k], ob["state"][i][k])
        for i in oa["state"] for k in oa["state"][i])
    print(f"resume: M2 after the restart vs uninterrupted: max|diff| per "
          f"tensor {max(deltas.values()):.3e}; optimizer state equal "
          f"{opt_same}", flush=True)
    check(all(torch.equal(ga[k], gb[k]) for k in ga),
          f"M2 differs after the restart: {deltas}")
    check(opt_same, "optimizer state differs after the restart")

    # 3. K2 at augment's own shape: the first finetune's queried pairs and
    # their matrices, against the plain version.
    left, right, draws = seen[0]
    q = left.shape[0]
    worst, cases = 0.0, []
    for (block, side), (variant, A, t) in sorted(draws.items()):
        x = (left, right)[side]
        Ms = augment._pullback_to_forward(F_IMAGE, F_IMAGE, A, t,
                                          variant != "shift").contiguous()
        got = k2(x, Ms, (F_IMAGE, F_IMAGE), "nearest", "nearest")
        want = image.affine_warp_batch_reference(x, Ms, (F_IMAGE, F_IMAGE),
                                                 "nearest", "nearest")
        worst = max(worst, maxdiff(got, want))
        cases.append((x, Ms))
    check(worst == 0.0, f"K2 at the augment shape: max|diff| {worst}")
    x, Ms = cases[0]
    ms, call = kernel_ms(
        lambda: k2(x, Ms, (F_IMAGE, F_IMAGE), "nearest", "nearest"), k2)
    plain = cuda_ms(lambda: image.affine_warp_batch_reference(
        x, Ms, (F_IMAGE, F_IMAGE), "nearest", "nearest"), iters=5)
    bound = 2 * x.numel() * 4 / H100_BYTES_PER_S * 1e3
    print(f"K2 augment ({q}, {F_IMAGE}, {F_IMAGE}, 3) f32 nearest/nearest, "
          f"{len(cases)} warps: max|diff| {worst:.3e} vs plain; kernel "
          f"{ms:.4f} ms ({call:.4f} per call from Python), plain "
          f"{plain:.4f} ms, bound {bound:.4f} ms (bytes) on {smi}",
          flush=True)

    # 4. custom_train through a DevicePrefetcher of pinned host batches
    # against the same loop fed the batches directly.
    def batches():
        rng = np.random.default_rng(SEED)
        while True:
            yield ((rng.random((J_PREFETCH_BATCH, 2048), np.float32),
                    rng.random((J_PREFETCH_BATCH, 2048), np.float32)),
                   (rng.random(J_PREFETCH_BATCH) > 0.5).astype(np.int64))

    def train(it):
        g = torch.Generator().manual_seed(SEED)
        st = TrainState(SiameseHead(2048, generator=g, device=dev))
        return custom_train(st, it, epochs=1, batch_size=J_PREFETCH_BATCH,
                            generator=g,
                            n_steps=J_PREFETCH_STEPS * J_PREFETCH_BATCH)

    placed = []

    def inspect(pf):
        for item in pf:
            placed.extend(t.device.type for t in (*item[0], item[1]))
            yield item

    s_raw, l_raw = train(batches())
    with DevicePrefetcher(batches(), depth=2, device=dev) as pf:
        s_pre, l_pre = train(inspect(pf))
        consumer = torch.cuda.current_stream(dev)
        side_stream = pf.copy_stream is not None and (
            pf.copy_stream.cuda_stream != consumer.cuda_stream)
    torch.cuda.synchronize()
    same = l_raw == l_pre and all(
        torch.equal(a, b) for a, b in zip(s_raw.module.parameters(),
                                          s_pre.module.parameters()))
    print(f"prefetch: custom_train over {J_PREFETCH_STEPS} batches of "
          f"{J_PREFETCH_BATCH} pairs: prefetched == direct {same}; "
          f"{len(placed)} tensors, devices {sorted(set(placed))}; copy on a "
          f"side stream {side_stream}", flush=True)
    check(same, "custom_train through the prefetcher differs")
    check(len(placed) == 3 * J_PREFETCH_STEPS
          and set(placed) == {"cuda"}, f"prefetched devices {placed}")
    check(side_stream, "the prefetcher did not copy on a side stream")
    print(f"resume: phase (j) {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return counts


def rng_images(n: int) -> np.ndarray:
    return np.random.default_rng(SEED).uniform(
        0, 255, (n, F_IMAGE, F_IMAGE, 3)).astype(np.float32)


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


# Phase (k): the rest of detect and serving, and the ArcFace A-LINK driver.
# Photos and batch as (c)/(d), open thresholds.  The crowd profile's
# within-budget totals cover every candidate (n x stage1_budget,
# n x stage2_budget); its defaults (4,096 and 4,096) are over budget here.
K_OPEN = (0.0, 0.0, 0.0)
K_PROFILES = ("typical", "worst_case", "crowd")
K_EXACT_PX = 1e-3        # crowd within budget vs worst_case: boxes, landmarks
K_WINDOW_ITERS = 3       # process calls per timing window, 7 windows
# The ArcFace training slice: (f)'s epochs, steps, queue and chunk; cuts,
# each printed:
K_PEOPLE = 4             # synthetic DFW people (DFW trains on ~1,000)
K_ALINK_BS = 2           # people per slab, default 16: 2 slabs of 40 pairs
# Selection opened so that every slab queries pairs and M2 is finetuned
# through ArcFace features: every pair selected, no grey band (the
# committee of this short pretraining sits inside the default band).
K_DISPARITY = 1.0        # default 0.25
K_EPS = 0.0              # default 0.05
K_LOOP_MAXITER = 2       # the loop's one-pixel generations, default 50
K_DE_PAIRS = 8           # the one-pixel attack alone, maxiter cut as (g)
K_FGSM_PAIRS = 32
K_ARC = 112


def phase_serving_rest(dev, g, rng, head, smi: str) -> dict:
    """(k), serving side: the crowd profile, faces/s under each profile,
    L-Net, ``detect_faces_limited``, ``profile_cascade`` and
    ``calibrate_budgets``, genderage and the score matrix over crowd
    embeddings; returns K1's and K2's launches."""
    from alink_tpu_torch.detect import (CascadeConfig, FaceModel,
                                        detect_faces, detect_faces_limited,
                                        init_cascade_params)
    from alink_tpu_torch.detect import cascade
    from alink_tpu_torch.detect.cascade import alignment_transforms
    from alink_tpu_torch.models import (ArcFaceResNet100, GenderAgeHead,
                                        GenderAgeResNet50)
    from alink_tpu_torch.ops import image, pairwise
    from alink_tpu_torch.serving import Verifier
    from alink_tpu_torch.tools.profile_serving import summary, windows

    t_phase = time.perf_counter()
    k1, k2 = pairwise.score_matrix_kernel, image.affine_warp_batch_kernel
    counts = {"pair_score": 0, "affine_warp": 0}
    photos = torch.as_tensor(rng.uniform(0, 255, (BATCH, IMG, IMG, 3)),
                             dtype=torch.float32, device=dev)
    wc = CascadeConfig.worst_case(thresholds=K_OPEN)
    crowd = CascadeConfig.crowd(thresholds=K_OPEN)

    # The crowd profile within budget, f32 towers: worst_case's detections.
    p32 = init_cascade_params(torch.Generator().manual_seed(SEED + 11),
                              dtype=torch.float32, device=dev)
    within = CascadeConfig.crowd(thresholds=K_OPEN,
                                 stage2_total=BATCH * wc.stage1_budget,
                                 stage3_total=BATCH * wc.stage2_budget)
    want, got = detect_faces(p32, photos, wc), detect_faces(p32, photos,
                                                            within)
    v = want.valid
    check(torch.equal(got.valid, v) and bool(v.any()),
          "crowd within budget: valid differs from worst_case")
    eb, el = maxdiff(got.boxes[v], want.boxes[v]), maxdiff(
        got.landmarks[v], want.landmarks[v])
    print(f"crowd: within budget (totals {within.stage2_total}, "
          f"{within.stage3_total}) vs worst_case, f32 towers: valid equal "
          f"({int(v.sum())} faces), max|diff| boxes {eb:.3e} landmarks "
          f"{el:.3e} px (limit {K_EXACT_PX})", flush=True)
    check(eb <= K_EXACT_PX and el <= K_EXACT_PX, "crowd within budget: "
          f"boxes {eb} or landmarks {el} past {K_EXACT_PX}")
    del p32, want, got

    # The default crowd() over budget: the pool is the top stage-2 total of
    # the stage-1 scores, against a plain stable sort on the host.
    pb = init_cascade_params(torch.Generator().manual_seed(SEED + 12),
                             device=dev)
    with torch.no_grad():
        b1, s1, v1 = cascade._stage1(pb, photos, crowd)
    n_cand = int(v1.sum())
    total = crowd.stage2_total
    check(n_cand > total, f"crowd: {n_cand} candidates fit the pool")
    idx, iid, tv = cascade._pool_by_score(
        s1.reshape(-1), v1.reshape(-1), BATCH, crowd.stage1_budget, total)
    flat = torch.where(v1, s1, float("-inf")).reshape(-1).cpu()
    order = torch.sort(flat, descending=True, stable=True).indices[:total]
    check(torch.equal(torch.sort(idx[tv].cpu()).values,
                      torch.sort(order).values),
          "crowd: the pooled candidates are not the top stage-1 scores")
    check(bool((iid[:-1] <= iid[1:]).all()), "crowd: pool not by image")
    fold = dict(offset=127.5, scale=0.0078125)
    bx = b1.reshape(-1, 4)[idx]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    image.crop_and_resize_gather(photos, bx, iid, (24, 24), **fold)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    ms = cuda_ms(lambda: image.crop_and_resize_gather(
        photos, bx, iid, (24, 24), **fold), iters=10)
    whole = total * IMG * IMG * 3 * 4 / 2 ** 20
    print(f"crowd: default crowd() {n_cand} stage-1 candidates, pool "
          f"{total}: exactly the top {total} scores (plain stable sort); "
          f"crop_and_resize_gather {total} x 24^2 from {IMG}^2: {ms:.3f} ms, "
          f"peak {peak:.1f} MiB above the inputs (a whole gather: "
          f"{whole:.0f} MiB) on {smi}", flush=True)
    det = detect_faces(pb, photos, crowd)
    check(det.boxes.shape == (BATCH, crowd.stage3_budget, 4)
          and bool(det.valid.any(dim=1).all())
          and bool(torch.isfinite(det.landmarks).all()),
          "crowd: bad detections")
    del b1, s1, v1, idx, iid, tv, bx

    # faces/s under each profile, each profile's K2 launches.
    emb = ArcFaceResNet100(generator=g, device=dev)
    for name in K_PROFILES:
        fm = FaceModel(emb, pb, getattr(CascadeConfig, name)(
            thresholds=K_OPEN))
        k2.launches = 0
        s = summary(windows(lambda: fm.process(photos), dev, n_windows=7,
                            iters=K_WINDOW_ITERS))
        torch.cuda.synchronize()
        counts["affine_warp"] += k2.launches
        print(f"process {name}: {BATCH * 1e3 / s['median_ms']:.1f} faces/s "
              f"at batch {BATCH} (median of 7 windows of {K_WINDOW_ITERS} "
              f"{s['median_ms']:.2f} ms/batch, min {s['min_ms']:.2f}, max "
              f"{s['max_ms']:.2f}; main-thread CPU {s['cpu_median_ms']:.2f}), "
              f"K2 launches {k2.launches}, r100 bf16, {IMG}x{IMG} on {smi}",
              flush=True)
        check(k2.launches > 0, f"process {name}: K2 was not launched")

    # L-Net: every refined landmark inside its patch; K2's chips of the
    # refined landmarks against the plain warp.
    typ = CascadeConfig.typical(thresholds=K_OPEN)
    fm_l = FaceModel(emb, pb, dataclasses.replace(typ,
                                                  accurate_landmark=True))
    d0, d1 = detect_faces(pb, photos, typ), fm_l.detect(photos)
    check(torch.equal(d0.valid, d1.valid) and torch.equal(d0.boxes,
                                                          d1.boxes),
          "accurate_landmark changed the detections")
    bw = torch.maximum(d0.boxes[..., 2] - d0.boxes[..., 0] + 1,
                       d0.boxes[..., 3] - d0.boxes[..., 1] + 1)
    pw = torch.round(bw * 0.25)
    pw = torch.where(pw % 2 == 1, pw + 1, pw)[..., None, None]
    x0 = torch.round(d0.landmarks - 0.5 * pw)
    # L-Net's offsets lie in [0.15, 0.85] of the patch (or at 0.5), and
    # x0 and the width are integers, so the truncation stays in the patch.
    inside = (d1.landmarks >= x0) & (d1.landmarks <= x0 + pw)
    moved = (d1.landmarks - d0.landmarks).abs()[d0.valid]
    check(bool(inside[d0.valid].all()), "a refined landmark left its patch")
    best = torch.argmax(torch.where(d1.valid, d1.scores, -1.0), dim=1)
    lmk = d1.landmarks[torch.arange(BATCH, device=dev), best]
    Ms = alignment_transforms(lmk)
    chips = image.affine_warp_batch(photos, Ms, (112, 112))
    one = image.affine_warp(photos[0], Ms[0], (112, 112))
    k2.launches = 0
    fm_l.process(photos)
    torch.cuda.synchronize()
    counts["affine_warp"] += k2.launches
    err = max(maxdiff(chips, image.affine_warp_batch_reference(
        photos, Ms, (112, 112))), maxdiff(one, chips[0]))
    print(f"lnet: {int(d0.valid.sum())} faces, every refined landmark in its "
          f"patch, mean |move| {float(moved.mean()):.2f} px; K2 chips of the "
          f"refined landmarks vs plain max|diff| {err:.3e}; K2 launches "
          f"{k2.launches}", flush=True)
    check(err <= 1e-3, f"lnet chips: max|diff| {err} > 1e-3")
    check(k2.launches > 0, "accurate_landmark process: K2 was not launched")

    # detect_faces_limited from the full cascade's stage-1 boxes.
    with torch.no_grad():
        b1, _, v1 = cascade._stage1(pb, photos, typ)
    dl = detect_faces_limited(pb, photos, b1, v1, typ)
    check(torch.equal(dl.valid, d0.valid), "limited: valid differs")
    el = max(maxdiff(dl.boxes[d0.valid], d0.boxes[d0.valid]),
             maxdiff(dl.landmarks[d0.valid], d0.landmarks[d0.valid]))
    print(f"limited: from stage-1 boxes reproduces detect_faces, max|diff| "
          f"{el:.3e} px", flush=True)
    check(el <= K_EXACT_PX, f"limited: max|diff| {el}")

    # profile_cascade against the stages' valid sums; calibrate_budgets.
    prof = cascade.profile_cascade(pb, photos, wc)
    with torch.no_grad():
        b, _, v1 = cascade._stage1(pb, photos, wc)
        b, _, v2 = cascade._stage2(pb, photos, b, v1, wc)
        v3 = cascade._stage3(pb, photos, b, v2, wc)[2]
    for key, vv in (("stage1", v1), ("stage2", v2), ("stage3", v3)):
        check(torch.equal(prof[key], vv.sum(1)), f"profile {key} differs")
    print("profile_cascade: stage counts equal the stages' valid sums; mean "
          + ", ".join(f"{k} {float(t.float().mean()):.1f}"
                      for k, t in prof.items()), flush=True)
    res = subprocess.run(
        [sys.executable, "-m", "alink_tpu_torch.tools.calibrate_budgets"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=300)
    text = res.stdout
    check(res.returncode == 0 and "Recommended config" in text,
          f"calibrate_budgets failed: {res.stderr[-2000:]}")
    print("python -m alink_tpu_torch.tools.calibrate_budgets (smoke mode): "
          + " ".join(text.split("Recommended config:")[1].split()), flush=True)

    # Genderage on 64 aligned chips.
    fm_t = FaceModel(emb, pb, typ)
    aligned = fm_t.get_input(photos)
    ga = GenderAgeResNet50(generator=g, device=dev).eval()
    with torch.no_grad():
        ms = cuda_ms(lambda: ga(aligned), iters=10)
    gender, age = fm_t.get_ga(aligned, ga)
    hg, ha = fm_t.get_ga_from_embedding(aligned, GenderAgeHead(
        generator=g, device=dev))
    for gg, aa in ((gender, age), (hg, ha)):
        check(gg.shape == aa.shape == (BATCH,) and bool(
            ((gg == 0) | (gg == 1)).all()) and bool(
            ((aa >= 0) & (aa <= 100)).all()), "genderage: bad decode")
    print(f"genderage: GenderAgeResNet50 {ga.stage_sizes} bf16 on {BATCH} "
          f"aligned chips {ms:.2f} ms/batch; gender {gender.tolist()[:8]}..., "
          f"age {age.tolist()[:8]}...; head over embeddings ok on {smi}",
          flush=True)
    del ga

    # Verifier.score_matrix over crowd-profile embeddings (K1).
    fm_c = FaceModel(emb, pb, crowd)
    k1.launches = 0
    grid = Verifier(fm_c.process, head).score_matrix(photos)
    torch.cuda.synchronize()
    counts["pair_score"] += k1.launches
    feats = fm_c.process(photos)
    err = maxdiff(grid, pairwise.score_matrix_reference(head, feats, feats))
    print(f"crowd: Verifier.score_matrix over crowd embeddings vs plain "
          f"max|diff| {err:.3e} (limit {K1_FLOAT_LIMIT}); K1 launches "
          f"{k1.launches}", flush=True)
    check(k1.launches > 0, "score_matrix did not launch K1")
    check(err <= K1_FLOAT_LIMIT, f"crowd score_matrix: max|diff| {err}")
    print(f"serving rest: phase (k) serving side "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


def phase_arc(dev, smi: str) -> None:
    """(k), training side: ``drivers.alink_arc`` at full width (ArcFace
    r100 112^2 bf16, the default six-channel bank with perlin and the
    one-pixel DE), then DE and FGSM through ArcFace alone."""
    import tempfile

    from alink_tpu_torch.config import ALinkArcConfig
    from alink_tpu_torch.drivers import alink as driver
    from alink_tpu_torch.drivers.alink import (make_adversarial_predict,
                                               parse_config, run_alink)
    from alink_tpu_torch.drivers.alink_arc import make_arcface_featurizer
    from alink_tpu_torch.models import SiameseHead

    t_phase = time.perf_counter()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(prefix="arc_", dir=work))
    cfg = parse_config(
        [], config_cls=ALinkArcConfig, synthetic_people=K_PEOPLE,
        dig_epochs=F_DIG_EPOCHS, undig_epochs=F_UNDIG_EPOCHS,
        train_steps=F_TRAIN_STEPS, alink_bs=K_ALINK_BS,
        batch_send=F_BATCH_SEND, device_batch=F_DEVICE_BATCH, seed=SEED,
        disparity_ratio=K_DISPARITY, eps=K_EPS,
        out_model=str(out / "postALINK_arc"),
        ensemble_basepath=str(out / "ensemble_arc"),
        disguised_basemodel=str(out / "disguisedModel_arc"))
    check(cfg.image_res == (K_ARC, K_ARC) and cfg.feature_res == 512
          and "perlin" in cfg.noise and cfg.noise[-1] == "adversarial",
          f"ArcFace config {cfg}")
    for line in (f"synthetic_people {K_PEOPLE} (DFW: ~1,000 people)",
                 f"dig_epochs {F_DIG_EPOCHS} (40), undig_epochs "
                 f"{F_UNDIG_EPOCHS} (60), train_steps {F_TRAIN_STEPS} "
                 "(320,000)",
                 f"alink_bs {K_ALINK_BS} (16), batch_send {F_BATCH_SEND} (64),"
                 f" device_batch {F_DEVICE_BATCH} (1,024)",
                 f"the loop's one-pixel maxiter 50 -> {K_LOOP_MAXITER}",
                 f"disparity_ratio {K_DISPARITY} (0.25), eps {K_EPS} "
                 "(0.05): every slab queries pairs and finetunes M2",
                 f"DE alone: {K_DE_PAIRS} pairs, maxiter {G_DE_MAXITER}; "
                 f"FGSM on {K_FGSM_PAIRS} pairs"):
        print(f"arc cut: {line}", flush=True)
    t0 = time.perf_counter()
    featurize, model = make_arcface_featurizer(
        torch.Generator().manual_seed(cfg.seed + 100), depth=cfg.embed_depth,
        device=dev)
    print(f"arc: ArcFace r100 {model.stage_sizes} bf16 built in "
          f"{time.perf_counter() - t0:.1f} s; bank {cfg.noise}", flush=True)

    base = driver.ALinkLoop

    class Cut(base):
        def __init__(self, *a, **k):
            super().__init__(*a, adversarial_kwargs={
                "maxiter": K_LOOP_MAXITER}, **k)

    driver.ALinkLoop = Cut
    try:
        t0 = time.perf_counter()
        state = run_alink(cfg, featurize=featurize, device=dev)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
    finally:
        driver.ALinkLoop = base
    logs = state.logs
    for lg in logs:
        print(f"arc: {lg}", flush=True)
    check(len(logs) >= 1 and state.un_size == sum(
        lg.pairs for lg in logs) > 0, f"arc loop logs {logs}")
    n_ft = sum(lg.finetuned for lg in logs)
    tm = state.timings.as_dict()
    check(state.active_count > 0 and n_ft > 0 and "finetune" in tm,
          f"arc: no pair was queried or M2 never finetuned ({logs})")
    n_it = len(logs)
    print(f"arc: run_alink {t_run:.1f} s; one loop iteration "
          f"{sum(tm.values()) / n_it:.3f} s (mean of {n_it}, "
          f"{logs[0].pairs} pairs); per-phase s/iteration "
          + ", ".join(f"{k} {v / n_it:.3f}" for k, v in
                      sorted(tm.items(), key=lambda kv: -kv[1]))
          + f"; finetune s/event {tm['finetune'] / n_ft:.4f} ({n_ft} "
          f"events, active count {state.active_count} of {state.un_size}) "
          f"on {smi}", flush=True)

    g = torch.Generator().manual_seed(SEED + 13)
    head = SiameseHead(512, (512, 64), generator=g, device=dev)
    predict = make_adversarial_predict(featurize)
    rng = np.random.default_rng(SEED + 13)

    left, right = rand_pairs(rng, K_DE_PAIRS, K_ARC, dev)
    _, labels = one_pixel_targets(predict, head, left, right)
    al, ar, res, t_de = timed_one_pixel(predict, head, left, right, labels,
                                        G_DE_MAXITER)
    gens = int(res.nit.max())
    changed = ((al != left).any(-1).flatten(1).sum(1)
               + (ar != right).any(-1).flatten(1).sum(1))
    check(bool((changed <= 40).all()), f"DE wrote {changed.tolist()} pixels")
    images = 2 * int(res.nfev.sum())
    print(f"arc: one-pixel DE on ArcFace r100, {K_DE_PAIRS} pairs: "
          f"{t_de:.3f} s, {gens} generation(s) (nit {res.nit.tolist()}), "
          f"{t_de / max(gens, 1):.3f} s/generation incl. init, nfev "
          f"{res.nfev.tolist()} ({images} images of 112^2, "
          f"{images / t_de:.0f} images/s), stopped early "
          f"{res.stopped_early.tolist()}, pixels changed {changed.tolist()} "
          f"on {smi}", flush=True)

    left, right = rand_pairs(rng, K_FGSM_PAIRS, K_ARC, dev)
    labels = torch.nn.functional.one_hot(torch.as_tensor(
        rng.integers(0, 2, K_FGSM_PAIRS), device=dev), 2).float()
    fl, fr, ms_fgsm = timed_fgsm(predict, head, left, right, labels)
    step = torch.cat([(fl - left).abs(), (fr - right).abs()])
    check(bool(torch.isfinite(step).all()) and float(step.max()) == 2.0,
          "ArcFace FGSM step is not 2 pixels")
    print(f"arc: FGSM on ArcFace r100, {K_FGSM_PAIRS} pairs (forward + "
          f"backward through cuDNN bf16): {ms_fgsm:.2f} ms, "
          f"{100 * float((step == 2).float().mean()):.1f} % of pixels moved; "
          f"phase (k) training side {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# Phase (l): the Multi-PIE cross-resolution path at full width, then the
# classical-AL drivers.  Cuts, each printed:
L_SUBJECTS = 8           # synthetic Multi-PIE training subjects (~337)
L_TEST_SUBJECTS = 128    # test subjects: 128 gallery entries, 384 probes
L_ALINK_BS = 4           # subjects per slab, default 8: 2 slabs of 64 pairs
L_EPOCHS = 2             # lowres_epochs 10, highres_epochs 5
L_TRAIN_STEPS = 512      # samples per pretraining epoch, default 320,000
L_BATCH_SEND = 4         # default 32
L_LOOP_MAXITER = 2       # the loop's one-pixel generations, default 50
# Selection opened so that every slab queries pairs and M2 is finetuned:
# half of each slab's pairs selected, no grey band.  At most half the pool
# is then charged, so the oracle budget never stops the loop early.
L_DISPARITY = 0.5        # default 0.25
L_EPS = 0.0              # default 0.1
L_LOW = 48
L_CPU_IMAGES = 64        # SmallRes on the card vs its f32 copy on the CPU
L_REL_LIMIT = 2e-2
L_K1_LIMIT = 2e-2        # the tail's grid vs K1's plain version
L_KEEP_BAND = 0.02       # dropout keep share within 0.75 +/- this
L_WARM_STEPS = 20
L_DE_PAIRS = 8           # the one-pixel attack alone, maxiter as (g)
L_AL_ROUNDS = 2
L_AL_PEOPLE = 4          # existing_al's synthetic DFW people


def phase_mtp(dev, smi: str) -> dict:
    """(l): ``drivers.alink_mtp`` at full width (VGGFace-ResNet50 teacher on
    K3, SmallRes(2048) at 48^2 with dropout, the adversarial-only bank),
    its top-1 tail on K1 held to the plain version, SmallRes against its
    f32 CPU copy, a dropout step's masks, DE at 48^2, then
    ``existing_al`` and ``existing_al_mtp``; returns the kernels' launch
    counts on these paths."""
    import tempfile

    from alink_tpu_torch import train as T
    from alink_tpu_torch.config import ExistingALConfig, MTPConfig
    from alink_tpu_torch.data import (load_person_stacks, make_synthetic_dfw,
                                      make_synthetic_mtp, scan_mtp)
    from alink_tpu_torch.drivers import alink_mtp as tmtp
    from alink_tpu_torch.drivers import common, existing_al, existing_al_mtp
    from alink_tpu_torch.drivers.alink import parse_config
    from alink_tpu_torch.evaluation.identification import gallery_top1
    from alink_tpu_torch.models import SmallRes, preprocess, siamese
    from alink_tpu_torch.ops import pairwise, resblock

    t_phase = time.perf_counter()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(prefix="mtp_", dir=work))
    make_synthetic_mtp(str(out / "train"), num_subjects=L_SUBJECTS,
                       image_size=F_IMAGE, seed=SEED)
    make_synthetic_mtp(str(out / "test"), num_subjects=L_TEST_SUBJECTS,
                       image_size=L_LOW, seed=SEED + 1)
    cfg = parse_config(
        [], config_cls=MTPConfig, data_dir_prefix=str(out / "train"),
        test_dir=str(out / "test"), image_res=(F_IMAGE, F_IMAGE),
        lowres_epochs=L_EPOCHS,
        highres_epochs=L_EPOCHS, train_steps=L_TRAIN_STEPS,
        alink_bs=L_ALINK_BS, batch_send=L_BATCH_SEND,
        disparity_ratio=L_DISPARITY, eps=L_EPS, seed=SEED,
        out_model=str(out / "postALINK"),
        ensemble_basepath=str(out / "ensemble"),
        lowres_basemodel=str(out / "lowresModel"))
    check(cfg.noise == ("adversarial",) and cfg.low_res == L_LOW
          and cfg.image_res == (F_IMAGE, F_IMAGE)
          and cfg.feature_res == 2048, f"Multi-PIE config {cfg}")
    for line in (f"subjects {L_SUBJECTS} (Multi-PIE: ~337), test subjects "
                 f"{L_TEST_SUBJECTS}",
                 f"lowres_epochs {L_EPOCHS} (10), highres_epochs {L_EPOCHS} "
                 f"(5), train_steps {L_TRAIN_STEPS} (320,000)",
                 f"alink_bs {L_ALINK_BS} (8), batch_send {L_BATCH_SEND} (32)",
                 f"the loop's one-pixel maxiter 50 -> {L_LOOP_MAXITER}",
                 f"disparity_ratio {L_DISPARITY} (0.25), eps {L_EPS} (0.1): "
                 "every slab queries pairs and finetunes M2",
                 f"DE alone: {L_DE_PAIRS} pairs, maxiter {G_DE_MAXITER}; "
                 f"existing_al / existing_al_mtp: {L_AL_ROUNDS} rounds"):
        print(f"mtp cut: {line}", flush=True)
    featurize, _ = common.make_resnet50_featurizer(
        torch.Generator().manual_seed(SEED), device=dev)

    base, real_train = tmtp.ALinkLoop, T.custom_train
    pre = {}

    class Cut(base):
        def __init__(self, *a, **k):
            super().__init__(*a, adversarial_kwargs={
                "maxiter": L_LOOP_MAXITER}, **k)

    def timed_train(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_train(*a, **k)
        torch.cuda.synchronize()
        pre.update(s=time.perf_counter() - t0, steps=k["epochs"] * int(
            k["n_steps"] / k["batch_size"]),
            dropout=k.get("dropout_generator") is not None)
        return res

    k3, k1 = resblock.bottleneck_s1_kernel, pairwise.score_matrix_kernel
    tmtp.ALinkLoop, T.custom_train = Cut, timed_train
    try:
        k3.launches = 0
        t0 = time.perf_counter()
        state, top1 = tmtp.run_alink_mtp(cfg, featurize=featurize,
                                         device=dev)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        counts = {"bottleneck": k3.launches}
    finally:
        tmtp.ALinkLoop, T.custom_train = base, real_train
    print(f"mtp: run_alink_mtp {t_run:.1f} s; K3 launches "
          f"{counts['bottleneck']}; top-1 {top1}", flush=True)
    check(counts["bottleneck"] > 0,
          "kernel bottleneck was not launched by run_alink_mtp")
    check(pre.get("dropout") and pre["steps"] > 0,
          f"SmallRes pretraining did not run with dropout ({pre})")
    print(f"mtp: SmallRes(2048) {L_LOW}^2 pretraining with dropout: "
          f"{pre['s'] / pre['steps'] * 1e3:.2f} ms/step ({pre['steps']} "
          f"steps of {cfg.batch_size} pairs, host batches included) on "
          f"{smi}", flush=True)
    logs = state.logs
    for lg in logs:
        print(f"mtp: {lg}", flush=True)
    n_ft = sum(lg.finetuned for lg in logs)
    check(len(logs) == L_SUBJECTS // L_ALINK_BS and all(
        lg.pairs == (2 * L_ALINK_BS) ** 2 for lg in logs),
        f"mtp loop logs {logs}")
    check(state.active_count > 0 and n_ft > 0,
          f"mtp: no pair was queried or M2 never finetuned ({logs})")
    tm = state.timings.as_dict()
    n_it = len(logs)
    print(f"mtp: one loop iteration {sum(tm.values()) / n_it:.3f} s (mean "
          f"of {n_it}, {logs[0].pairs} pairs); per-phase s/iteration "
          + ", ".join(f"{k} {v / n_it:.3f}" for k, v in
                      sorted(tm.items(), key=lambda kv: -kv[1]))
          + f"; finetune s/event {tm['finetune'] / n_ft:.4f} ({n_ft} events,"
          f" active count {state.active_count} of {state.un_size}) on {smi}",
          flush=True)
    check(top1 is not None and 0.0 <= top1 <= 1.0, f"top-1 {top1}")

    # The top-1 tail again, with K1 counted and timed, then its grid held to
    # K1's plain version on the same embeddings.
    m2 = state.m2_state.module
    test_lo = load_person_stacks(list(scan_mtp(cfg.test_dir).values()),
                                 (L_LOW, L_LOW))
    score = tmtp.smallres_score_fn(state.m2_state)
    gallery_top1(score, test_lo)
    torch.cuda.synchronize()
    k1.launches = 0
    t0 = time.perf_counter()
    again = gallery_top1(score, test_lo)
    torch.cuda.synchronize()
    t_tail = (time.perf_counter() - t0) * 1e3
    counts["pair_score"] = tail_launches = k1.launches
    check(k1.launches > 0, "kernel pair_score was not launched by the "
          "top-1 tail")
    check(again == top1, f"top-1 {again} != the driver's {top1}")
    live = np.flatnonzero(test_lo.counts > 0)
    gallery = test_lo.images[live, 0]
    probes = np.concatenate([test_lo.images[p, 1:test_lo.counts[p]]
                             for p in live])
    pe = tmtp.embed(m2, probes, dev)
    ge = tmtp.embed(m2, gallery, dev)
    got = pairwise.score_matrix_kernel(m2.verify_head, pe, ge)
    want = pairwise.score_matrix_reference(m2.verify_head, pe, ge)
    torch.cuda.synchronize()
    err = maxdiff(got, want)
    print(f"mtp: top-1 {top1:.4f} over {len(probes)} probes x "
          f"{len(gallery)} gallery; the tail {t_tail:.2f} ms (embed both, "
          f"K1 grid, argmax), K1 launches {tail_launches}; grid vs plain max "
          f"|diff| {err:.3e} (limit {L_K1_LIMIT}) on {smi}", flush=True)
    check(err <= L_K1_LIMIT, f"mtp tail grid: K1 vs plain {err}")

    # SmallRes on the card against its f32 copy on the CPU.
    x = torch.as_tensor(probes[:L_CPU_IMAGES], device=dev)
    cpu = SmallRes(2048, dtype=torch.float32)
    cpu.load_state_dict({k: v.cpu() for k, v in m2.state_dict().items()})
    with torch.no_grad():
        e_dev = m2.embed(preprocess.smallres(x)).cpu()
        e_cpu = cpu.embed(preprocess.smallres(x.cpu()))
        l_dev = m2.logits(preprocess.smallres(x),
                          preprocess.smallres(x.flip(0))).cpu()
        l_cpu = cpu.logits(preprocess.smallres(x.cpu()),
                           preprocess.smallres(x.cpu().flip(0)))
    rel_e = maxdiff(e_dev, e_cpu) / float(e_cpu.abs().max())
    rel_l = maxdiff(l_dev, l_cpu) / float(l_cpu.abs().max())
    print(f"mtp: SmallRes bf16 on the card vs f32 on the CPU, "
          f"{L_CPU_IMAGES} images: relative max|diff| embed {rel_e:.3e}, "
          f"logits {rel_l:.3e} (limit {L_REL_LIMIT}) on {smi}", flush=True)
    check(max(rel_e, rel_l) <= L_REL_LIMIT,
          f"SmallRes card vs CPU: {rel_e}, {rel_l}")

    # One dropout train step: every mask's keep share, and the kept units
    # scaled by exactly 1/0.75 in the tower's dtype.
    masks = []
    draw = m2.tower.draw

    def record(shape, g, device):
        mk = draw(shape, g, device)
        masks.append(mk)
        return mk

    m2.tower.draw = record
    try:
        T.train_step(T.TrainState(m2, 0.1), preprocess.smallres(x),
                     preprocess.smallres(x.flip(0)),
                     torch.arange(len(x), device=dev) % 2,
                     dropout_generator=torch.Generator(dev).manual_seed(SEED))
    finally:
        m2.tower.draw = draw
    shares = [float(mk.float().mean()) for mk in masks]
    ones = torch.ones(4, 32, 23, 23, dtype=m2.tower.dtype, device=dev)
    scaled = m2.tower._dropout(ones, True,
                               torch.Generator(dev).manual_seed(SEED))
    kept = torch.tensor(1.0, dtype=ones.dtype) / siamese.KEEP
    values = set(torch.unique(scaled).float().tolist())
    print(f"mtp: dropout step on {len(x)} pairs: {len(masks)} masks "
          f"{[tuple(mk.shape) for mk in masks]}, keep shares "
          f"{[round(v, 4) for v in shares]}; multiplier values "
          f"{sorted(values)}", flush=True)
    check(len(masks) == 4 and all(mk.dtype == torch.bool for mk in masks)
          and all(abs(v - siamese.KEEP) <= L_KEEP_BAND for v in shares),
          f"dropout keep shares {shares}")
    check(values == {0.0, float(kept)}, f"dropout multipliers {values}")
    # The same step warm, at the pretraining's batch: device-resident pairs,
    # no host batch making.
    state = T.TrainState(m2, 0.1)
    b = cfg.batch_size
    xa, xb = preprocess.smallres(x[:b]), preprocess.smallres(x.flip(0)[:b])
    yb = torch.arange(b, device=dev) % 2
    gen = torch.Generator(dev).manual_seed(SEED)
    T.train_step(state, xa, xb, yb, dropout_generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(L_WARM_STEPS):
        T.train_step(state, xa, xb, yb, dropout_generator=gen)
    torch.cuda.synchronize()
    print(f"mtp: SmallRes train step with dropout, warm, batch {b}: "
          f"{(time.perf_counter() - t0) * 1e3 / L_WARM_STEPS:.2f} ms/step "
          f"(mean of {L_WARM_STEPS}) on {smi}", flush=True)

    # One-pixel DE through SmallRes: pairs at 224^2, scored at 48^2.
    predict = tmtp.make_adversarial_predict(L_LOW)
    rng = np.random.default_rng(SEED + 17)
    left, right = rand_pairs(rng, L_DE_PAIRS, F_IMAGE, dev)
    _, labels = one_pixel_targets(predict, m2, left, right)
    al, ar, res, t_de = timed_one_pixel(predict, m2, left, right, labels,
                                        G_DE_MAXITER)
    images = 2 * int(res.nfev.sum())
    changed = ((al != left).any(-1).flatten(1).sum(1)
               + (ar != right).any(-1).flatten(1).sum(1))
    check(bool((changed <= 40).all()), f"DE wrote {changed.tolist()} pixels")
    print(f"mtp: one-pixel DE through SmallRes, {L_DE_PAIRS} pairs of "
          f"{F_IMAGE}^2 scored at {L_LOW}^2: {t_de:.3f} s, nit "
          f"{res.nit.tolist()}, {images} images, {images / t_de:.0f} "
          f"images/s on {smi}", flush=True)

    # The classical-AL drivers, L_AL_ROUNDS rounds each, timed by round.
    rounds = []

    def timed_learner(cls):
        class Timed(cls):
            def query(self, *a, **k):
                torch.cuda.synchronize()
                rounds.append(time.perf_counter())
                return super().query(*a, **k)

        return Timed

    dfw = make_synthetic_dfw(str(out / "dfw"), num_people=L_AL_PEOPLE,
                             image_size=F_IMAGE, seed=SEED)
    for name, mod, run in (
            ("existing_al", existing_al, lambda: existing_al.run_existing_al(
                parse_config([], config_cls=ExistingALConfig,
                             data_dir_prefix=dfw, epochs=1, seed=SEED,
                             model_path=str(out / "active"),
                             out_model=str(out / "post_active")),
                featurize=featurize, n_rounds=L_AL_ROUNDS,
                n_steps=L_TRAIN_STEPS, device=dev)),
            ("existing_al_mtp", existing_al_mtp,
             lambda: existing_al_mtp.run_existing_al_mtp(
                 dataclasses.replace(cfg, lowres_epochs=1,
                                     lowres_basemodel=str(out / "low_al"),
                                     out_model=str(out / "post_al")),
                 n_rounds=L_AL_ROUNDS, n_steps=L_TRAIN_STEPS, device=dev))):
        learner_cls = mod.ActiveLearner
        mod.ActiveLearner = timed_learner(learner_cls)
        rounds.clear()
        k3.launches = 0
        try:
            t0 = time.perf_counter()
            learner = run()
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        finally:
            mod.ActiveLearner = learner_cls
        launched = k3.launches
        check(len(rounds) == L_AL_ROUNDS and learner._y is not None,
              f"{name}: {len(rounds)} rounds")
        per = (t_end - rounds[0]) / len(rounds)
        print(f"mtp: {name} {t_end - t0:.1f} s, {L_AL_ROUNDS} rounds of "
              f"{len(learner._y) // L_AL_ROUNDS} queried pairs: {per:.3f} "
              f"s/round; K3 launches {launched} on {smi}", flush=True)
        if name == "existing_al":
            check(launched > 0, "kernel bottleneck was not launched by "
                  "existing_al")
            counts["bottleneck"] += launched
    print(f"mtp: phase (l) {time.perf_counter() - t_phase:.1f} s on {smi}",
          flush=True)
    return counts


M_IMAGE = 224
M_BATCH = 32
M_OUT = 1000             # identities of the classifier heads
M_HID = 512              # VGG16Classifier's fc6 / fc7
M_IMAGES = 256           # synthetic class-separable images per classifier
M_CLASSES = 8            # classes the images encode (of M_OUT outputs)
M_EPOCHS = 2             # fit_classifier epochs (CustomModel: early stop)
M_LOW = 48               # SmallResClassifier's input
# bf16 backbone vs its f32 copy, relative L2; the relative max is printed.
# It is the tail of bf16's own rounding through 16 SE blocks: the JAX
# package's bf16 SENet50 against its f32 one passes 1e-2 on 4 images at
# 224^2, and the port's is no further (tests/test_torch_port_classify.py,
# test_bf16_senet50_is_as_far_from_f32_as_jax_bf16); 32 images reach
# further.
M_FWD_LIMIT = 2e-2
M_GRAD_LIMIT = 2e-2      # K3 route vs the plain chain's autograd, rel. L2
M_ARC_CHIPS = 64
M_NORM_LIMIT = 1e-3
M_R100 = (3, 13, 30, 3)
M_CUTS = (f"fit_classifier: {M_IMAGES} synthetic images of {M_CLASSES} "
          f"classes (a face dataset: thousands of identities), "
          f"{M_EPOCHS} epochs (EarlyStopping ends CustomModel's fits), "
          f"out_dim {M_OUT}",
          "the converted ArcFace: a seeded random r100-shaped .params file "
          "(model-r100-ii's names and shapes), not the released weights")


def _mxnet_params(path: Path, arrays: dict) -> None:
    """Write ``arrays`` as an ``mx.nd.save`` dict file (NDArray V2 blobs,
    f32, ``arg:`` names): uint64 magic 0x112, reserved, count; per blob
    uint32 magic, int32 storage type 0, uint32 ndim, int64 dims, int32
    dev_type, dev_id, type_flag, the data; then the names."""
    import struct

    with open(path, "wb") as f:
        f.write(struct.pack("<QQQ", 0x112, 0, len(arrays)))
        for v in arrays.values():
            f.write(struct.pack("<IiI", 0xF993FAC9, 0, v.ndim))
            f.write(struct.pack(f"<{v.ndim}q", *v.shape))
            f.write(struct.pack("<iii", 1, 0, 0))
            f.write(np.ascontiguousarray(v, np.float32).tobytes())
        f.write(struct.pack("<Q", len(arrays)))
        for k in arrays:
            name = f"arg:{k}".encode()
            f.write(struct.pack("<Q", len(name)) + name)


def _r100_raw(rng) -> dict:
    """LResNet100E-II parameters in insightface's names and MXNet layouts
    (OIHW, the fc over an NCHW flatten), variance-preserving random
    values so the 100-layer forward stays finite."""
    raw = {}

    def conv(name, cin, cout, k):
        raw[f"{name}_weight"] = rng.standard_normal(
            (cout, cin, k, k), np.float32) * np.float32(
                (2.0 / (k * k * cin)) ** 0.5)

    def bn(name, c):
        raw[f"{name}_gamma"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
        raw[f"{name}_beta"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        raw[f"{name}_moving_mean"] = (0.1 * rng.standard_normal(c)).astype(
            np.float32)
        raw[f"{name}_moving_var"] = rng.uniform(0.9, 1.1, c).astype(
            np.float32)

    def prelu(name, c):
        raw[f"{name}_gamma"] = rng.uniform(0.1, 0.3, c).astype(np.float32)

    conv("conv0", 3, 64, 3)
    bn("bn0", 64)
    prelu("relu0", 64)
    cin = 64
    for s, (units, w) in enumerate(zip(M_R100, (64, 128, 256, 512)), 1):
        for u in range(1, units + 1):
            base = f"stage{s}_unit{u}"
            bn(f"{base}_bn1", cin)
            conv(f"{base}_conv1", cin, w, 3)
            bn(f"{base}_bn2", w)
            prelu(f"{base}_relu1", w)
            conv(f"{base}_conv2", w, w, 3)
            bn(f"{base}_bn3", w)
            if u == 1:
                conv(f"{base}_conv1sc", cin, w, 1)
                bn(f"{base}_sc", w)
            cin = w
    bn("bn1", cin)
    raw["pre_fc1_weight"] = rng.standard_normal(
        (512, cin * 49), np.float32) * np.float32((1.0 / (cin * 49)) ** 0.5)
    raw["pre_fc1_bias"] = np.zeros(512, np.float32)
    bn("fc1", 512)
    return raw


def phase_classify(dev, smi: str) -> dict:
    """(m): the side models and the identification classifiers at full
    width: SENet50 and VGGFace16 in bf16 against their f32 copies, K3's
    weight gradients block by block against the plain chain's autograd,
    ``fit_classifier`` on the four classifiers (K3 counted in
    ResNet50Classifier's), then an r100 ``.params`` file through
    ``tools.convert_mxnet`` into ArcFace; returns K3's launch count in the
    classifiers' fits."""
    import tempfile

    from alink_tpu_torch import train as T
    from alink_tpu_torch.models import (ArcFaceResNet100, ResNet50Classifier,
                                        SENet50, SENet50Classifier,
                                        SmallResClassifier, VGG16Classifier,
                                        VGGFace16, VGGFaceResNet50,
                                        preprocess)
    from alink_tpu_torch.models.resnet import bottleneck_weights
    from alink_tpu_torch.ops import resblock
    from alink_tpu_torch.tools import convert_mxnet
    from alink_tpu_torch.train import checkpoint
    from alink_tpu_torch.train import classifier as tclassifier

    t_phase = time.perf_counter()
    for line in M_CUTS:
        print(f"classify cut: {line}", flush=True)
    k3 = resblock.bottleneck_s1_kernel
    gd = torch.Generator(device=dev).manual_seed(SEED + 13)

    def seeded():
        return torch.Generator().manual_seed(SEED)

    # 1. SENet50 and VGGFace16, bf16 against an f32 copy of the same
    # weights on the same card (TF32 off: the copy is f32 throughout).
    x = torch.rand((M_BATCH, M_IMAGE, M_IMAGE, 3), generator=gd,
                   device=dev) * 255.0
    for name, make, version in (
            ("SENet50", lambda dt: SENet50(dtype=dt, generator=seeded(),
                                           device=dev), 2),
            ("VGGFace16", lambda dt: VGGFace16(dt, generator=seeded(),
                                               device=dev), 1)):
        model, ref = make(torch.bfloat16), make(torch.float32)
        xp = preprocess.vggface(x, version=version)
        with torch.no_grad():
            got, want = model(xp), ref(xp)
            ms = cuda_ms(lambda: model(xp), iters=5, warmup=2)
        rel = float((got.float() - want).norm() / want.norm())
        rel_max = maxdiff(got, want) / float(want.abs().max())
        print(f"classify: {name} {M_IMAGE}^2 bf16 batch {M_BATCH}: "
              f"{tuple(got.shape)}, vs its f32 copy relative L2 {rel:.3e} "
              f"(limit {M_FWD_LIMIT}), relative max {rel_max:.3e}; "
              f"{ms:.3f} ms, {M_BATCH / ms * 1e3:.1f} images/s on {smi}",
              flush=True)
        check(bool(torch.isfinite(got).all()) and rel <= M_FWD_LIMIT,
              f"{name} bf16 vs f32 relative L2 {rel}")
        del model, ref, got, want
    torch.cuda.empty_cache()

    # 2. K3 with weight gradients: a trainable VGGFace-ResNet50's training
    # forward launches K3 once per stride-1 block; each block's gradients
    # (conv weights, BN gamma, beta, mean, var) through BottleneckS1 (K3
    # forward, f32 recompute backward) against the plain arithmetic's
    # autograd, at the inputs and upstream gradients of that pass.
    net = VGGFaceResNet50(generator=seeded(), device=dev, trainable=True)
    g = seeded()
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith((".gamma", ".var")):
                p.copy_(0.5 + torch.rand(p.shape, generator=g))
            elif name.endswith((".beta", ".mean")):
                p.copy_(0.2 * torch.randn(p.shape, generator=g))
    xp = preprocess.vggface(x, version=2)
    k3.launches = 0
    net(xp)
    fwd_launches = k3.launches
    stride1, idx = [], 0
    for stage, n in enumerate(net.stage_sizes):
        stride1 += list(net.blocks[idx + (1 if stage else 0):idx + n])
        idx += n
    recs = []

    def tap(y, blocks):
        for wts in blocks:
            rec = [y.detach(), None]
            recs.append(rec)
            y = resblock.BottleneckS1.apply(y, *wts)
            y.register_hook(lambda gy, rec=rec: rec.__setitem__(1, gy))
        return y

    v = torch.randn(2048, generator=g).to(dev)
    (net(xp, chain=tap) @ v).sum().backward()
    check(len(recs) == len(stride1) == 13 and fwd_launches == 13,
          f"K3 launches per training forward {fwd_launches}, "
          f"{len(recs)} blocks")
    worst, worst_name = 0.0, ""
    for i, (blk, (xi, gy)) in enumerate(zip(stride1, recs)):
        params = list(blk.named_parameters())
        tensors = [p for _, p in params]
        gk = torch.autograd.grad(resblock.BottleneckS1.apply(
            xi, *bottleneck_weights(blk)), tensors, gy)
        gp = torch.autograd.grad(resblock._block_plain(
            xi.float(), bottleneck_weights(blk)), tensors, gy)
        for (name, _), a, b in zip(params, gk, gp):
            check(float(b.norm()) > 0, f"block {i} {name}: zero gradient")
            rel = float((a - b).norm() / b.norm())
            if rel > worst:
                worst, worst_name = rel, f"block {i} {name}"
    print(f"classify: K3 with weight gradients, 13 stride-1 blocks of a "
          f"trainable VGGFace-ResNet50 at batch {M_BATCH}: {fwd_launches} "
          f"K3 launches per training forward; every conv weight and BN "
          f"tensor's gradient vs the plain chain's autograd: worst "
          f"relative L2 {worst:.3e} ({worst_name}; limit {M_GRAD_LIMIT})",
          flush=True)
    check(worst <= M_GRAD_LIMIT, f"K3 weight gradients relative {worst}")
    del net, recs
    torch.cuda.empty_cache()

    # 3. fit_classifier on the four classifiers, each step timed.
    labels = torch.randint(0, M_CLASSES, (M_IMAGES,), generator=gd,
                           device=dev)
    bases = torch.rand((M_CLASSES, 1, 1, 3), generator=gd, device=dev)
    real_step = tclassifier.classifier_train_step
    counts = {"bottleneck": 0}
    for name, make, size in (
            ("ResNet50Classifier", lambda: ResNet50Classifier(
                M_OUT, generator=seeded(), device=dev), M_IMAGE),
            ("SENet50Classifier", lambda: SENet50Classifier(
                M_OUT, generator=seeded(), device=dev), M_IMAGE),
            ("VGG16Classifier", lambda: VGG16Classifier(
                M_OUT, M_HID, input_size=(M_IMAGE, M_IMAGE),
                generator=seeded(), device=dev), M_IMAGE),
            ("SmallResClassifier", lambda: SmallResClassifier(
                M_OUT, input_size=(M_LOW, M_LOW), generator=seeded(),
                device=dev), M_LOW)):
        # Class-separable: each class a colour, plus noise.
        imgs = (bases[labels] * 200.0 + torch.rand(
            (M_IMAGES, size, size, 3), generator=gd, device=dev) * 55.0)
        if name != "SmallResClassifier":
            imgs = preprocess.vggface(imgs, version=1 if name.startswith(
                "VGG") else 2)
        model = make()
        state = T.create_classifier_state(model)
        stats = {k: p.detach().clone() for k, p in model.named_parameters()
                 if k.endswith((".mean", ".var"))}
        steps = []

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = real_step(*a, **k)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0, a[1].shape[0],
                          float(res[1])))
            return res

        tclassifier.classifier_train_step = timed
        try:
            k3.launches = 0
            state, logs = T.fit_classifier(
                state, imgs, labels, epochs=M_EPOCHS, batch_size=M_BATCH,
                generator=seeded(),
                dropout_generator=torch.Generator(device=dev).manual_seed(
                    SEED))
            torch.cuda.synchronize()
            launched = k3.launches
        finally:
            tclassifier.classifier_train_step = real_step
        full = [t for t, n, _ in steps[1:] if n == M_BATCH]
        warm = float(np.median(full)) * 1e3
        losses = [loss for _, _, loss in steps]
        print(f"classify: {name} {size}^2 batch {M_BATCH} out {M_OUT}: "
              f"train step {steps[0][0] * 1e3:.2f} ms first, {warm:.2f} ms "
              f"warm (median of {len(full)}), {M_BATCH / warm * 1e3:.1f} "
              f"images/s; {len(steps)} steps, losses "
              + ", ".join(f"{v:.4f}" for v in losses)
              + f"; K3 launches {launched} on {smi}", flush=True)
        for lg in logs:
            print(f"classify: {name} {lg}", flush=True)
        check(all(np.isfinite(losses)) and all(
            np.isfinite(lg.val_loss) for lg in logs) and len(logs)
              == M_EPOCHS, f"{name}: losses {losses}, logs {logs}")
        if name == "ResNet50Classifier":
            evals = len(logs)
            check(launched == 13 * (len(steps) + evals),
                  f"K3 launched {launched} times for {len(steps)} steps "
                  f"and {evals} evaluations")
            moved = [k for k, p in model.named_parameters()
                     if k in stats and not torch.equal(p, stats[k])]
            check(len(moved) == len(stats) > 0,
                  f"BN statistics moved: {len(moved)} of {len(stats)}")
            print(f"classify: {name}: all {len(stats)} BN mean and var "
                  f"tensors moved under Adadelta", flush=True)
            counts["bottleneck"] = launched
            # Where a warm step's device time goes (torch.profiler).
            from alink_tpu_torch.tools.profile_alink import device_split

            split = device_split(lambda: real_step(
                state, imgs[:M_BATCH], labels[:M_BATCH]), calls=3)
            total = sum(split.values())
            print(f"classify: {name} warm step device ms by family: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
                  + f"; K3 {split['bottleneck (K3)'] / total:.1%} of "
                  f"{total:.2f} ms on {smi}", flush=True)
        else:
            check(launched == 0, f"{name} launched K3")
        del model, state, imgs
        torch.cuda.empty_cache()

    # 4. An r100 .params file through tools.convert_mxnet into ArcFace.
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(prefix="classify_", dir=work))
    t0 = time.perf_counter()
    raw = _r100_raw(np.random.default_rng(SEED))
    _mxnet_params(out / "model-0000.params", raw)
    t_write = time.perf_counter() - t0
    n_params = sum(a.size for a in raw.values())
    del raw
    t0 = time.perf_counter()
    convert_mxnet.main(["arcface", str(out / "model-0000.params"),
                        str(out / "r100")])
    t_convert = time.perf_counter() - t0
    model = ArcFaceResNet100(M_R100, device=dev)
    model.load_state_dict(checkpoint.restore(str(out / "r100")), strict=True)
    chips = torch.rand((M_ARC_CHIPS, 112, 112, 3), generator=gd,
                       device=dev) * 255.0
    with torch.no_grad():
        emb = model(chips)
    norm_err = float((emb.norm(dim=-1) - 1.0).abs().max())
    print(f"classify: r100 .params ({n_params} values, "
          f"{(out / 'model-0000.params').stat().st_size / 2 ** 20:.1f} MiB) "
          f"written {t_write:.2f} s, converted {t_convert:.2f} s, loaded "
          f"strict into ArcFaceResNet100; {M_ARC_CHIPS} chips -> "
          f"{tuple(emb.shape)}, finite {bool(torch.isfinite(emb).all())}, "
          f"max |norm - 1| {norm_err:.2e} (limit {M_NORM_LIMIT})",
          flush=True)
    check(tuple(emb.shape) == (M_ARC_CHIPS, 512)
          and bool(torch.isfinite(emb).all()) and norm_err <= M_NORM_LIMIT,
          f"converted ArcFace embeddings: norm error {norm_err}")
    import shutil

    shutil.rmtree(out)
    print(f"classify: phase (m) {time.perf_counter() - t_phase:.1f} s on "
          f"{smi}", flush=True)
    return counts


# Phase (n): the parallel layer on the card, in a world-1 NCCL group (one
# H100: NCCL refuses two ranks on one GPU), every sharded path against its
# unsharded call on the same tensors, then TP and PP across a 2-rank gloo
# world on the host CPU at full r100 depth (f32).
N_FEAT_FACES = 128       # VGGFace-ResNet50 224^2 bf16 (phase (f)'s batch)
N_PHOTOS = 64            # r100 typical, 160^2 photos (phase (c)'s batch)
N_HEADS = 5              # committee members, heads (512, 64) on 2,048-d
N_PAIRS = 1024
N_GRID = 1000            # 1000 x 1000 pairs of 512-d features (phase (b))
N_TP_CHIPS = 64          # r100 bf16 112^2 chips
N_WINDOWS = 7
N_CPU_RANKS = 2
N_CPU_BATCH = 4
N_CPU_LIMIT = 5e-5       # tests/test_parallel.py's full-depth bound (f32)
N_COMMITTEE_LIMIT = 1e-6


def _alternating_ms(fns: dict, iters: int) -> dict:
    """Median ms per call of each function over ``N_WINDOWS`` windows of
    ``iters`` synchronised calls, the functions taking turns (ABBA)."""
    import statistics

    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    names = list(fns)
    for w in range(N_WINDOWS):
        for k in (names if w % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fns[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3 / iters)
    return {k: statistics.median(v) for k, v in times.items()}


def _cpu_world(rank: int, world: int, init: str, out: str) -> None:
    """One rank of (n)'s host-CPU world: TP and PP of the full-depth r100
    in f32 on a (1, world) mesh; rank 0 also runs the local forward and
    writes the comparison to ``out``."""
    import json as _json

    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        from alink_tpu_torch import parallel as P
        from alink_tpu_torch.models import ArcFaceResNet100

        mesh = P.create_mesh((1, world), device_type="cpu")
        model = ArcFaceResNet100(dtype=torch.float32,
                                 generator=torch.Generator().manual_seed(SEED))
        x = torch.rand((N_CPU_BATCH, 112, 112, 3),
                       generator=torch.Generator().manual_seed(SEED + 1)) * 255
        t0 = time.perf_counter()
        tp = P.arcface_tp_apply(mesh, model, x)
        t_tp = time.perf_counter() - t0
        t0 = time.perf_counter()
        pp = P.arcface_pp_apply(mesh, model, x, microbatches=2)
        t_pp = time.perf_counter() - t0
        if rank == 0:
            t0 = time.perf_counter()
            with torch.no_grad():
                local = model(x)
            t_local = time.perf_counter() - t0
            with open(out, "w") as f:
                _json.dump({"tp": maxdiff(tp, local), "pp": maxdiff(pp, local),
                            "finite": bool(torch.isfinite(tp).all()
                                           and torch.isfinite(pp).all()),
                            "shape": list(tp.shape), "tp_s": t_tp,
                            "pp_s": t_pp, "local_s": t_local,
                            "threads": torch.get_num_threads()}, f)
    finally:
        dist.destroy_process_group()


def phase_parallel(dev, smi: str) -> dict:
    """(n): the parallel layer at full width in a world-1 NCCL group;
    returns the sharded paths' launch counts."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from alink_tpu_torch import parallel as P
    from alink_tpu_torch.active import Committee
    from alink_tpu_torch.data.prefetch import DevicePrefetcher
    from alink_tpu_torch.detect import (CascadeConfig, FaceModel,
                                        init_cascade_params)
    from alink_tpu_torch.drivers.common import make_resnet50_featurizer
    from alink_tpu_torch.models import ArcFaceResNet100, SiameseHead
    from alink_tpu_torch.ops import image, pairwise, resblock
    from alink_tpu_torch.serving import Verifier

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(SEED)
    gd = torch.Generator(dev).manual_seed(SEED)
    mesh = P.create_mesh()
    check(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
          and "nccl" in str(dist.get_backend()),
          f"world-1 mesh: {mesh} on {dist.get_backend()}")
    print(f"parallel: world {dist.get_world_size()} ({dist.get_backend()}), "
          f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
          f"{mesh.device_type}:{torch.cuda.current_device()}", flush=True)

    featurize, _ = make_resnet50_featurizer(g, device=dev)
    faces = torch.rand((N_FEAT_FACES, F_IMAGE, F_IMAGE, 3), generator=gd,
                       device=dev) * 255
    fm = FaceModel(ArcFaceResNet100(generator=g, device=dev),
                   init_cascade_params(g, device=dev),
                   CascadeConfig.typical(thresholds=(0.0, 0.0, 0.0)))
    photos = torch.rand((N_PHOTOS, IMG, IMG, 3), generator=gd,
                        device=dev) * 255
    heads = [SiameseHead(2048, (512, 64), generator=g, device=dev)
             for _ in range(N_HEADS)]
    com = Committee.from_param_list(heads[0], [h.state_dict() for h in heads])
    left = torch.randn((N_PAIRS, 2048), generator=gd, device=dev)
    right = torch.randn((N_PAIRS, 2048), generator=gd, device=dev)
    grid_head = SiameseHead(512, (512, 64), generator=g, device=dev)
    rows = torch.randn((N_GRID, 512), generator=gd, device=dev)
    cols = torch.randn((N_GRID, 512), generator=gd, device=dev)
    verifier = Verifier(fm.process, grid_head, mesh=mesh)
    r100 = fm.embedder
    chips = torch.rand((N_TP_CHIPS, 112, 112, 3), generator=gd,
                       device=dev) * 255

    k1, k2, k3 = (pairwise.score_matrix_kernel,
                  image.affine_warp_batch_kernel,
                  resblock.bottleneck_s1_kernel)
    k1.launches = k2.launches = k3.launches = 0
    with torch.no_grad():
        f_sh = P.sharded_featurize(mesh, featurize, faces)
    p_sh = P.sharded_face_pipeline(mesh, fm, photos)
    c_sh = P.sharded_committee_probs(mesh, com.head, com.params, left, right)
    g_sh = pairwise.score_matrix_sharded(mesh, grid_head, rows, cols)
    v_sh = verifier.score_matrix(rows, precomputed=True)
    tp_sh = P.arcface_tp_apply(mesh, r100, chips)
    torch.cuda.synchronize()
    counts = {"bottleneck": k3.launches, "affine_warp": k2.launches,
              "pair_score": k1.launches}
    print(f"parallel: sharded featurize / face pipeline / committee / grid / "
          f"Verifier grid / TP; launches {counts}", flush=True)
    check(counts["bottleneck"] == 13,
          f"sharded featurize: K3 launched {counts['bottleneck']} times, "
          "13 expected (one forward)")
    check(counts["affine_warp"] >= 1, "sharded face pipeline: K2 not launched")
    check(counts["pair_score"] == 2,
          f"sharded grids: K1 launched {counts['pair_score']} times, 2 "
          "expected")

    with torch.no_grad():
        f_lo = featurize(faces)
        tp_lo = r100(chips)
    diffs = {"featurize": maxdiff(f_sh, f_lo),
             "face_pipeline": maxdiff(p_sh, fm.pipeline(photos)),
             "committee": maxdiff(c_sh, com.predict(left, right)),
             "grid": maxdiff(g_sh, pairwise.score_matrix(grid_head, rows,
                                                         cols)),
             "verifier_grid": maxdiff(v_sh, pairwise.score_matrix(
                 grid_head, rows, rows)),
             "tp_model1": maxdiff(tp_sh, tp_lo)}
    print("parallel: sharded vs unsharded max|diff| " + ", ".join(
        f"{k} {v:.3e}" for k, v in diffs.items())
        + f" (limits 0, committee {N_COMMITTEE_LIMIT})", flush=True)
    for name, d in diffs.items():
        limit = N_COMMITTEE_LIMIT if name == "committee" else 0.0
        check(d <= limit, f"sharded {name}: max|diff| {d} > {limit}")
    shapes = {"featurize": (f_sh, (N_FEAT_FACES, 2048)),
              "face_pipeline": (p_sh, (N_PHOTOS, 512)),
              "committee": (c_sh, (N_PAIRS, 2)),
              "grid": (g_sh, (N_GRID, N_GRID)),
              "tp_model1": (tp_sh, (N_TP_CHIPS, 512))}
    for name, (t, shape) in shapes.items():
        check(tuple(t.shape) == shape and bool(torch.isfinite(t).all()),
              f"sharded {name}: shape {tuple(t.shape)} or non-finite")

    host = [np.random.default_rng(i).uniform(0, 255, (BATCH, 112, 112, 3))
            .astype(np.float32) for i in range(4)]
    with DevicePrefetcher(iter(host), sharding=P.batch_sharding(mesh, 4)) \
            as it:
        landed = list(it)
    check(len(landed) == 4 and all(
        b.to_local().device == torch.device("cuda", 0)
        and tuple(b.shape) == h.shape
        and np.array_equal(b.to_local().cpu().numpy(), h)
        for b, h in zip(landed, host)),
        "prefetcher: sharded batches did not land whole on cuda:0")
    print(f"parallel: DevicePrefetcher(sharding=batch_sharding(mesh, 4)) "
          f"landed {len(landed)} batches of {host[0].shape} on "
          f"{landed[0].to_local().device} as {type(landed[0]).__name__} "
          f"{landed[0].placements}", flush=True)

    def timed(name, sharded, local, iters):
        ms = _alternating_ms({"unsharded": local, "sharded": sharded}, iters)
        print(f"parallel: {name} unsharded {ms['unsharded']:.4f} ms, sharded "
              f"{ms['sharded']:.4f} ms ({ms['sharded'] / ms['unsharded']:.4f}"
              f"x; median of {N_WINDOWS} windows of {iters} synchronised "
              f"calls) on {smi}", flush=True)

    with torch.no_grad():
        timed(f"featurize {N_FEAT_FACES} x {F_IMAGE}^2",
              lambda: P.sharded_featurize(mesh, featurize, faces),
              lambda: featurize(faces), 3)
        timed(f"face pipeline {N_PHOTOS} x {IMG}^2",
              lambda: P.sharded_face_pipeline(mesh, fm, photos),
              lambda: fm.pipeline(photos), 3)
        timed(f"committee {N_HEADS} heads x {N_PAIRS} pairs",
              lambda: P.sharded_committee_probs(mesh, com.head, com.params,
                                                left, right),
              lambda: com.predict(left, right), 10)
        timed(f"grid {N_GRID}x{N_GRID}x512",
              lambda: pairwise.score_matrix_sharded(mesh, grid_head, rows,
                                                    cols),
              lambda: pairwise.score_matrix(grid_head, rows, cols), 10)
        timed(f"TP r100 model 1, {N_TP_CHIPS} chips",
              lambda: P.arcface_tp_apply(mesh, r100, chips),
              lambda: r100(chips), 3)
    del fm, r100, featurize, heads, com
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="parallel_", dir=work) as tmp:
        out = os.path.join(tmp, "cpu_world.json")
        t0 = time.perf_counter()
        mp.start_processes(_cpu_world, args=(N_CPU_RANKS,
                                             os.path.join(tmp, "rdzv"), out),
                           nprocs=N_CPU_RANKS, start_method="spawn")
        t_world = time.perf_counter() - t0
        with open(out) as f:
            res = json.load(f)
    print(f"parallel: host CPU ({os.cpu_count()} cores, {res['threads']} "
          f"threads a rank), {N_CPU_RANKS}-rank gloo world, r100 (3, 13, 30, "
          f"3) f32, batch {N_CPU_BATCH} at 112^2: TP max|diff| "
          f"{res['tp']:.3e}, PP (2 microbatches) max|diff| {res['pp']:.3e} "
          f"against the local f32 forward (limit {N_CPU_LIMIT}); TP "
          f"{res['tp_s']:.2f} s, PP {res['pp_s']:.2f} s, local "
          f"{res['local_s']:.2f} s, world {t_world:.1f} s (host CPU, not "
          f"the card)", flush=True)
    check(res["finite"] and res["shape"] == [N_CPU_BATCH, 512]
          and max(res["tp"], res["pp"]) <= N_CPU_LIMIT,
          f"host-CPU TP/PP: {res}")
    print(f"parallel: phase (n) {time.perf_counter() - t_phase:.1f} s on "
          f"{smi}", flush=True)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from alink_tpu_torch import _build

    t_start = time.perf_counter()

    def stamp(phases: str) -> None:
        print(f"[{phases}] done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

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
            if any(k in line for k in ("registers", "spill", "smem",
                                       "entry function")):
                print("ptxas:", line.strip(), flush=True)

    g = torch.Generator().manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    stamp("a")
    head, numbers = phase_kernels(dev, g, rng)
    stamp("b")
    fm, counts = phase_slice(dev, g, rng, head)
    stamp("c")

    phase_speed(fm, torch.as_tensor(
        rng.uniform(0, 255, (BATCH, IMG, IMG, 3)), dtype=torch.float32,
        device=dev), smi)
    del fm
    torch.cuda.empty_cache()
    stamp("d")

    numbers["bottleneck"] = phase_k3(dev, g)
    stamp("e")
    alink_counts, alink_cfg, f_finetune_s = phase_alink(dev, smi)
    torch.cuda.empty_cache()
    stamp("f")
    a2_launches = phase_a2(dev, smi)
    torch.cuda.empty_cache()
    stamp("g")
    counts["qconv"], numbers["qconv"] = phase_k4(dev, g, smi)
    torch.cuda.empty_cache()
    stamp("h")
    eval_counts = phase_eval(dev, smi)
    torch.cuda.empty_cache()
    stamp("i")
    resume_counts = phase_resume(dev, smi, alink_cfg, f_finetune_s)
    torch.cuda.empty_cache()
    stamp("j")
    rest_counts = phase_serving_rest(dev, g, rng, head, smi)
    torch.cuda.empty_cache()
    phase_arc(dev, smi)
    torch.cuda.empty_cache()
    stamp("k")
    mtp_counts = phase_mtp(dev, smi)
    torch.cuda.empty_cache()
    stamp("l")
    classify_counts = phase_classify(dev, smi)
    torch.cuda.empty_cache()
    stamp("m")
    par_counts = phase_parallel(dev, smi)
    stamp("n")
    # Each kernel's count is the one from the main paths that run it:
    # serving, evaluation, (k)'s score matrix and (l)'s top-1 tail for K1,
    # serving, the augmented loop and (k)'s profiles and L-Net chips for
    # K2, training, the A2 channel, evaluation, the augmented loop,
    # run_alink_mtp, existing_al and ResNet50Classifier's fit for K3, its
    # own op path for K4; and (n)'s sharded paths for K1, K2 and K3.
    counts["bottleneck"] = (alink_counts["bottleneck"] + a2_launches
                            + eval_counts["bottleneck"]
                            + resume_counts["bottleneck"]
                            + mtp_counts["bottleneck"]
                            + classify_counts["bottleneck"]
                            + par_counts["bottleneck"])
    counts["pair_score"] += (eval_counts["pair_score"]
                             + rest_counts["pair_score"]
                             + mtp_counts["pair_score"]
                             + par_counts["pair_score"])
    counts["affine_warp"] += (resume_counts["affine_warp"]
                              + rest_counts["affine_warp"]
                              + par_counts["affine_warp"])

    sources = {"pair_score": ("alink_tpu_torch/csrc/pair_score.cu",
                              "alink_tpu/ops/pairwise.py:134"),
               "affine_warp": ("alink_tpu_torch/csrc/affine_warp.cu",
                               "alink_tpu/ops/image.py:230"),
               "bottleneck": ("alink_tpu_torch/csrc/bottleneck.cu",
                              "alink_tpu/ops/resblock.py:72"),
               "qconv": ("alink_tpu_torch/csrc/qconv.cu",
                         "alink_tpu/ops/qconv.py:116")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": counts[name],
         "max_abs_err": v["err"], "ms": v["ms"], "call_ms": v["call_ms"],
         "plain_ms": v["plain_ms"],
         "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
         "library_ms": v["library_ms"]}
        for name, v in numbers.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
