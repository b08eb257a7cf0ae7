#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths, the A2 channel, the
int8 conv, the DFW evaluation chain, the loop's resume, supervision and
augmentation, the rest of detect and serving, the ArcFace driver, the
Multi-PIE driver with the classical-AL baselines, the identification
classifiers with the weight tools, the parallel layer, and ingest with the
flagship forward ``entry()`` once on one NVIDIA GPU.

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
   identification and the score matrix.  The kernels' launches are
   counted over it (``profiling.counting``); the aligned chips and the score
   matrix are then compared with the plain versions on the same tensors;
d. ``FaceModel.process`` faces/s at batch 64 (warm, synchronised): the
   median, min and max of 7 windows, and the main thread's CPU time.
   ``python -m alink_tpu_torch.tools.profile_serving`` breaks it down;
e. K3 (fused stride-1 bottleneck) against its plain version at the five
   stride-1 block shapes of VGGFace-ResNet50 at 224x224, at batch 32, 64,
   256 and 1,024 (each launch setup the paths use: clusters of 4 and of 2
   at 7x7, of 2 at 14x14, persistent blocks, one block per tile), each
   line naming its tile: on dyadic data (exact, limit 1e-6) and float data
   (relative 1e-2), and a chain of two blocks
   at widths the kernel runs zero-padded (32 -> 80 -> 200, 200 -> 48 ->
   200; dyadic, exact), and at Cm 576 and 1,024 (y1 and y2 in global
   scratch): each block exact on dyadic data, a two-block chain held to
   the float limit and timed; then
   the device time of the launch alone (``bench_kernels.graph_ms``: calls
   captured in a CUDA graph and replayed; the time per call from Python
   beside it) per shape and over the 13 blocks of one forward at batch 32,
   256 and 1,024, beside the same block as an unfused bf16 cuDNN sequence
   (a yardstick only), with TFLOP/s, and each shape at batch 32 and 1,024
   beside its ``roofline.bound_s`` bound;
f. the A-LINK training slice at full width: ``run_alink`` (synthetic DFW
   tree, VGGFace-ResNet50 (3, 4, 6, 3) bf16 with seeded random weights,
   ``SiameseHead`` (512, 64), the default noise bank without "adversarial",
   which phase (g) runs)
   with the launches counted over it (K3 must have run); then
   ``test_accuracy`` of the student over the plain features, with K1's
   launches counted over it.  Epochs,
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
   and a conv -> prelu_quant -> add_lead -> conv chain, with its launches
   counted over them; then the kernel on operands
   packed once (``pack_conv``) against its plain version (max |diff| 0 on
   bf16 and int8 outputs, relative 1e-5 on f32); the launch alone (device
   time, ``graph_ms``, and per call from Python), the op path call
   (packing included), plain and bf16 ``F.conv2d`` (``graph_ms``) ms,
   useful TOPS and the bound of the unpadded problem (Cin and Cout as they
   are, pixel rows only);
i. the DFW evaluation chain: ``tools.evaluate --prefix`` on a synthetic
   DFW test protocol at 224^2 (1,029 faces; DFW's list has 7,771) with
   VGGFace-ResNet50 and ``SiameseHead`` (512, 64), K1's and K3's
   launches counted over it, the grid held to the plain
   version; the DFW-size evaluation (7,770^2 x 2,048 grid, split + sweep
   and stats of the three ROC cases) timed by step as "DFW evaluation s";
   ``eval_regression`` on ``EVAL_r05.json``'s protocol with its stage
   AUC / EER and 15 ordering flags beside the file's (a flag that differs
   is reported, not hidden);
j. resume, restart and augment at full width, with (f)'s configuration and
   cuts (the M2 and committee that (f) saved loaded in every run):
   ``run_alink(augment=True, loop_checkpoint=A)`` with K2's and K3's
   launches counted over it (K2 six launches per
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

o. ingest: a DFW-protocol tree of 1,008 camera-size photos (112 people x
   (3 + 4 + 2); 800x640 JPEGs at quality 90, smooth; written on a thread
   pool, the write time printed apart) staged through
   ``drivers.common.load_dfw`` at 224^2 with PIL, "auto" (the main path,
   K3 counted in its featurize), the native loader exact and the native
   loader with ``ingest_dct_scale``: staging s, decode + resize s and
   images/s, the threads and ``os.cpu_count()``, featurize s and ingest's
   share of staging.  Checks: "auto" equals "native" bit for bit;
   ``dct_scale`` within mean 3 and max 40 levels of exact; the native
   loader decodes every file; native against PIL printed (the resize
   kernels differ).  Where the library cannot be built (no libjpeg /
   libpng headers on the host), the compiler's reason is printed on its
   own line, native staging is reported as not measured, and "auto" must
   equal "pil".  Then the featurizer with K3 against its plain chain on 64
   staged faces, and ``tools.dryrun_multichip.entry()``'s forward (ArcFace
   r100 + ``SiameseHead``, batch 8 of 112^2 pairs) in ms.

p. the fused BN / PReLU / residual add (``ops.bn_act``, ArcFace's three
   passes a unit) at every (mode, H, C) an r100 forward at batch 256
   calls it with (bf16), and at f32, a tensor-parallel padded width (171)
   and a misaligned pointer (the kernel's one-element path): the kernel
   ``torch.equal`` to ``bn_act_reference``, its device time (``graph_ms``)
   and time per call from Python beside its bound (bytes / 3.35 TB/s),
   the plain version's device time and the library's yardstick
   (PyTorch's vectorised elementwise kernel on the same bytes), each
   shape and summed over the 149 calls of one forward; a whole r100
   forward at batch 256 through the kernel against the ``_FrozenBN`` /
   ``_PReLU`` / ``+`` module chain (bit-equal) and both timed in turns,
   the kernels each launches and their device ms, ``launches.bn_act`` 149
   in ``profiling.trace``'s ``counters.json``; the FGSM pixel gradient on
   8 chips through the autograd function's backward (149 launches of
   ``alink_bn_act_backward``, each case above also held to
   ``bn_act_backward_reference`` and timed) against the module chain's
   (bit-equal, cuDNN deterministic), and one FGSM step
   (``fgsm_pairs``, 32 pairs) through each, timed in turns.  Then the ReLU
   modes (``bn_relu``, ``bn_add_bn_relu``) at every (mode, H, C) a
   VGGFace-ResNet50 forward calls them with, at batch 32 and 1,024 (bf16;
   and at f32, a padded width and a misaligned pointer), with NaN, -0 and
   +0 planted where the ReLU reads them: forward and backward bit for bit
   (NaN and the sign of a zero included) to ``bn_act_reference`` and
   ``bn_act_backward_reference``, each timed beside its bytes bound and
   the plain version, and summed over a forward's 10 launches; featurize
   at both batches through the kernel against the ``_FrozenBN`` /
   ``torch.relu`` / ``+`` module chain (bit-equal, and the FGSM pixel
   gradient on 8 faces, 10 backward launches), both timed in turns and
   traced (every kernel by name), ``launches.bn_act`` 10 a featurize call
   in ``counting()`` and ``counters.json``.  The kernels line counts
   bn_act's launches in the r100 forwards of (c) and (k)'s profiles, each
   held to 149 a forward, and in (p)'s held VGG featurize calls, 10
   each.
q. the ViT attention core (``ops.attention``, ``csrc/attention.cu``):
   the kernel against ``attention_core_reference`` (float32, TF32 off) on
   strided views of an (N, T, 3, H, d) bf16 qkv tensor, as the ViT gives
   them, at ViT-L's (256, 8, 144, 96) and at ragged and wide shapes (T 7
   to 256, d 16 to 128, a contiguous input), the widest gap over the
   widest |reference| held under 1e-5; the kernel's registers, shared
   memory and spills from ``-Xptxas -v``; at ViT-L's shape its device
   time (``graph_ms``), its time by CUDA events with the L2 flushed
   before each call, and per call from Python, beside its bytes bound
   (float32 output) and ``attn_roofline.serve_vit``'s bound (output at 2
   bytes), the plain version's time and the library's yardstick (float32
   ``F.scaled_dot_product_attention`` with its three upcasts and the head
   merge, ``library_ms``); a ViT-L forward (bf16, batch 32) against the
   same model with the plain core (the cores of blocks 0 and 23
   teacher-forced, as ``attn_gap`` reads them; the unit embeddings), both
   forwards at batch 256 timed in turns, ``launches.attn`` 24 a forward
   in ``counters.json``, no library attention kernel in its trace and its
   kernel count beside the library core's; the autograd function's
   gradients of q, k and v bit-equal to plain autograd of the reference,
   and the FGSM pixel gradient on 4 chips against the plain core's, beside
   the library core's distance from it.  The kernels line counts the
   launches of (q)'s ViT-L forwards, each held to 24.
r. RetinaFace-R50's detector: the NMS kernel (``csrc/nms.cu``) against
   ``ops.nms.nms`` at the cascade's budgets (grid boxes, tied scores) and
   one photo at a time at 5,000 candidates, and against the reference's
   sequential greedy loop at 256 x 5,000 (sorted and unsorted input), the
   keep-masks bit-equal; its device time beside
   ``roofline_retina.nms_bound_s``; K3 at the detector's five stride-1
   shapes (160^2 to 20^2) on dyadic data (exact) at batch 32 and 256,
   timed at 256 beside each shape's bound; ``RetinaFaceR50`` at 640^2,
   batch 256 (forward and detector call, TFLOP/s) and
   ``FaceModel(r100, detector=...)`` faces/s, with its launches a call
   (K3 13, NMS 1).
s. The Swin embedder's windowed core (``ops.attention.window_attention``,
   ``csrc/attention.cu``'s ``alink_window_attention``) against the plain
   float32 roll-partition path at Swin-S's four stage shapes, shifted and
   not, at batch 1,024 (stages 1 and 3) and on ragged head counts, the gap
   over the widest |reference| under ``wattn_gap``'s limit; stages 1 and
   3 timed beside their bytes bound, the plain float32 path and the same
   path under bf16 autocast (the published sequence's, a yardstick); a
   ``FaceSwin_S`` forward through ``FaceModel.get_feature`` with 24
   ``launches.wattn``, nothing but the core's kernel inside the
   ``alink/swin.attn`` spans of its trace, its embeddings against the
   plain core's and its chips a second at batch 1,024.  Then the
   transformers' LayerNorm (``ops.layer_norm``, ``csrc/layer_norm.cu``)
   against ``F.layer_norm`` + ``.to`` at each of a Swin-S forward's norm
   shapes at 1,024 chips and at 49,007 rows of each width 96-1,536 with
   float32 and bf16 in and out (bf16 out: >= 99.9 % bit-equal, every
   element within one ulp; float32 out: within 1e-5 of the widest
   |reference|); each shape timed beside its bytes bound and PyTorch's
   sequence, summed over a forward's 53 norms; Swin-S and ViT-L forwards
   with 53 and 49 ``launches.ln``, nothing but the norm kernel inside the
   ``alink/ln`` spans and no cast after it in the Swin's trace, the
   embeddings against the plain norms' and the Swin-S forward at 1,024
   chips with each, in turns.

The second-to-last line is a JSON object with one entry per kernel (its
device time ``ms`` and time per call from Python ``call_ms``, its bound
from the shapes, the card's peaks and memory rate); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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

from alink_tpu_torch.tools.bench_kernels import cuda_ms, graph_ms, kernel_ms
from alink_tpu_torch.utils.profiling import counting
from bench_torch.roofline import (H100_BF16_TFLOPS, H100_BYTES_PER_S,
                                  H100_F32_TFLOPS, bound_s, k3_flops)

SEED = 0
IMG = 160          # pre-cropped face photos, as the JAX package's bench uses
BATCH = 64


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


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
            "launches.k1")
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
        "launches.k2")
    k2_plain = cuda_ms(lambda: image.affine_warp_batch_reference(
        imgs, Ms, (112, 112)))
    print(f"K2 64x160x160x3 -> 112x112 f32: kernel {k2_ms:.4f} ms "
          f"({k2_call:.4f} per call from Python), plain {k2_plain:.4f} ms",
          flush=True)
    bf_ms, bf_call = kernel_ms(
        lambda: image.affine_warp_batch_kernel(imgs_bf, Ms, (112, 112)),
        "launches.k2")
    bf_bound, _ = bound_s(0, H100_F32_TFLOPS,
                          2 * (imgs.numel() + BATCH * 112 * 112 * 3))
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
        with counting() as made:
            got = k1(hd, rows, cols)
        launched = made["launches.k1"]
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
        ms, call = kernel_ms(lambda: k1(hd, rows, cols), "launches.k1",
                             per_call=chunks)
        plain = cuda_ms(lambda: pairwise.score_matrix_reference(hd, rows,
                                                                cols), iters=3)
        ops = n * m * (d + 2 * d * h1 + 2 * h1 * h2 + 2 * h2 * 2)
        nbytes = 4 * (n * d + m * d + n * m) + 2 * (d * h1 + h1 * h2 + 2 * h2)
        bound, by = bound_s(ops, H100_BF16_TFLOPS, nbytes)
        print(f"K1 pair_score {name} dyadic, {chunks} chunks of H2: "
              f"max|diff| {err:.3e} (limit {K1_LIMIT}), plain scores 5-95 % "
              f"in [{q05:.3f}, {q95:.3f}]; kernel {ms:.4f} ms ({call:.4f} "
              f"per call from Python), plain {plain:.4f} ms, bound "
              f"{bound * 1e3:.4f} ms ({by})", flush=True)


def kernel_numbers(err, ms, call, plain, ops, peak_tera, nbytes,
                   library=None):
    """One entry of the ``kernels`` line, with the bound of ``ops`` at
    ``peak_tera`` and ``nbytes`` (``roofline.bound_s``)."""
    bound, by = bound_s(ops, peak_tera, nbytes)
    return {"err": err, "ms": ms, "call_ms": call, "plain_ms": plain,
            "bound_ms": bound * 1e3, "bound_by": by, "library_ms": library}


# K3 against its plain version on the card, at the five stride-1 block
# shapes of VGGFace-ResNet50 at 224x224 (bench_kernels.K3_SHAPES), at the
# batches whose launches differ: 32 (clusters of 4 at 7x7 and of 2 at
# 14x14), 64 (clusters of 2 at 7x7: the featurizer check of (f)), 256
# (``featurize_stacks`` and the one-pixel DE's ``EVAL_BATCH``) and 1,024
# (the noise cell's slab): persistent blocks at every other shape and
# batch.  The plain version is timed at batch 32; the kernel at 32, 256 and
# 1,024, each shape beside its bound at 32 and 1,024.
K3_BATCH = 32
K3_CHECK_BATCHES = (32, 64, 256, 1024)
K3_TIME_BATCHES = (32, 256, 1024)
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
        ms, call = kernel_ms(lambda: resblock.bottleneck_chain(x, ws),
                             "launches.k3", per_call=len(ws))
        plain = cuda_ms(lambda: resblock.bottleneck_chain_reference(x, ws),
                        iters=3)
        ops = sum(k3_flops(K3_BATCH, hw, ci, c, co, p)
                  for ci, c, co, p in blocks)
        nbytes = 2 * sum(K3_BATCH * hw * hw * (ci + co) + sum(
            t.numel() for t in (w.w1, w.w3, w.w2, w.wp) if t is not None)
            for (ci, c, co, p), w in zip(blocks, ws))
        bound = bound_s(ops, H100_BF16_TFLOPS, nbytes)[0] * 1e3
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
    block shapes, at batch 32, 64, 256 and 1,024; then the launch alone at
    batch 32, 256 (the batch ``featurize_stacks`` and the one-pixel DE give
    it) and 1,024 beside the same block as an unfused bf16 cuDNN sequence
    (a yardstick, not ``library_ms``: no single call computes the block),
    and each shape at batch 32 and 1,024 beside its bound.  Returns the
    numbers summed over the 13 blocks of one forward at batch 32."""
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
            setup = (f"{plan.tile.th}x{plan.tile.tw} tiles, " + (
                f"clusters of {plan.split}" if plan.split > 1 else
                "persistent" if plan.blocks < plan.tiles else
                "one block per tile"))
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
                bound_fwd += count * (bound_s(ops, H100_BF16_TFLOPS,
                                              nbytes)[0] * 1e3)
                ops_fwd += count * ops
                bytes_fwd += count * nbytes
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
    times = bench_k3(dev, K3_TIME_BATCHES, g)
    for batch, res in times.items():
        if int(batch) in (K3_BATCH, K3_TIME_BATCHES[-1]):
            for (hw, cin, cm, cout, proj, _), row in zip(K3_SHAPES,
                                                         res["shapes"]):
                n = int(batch)
                nbytes = 2 * (n * hw * hw * (cin + cout) + cin * cm
                              + 9 * cm * cm + cm * cout
                              + (cin * cout if proj else 0))
                bound, by = bound_s(k3_flops(n, hw, cin, cm, cout, proj),
                                    H100_BF16_TFLOPS, nbytes)
                print(f"K3 {row['shape']} batch {n}: kernel "
                      f"{row['ms']:.4f} ms, bound {bound * 1e3:.4f} ms "
                      f"({by}; {100 * bound * 1e3 / row['ms']:.1f} % of "
                      "it)", flush=True)
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
            "bound_by": bound_s(ops_fwd, H100_BF16_TFLOPS, bytes_fwd)[1],
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
    from alink_tpu_torch.ops import resblock
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

    with counting() as made:
        t0 = time.perf_counter()
        state = run_alink(cfg, featurize=featurize, device=dev)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
    counts = {"bottleneck": made["launches.k3"],
              "pair_score": made["launches.k1"]}
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
    with counting() as made:
        acc = T.test_accuracy(state.m2_state, feats, labels)
        torch.cuda.synchronize()
    print(f"alink: test_accuracy of M2 on {len(feats)} plain faces "
          f"{acc:.4f}; pair_score launches {made['launches.k1']}", flush=True)
    check(made["launches.k1"] > 0, "kernel pair_score was not launched by "
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
    total = 0

    # One-pixel DE.
    left, right = rand_pairs(rng, G_DE_PAIRS, F_IMAGE, dev)
    target, labels = one_pixel_targets(predict, head, left, right)
    with counting() as made:
        al, ar, res, t_de = timed_one_pixel(predict, head, left, right,
                                            labels, G_DE_MAXITER)
    de_launches = made["launches.k3"]
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
    with counting() as made:
        fl, fr, ms_fgsm = timed_fgsm(predict, head, left, right, labels)
    total += made["launches.k3"]
    step = torch.cat([(fl - left).abs(), (fr - right).abs()])
    check(bool(torch.isfinite(step).all()) and float(step.max()) == 2.0,
          "FGSM step is not 2 pixels")
    print(f"a2: FGSM {G_FGSM_PAIRS} pairs (forward + backward through K3): "
          f"{ms_fgsm:.2f} ms; K3 launches {made['launches.k3']} over 2 calls; "
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
    with counting() as made:
        t0 = time.perf_counter()
        log = loop.run_iteration(*stacks)
        torch.cuda.synchronize()
        t_it = time.perf_counter() - t0
    total += made["launches.k3"]
    tm = loop.timings.as_dict()
    check(log.pairs > 0 and log.queried <= log.selected <= log.pairs,
          f"loop log {log}")
    print(f"a2: one loop iteration, default bank {cfg.noise}, {log.pairs} "
          f"pairs: {t_it:.3f} s; per phase s " + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(tm.items(),
                                                 key=lambda kv: -kv[1]))
          + f"; K3 launches {made['launches.k3']}; {log}", flush=True)
    print(f"a2: K3 launches in (g) {total} on {smi}", flush=True)
    return total


# Phase (h): K4 against its plain version at LResNet100E-II's stage shapes
# (benchmarks/bench_qconv.py:57-59): (H, Cin, Cout), batch 64.
K4_F32_LIMIT = 1e-5     # relative, tests/test_qconv.py:27's bound
H100_INT8_TOPS = 1979.0


def phase_k4(dev, g, smi: str):
    """(h): K4's op path (``conv3x3_s1_int8`` at the five shapes and a
    conv -> prelu_quant -> add_lead -> conv chain at 14x14x256) with its
    launches counted over it, then the kernel on packed operands against
    its plain version on the same operands."""
    import torch.nn.functional as F

    from alink_tpu_torch.ops import qconv
    from alink_tpu_torch.tools.bench_kernels import (K4_BATCH, K4_SHAPES,
                                                     k4_case)

    k4 = qconv.conv3x3_s1_int8_flat_kernel
    cases = [k4_case(*s, g, dev) for s in K4_SHAPES]
    with counting() as made:
        for x, w, scale, bias, *_ in cases:
            out = qconv.conv3x3_s1_int8(x, w, scale, bias)
            check(out.shape == x.shape[:3] + (w.shape[3],)
                  and bool(torch.isfinite(out.float()).all()),
                  "K4 op output")
        x, w, scale, bias, alpha, qs, lo = cases[2]
        q2 = qconv.conv3x3_s1_int8_flat(qconv.nhwc_to_flat(x, lo), w, scale,
                                        bias, lo, alpha=alpha,
                                        quant_scale=qs,
                                        epilogue="prelu_quant")
        chain_k = qconv.conv3x3_s1_int8_flat(qconv.add_lead(q2, lo), w,
                                             scale, bias, lo,
                                             out_dtype=torch.float32)
        torch.cuda.synchronize()
    launches = made["launches.k4"]
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
        ms, call = kernel_ms(lambda: k4(xf, packed, lo), "launches.k4")
        op = cuda_ms(lambda: qconv.conv3x3_s1_int8(x, w, scale, bias))
        plain = cuda_ms(lambda: qconv.conv3x3_s1_int8_flat_reference(
            ops, lo, "affine", torch.bfloat16), iters=5)
        xc = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        wc = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        lib = graph_ms(lambda: F.conv2d(xc, wc, padding=1), exact=False)
        # The unpadded problem: pixel rows only, Cin and Cout as they are.
        npix = K4_BATCH * hw * hw
        useful = 2.0 * npix * 9 * cin * cout
        moved = npix * cin + 9 * cin * cout + npix * cout * 2
        bound, by = bound_s(useful, H100_INT8_TOPS, moved)
        bound *= 1e3
        print(f"K4 {name} batch {K4_BATCH}, affine bf16: launch {ms:.4f} ms "
              f"({useful / ms / 1e9:.1f} useful TOPS; {call:.4f} per call "
              f"from Python), op path {op:.4f} ms, "
              f"plain {plain:.4f} ms, bf16 F.conv2d {lib:.4f} ms "
              f"({ms / lib:.2f}x), bound {bound:.4f} ms ({by}; "
              f"{100 * bound / ms:.1f} % of it) on {smi}", flush=True)
        rows.append((ms, plain, lib, op, bound, call, by == "operations"))
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
    ``--prefix``) at 224^2 with the launches counted over it, its grid
    held to the plain version; the DFW-size
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
    from alink_tpu_torch.ops import pairwise
    from alink_tpu_torch.tools import eval_regression, evaluate
    from alink_tpu_torch.tools.generate_matrix import restore_head_and_score

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
    buf = io.StringIO()
    t0 = time.perf_counter()
    with counting() as made, contextlib.redirect_stdout(buf):
        feats, scores = evaluate.main([
            "--model_ckpt", ckpt, "--prefix", root, "--mask",
            str(Path(root) / "updated_testing_mask.txt"), "--device",
            str(dev)])
        torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    counts = {"pair_score": made["launches.k1"],
              "bottleneck": made["launches.k3"]}
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
        with counting() as made:
            t0 = time.perf_counter()
            grid = restore_head_and_score(ckpt, fd, dev)
            torch.cuda.synchronize()
            t_grid = time.perf_counter() - t0
        launched = made["launches.k1"]
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
    t0 = time.perf_counter()
    try:
        with counting() as made, contextlib.redirect_stdout(buf):
            art = eval_regression.main(["--device", str(dev)])
            torch.cuda.synchronize()
    finally:
        eval_regression.restore_head_and_score = score_stage
    t_reg = time.perf_counter() - t0
    launched = made["launches.k1"]
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
    from alink_tpu_torch.ops import augment, image
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
    try:
        with counting() as made:
            t0 = time.perf_counter()
            gt = alink_mod.run_alink(cfg_a, featurize=featurize, device=dev)
            torch.cuda.synchronize()
            t_gt = time.perf_counter() - t0
    finally:
        loop_mod.augment_pairs = real_augment
    counts = {"affine_warp": made["launches.k2"],
              "bottleneck": made["launches.k3"]}
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
    try:
        with counting() as made:
            t0 = time.perf_counter()
            sup = alink_mod.run_alink(cfg_b, featurize=featurize, device=dev)
            torch.cuda.synchronize()
            t_sup = time.perf_counter() - t0
    finally:
        alink_mod.ALinkLoop = loop_mod.ALinkLoop
    st = sup.timings
    print(f"resume: supervised run {t_sup:.1f} s, attempts {len(attempts)}, "
          f"'{J_INJECTED}' raised in attempt {faults}; K2 "
          f"{made['launches.k2']}, K3 {made['launches.k3']} launches; "
          f"restore {st.totals['restore']:.4f} s, "
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
        lambda: k2(x, Ms, (F_IMAGE, F_IMAGE), "nearest", "nearest"),
        "launches.k2")
    plain = cuda_ms(lambda: image.affine_warp_batch_reference(
        x, Ms, (F_IMAGE, F_IMAGE), "nearest", "nearest"), iters=5)
    bound = bound_s(0, H100_F32_TFLOPS, 2 * x.numel() * 4)[0] * 1e3
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


@contextlib.contextmanager
def bn_act_counted(model, what: str, counts: dict):
    """Yields ``counting()``'s dict over the block; its
    ``launches.bn_act`` is held to 149 a forward of the r100 ``model``
    inside the block (a forward pre-hook counts them) and added to
    ``counts["bn_act"]``."""
    forwards = []
    hook = model.register_forward_pre_hook(lambda m, a: forwards.append(1))
    try:
        with counting() as made:
            yield made
            torch.cuda.synchronize()
    finally:
        hook.remove()
    n = made["launches.bn_act"]
    check(bool(forwards) and n == 149 * len(forwards),
          f"{what}: bn_act launched {n} times over {len(forwards)} r100 "
          f"forwards, not 149 each")
    counts["bn_act"] = counts.get("bn_act", 0) + n


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

    t0 = time.perf_counter()
    bn_act_count = {}
    with bn_act_counted(fm.embedder, "serving slice", bn_act_count) as made, \
            MicroBatcher(fm.process, max_batch=8, max_delay_s=0.05) as mb:
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
    counts = {"pair_score": made["launches.k1"],
              "affine_warp": made["launches.k2"],
              "bn_act": bn_act_count["bn_act"]}
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
    embeddings; returns K1's and K2's launches, and bn_act's in the
    profiles' r100 forwards."""
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
    counts = {"pair_score": 0, "affine_warp": 0, "bn_act": 0}
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
        with bn_act_counted(emb, f"process {name}", counts) as made:
            s = summary(windows(lambda: fm.process(photos), dev,
                                n_windows=7, iters=K_WINDOW_ITERS))
        counts["affine_warp"] += made["launches.k2"]
        print(f"process {name}: {BATCH * 1e3 / s['median_ms']:.1f} faces/s "
              f"at batch {BATCH} (median of 7 windows of {K_WINDOW_ITERS} "
              f"{s['median_ms']:.2f} ms/batch, min {s['min_ms']:.2f}, max "
              f"{s['max_ms']:.2f}; main-thread CPU {s['cpu_median_ms']:.2f}), "
              f"K2 launches {made['launches.k2']}, r100 bf16, {IMG}x{IMG} "
              f"on {smi}", flush=True)
        check(made["launches.k2"] > 0, f"process {name}: K2 was not "
              "launched")

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
    with counting() as made:
        fm_l.process(photos)
        torch.cuda.synchronize()
    counts["affine_warp"] += made["launches.k2"]
    err = max(maxdiff(chips, image.affine_warp_batch_reference(
        photos, Ms, (112, 112))), maxdiff(one, chips[0]))
    print(f"lnet: {int(d0.valid.sum())} faces, every refined landmark in its "
          f"patch, mean |move| {float(moved.mean()):.2f} px; K2 chips of the "
          f"refined landmarks vs plain max|diff| {err:.3e}; K2 launches "
          f"{made['launches.k2']}", flush=True)
    check(err <= 1e-3, f"lnet chips: max|diff| {err} > 1e-3")
    check(made["launches.k2"] > 0, "accurate_landmark process: K2 was not "
          "launched")

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
    with counting() as made:
        grid = Verifier(fm_c.process, head).score_matrix(photos)
        torch.cuda.synchronize()
    counts["pair_score"] += made["launches.k1"]
    feats = fm_c.process(photos)
    err = maxdiff(grid, pairwise.score_matrix_reference(head, feats, feats))
    print(f"crowd: Verifier.score_matrix over crowd embeddings vs plain "
          f"max|diff| {err:.3e} (limit {K1_FLOAT_LIMIT}); K1 launches "
          f"{made['launches.k1']}", flush=True)
    check(made["launches.k1"] > 0, "score_matrix did not launch K1")
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
    from alink_tpu_torch.ops import pairwise

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

    tmtp.ALinkLoop, T.custom_train = Cut, timed_train
    try:
        with counting() as made:
            t0 = time.perf_counter()
            state, top1 = tmtp.run_alink_mtp(cfg, featurize=featurize,
                                             device=dev)
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t0
        counts = {"bottleneck": made["launches.k3"]}
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
    with counting() as made:
        t0 = time.perf_counter()
        again = gallery_top1(score, test_lo)
        torch.cuda.synchronize()
        t_tail = (time.perf_counter() - t0) * 1e3
    counts["pair_score"] = tail_launches = made["launches.k1"]
    check(tail_launches > 0, "kernel pair_score was not launched by the "
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
        try:
            with counting() as made:
                t0 = time.perf_counter()
                learner = run()
                torch.cuda.synchronize()
                t_end = time.perf_counter()
        finally:
            mod.ActiveLearner = learner_cls
        launched = made["launches.k3"]
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
    with counting() as made:
        net(xp)
    fwd_launches = made["launches.k3"]
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
            with counting() as made:
                state, logs = T.fit_classifier(
                    state, imgs, labels, epochs=M_EPOCHS, batch_size=M_BATCH,
                    generator=seeded(),
                    dropout_generator=torch.Generator(
                        device=dev).manual_seed(SEED))
                torch.cuda.synchronize()
            launched = made["launches.k3"]
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
    from alink_tpu_torch.ops import pairwise
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

    with counting() as made:
        with torch.no_grad():
            f_sh = P.sharded_featurize(mesh, featurize, faces)
        p_sh = P.sharded_face_pipeline(mesh, fm, photos)
        c_sh = P.sharded_committee_probs(mesh, com.head, com.params, left,
                                         right)
        g_sh = pairwise.score_matrix_sharded(mesh, grid_head, rows, cols)
        v_sh = verifier.score_matrix(rows, precomputed=True)
        tp_sh = P.arcface_tp_apply(mesh, r100, chips)
        torch.cuda.synchronize()
    counts = {"bottleneck": made["launches.k3"],
              "affine_warp": made["launches.k2"],
              "pair_score": made["launches.k1"]}
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


# Phase (o): ingest at full width.  A DFW-protocol tree of camera-size
# photos (BENCHMARKS.md's "camera" source: 800x640 JPEGs at quality 90),
# smooth as cameras give libjpeg (per-person low-resolution noise,
# bilinearly upscaled, a per-image jitter and a little full-size noise), is
# staged through ``drivers/common.load_dfw`` at 224^2 with each decoder.
O_PEOPLE = 112           # x (3 + 4 + 2) = 1,008 images
O_GROUPS = (3, 4, 2)     # plain, disguised, impostor images per person
O_SOURCE = (800, 640)    # (w, h)
O_QUALITY = 90
O_DFW_TRAIN = 3386       # DFW's training images
O_DCT_MEAN = 3.0         # dct_scale against exact, levels
O_DCT_MAX = 40.0         # (tests/test_native_loader.py:102-103)
O_ENTRY_BATCH = 8
O_ENTRY_ITERS = 5


def write_camera_tree(root: Path, people: int) -> float:
    """Write the (o) tree under ``root`` on a thread pool; returns the
    seconds the writing took."""
    import concurrent.futures as cf

    from PIL import Image

    rng = np.random.default_rng(SEED)
    w, h = O_SOURCE
    fields = [rng.integers(-2, 3, (h, w, 3), dtype=np.int16)
              for _ in range(4)]
    jobs = []
    for p in range(people):
        pdir = root / "Training_data" / f"person_{p:03d}"
        pdir.mkdir(parents=True, exist_ok=True)
        base, impostor = (rng.normal(128, 40, (20, 16, 3)) for _ in range(2))
        for prefix, n, b, jitter in (("img_", O_GROUPS[0], base, 6.0),
                                     ("img_h_", O_GROUPS[1], base, 20.0),
                                     ("img_I_", O_GROUPS[2], impostor, 6.0)):
            for i in range(n):
                low = b + rng.normal(0, jitter, b.shape)
                jobs.append((pdir / f"{prefix}{i}.jpg", low,
                             int(rng.integers(len(fields)))))

    def write(job) -> None:
        path, low, k = job
        up = np.asarray(Image.fromarray(
            low.clip(0, 255).astype(np.uint8)).resize((w, h),
                                                      Image.BILINEAR))
        Image.fromarray((up + fields[k]).clip(0, 255).astype(np.uint8)).save(
            path, quality=O_QUALITY)

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        list(ex.map(write, jobs))
    return time.perf_counter() - t0


def phase_ingest(dev, smi: str, people: int = O_PEOPLE) -> dict:
    """(o): the (o) tree through ``load_dfw`` with PIL, the native loader
    exact and the native loader with ``ingest_dct_scale``, each timed with
    its ingest share; the featurize on the card with K3 counted; then
    ``entry()``'s forward.  Returns K3's launches in the staging run."""
    import shutil
    import tempfile

    from alink_tpu_torch.config import ALinkConfig
    from alink_tpu_torch.data import (load_person_stacks, native_loader,
                                      scan_dfw)
    from alink_tpu_torch.drivers import common
    from alink_tpu_torch.models import preprocess
    from alink_tpu_torch.ops import resblock
    from alink_tpu_torch.tools.dryrun_multichip import entry

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="ingest_", dir=work))
    n_images = people * sum(O_GROUPS)
    try:
        t_write = write_camera_tree(root, people)
        print(f"ingest: wrote {n_images} JPEGs of {O_SOURCE[0]}x"
              f"{O_SOURCE[1]} "
              f"(quality {O_QUALITY}) in {t_write:.3f} s on "
              f"{os.cpu_count()} threads (not staging time)", flush=True)
        print(f"ingest cut: {people} people x {O_GROUPS} = {n_images} "
              f"images (DFW trains on {O_DFW_TRAIN})", flush=True)
        featurize, model = common.make_resnet50_featurizer(
            torch.Generator().manual_seed(SEED), device=dev)
        feat_s = [0.0]

        def timed_featurize(x):
            sync()
            t0 = time.perf_counter()
            out = featurize(x)
            sync()
            feat_s[0] += time.perf_counter() - t0
            return out

        featurize(torch.zeros((2, F_IMAGE, F_IMAGE, 3), device=dev))  # warm
        cfg = ALinkConfig(data_dir_prefix=str(root),
                          image_res=(F_IMAGE, F_IMAGE))
        threads = 16          # load_person_stacks' default

        def stage(name, dct=False, pil=False):
            """``load_dfw`` timed; ``pil`` switches the native loader off
            for the run (``load_image_list``'s "auto" then takes PIL)."""
            feat_s[0] = 0.0
            available = native_loader.available
            if pil:
                native_loader.available = lambda: False
            try:
                with counting() as made:
                    sync()
                    t0 = time.perf_counter()
                    data = common.load_dfw(
                        dataclasses.replace(cfg, ingest_dct_scale=dct),
                        timed_featurize, dev)
                    sync()
                    wall = time.perf_counter() - t0
            finally:
                native_loader.available = available
            ingest = wall - feat_s[0]
            print(f"ingest: {name}: staging {wall:.3f} s for {n_images} "
                  f"images at {F_IMAGE}x{F_IMAGE}: decode + resize "
                  f"{ingest:.3f} s ({n_images / ingest:.1f} images/s; "
                  f"threads {threads}, os.cpu_count() {os.cpu_count()}), "
                  f"featurize {feat_s[0]:.3f} s "
                  f"(K3 launches {made['launches.k3']}); ingest "
                  f"{ingest / wall:.1%} of staging", flush=True)
            return data, made["launches.k3"]

        pil, _ = stage("pil", pil=True)
        # The main path: load_dfw as run_alink calls it (the decoder
        # "auto": native exact wherever the library builds).
        auto, launches = stage("auto")
        if native_loader.available():
            print(f"ingest: native loader built "
                  f"({native_loader.get_lib()._name})", flush=True)
            dct, _ = stage("native dct_scale", dct=True)
            # "auto" against the native decoder called on the same paths.
            res = (F_IMAGE, F_IMAGE)
            persons = scan_dfw(str(root), "Training_data")
            failures = 0
            for kind, st in (("plain", auto.plain_raw),
                             ("disguised", auto.dig_raw),
                             ("impostor", None)):
                groups = [getattr(q, kind) for q in persons]
                if st is None:
                    st = load_person_stacks(groups, res)
                want, n_bad = native_loader.decode_resize_batch(
                    [q for grp in groups for q in grp], res)
                failures += n_bad
                check(np.array_equal(st.images[st.mask()], want),
                      f"ingest: auto != native ({kind})")
            print(f"ingest: auto equals native bit for bit (plain, "
                  f"disguised, impostors); native decode failures "
                  f"{failures} of {n_images}", flush=True)
            check(failures == 0, f"ingest: {failures} files not decoded")
            exact = auto.plain_raw
            d = np.abs(dct.plain_raw.images - exact.images)[exact.mask()]
            print(f"ingest: dct_scale vs exact: mean |diff| {d.mean():.4f}, "
                  f"max {d.max():.4f} levels (limits {O_DCT_MEAN}, "
                  f"{O_DCT_MAX})", flush=True)
            check(d.mean() < O_DCT_MEAN and d.max() < O_DCT_MAX,
                  f"ingest: dct_scale off by mean {d.mean()}, max {d.max()}")
            check(d.max() > 0, "ingest: the scaled decode did not engage")
            d = np.abs(pil.plain_raw.images - exact.images)[exact.mask()]
            print(f"ingest: native vs PIL (resize kernels differ, no limit): "
                  f"mean |diff| {d.mean():.4f}, max {d.max():.4f} levels",
                  flush=True)
        else:
            reason = native_loader.build_error() or "unknown"
            first = next((ln for ln in reason.splitlines()
                          if "error" in ln), reason.splitlines()[-1])
            print(f"ingest: native loader unavailable: {first.strip()}",
                  flush=True)
            print("ingest: native and dct_scale staging not measured on "
                  "this host; auto decoded with PIL", flush=True)
            for name in ("plain_raw", "dig_raw"):
                check(np.array_equal(getattr(auto, name).images,
                                     getattr(pil, name).images),
                      f"ingest: auto != pil ({name})")
        # Every file decoded: no zero-filled slot among the live images.
        for name, per in (("plain_raw", O_GROUPS[0]),
                          ("dig_raw", O_GROUPS[1])):
            st = getattr(auto, name)
            live = st.images[st.mask()]
            check(live.shape[0] == people * per
                  and bool((live.reshape(len(live), -1).std(1) > 1).all()),
                  f"ingest: an image of {name} did not decode")
        feats = auto.plain_feats.images[auto.plain_feats.mask()]
        check(feats.shape == (people * O_GROUPS[0], 2048)
              and np.isfinite(feats).all(), "ingest: bad features")
        if dev.type == "cuda":
            check(launches > 0, "kernel bottleneck was not launched by "
                  "load_dfw's featurize")
        faces = auto.plain_raw.images[auto.plain_raw.mask()][:64]
        xp = preprocess.vggface(torch.as_tensor(faces, device=dev), version=2)
        with torch.no_grad():
            got = model(xp)
            want = model(xp, chain=resblock.bottleneck_chain_reference)
        rel = maxdiff(got, want) / float(want.abs().max())
        print(f"ingest: featurizer K3 vs plain chain on {len(xp)} staged "
              f"faces: relative max|diff| {rel:.3e} (limit {F_FEAT_LIMIT})",
              flush=True)
        check(rel < F_FEAT_LIMIT, f"ingest: featurizer relative {rel}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # entry(): the flagship forward at batch 8, through functional_call as
    # entry() gives it, beside the same modules called directly (the
    # difference is functional_call's parameter swap, on the host).
    from alink_tpu_torch.models import ArcFaceResNet100, SiameseHead

    forward, (estate, hstate, example, _) = entry(device=dev)
    embedder = ArcFaceResNet100(device=dev)
    embedder.load_state_dict(estate)
    head = SiameseHead(embedder.embedding_dim, device=dev)
    head.load_state_dict(hstate)
    g = torch.Generator().manual_seed(SEED)
    left, right = ((torch.rand(example.shape, generator=g) * 255).to(dev)
                   for _ in range(2))
    with torch.no_grad():
        probs = forward(estate, hstate, left, right)
        direct = head(embedder(left), embedder(right))
        ms = _alternating_ms({
            "entry": lambda: forward(estate, hstate, left, right),
            "direct": lambda: head(embedder(left), embedder(right))},
            O_ENTRY_ITERS)
    check(probs.shape == (O_ENTRY_BATCH, 2)
          and bool(torch.isfinite(probs).all())
          and float((probs.sum(-1) - 1).abs().max()) < 1e-5
          and maxdiff(probs, direct) < 1e-6,
          f"entry(): bad probabilities {probs} (direct {direct})")
    print(f"entry: ArcFace r100 + SiameseHead forward at batch "
          f"{O_ENTRY_BATCH} of 112^2 pairs: {ms['entry']:.3f} ms through "
          f"functional_call, {ms['direct']:.3f} ms with the modules called "
          f"directly (max |diff| {maxdiff(probs, direct):.3e}; median of "
          f"{N_WINDOWS} windows of "
          f"{O_ENTRY_ITERS} synchronised calls, taking turns) on {smi}",
          flush=True)
    print(f"ingest: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"bottleneck": launches}


P_BATCH = 256            # serving's embed batch (serve_r100_typical)
P_FGSM = 8               # chips under the FGSM gradient check
P_CALLS = 5              # captured calls a shape (20 would hold ~30 GB)
P_FGSM_PAIRS = 32        # pairs of the timed FGSM step


def _module_chain(x, bn, prelu=None, shortcut=None, shortcut_bn=None,
                  relu=False):
    """``ops.bn_act.bn_act`` through the ``_FrozenBN`` / ``_PReLU`` modules,
    ``+`` and ``torch.relu``: the unfused path ArcFace and VGGFace-ResNet50
    ran before the fused op."""
    y = bn(x)
    if prelu is not None:
        return prelu(y)
    if shortcut is not None:
        y = y + (shortcut.to(bn.dtype) if shortcut_bn is None
                 else shortcut_bn(shortcut))
    return torch.relu(y) if relu else y


def _bn_act_mode(prelu, shortcut, shortcut_bn, relu=False) -> str:
    mode = ("bn_prelu" if prelu is not None else "bn_add_bn"
            if shortcut_bn is not None else "bn_add" if shortcut is not None
            else "bn")
    return mode + "_relu" if relu else mode


@contextlib.contextmanager
def _swap_bn_act(fn, family: str = "arcface"):
    """The ``bn_act`` of ``models.<family>`` swapped for ``fn`` inside the
    block (ArcFace's, or with "resnet" VGGFace-ResNet50's stem and strided
    blocks; the model's own forward otherwise unchanged)."""
    import importlib

    mod = importlib.import_module(f"alink_tpu_torch.models.{family}")
    real, mod.bn_act = mod.bn_act, fn
    try:
        yield
    finally:
        mod.bn_act = real


def _randomise_bn(model, g: torch.Generator) -> None:
    """BN statistics and PReLU slopes drawn from ``g`` (the defaults are
    an identity BN), the residual branch's last BN scaled down so 49
    units stay in range."""
    with torch.no_grad():
        for name, t in list(model.named_buffers()) + list(
                model.named_parameters()):
            leaf = name.rsplit(".", 1)[-1]
            n = t.shape
            draw = {"gamma": lambda: 1.0 + 0.2 * torch.randn(n, generator=g),
                    "beta": lambda: 0.3 * torch.randn(n, generator=g),
                    "mean": lambda: 0.3 * torch.randn(n, generator=g),
                    "var": lambda: 0.5 + 1.5 * torch.rand(n, generator=g),
                    "alpha": lambda: 0.05 + 0.45 * torch.rand(n, generator=g)
                    }.get(leaf)
            if draw is None:
                continue
            v = draw()
            if leaf == "gamma" and ".bn.2." in f".{name}":
                v = 0.2 * v
            t.copy_(v.to(t.device))


def _bn_act_case(mode, shape, dtype, g, offset: int = 0):
    """Seeded activations (channels-last, ``offset`` elements into their
    storage) and statistics for one call of ``bn_act_kernel``; ``g`` is a
    generator on the card."""
    from alink_tpu_torch.ops.bn_act import BNParams

    n, c, h, w = shape
    dev = g.device

    def act():
        flat = torch.randn(n * c * h * w + offset, generator=g, device=dev)
        return (2.0 * flat).to(dtype)[offset:].view(n, h, w, c).permute(
            0, 3, 1, 2)

    def vec(lo, spread, normal=True):
        draw = torch.randn if normal else torch.rand
        return lo + spread * draw(c, generator=g, device=dev)

    def stats():
        return BNParams(vec(1.0, 0.2), vec(0.0, 0.3), vec(0.0, 0.3),
                        vec(0.5, 1.5, normal=False), 2e-5)

    x, bn = act(), stats()
    alpha = vec(0.05, 0.45, normal=False) if mode == "bn_prelu" else None
    shortcut = act() if mode.startswith("bn_add") else None
    shortcut_bn = stats() if mode == "bn_add_bn" else None
    return x, bn, dtype, alpha, shortcut, shortcut_bn


def phase_bn_act(dev, smi: str) -> dict:
    """(p) the fused BN / PReLU / add: ``bn_act_kernel`` against
    ``bn_act_reference`` at every (mode, H, C) of r100 at batch 256 (and
    at f32, a padded width and a misaligned pointer), timed beside its
    bound and the plain version; a whole r100 forward and an FGSM
    gradient through the kernel against the module chain; the launches of
    one forward from ``profiling.trace``'s ``counters.json``."""
    from alink_tpu_torch.models import ArcFaceResNet100
    from alink_tpu_torch.ops import bn_act as B
    from alink_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(SEED + 15)
    model = ArcFaceResNet100(generator=g, device=dev)
    _randomise_bn(model, g)
    model.eval().requires_grad_(False)
    photos = (torch.rand((P_BATCH, 112, 112, 3), generator=g) * 255).to(dev)

    calls = []

    def recording(x, bn, prelu=None, shortcut=None, shortcut_bn=None):
        calls.append((_bn_act_mode(prelu, shortcut, shortcut_bn),
                      tuple(x.shape)))
        return B.bn_act(x, bn, prelu, shortcut, shortcut_bn)

    with torch.no_grad(), _swap_bn_act(recording):
        model(photos)
    check(len(calls) == 149, f"bn_act: {len(calls)} calls an r100 forward")
    shapes = sorted(set(calls), key=lambda ms: (-ms[1][2], ms[1][1], ms[0]))
    extra = [("bn_prelu", (P_BATCH, 171, 28, 28), torch.bfloat16, 0),
             ("bn_add_bn", (P_BATCH, 171, 14, 14), torch.float32, 0),
             ("bn_add", (P_BATCH, 128, 28, 28), torch.bfloat16, 1),
             ("bn", (P_BATCH, 64, 56, 56), torch.float32, 0),
             ("bn_prelu", (P_BATCH, 512, 7, 7), torch.float32, 0)]
    cases = [(m, sh, torch.bfloat16, 0) for m, sh in shapes] + extra
    per, per_b = {}, {}
    err = 0.0
    gd = torch.Generator(device=dev).manual_seed(SEED + 15)
    for mode, shape, dtype, offset in cases:
        args = _bn_act_case(mode, shape, dtype, gd, offset)
        got = B.bn_act_kernel(*args)
        want = B.bn_act_reference(*args)
        diff = maxdiff(got, want)
        err = max(err, diff)
        check(torch.equal(got, want) and got.dtype == dtype,
              f"bn_act {mode} {shape} {dtype} offset {offset}: max |diff| "
              f"{diff:.3e}")
        elt = torch.finfo(dtype).bits // 8
        nbytes = (3 if mode.startswith("bn_add") else 2) * got.numel() * elt
        ms, call = kernel_ms(lambda: B.bn_act_kernel(*args),
                             "launches.bn_act", calls=P_CALLS)
        plain = graph_ms(lambda: B.bn_act_reference(*args), calls=P_CALLS)
        # The library's yardstick: PyTorch's vectorised elementwise kernel
        # on the same bytes (x * 2, or x + shortcut in the add modes).
        x, shortcut = args[0], args[4]
        library = graph_ms((lambda: x + shortcut) if shortcut is not None
                           else (lambda: x * 2), calls=P_CALLS)
        bound = bound_s(0, H100_BF16_TFLOPS, nbytes)[0] * 1e3
        if offset == 0 and dtype == torch.bfloat16:
            per[(mode, shape)] = (ms, call, plain, bound, library)
        print(f"bn_act {mode} {shape} {str(dtype)[6:]}"
              f"{' offset 1' if offset else ''}: exact; kernel {ms:.4f} ms "
              f"(per call from Python {call:.4f}), bound {bound:.4f} "
              f"({100 * bound / ms:.1f} % of it, {nbytes / ms / 1e6:.0f} "
              f"GB/s), plain {plain:.4f} ms, library elementwise "
              f"{library:.4f} ms ({100 * bound / library:.1f} %), "
              f"{nbytes / 1e6:.1f} MB", flush=True)
        # The backward (``alink_bn_act_backward``) on a seeded gradient.
        grad = _bn_act_case("bn", shape, dtype, gd, offset)[0]
        bargs = (grad, x, args[1], dtype, args[3], shortcut is not None,
                 args[5])
        got_b = B.bn_act_backward_kernel(*bargs)
        want_b = B.bn_act_backward_reference(*bargs)
        for gb, wb in zip(got_b, want_b):
            check((gb is None) == (wb is None), f"bn_act backward {mode}: "
                  f"a gradient given on one side only")
            if gb is not None:
                diff = maxdiff(gb, wb)
                err = max(err, diff)
                check(torch.equal(gb, wb) and gb.dtype == dtype,
                      f"bn_act backward {mode} {shape} {dtype} offset "
                      f"{offset}: max |diff| {diff:.3e}")
        b_ms, b_call = kernel_ms(
            lambda: B.bn_act_backward_kernel(*bargs)[0],
            "launches.bn_act_backward", calls=P_CALLS)
        b_plain = graph_ms(lambda: B.bn_act_backward_reference(*bargs)[0],
                           calls=P_CALLS)
        b_bytes = (3 if mode in ("bn_prelu", "bn_add_bn") else 2) * \
            grad.numel() * elt
        b_bound = bound_s(0, H100_BF16_TFLOPS, b_bytes)[0] * 1e3
        if offset == 0 and dtype == torch.bfloat16:
            per_b[(mode, shape)] = (b_ms, b_call, b_plain, b_bound)
        print(f"bn_act backward {mode} {shape} {str(dtype)[6:]}"
              f"{' offset 1' if offset else ''}: exact; kernel {b_ms:.4f} ms "
              f"(per call from Python {b_call:.4f}), bound {b_bound:.4f} "
              f"({100 * b_bound / b_ms:.1f} % of it), plain {b_plain:.4f} "
              f"ms", flush=True)
        del args, got, want, x, shortcut, grad, bargs, got_b, want_b
        torch.cuda.empty_cache()
    tot = [sum(per[c][i] for c in calls) for i in range(5)]
    tot_b = [sum(per_b[c][i] for c in calls) for i in range(4)]
    print(f"bn_act backward per r100 forward at batch {P_BATCH} (149 "
          f"launches): kernel {tot_b[0]:.3f} ms (per call from Python "
          f"{tot_b[1]:.3f}), bound {tot_b[3]:.3f} "
          f"({100 * tot_b[3] / tot_b[0]:.1f} % of it), plain "
          f"{tot_b[2]:.3f} ms", flush=True)
    nbytes = sum(per[c][3] for c in calls) * H100_BYTES_PER_S / 1e3
    print(f"bn_act per r100 forward at batch {P_BATCH} (149 launches, "
          f"{nbytes / 1e9:.2f} GB): kernel {tot[0]:.3f} ms (per call from "
          f"Python {tot[1]:.3f}), bound {tot[3]:.3f} "
          f"({100 * tot[3] / tot[0]:.1f} % of it), plain {tot[2]:.3f} ms, "
          f"library elementwise on the same bytes {tot[4]:.3f} ms "
          f"({100 * tot[3] / tot[4]:.1f} %) on {smi}", flush=True)

    with torch.no_grad():
        fused = model(photos)
        with _swap_bn_act(_module_chain):
            chain = model(photos)
    check(bool(torch.isfinite(fused).all()), "bn_act: r100 forward not finite")
    diff = maxdiff(fused, chain)
    err = max(err, diff)
    check(torch.equal(fused, chain), f"bn_act: r100 forward against the "
          f"module chain, max |diff| {diff:.3e}")

    def forward_ms(fn) -> float:
        with torch.no_grad(), _swap_bn_act(fn):
            return cuda_ms(lambda: model(photos), iters=5, warmup=2)

    times = {B.bn_act: [], _module_chain: []}
    for fn in (B.bn_act, _module_chain, _module_chain, B.bn_act):
        times[fn].append(forward_ms(fn))
    print("bn_act: r100 forward at batch {} ms (per call from Python, in "
          "turns): fused {}, module chain {}".format(
              P_BATCH, [f"{t:.2f}" for t in times[B.bn_act]],
              [f"{t:.2f}" for t in times[_module_chain]]), flush=True)

    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    kernels = {}
    for side in ("fused", "chain"):
        log_dir = work / f"bn_act_{side}"
        fn = B.bn_act if side == "fused" else _module_chain
        with torch.no_grad(), _swap_bn_act(fn), \
                profiling.trace(str(log_dir)) as prof:
            model(photos)
            torch.cuda.synchronize()
        dev_events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.name.startswith(("Memcpy", "Memset"))]
        kernels[side] = (len(dev_events), 1e-3 * sum(
            e.time_range.end - e.time_range.start for e in dev_events))
        counted = json.loads((log_dir / "counters.json").read_text())
        want = 149 if side == "fused" else 0
        check(counted["launches.bn_act"] == want,
              f"bn_act: counters.json {side} launches.bn_act "
              f"{counted['launches.bn_act']}, want {want}")
    print(f"bn_act: one r100 forward, kernels launched and their device ms: "
          f"fused {kernels['fused'][0]} ({kernels['fused'][1]:.3f} ms), "
          f"module chain {kernels['chain'][0]} ({kernels['chain'][1]:.3f} "
          f"ms); counters.json launches.bn_act 149", flush=True)

    x = photos[:P_FGSM]
    w = torch.randn((P_FGSM, 512), generator=g).to(dev)
    det, bench = torch.backends.cudnn.deterministic, \
        torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        grads = []
        for fn in (B.bn_act, _module_chain):
            xi = x.clone().requires_grad_(True)
            with counting() as made, _swap_bn_act(fn):
                (model(xi) * w).sum().backward()
            grads.append(xi.grad)
            want = 149 if fn is B.bn_act else 0
            check(made["launches.bn_act_backward"] == want,
                  f"bn_act: {made['launches.bn_act_backward']} backward "
                  f"launches in one r100 backward, want {want}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det, bench
    diff = maxdiff(*grads)
    err = max(err, diff)
    check(bool(grads[0].abs().sum() > 0) and torch.equal(*grads),
          f"bn_act: FGSM gradient on {P_FGSM} chips against the module "
          f"chain, max |diff| {diff:.3e}")
    print(f"bn_act: r100 forward ({P_BATCH}) and FGSM gradient ({P_FGSM}) "
          f"bit-equal to the module chain", flush=True)

    # One FGSM step (ops.attack.fgsm_pairs) through r100 and a two-class
    # head on P_FGSM_PAIRS pairs, the fused op against the module chain,
    # timed in turns.
    from alink_tpu_torch.ops.attack import fgsm_pairs

    left = photos[:P_FGSM_PAIRS]
    right = photos[P_FGSM_PAIRS:2 * P_FGSM_PAIRS]
    head_w = 0.05 * torch.randn((2, 512), generator=g).to(dev)
    labels = torch.nn.functional.one_hot(
        torch.arange(P_FGSM_PAIRS, device=dev) % 2, 2).float()

    def predict(w, lh, rh):
        d = (model(lh) - model(rh)).abs()
        return torch.softmax(d @ w.t(), dim=-1)

    def fgsm_ms(fn) -> float:
        with _swap_bn_act(fn):
            return cuda_ms(lambda: fgsm_pairs(predict, head_w, left, right,
                                              labels), iters=5, warmup=2)

    steps = {B.bn_act: [], _module_chain: []}
    for fn in (B.bn_act, _module_chain, _module_chain, B.bn_act):
        steps[fn].append(fgsm_ms(fn))
    print("bn_act: FGSM step on {} pairs of 112^2 through r100, ms (per "
          "call from Python, in turns): fused {}, module chain {}".format(
              P_FGSM_PAIRS, [f"{t:.2f}" for t in steps[B.bn_act]],
              [f"{t:.2f}" for t in steps[_module_chain]]), flush=True)
    print(f"bn_act: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"err": err, "ms": tot[0], "call_ms": tot[1], "plain_ms": tot[2],
            "bound_ms": tot[3], "bound_by": "bytes", "library_ms": tot[4]}


V_BATCHES = (32, 1024)   # the A2 cell's DE featurize and the noise cell's
V_FGSM = 8               # faces under the VGG FGSM gradient check


def _bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bits differ (NaN and the sign of a zero included);
    -1 for another dtype or shape."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return -1
    bits = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return int((a.view(bits) != b.view(bits)).sum())


def _plant(args) -> None:
    """-0 and +0 in rows 0 and 1 of channels 0 and 1, a NaN in channel 2,
    and the BN's shift -0 and +0 in channels 0 and 1, in each activation
    of a ``_bn_act_case``: the ReLU's input is then a signed zero there."""
    x, bn, _, _, shortcut, shortcut_bn = args
    for t, p in ((x, bn), (shortcut, shortcut_bn)):
        if t is None:
            continue
        t[:, :2, 0] = -0.0
        t[:, :2, 1] = 0.0
        t[:, 2, 2, 0] = float("nan")
        p.mean[:2] = 0.0
        p.beta[0], p.beta[1] = -0.0, 0.0


def _device_kernels(prof) -> dict:
    """{kernel name: (launches, device ms)} of a ``profiling.trace``."""
    out: dict = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset"))):
            n, ms = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, ms + 1e-3 * (e.time_range.end
                                               - e.time_range.start))
    return out


def phase_bn_act_vgg(dev, smi: str) -> int:
    """(p, VGG) ``bn_act``'s ReLU modes in VGGFace-ResNet50's stem and
    strided blocks: each (mode, H, C) a forward calls at batch 32 and
    1,024, NaN and signed zeros planted, forward and backward bit-equal to
    the plain chain and timed beside their bytes bound; featurize at both
    batches bit-equal to the module chain (and the FGSM pixel gradient),
    both timed in turns and traced, ``launches.bn_act`` 10 a forward.
    Returns the launches of the held featurize calls."""
    from alink_tpu_torch.drivers.common import make_resnet50_featurizer
    from alink_tpu_torch.models import VGGFaceResNet50
    from alink_tpu_torch.ops import bn_act as B
    from alink_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(SEED + 21)
    model = VGGFaceResNet50(generator=g, device=dev)
    _randomise_bn(model, g)
    model.refold()
    featurize, _ = make_resnet50_featurizer(model=model)
    photos = {n: (torch.rand((n, 224, 224, 3), generator=g) * 255).to(dev)
              for n in V_BATCHES}

    calls = []

    def recording(x, bn, prelu=None, shortcut=None, shortcut_bn=None,
                  relu=False):
        calls.append((_bn_act_mode(prelu, shortcut, shortcut_bn, relu),
                      tuple(x.shape[1:])))
        return B.bn_act(x, bn, prelu, shortcut, shortcut_bn, relu)

    with torch.no_grad(), _swap_bn_act(recording, "resnet"):
        featurize(photos[32])
    check(len(calls) == 10 and sum(m == "bn_add_bn_relu" for m, _ in calls)
          == 3, f"bn_act: VGG forward calls {calls}")
    shapes = sorted(set(calls), key=lambda ms: (-ms[1][1], ms[1][0]))
    gd = torch.Generator(device=dev).manual_seed(SEED + 21)
    per = {}
    cases = [(m, (n,) + sh, torch.bfloat16, 0) for n in V_BATCHES
             for m, sh in shapes]
    cases += [("bn_relu", (32, 171, 28, 28), torch.bfloat16, 0),
              ("bn_add_bn_relu", (32, 512, 14, 14), torch.bfloat16, 1),
              ("bn_relu", (32, 64, 56, 56), torch.float32, 0),
              ("bn_add_bn_relu", (32, 171, 7, 7), torch.float32, 0)]
    for mode, shape, dtype, offset in cases:
        args = _bn_act_case(mode.replace("_relu", ""), shape, dtype, gd,
                            offset)
        _plant(args)
        got = B.bn_act_kernel(*args, relu=True)
        want = B.bn_act_reference(*args, relu=True)
        zeros = int((want == 0).logical_and(torch.signbit(want)).sum())
        differ = _bits_differ(got, want)
        check(differ == 0 and bool(want.isnan().any()),
              f"bn_act {mode} {shape} {dtype} offset {offset}: {differ} "
              f"elements differ in their bits")
        x, bn, _, _, shortcut, shortcut_bn = args
        grad = _bn_act_case("bn", shape, dtype, gd, offset)[0]
        bargs = (grad, got, bn, dtype, None, shortcut is not None,
                 shortcut_bn, True)
        got_b = B.bn_act_backward_kernel(*bargs)
        want_b = B.bn_act_backward_reference(*bargs)
        for gb, wb in zip(got_b, want_b):
            differ = 0 if gb is None and wb is None else (
                -1 if gb is None or wb is None else _bits_differ(gb, wb))
            check(differ == 0, f"bn_act backward {mode} {shape} {dtype} "
                  f"offset {offset}: {differ} elements differ in their bits")
        # graph_ms holds a replay to an eager call by torch.equal, which a
        # NaN never passes: time the same shapes with the NaN made 0.
        for t in (x, shortcut):
            if t is not None:
                t.nan_to_num_(0.0)
        bargs = (grad, B.bn_act_kernel(*args, relu=True)) + bargs[2:]
        elt = torch.finfo(dtype).bits // 8
        reads = 2 if shortcut is not None else 1
        nbytes = (reads + 1) * got.numel() * elt
        b_bytes = (3 if shortcut is None else 4) * got.numel() * elt
        ms, call = kernel_ms(lambda: B.bn_act_kernel(*args, relu=True),
                             "launches.bn_act", calls=P_CALLS)
        plain = graph_ms(lambda: B.bn_act_reference(*args, relu=True),
                         calls=P_CALLS)
        b_ms, _ = kernel_ms(lambda: B.bn_act_backward_kernel(*bargs)[0],
                            "launches.bn_act_backward", calls=P_CALLS)
        b_plain = graph_ms(lambda: B.bn_act_backward_reference(*bargs)[0],
                           calls=P_CALLS)
        bound = bound_s(0, H100_BF16_TFLOPS, nbytes)[0] * 1e3
        b_bound = bound_s(0, H100_BF16_TFLOPS, b_bytes)[0] * 1e3
        if offset == 0 and dtype == torch.bfloat16:
            per[(mode, shape)] = (ms, plain, bound, b_ms, b_plain, b_bound)
        print(f"bn_act {mode} {shape} {str(dtype)[6:]}"
              f"{' offset 1' if offset else ''}: bit-equal, NaN and {zeros} "
              f"output -0; kernel {ms:.4f} ms (per call from Python "
              f"{call:.4f}), bound {bound:.4f} ({100 * bound / ms:.1f} %), "
              f"plain {plain:.4f} ms; backward bit-equal, kernel "
              f"{b_ms:.4f} ms, bound {b_bound:.4f} "
              f"({100 * b_bound / b_ms:.1f} %), plain {b_plain:.4f} ms",
              flush=True)
        del args, got, want, x, shortcut, grad, bargs, got_b, want_b
        torch.cuda.empty_cache()
    for n in V_BATCHES:
        tot = [sum(per[(m, (n,) + sh)][i] for m, sh in calls)
               for i in range(6)]
        print(f"bn_act per VGG forward at batch {n} (10 launches): kernel "
              f"{tot[0]:.3f} ms, bound {tot[2]:.3f} "
              f"({100 * tot[2] / tot[0]:.1f} %), plain {tot[1]:.3f} ms; "
              f"backward {tot[3]:.3f} ms, bound {tot[5]:.3f} "
              f"({100 * tot[5] / tot[3]:.1f} %), plain {tot[4]:.3f} ms on "
              f"{smi}", flush=True)

    det, bench = torch.backends.cudnn.deterministic, \
        torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        launched = 0
        # Photos arrive packed NHWC or as NCHW tensors permuted to NHWC
        # (the loop cells' synthetic people): the stem packs both.
        permuted = photos[32].permute(0, 3, 1, 2).contiguous().permute(
            0, 2, 3, 1)
        for n, x in [(n, photos[n]) for n in V_BATCHES] + [(32, permuted)]:
            with torch.no_grad():
                with counting() as made:
                    fused = featurize(x)
                    torch.cuda.synchronize()
                with _swap_bn_act(_module_chain, "resnet"):
                    chain = featurize(x)
            launched += made["launches.bn_act"]
            check(made["launches.bn_act"] == 10 * made["featurize.calls"]
                  == 10, f"bn_act: {made['launches.bn_act']} launches over "
                  f"{made['featurize.calls']} featurize calls")
            check(bool(torch.isfinite(fused).all()) and torch.equal(
                fused, chain), f"bn_act: VGG features at batch {n} against "
                f"the module chain, max |diff| {maxdiff(fused, chain):.3e}")
        x = photos[32][:V_FGSM]
        w = torch.randn((V_FGSM, 2048), generator=g).to(dev)
        grads = []
        for fn in (B.bn_act, _module_chain):
            xi = x.clone().requires_grad_(True)
            with counting() as made, _swap_bn_act(fn, "resnet"):
                (featurize(xi) * w).sum().backward()
            grads.append(xi.grad)
            want = 10 if fn is B.bn_act else 0
            check(made["launches.bn_act_backward"] == want,
                  f"bn_act: {made['launches.bn_act_backward']} backward "
                  f"launches in one VGG backward, want {want}")
        check(bool(grads[0].abs().sum() > 0) and torch.equal(*grads),
              f"bn_act: VGG FGSM gradient against the module chain, max "
              f"|diff| {maxdiff(*grads):.3e}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det, bench
    print(f"bn_act: VGG features at batch {V_BATCHES} (and 32 permuted from "
          f"NCHW) and the FGSM gradient ({V_FGSM}) bit-equal to the module "
          f"chain; launches.bn_act 10 a featurize call", flush=True)

    for n in V_BATCHES:
        times = {B.bn_act: [], _module_chain: []}
        for fn in (B.bn_act, _module_chain, _module_chain, B.bn_act):
            with torch.no_grad(), _swap_bn_act(fn, "resnet"):
                times[fn].append(cuda_ms(lambda: featurize(photos[n]),
                                         iters=5, warmup=2))
        print("bn_act: VGG featurize at batch {} ms (per call from Python, "
              "in turns): fused {}, module chain {}".format(
                  n, [f"{t:.2f}" for t in times[B.bn_act]],
                  [f"{t:.2f}" for t in times[_module_chain]]), flush=True)
        work = Path(__file__).resolve().parent / "build" / "chip_smoke"
        for side, fn in (("fused", B.bn_act), ("chain", _module_chain)):
            log_dir = work / f"vgg_{side}_{n}"
            with torch.no_grad(), _swap_bn_act(fn, "resnet"), \
                    profiling.trace(str(log_dir)) as prof:
                featurize(photos[n])
                torch.cuda.synchronize()
            counted = json.loads((log_dir / "counters.json").read_text())
            want = 10 * counted["featurize.calls"] if side == "fused" else 0
            check(counted["launches.bn_act"] == want, f"bn_act: VGG "
                  f"counters.json {side} launches.bn_act "
                  f"{counted['launches.bn_act']}, want {want}")
            kernels = sorted(_device_kernels(prof).items(),
                             key=lambda kv: -kv[1][1])
            total = sum(ms for _, ms in (v for _, v in kernels))
            print(f"bn_act: VGG featurize at batch {n}, {side}: "
                  f"{sum(c for _, (c, _) in kernels)} kernels, {total:.3f} "
                  f"device ms", flush=True)
            for name, (c, ms) in kernels:
                print(f"  {ms:9.4f} ms {c:4d}x {name[:160]}", flush=True)
    print(f"bn_act VGG: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launched


Q_BATCH = 256            # faces of serve_vitl_typical's call
Q_SHAPE = (Q_BATCH, 8, 144, 96)   # ViT-L: (faces, heads, tokens, width)
Q_DEPTH = 24
Q_TOL = 1e-5             # attn_gap's limit
Q_FORWARD = 32           # faces of the held ViT-L forward
Q_FGSM = 4               # chips under the FGSM gradient check


def _qkv_views(shape, g, contiguous: bool = False):
    """q, k, v (N, H, T, d) bf16 from a generator on the card: the strided
    views of one (N, T, 3, H, d) tensor that ``Attention.forward``
    passes, or contiguous copies."""
    n, h, t, d = shape
    qkv = torch.randn((n, t, 3 * h * d), generator=g, device=g.device).to(
        torch.bfloat16).reshape(n, t, 3, h, d).permute(2, 0, 3, 1, 4)
    views = (qkv[0], qkv[1], qkv[2])
    return tuple(x.contiguous() for x in views) if contiguous else views


def _cold_ms(fn, iters: int = 20) -> float:
    """Mean ms of one call by CUDA events, 256 MB written between calls so
    that each starts with nothing of its inputs in the 50-MB L2."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _ptxas(kernel: str) -> list[str]:
    """``-Xptxas -v``'s lines (registers, spills) for each instance of
    ``kernel`` in the build log."""
    from alink_tpu_torch import _build

    log = _build.BUILD_DIR / "build.log"
    out, name = [], None
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
        elif name and ("spill" in line or "Used" in line):
            out.append(f"{name}: {line.strip()}")
    return out


def phase_attention(dev, smi: str) -> tuple[int, dict]:
    """(q) the ViT attention core: ``attention_core_kernel`` against
    ``attention_core_reference`` at ViT-L's shape and at ragged ones,
    timed beside its bounds, the plain version and the library's float32
    attention; a ViT-L forward, its cores and an FGSM gradient against
    the plain core; ``launches.attn`` a forward."""
    import torch.nn.functional as F

    import alink_tpu_torch.models.vit as vit
    from alink_tpu_torch import _build
    from bench_torch.roofline_vit import attn_bound_s
    from alink_tpu_torch.models import FaceViT_L
    from alink_tpu_torch.ops import attention as A
    from alink_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "attention: the plain version runs in float32, TF32 must be off")
    _build.load()
    for line in _ptxas("attention_kernel"):
        print(f"attention ptxas: {line}", flush=True)
    gd = torch.Generator(device=dev).manual_seed(SEED + 16)
    err = 0.0
    cases = [(Q_SHAPE, False), ((3, 2, 7, 32), False),
             ((5, 3, 144, 16), False), ((4, 2, 200, 64), False),
             ((2, 2, 256, 128), False), ((3, 4, 144, 80), False),
             ((2, 3, 33, 112), False), ((7, 8, 144, 96), True)]
    for shape, contiguous in cases:
        q, k, v = _qkv_views(shape, gd, contiguous)
        got = A.attention_core_kernel(q, k, v)
        want = A.attention_core_reference(q, k, v)
        torch.cuda.synchronize()
        n, h, t, d = shape
        check(got.dtype == torch.float32 and got.shape == (n, t, h * d)
              and got.is_contiguous(), f"attention {shape}: output "
              f"{got.dtype} {tuple(got.shape)}")
        gap = maxdiff(got, want) / float(want.abs().max())
        err = max(err, maxdiff(got, want))
        check(gap <= Q_TOL, f"attention {shape}: gap {gap:.3e} over the "
              f"widest |reference| (limit {Q_TOL:g})")
        print(f"attention {shape}{' contiguous' if contiguous else ''}: "
              f"gap {gap:.3e} of the widest |reference| "
              f"{float(want.abs().max()):.3f}", flush=True)
        del q, k, v, got, want

    q, k, v = _qkv_views(Q_SHAPE, gd)
    n, h, t, d = Q_SHAPE
    kernel = lambda: A.attention_core_kernel(q, k, v)      # noqa: E731
    ms, call = kernel_ms(kernel, "launches.attn")
    cold = _cold_ms(kernel)
    plain = graph_ms(lambda: A.attention_core_reference(q, k, v),
                     exact=False)

    def library_core(q, k, v):
        # PyTorch's float32 attention with its upcasts and the head merge,
        # the core before this kernel: a yardstick only.
        nn, hh, tt, dd = q.shape
        out = F.scaled_dot_product_attention(q.float(), k.float(), v.float())
        return out.transpose(1, 2).reshape(nn, tt, hh * dd)

    lib = cuda_ms(lambda: library_core(q, k, v))
    problems = n * h
    bytes_f32 = problems * t * d * (3 * 2 + 4)
    bound = bound_s(0, H100_BF16_TFLOPS, bytes_f32)[0] * 1e3
    # attn_roofline.serve_vit's bound: 4 T^2 D a face over TF32's peak, or
    # q, k, v and the output at 2 bytes.
    metric_bound = attn_bound_s(n, t, h * d) * 1e3
    flops = problems * 8 * t * t * d
    print(f"attention {Q_SHAPE}: kernel {ms:.4f} ms (L2 flushed "
          f"{cold:.4f}, per call from Python {call:.4f}), bytes bound "
          f"{bound:.4f} ({100 * bound / ms:.1f} % of it, "
          f"{bytes_f32 / ms / 1e6:.0f} GB/s; "
          f"{bytes_f32 / 1e6:.1f} MB), attn_roofline's bound "
          f"{metric_bound:.4f} ({100 * metric_bound / ms:.1f} %), "
          f"{flops / ms / 1e9:.1f} TFLOP/s of bf16 products, plain "
          f"{plain:.4f} ms, library float32 attention with its upcasts "
          f"and merge {lib:.4f} ms (per call from Python) on {smi}",
          flush=True)
    del q, k, v
    torch.cuda.empty_cache()

    g = torch.Generator().manual_seed(SEED + 16)
    model = FaceViT_L(generator=g, device=dev).eval().requires_grad_(False)
    chips = (torch.rand((Q_BATCH, 112, 112, 3), generator=g) * 255).to(dev)
    real = vit.attention_core

    @contextlib.contextmanager
    def core(fn):
        vit.attention_core = fn
        try:
            yield
        finally:
            vit.attention_core = real

    seen = {}

    def keep(i):
        def hook(mod, args, out):
            seen[i] = (tuple(a.detach().clone() for a in args),
                       out.detach().clone())
        return hook

    hooks = [model.blocks[i].attn.core.register_forward_hook(keep(i))
             for i in (0, Q_DEPTH - 1)]
    with torch.no_grad():
        with counting() as made:
            emb = model(chips[:Q_FORWARD])
        for hk in hooks:
            hk.remove()
        check(made["launches.attn"] == Q_DEPTH,
              f"attention: {made['launches.attn']} launches in one ViT-L "
              f"forward")
        with core(A.attention_core_reference):
            emb_plain = model(chips[:Q_FORWARD])
    attn_gap = max(maxdiff(out, A.attention_core_reference(*args))
                   / float(A.attention_core_reference(*args).abs().max())
                   for args, out in seen.values())
    embed_gap = float(torch.linalg.vector_norm(emb - emb_plain,
                                               dim=1).max())
    check(attn_gap <= Q_TOL, f"attention: ViT-L blocks 0 and 23, gap "
          f"{attn_gap:.3e}")
    check(bool(torch.isfinite(emb).all()) and embed_gap <= 0.03,
          f"attention: ViT-L embeddings {embed_gap:.3e} from the plain "
          f"core's")
    print(f"attention: ViT-L forward ({Q_FORWARD} faces): blocks 0 and 23 "
          f"gap {attn_gap:.3e} (attn_gap's reading), unit embeddings "
          f"{embed_gap:.3e} from the plain core's", flush=True)

    def forward_ms(fn) -> float:
        with torch.no_grad(), core(fn):
            return cuda_ms(lambda: model(chips), iters=5, warmup=2)

    times = {A.attention_core: [], A.attention_core_reference: []}
    for fn in (A.attention_core, A.attention_core_reference,
               A.attention_core_reference, A.attention_core):
        times[fn].append(forward_ms(fn))
    print("attention: ViT-L forward at batch {} ms (per call from Python, "
          "in turns): kernel core {}, plain core {}".format(
              Q_BATCH, [f"{x:.2f}" for x in times[A.attention_core]],
              [f"{x:.2f}" for x in times[A.attention_core_reference]]),
          flush=True)

    log_dir = Path(__file__).resolve().parent / "build" / "chip_smoke" / \
        "attention"
    launches = 2 * Q_DEPTH            # the held forward's, the traced one's
    kernels = {}
    for side, fn in (("library", library_core), ("kernel", A.attention_core)):
        with torch.no_grad(), core(fn), \
                profiling.trace(str(log_dir / side)) as prof:
            model(chips)
            torch.cuda.synchronize()
        kernels[side] = [e.name for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
    names = kernels["kernel"]
    counted = json.loads((log_dir / "kernel" / "counters.json").read_text())
    check(counted["launches.attn"] == Q_DEPTH,
          f"attention: counters.json launches.attn "
          f"{counted['launches.attn']}, want {Q_DEPTH}")
    library_kernels = sorted({x for x in names if "fmha" in x
                              or "flash" in x.lower()})
    check(not library_kernels, f"attention: library attention kernels in "
          f"a ViT-L forward: {library_kernels}")
    ours = sum("attention_kernel" in x for x in names)
    check(ours == Q_DEPTH, f"attention: {ours} kernel launches in the "
          f"trace of one forward")
    print(f"attention: one ViT-L forward ({Q_BATCH}), {len(names)} kernels "
          f"launched ({len(kernels['library'])} with the library's core), "
          f"{ours} of them the core's; counters.json launches.attn "
          f"{Q_DEPTH}; no library attention kernel", flush=True)

    # The backward: the autograd function's gradients at ViT-L's shape
    # against autograd of the plain core (the same operations on the same
    # saved q, k, v: bit-equal).
    n, h, t, d = Q_SHAPE
    base = torch.randn((Q_FGSM, t, 3 * h * d), generator=gd, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    q, k, v = base.reshape(Q_FGSM, t, 3, h, d).permute(2, 0, 3, 1, 4)
    up = torch.randn((Q_FGSM, t, h * d), generator=gd, device=dev)
    got = torch.autograd.grad(A.attention_core(q, k, v), (q, k, v), up)
    want = torch.autograd.grad(A.attention_core_reference(q, k, v),
                               (q, k, v), up)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "attention: the autograd function's gradients differ from plain "
          "autograd of the reference")
    del base, q, k, v, up, got, want

    # The FGSM pixel gradient through ViT-L: the kernel core's against the
    # plain core's, beside the library's float32 core (the one the ViT ran
    # before) against the plain core's: a float32 core that sums in
    # another order moves the forward's bf16 roundings, and through 24
    # blocks the gradient, as much.
    x = chips[:Q_FGSM]
    w = torch.randn((Q_FGSM, 512), generator=g).to(dev)
    grads = []
    for fn in (A.attention_core, A.attention_core_reference, library_core):
        xi = x.clone().requires_grad_(True)
        with counting() as made, core(fn):
            (model(xi) * w).sum().backward()
        want = Q_DEPTH if fn is A.attention_core else 0
        check(made["launches.attn"] == want,
              f"attention: {made['launches.attn']} launches in one FGSM "
              f"forward, want {want}")
        launches += want
        grads.append(xi.grad)

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    kernel_rel, control_rel = rel(grads[0], grads[1]), rel(grads[2], grads[1])
    check(bool(torch.isfinite(grads[0]).all()) and
          float(grads[0].abs().max()) > 0 and
          kernel_rel <= 2 * control_rel + 1e-3,
          f"attention: FGSM gradient on {Q_FGSM} chips, relative L2 "
          f"{kernel_rel:.3e} from the plain core's (the library core's "
          f"{control_rel:.3e})")
    print(f"attention: gradients of q, k, v bit-equal to the plain core's "
          f"autograd; FGSM gradient ({Q_FGSM} chips) relative L2 "
          f"{kernel_rel:.3e} from the plain core's, the library's float32 "
          f"core {control_rel:.3e} from it", flush=True)
    print(f"attention: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, {"err": err, "ms": ms, "call_ms": call,
                      "plain_ms": plain, "bound_ms": bound,
                      "bound_by": "bytes", "library_ms": lib}


# Phase (r): RetinaFace-R50's detector, its NMS kernel and K3 at its
# shapes.  NMS data: boxes on an integer grid (inclusive sides 1 to 40,
# so overlaps repeat and some land exactly on the threshold) with scores
# on a grid of 1/8 (ties by the hundred), at the cascade's budgets; and
# decode-like boxes over a 640^2 photo (centres uniform, sides 16 to 512
# px times exp(N(0, 0.2))) with scores on a grid of 2^-12, at 5,000.
R_PHOTO = 640
R_BATCH = 256
R_TOPK = 5000
R_CASCADE = ((256, 32), (256, 8), (256, 4), (64, 1))
R_K3_BATCHES = (32, 256)
R_STEM_VAR = 5688.83


def _grid_boxes(n: int, k: int, g) -> tuple:
    xy = torch.randint(0, 24, (n, k, 2), generator=g).float()
    wh = torch.randint(0, 40, (n, k, 2), generator=g).float()
    s = torch.randint(0, 8, (n, k), generator=g).float() / 8
    return torch.cat([xy, xy + wh], -1), s, torch.rand(n, k, generator=g) > .1


def _photo_boxes(n: int, k: int, g) -> tuple:
    c = torch.rand(n, k, 2, generator=g) * R_PHOTO
    side = torch.tensor([16.0, 32, 64, 128, 256, 512])[
        torch.randint(0, 6, (n, k), generator=g)][..., None] * torch.exp(
            0.2 * torch.randn(n, k, 2, generator=g))
    s = torch.randint(0, 4096, (n, k), generator=g).float() / 4096
    return (torch.cat([c - side / 2, c + side / 2], -1), s,
            torch.rand(n, k, generator=g) > 0.02)


def _in_visit_order(b, s, v) -> tuple:
    """Candidates sorted into ``ops.nms.nms``'s visit order (descending
    score, ties to the lower index), as ``nms_kernel`` takes them."""
    order = torch.sort(s, dim=1, descending=True, stable=True)[1]
    return (torch.gather(b, 1, order[..., None].expand(b.shape)),
            torch.gather(s, 1, order), torch.gather(v, 1, order))


def phase_retina(dev, smi: str) -> tuple[dict, dict]:
    """(r) the NMS kernel (``ops.nms.nms_kernel``, ``csrc/nms.cu``) on
    candidates in visit order against ``ops.nms.nms`` at the cascade's
    budgets and one photo at a time at 5,000 candidates, and against the
    reference's sequential greedy loop
    (``bench_torch/reference/retinaface.greedy_nms``) at 256 x 5,000,
    the keep-masks bit-equal; its device time beside
    ``roofline_retina.nms_bound_s``; K3 at RetinaFace-R50's five stride-1
    shapes (160^2 to 20^2) against its plain version on dyadic data
    (exact) at batch 32 and 256, its device time at 256 beside each
    shape's ``roofline.bound_s``; then ``RetinaFaceR50`` at 640^2 and
    batch 256 with its landmark heads at the mean-face prior (the forward,
    the detector's call, TFLOP/s against ``retina_flops``),
    ``FaceModel(r100, detector=...)`` faces/s with the launches of one
    pipeline call, and K2 at this path's shapes (the 256 photos of 640^2
    warped by the similarities of each photo's best kept landmarks)
    against the plain warp.  Returns the launches of the phase's main-path
    runs by kernel, and the NMS kernel's numbers."""
    from alink_tpu_torch.detect import (CascadeConfig, FaceModel,
                                        RetinaFaceDetector)
    from alink_tpu_torch.detect.cascade import _MEAN_FACE, alignment_transforms
    from alink_tpu_torch.models import ArcFaceResNet100, RetinaFaceR50
    from alink_tpu_torch.ops import image
    from alink_tpu_torch.ops import nms as N
    from alink_tpu_torch.ops import resblock
    from bench_torch import roofline_retina as RR
    from bench_torch.reference.retinaface import greedy_nms

    t_phase = time.perf_counter()
    for line in _ptxas("nms_"):
        print(f"nms ptxas: {line}", flush=True)
    g = torch.Generator().manual_seed(SEED + 20)
    for n, k in R_CASCADE:
        b, s, v = (t.to(dev) for t in _in_visit_order(*_grid_boxes(n, k,
                                                                     g)))
        got, want = N.nms_kernel(b, v, 0.4), N.nms(b, s, v, 0.4)
        print(f"nms kernel {n} x {k} (grid boxes, tied scores): "
              f"{int((got != want).sum())} flags differ from ops.nms.nms, "
              f"{int(want.sum())} kept", flush=True)
        check(torch.equal(got, want), f"nms kernel {n} x {k}: differs")
    bs, ss, vs = (t.to(dev) for t in _in_visit_order(
        *_photo_boxes(R_BATCH, R_TOPK, g)))
    for i in range(4):
        got = N.nms_kernel(bs[i:i + 1], vs[i:i + 1], 0.4)
        want = N.nms(bs[i:i + 1], ss[i:i + 1], vs[i:i + 1], 0.4)
        print(f"nms kernel photo {i}, 1 x {R_TOPK}: "
              f"{int((got != want).sum())} flags differ from ops.nms.nms, "
              f"{int(want.sum())} kept", flush=True)
        check(torch.equal(got, want), f"nms kernel photo {i}: differs")
    got = N.nms_kernel(bs, vs, 0.4)
    t0 = time.perf_counter()
    want = greedy_nms(bs, vs, 0.4)
    t_loop = time.perf_counter() - t0
    print(f"nms kernel {R_BATCH} x {R_TOPK}: {int((got != want).sum())} "
          f"flags differ from the sequential greedy loop ({t_loop:.2f} s), "
          f"{int(want.sum())} kept ({int(want.sum(1).min())} to "
          f"{int(want.sum(1).max())} a photo)", flush=True)
    check(torch.equal(got, want), "nms kernel 256 x 5,000: differs from "
          "the greedy loop")
    ms, call = kernel_ms(lambda: N.nms_kernel(bs, vs, 0.4), "launches.nms")
    bound = RR.nms_bound_s(R_BATCH, R_TOPK) * 1e3
    nms_numbers = kernel_numbers(0.0, ms, call, None,
                                 RR.nms_ops(R_BATCH, R_TOPK), H100_F32_TFLOPS,
                                 RR.nms_bytes(R_BATCH, R_TOPK))
    print(f"nms kernel {R_BATCH} x {R_TOPK}: {ms:.4f} ms on the device "
          f"({call:.4f} per call from Python), bound {bound:.4f} ms "
          f"({nms_numbers['bound_by']}; {100 * bound / ms:.1f} % of it)",
          flush=True)
    del bs, ss, vs, got, want
    torch.cuda.empty_cache()

    gd = torch.Generator(device=dev).manual_seed(SEED + 21)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = sorted(set(RR.retina_stride1_blocks(R_PHOTO)), reverse=True)
    for hw, cin, cm, cout, proj in shapes:
        name = f"{hw}x{hw} {cin}->{cm}->{cout}{' proj' if proj else ''}"
        wts = k3_weights(cin, cm, cout, proj, g, dev, True)
        for batch in R_K3_BATCHES:
            plan = resblock.launch_plan(batch, hw, hw, cin, cm, cout, proj,
                                        sms)
            x = torch.randint(-2, 3, (batch, hw, hw, cin), generator=gd,
                              device=dev).to(torch.bfloat16)
            got = resblock.bottleneck_s1_kernel(x, wts)
            want = torch.cat([resblock.bottleneck_s1_reference(
                x[i:i + 32], wts) for i in range(0, batch, 32)])
            torch.cuda.synchronize()
            err = maxdiff(got, want)
            nonzero = float((want != 0).float().mean())
            line = (f"K3 retina {name} batch {batch} ({plan.tile.th}x"
                    f"{plan.tile.tw} tiles, {plan.blocks} blocks, ring "
                    f"{plan.slots}, y1/y2 global {plan.global_act}) dyadic: "
                    f"max|diff| {err:.3e} (limit {K3_EXACT_LIMIT}), "
                    f"{100 * nonzero:.0f} % non-zero")
            if batch == R_K3_BATCHES[-1]:
                ms = graph_ms(lambda: resblock.bottleneck_s1_kernel(x, wts),
                              calls=5, counter="launches.k3")
                bound, by = bound_s(k3_flops(batch, hw, cin, cm, cout, proj),
                                    H100_BF16_TFLOPS,
                                    RR.k3_bytes(batch, hw, cin, cm, cout,
                                                proj))
                line += (f"; kernel {ms:.4f} ms, bound {bound * 1e3:.4f} ms "
                         f"({by}; {100 * bound * 1e3 / ms:.1f} % of it)")
            print(line, flush=True)
            check(err <= K3_EXACT_LIMIT and nonzero > 0.2,
                  f"K3 retina {name} batch {batch}: max|diff| {err}")
            del x, got, want
        del wts
    torch.cuda.empty_cache()

    gw = torch.Generator(device=dev).manual_seed(SEED + 22)
    model = RetinaFaceR50(dtype=torch.bfloat16, device=dev)
    prior = torch.tensor([10.0 * (p - 0.5) for xy in zip(_MEAN_FACE[:5],
                                                          _MEAN_FACE[5:])
                          for p in xy] * 2, device=dev)
    with torch.no_grad():
        # The stem's BN at the second moment of the mean-subtracted
        # levels, so that the random trunk's activations stay near 1; the
        # landmark heads at the mean-face prior, as the benchmark's
        # configuration seeds them (random ones give degenerate faces).
        model.body.bn[0].var.fill_(R_STEM_VAR)
        for head in model.landmark_head:
            head.weight.mul_(0.01)
            head.bias.copy_(prior)
    model.refold()
    emb = ArcFaceResNet100(dtype=torch.bfloat16, device=dev).eval()
    detector = RetinaFaceDetector(model)
    photos = torch.randint(0, 256, (R_BATCH, R_PHOTO, R_PHOTO, 3),
                           generator=gw, device=dev).float()
    fwd = cuda_ms(lambda: model(photos), iters=3, warmup=1)
    det_ms = cuda_ms(lambda: detector(photos), iters=3, warmup=1)
    tf = RR.retina_flops(R_PHOTO) * R_BATCH / (fwd * 1e-3) / 1e12
    print(f"retina forward {R_BATCH} x {R_PHOTO}^2: {fwd:.2f} ms "
          f"({tf:.1f} TFLOP/s, {100 * tf / H100_BF16_TFLOPS:.1f} % of "
          f"{H100_BF16_TFLOPS:.0f}); detector call {det_ms:.2f} ms "
          f"(post-process {det_ms - fwd:.2f})", flush=True)
    fm = FaceModel(emb, cfg=CascadeConfig(), detector=detector)
    with counting() as made:
        emb_out, found = fm.pipeline_valid(photos)
        torch.cuda.synchronize()
    pipe = cuda_ms(lambda: fm.pipeline(photos), iters=3, warmup=1)
    print(f"retina pipeline (RetinaFace-R50 -> K2 -> r100) {R_BATCH} "
          f"photos: {pipe:.2f} ms, {R_BATCH / pipe * 1e3:.1f} faces/s; "
          f"found {int(found.sum())}; counts "
          + ", ".join(f"{k} {v}" for k, v in made.items()
                      if k.startswith(("launches.", "retina.", "nms."))
                      and v), flush=True)
    check(bool(torch.isfinite(emb_out).all()), "retina pipeline: non-finite")
    check(made["launches.k3"] == 13 and made["launches.nms"] == 1,
          "retina pipeline: K3 13 and NMS 1 launch a call expected")

    # K2 at this path's shapes: 256 photos of 640^2 float32 (1.26 GB)
    # warped by the similarities of each photo's best kept landmarks, as
    # FaceModel aligns them, against the plain warp, on the found photos
    # (coinciding landmarks warp by a singular map, to NaN on both sides).
    det = detector(photos)
    best = torch.argmax(torch.where(det.valid, det.scores, -1.0), dim=1)
    lmk = det.landmarks[torch.arange(R_BATCH, device=dev), best]
    found = det.valid.any(1) & ((lmk - lmk[:, :1]).abs().amax(dim=(1, 2))
                                > 0)
    Ms = alignment_transforms(lmk)
    with counting() as warped:
        chips = image.affine_warp_batch(photos, Ms, (112, 112))
        torch.cuda.synchronize()
    want = image.affine_warp_batch_reference(photos, Ms, (112, 112))
    err = maxdiff(chips[found], want[found])
    inside = float((want[found] != 0).float().mean())
    print(f"retina K2 {R_BATCH} x {R_PHOTO}^2 f32 -> 112^2, the detector's "
          f"landmarks: {int(found.sum())} found, vs plain max|diff| "
          f"{err:.3e} (limit 1e-3), {100 * inside:.1f} % of the chips' "
          f"values non-zero; K2 launches {warped['launches.k2']}",
          flush=True)
    check(int(found.sum()) > R_BATCH // 2, "retina K2: under half the "
          "photos found")
    check(err <= 1e-3, f"retina K2 chips: max|diff| {err} > 1e-3")
    check(inside > 0.25, "retina K2: the chips lie mostly outside the "
          "photos")
    print(f"retina: phase (r) {time.perf_counter() - t_phase:.1f} s on "
          f"{smi}", flush=True)
    return {"nms": made["launches.nms"],
            "affine_warp": made["launches.k2"] + warped["launches.k2"],
            "bottleneck": made["launches.k3"],
            "bn_act": made["launches.bn_act"]}, nms_numbers


# Phase (s): the Swin embedder's windowed attention core.  Shapes (chips,
# grid, heads, shift) of Swin-S's stages at 112^2 and patch 2.
S_BATCH = 1024
S_STAGES = ((S_BATCH, 56, 3, 3), (S_BATCH, 56, 3, 0), (S_BATCH, 28, 6, 3),
            (S_BATCH, 14, 12, 3), (S_BATCH, 14, 12, 0), (S_BATCH, 7, 24, 0))
S_RAGGED = ((3, 21, 5, 3), (5, 14, 2, 3), (2, 7, 4, 0), (1, 35, 8, 3))
S_TIMED = ((S_BATCH, 56, 3, 3), (S_BATCH, 14, 12, 3))
S_DEPTH = 24
S_FORWARD = 64           # chips of the held forward


def _swin_qkv(n, side, heads, g):
    """(N, S, S, 3 H 32) bf16 and a (169, H) float32 table of the
    published scale from a generator on the card."""
    qkv = torch.randn((n, side, side, 3 * heads * 32), generator=g,
                      device=g.device).to(torch.bfloat16)
    table = torch.randn((169, heads), generator=g, device=g.device) * 0.02
    return qkv, table


def _wattn_gap(qkv, table, shift, got, block: int = 128
               ) -> tuple[float, float]:
    """(widest |kernel - plain| over widest |plain|, widest |kernel -
    plain|), the plain float32 path in blocks of chips."""
    from alink_tpu_torch.ops import attention as A

    gap = top = 0.0
    for i in range(0, qkv.shape[0], block):
        want = A.window_attention_reference(qkv[i:i + block], table, shift, 7)
        gap = max(gap, maxdiff(got[i:i + block].float(), want))
        top = max(top, float(want.abs().max()))
    return gap / top, gap


def phase_swin(dev, smi: str) -> tuple[int, dict]:
    """(s) the windowed core against the plain path at Swin-S's shapes,
    timed beside its bound; a ``FaceSwin_S`` forward: launches, the trace
    inside ``alink/swin.attn``, embeddings, chips a second."""
    import alink_tpu_torch.models.swin as swin
    from alink_tpu_torch import _build
    from alink_tpu_torch.detect import FaceModel
    from alink_tpu_torch.models import FaceSwin_S
    from alink_tpu_torch.ops import attention as A
    from alink_tpu_torch.utils import profiling
    from bench_torch.roofline_swin import (wattn_bound_per_forward_s,
                                           wattn_bound_s, wattn_bytes)

    t_phase = time.perf_counter()
    limits = json.loads((Path(__file__).resolve().parent / "bench_torch" /
                         "configs" / "swin_s_face112.json").read_text()
                        )["limits"]
    limit = limits["wattn_gap"]
    _build.load()
    for line in _ptxas("window_attention_kernel"):
        print(f"window attention ptxas: {line}", flush=True)
    gd = torch.Generator(device=dev).manual_seed(SEED + 19)
    err = 0.0
    for n, side, heads, shift in S_STAGES + S_RAGGED:
        qkv, table = _swin_qkv(n, side, heads, gd)
        got = A.window_attention_kernel(qkv, table, shift, 7)
        torch.cuda.synchronize()
        check(got.dtype == torch.bfloat16 and got.is_contiguous() and
              got.shape == (n, side, side, heads * 32),
              f"window attention {(n, side, heads, shift)}: output "
              f"{got.dtype} {tuple(got.shape)}")
        gap, diff = _wattn_gap(qkv, table, shift, got)
        err = max(err, diff)
        check(gap <= limit, f"window attention {(n, side, heads, shift)}: "
              f"gap {gap:.3e} over the widest |reference| (limit {limit:g})")
        print(f"window attention (chips, grid, heads, shift) "
              f"{(n, side, heads, shift)}: gap {gap:.3e} of the widest "
              f"|reference|", flush=True)
        del qkv, table, got
    torch.cuda.empty_cache()

    timed = {}
    for n, side, heads, shift in S_TIMED:
        qkv, table = _swin_qkv(n, side, heads, gd)
        kernel = lambda: A.window_attention_kernel(  # noqa: E731
            qkv, table, shift, 7)
        ms, call = kernel_ms(kernel, "launches.wattn")
        cold = _cold_ms(kernel)
        plain = cuda_ms(lambda: A.window_attention_reference(
            qkv, table, shift, 7), iters=3, warmup=1)

        def autocast_path():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return A.window_attention_reference(qkv, table, shift, 7)

        lib = cuda_ms(autocast_path, iters=3, warmup=1)
        c = heads * 32
        bound = wattn_bound_s(n, side, c) * 1e3
        nbytes = n * wattn_bytes(side * side, c)
        print(f"window attention {(n, side, heads, shift)}: kernel {ms:.4f} "
              f"ms (L2 flushed {cold:.4f}, per call from Python "
              f"{call:.4f}), bytes bound {bound:.4f} ({100 * bound / ms:.1f} "
              f"% of it, {nbytes / ms / 1e6:.0f} GB/s of "
              f"{nbytes / 1e6:.1f} MB), plain float32 path {plain:.4f} ms, "
              f"the published sequence under bf16 autocast {lib:.4f} ms "
              f"(per call from Python) on {smi}", flush=True)
        timed[(side, shift)] = (ms, call, plain, bound, lib)
        del qkv, table
        torch.cuda.empty_cache()
    ms, call, plain, bound, lib = timed[(56, 3)]
    check(ms < plain, f"window attention: kernel {ms:.4f} ms not faster "
          f"than the plain path {plain:.4f} ms at stage 1")

    g = torch.Generator().manual_seed(SEED + 19)
    model = FaceSwin_S(generator=g, device=dev).eval()
    fm = FaceModel(model)
    chips = (torch.rand((S_BATCH, 112, 112, 3), generator=g) * 255).to(dev)
    real = swin.window_attention

    @contextlib.contextmanager
    def core(fn):
        swin.window_attention = fn
        try:
            yield
        finally:
            swin.window_attention = real

    seen = {}

    def keep(module, args, out):
        seen["core"] = (args[0].detach().clone(), args[1].detach().clone(),
                        module.shift, out.detach().clone())

    hook = model.layers[0].blocks[1].attn.core.register_forward_hook(keep)
    with counting() as made:
        emb = fm.get_feature(chips[:S_FORWARD])
    hook.remove()
    check(made["launches.wattn"] == S_DEPTH and made["embed.calls"] == 1,
          f"window attention: {made['launches.wattn']} launches in one "
          f"Swin-S forward")
    with core(A.window_attention_reference):
        emb_plain = fm.get_feature(chips[:S_FORWARD])
    qkv, table, shift, out = seen["core"]
    check(shift == 3, "window attention: stage 1's block 1 does not shift")
    block_gap = _wattn_gap(qkv, table, shift, out)[0]
    embed_gap = float(torch.linalg.vector_norm(emb - emb_plain,
                                               dim=1).max())
    check(block_gap <= limit and bool(torch.isfinite(emb).all()) and
          embed_gap <= limits["embed_gap"], f"window attention: Swin-S "
          f"stage 1 block 1 "
          f"gap {block_gap:.3e}, embeddings {embed_gap:.3e} from the plain "
          f"core's")
    print(f"window attention: Swin-S forward ({S_FORWARD} chips): stage 1 "
          f"block 1 gap {block_gap:.3e} (wattn_gap's reading), unit "
          f"embeddings {embed_gap:.3e} from the plain core's", flush=True)
    del seen, qkv, table, out

    log_dir = Path(__file__).resolve().parent / "build" / "chip_smoke" / \
        "swin"
    with profiling.trace(str(log_dir)) as prof:
        fm.get_feature(chips)
        torch.cuda.synchronize()
    launches = 2 * S_DEPTH            # the held forward's, the traced one's

    def kernels(evt) -> list:
        own = [k.name for k in getattr(evt, "kernels", ())]
        return own + [x for c in evt.cpu_children for x in kernels(c)]

    # The host's ranges (with CUDA traced, each range also has a device
    # annotation of the same name).
    spans = [e for e in prof.events()
             if e.name == profiling.SPAN_PREFIX + "swin.attn"
             and e.device_type != torch.autograd.DeviceType.CUDA]
    inside = [x for e in spans for x in kernels(e)]
    counted = json.loads((log_dir / "counters.json").read_text())
    check(len(spans) == S_DEPTH and counted["launches.wattn"] == S_DEPTH and
          len(inside) == S_DEPTH and
          all("window_attention_kernel" in x for x in inside),
          f"window attention: {len(spans)} swin.attn spans, kernels inside "
          f"{sorted(set(inside))} ({len(inside)})")
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"window attention: one Swin-S forward ({S_BATCH}), {len(names)} "
          f"kernels launched; inside the 24 alink/swin.attn spans only "
          f"{len(inside)} window_attention_kernel launches; counters.json "
          f"launches.wattn {counted['launches.wattn']}", flush=True)

    def forward_ms(fn) -> float:
        with core(fn):
            return cuda_ms(lambda: fm.get_feature(chips), iters=5, warmup=2)

    times = {real: [], A.window_attention_reference: []}
    for fn in (real, A.window_attention_reference,
               A.window_attention_reference, real):
        times[fn].append(forward_ms(fn))
    best = min(times[real])
    bound_fwd = wattn_bound_per_forward_s(S_BATCH) * 1e3
    print("window attention: Swin-S forward at batch {} ms (per call from "
          "Python, in turns): kernel core {}, plain core {}; {:.0f} chips/s; "
          "the cores' bytes bound {:.3f} ms a forward".format(
              S_BATCH, [f"{x:.2f}" for x in times[real]],
              [f"{x:.2f}" for x in times[A.window_attention_reference]],
              S_BATCH / best * 1e3, bound_fwd), flush=True)
    print(f"window attention: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, {"err": err, "ms": ms, "call_ms": call,
                      "plain_ms": plain, "bound_ms": bound,
                      "bound_by": "bytes", "library_ms": lib}


# Phase (s), LayerNorm: each distinct norm of a Swin-S forward at 112^2 and
# 1,024 chips, (what, rows, width, input dtype, output dtype, norms of that
# shape a forward), in the order they run.
F32, BF16 = torch.float32, torch.bfloat16
LN_SHAPES = (("patch", S_BATCH * 3136, 96, BF16, F32, 1),
             ("stage 1", S_BATCH * 3136, 96, F32, BF16, 4),
             ("merge 1", S_BATCH * 784, 384, F32, BF16, 1),
             ("stage 2", S_BATCH * 784, 192, F32, BF16, 4),
             ("merge 2", S_BATCH * 196, 768, F32, BF16, 1),
             ("stage 3", S_BATCH * 196, 384, F32, BF16, 36),
             ("merge 3", S_BATCH * 49, 1536, F32, BF16, 1),
             ("stage 4", S_BATCH * 49, 768, F32, BF16, 4),
             ("final", S_BATCH * 49, 768, F32, F32, 1))
LN_WIDTHS = (96, 192, 384, 768, 1536)
LN_RAGGED = 49 * 1000 + 7
LN_NORMS = {"swin": 53, "vit": 49}


def _ln_case(rows, c, in_dtype, g):
    """Rows of the residual stream's kind: a per-row offset and scale on
    normal noise, in ``in_dtype``; gamma and beta near their init."""
    dev = g.device
    x = (torch.randn((rows, c), generator=g, device=dev)
         * (0.5 + torch.rand((rows, 1), generator=g, device=dev) * 4)
         + torch.randn((rows, 1), generator=g, device=dev) * 3).to(in_dtype)
    gamma = 1 + 0.2 * torch.randn(c, generator=g, device=dev)
    beta = 0.2 * torch.randn(c, generator=g, device=dev)
    return x, gamma, beta


def _ln_gap(got, want) -> tuple[float, float, float]:
    """(share of elements bit-equal, widest |difference| in bf16 ulps of
    the reference (bf16 output) or over the widest |reference| (float32
    output), widest |difference|).  A bf16 ulp is taken at no less than
    1/256 of the widest |reference|: nearer 0 the float32 rounding of any
    two implementations' statistics (~2^-23 of the widest) spans more
    than one of the value's own ulps."""
    diff = (got.float() - want.float()).abs()
    bits = torch.int16 if got.dtype == BF16 else torch.int32
    same = float((got.view(bits) == want.view(bits)).float().mean())
    if got.dtype == BF16:
        ref = want.float().abs()
        _, e = torch.frexp(torch.clamp(ref, min=float(ref.max()) / 256))
        ulp = torch.ldexp(torch.ones_like(diff), e - 8)
        return same, float((diff / ulp).max()), float(diff.max())
    return same, float(diff.max() / want.float().abs().max()), \
        float(diff.max())


def phase_ln(dev, smi: str) -> tuple[int, dict]:
    """(s, LayerNorm) ``ops.layer_norm``'s kernel (``csrc/layer_norm.cu``)
    against ``F.layer_norm`` + ``.to`` at Swin-S's norms and a ragged row
    count, every width with each input and output dtype; each of a
    forward's norm shapes timed beside its bytes bound and PyTorch's
    sequence; Swin-S and ViT-L forwards with 53 and 49 ``launches.ln``,
    nothing but the norm kernel inside ``alink/ln`` and no cast after it
    in the trace, the embeddings against the plain norms' and a Swin-S
    forward at 1,024 chips with each."""
    import alink_tpu_torch.models.vit as vit_module
    from alink_tpu_torch.detect import FaceModel
    from alink_tpu_torch.models import FaceSwin_S, FaceViT_L
    from alink_tpu_torch.ops import layer_norm as L
    from alink_tpu_torch.utils import profiling
    from bench_torch.roofline_ln import ln_bound_per_forward_s

    t_phase = time.perf_counter()
    for line in _ptxas("layer_norm_kernel"):
        print(f"layer norm ptxas: {line}", flush=True)
    gd = torch.Generator(device=dev).manual_seed(SEED + 23)
    eps, err = 1e-5, 0.0
    cases = [(what, rows, c, i, o) for what, rows, c, i, o, _ in LN_SHAPES]
    cases += [("ragged", LN_RAGGED, c, i, o) for c in LN_WIDTHS
              for i in (F32, BF16) for o in (BF16, F32)]
    for what, rows, c, in_dtype, out_dtype in cases:
        x, gamma, beta = _ln_case(rows, c, in_dtype, gd)
        got = L.layer_norm_kernel(x, gamma, beta, eps, out_dtype)
        want = L.layer_norm_reference(x, gamma, beta, eps, out_dtype)
        torch.cuda.synchronize()
        same, gap, diff = _ln_gap(got, want)
        name = f"{what} ({rows} x {c}, {in_dtype} -> {out_dtype})"
        if out_dtype == BF16:
            check(same >= 0.999 and gap <= 1.0, f"layer norm {name}: "
                  f"{100 * same:.4f} % bit-equal, widest {gap:.2f} ulp")
        else:
            check(gap <= 1e-5, f"layer norm {name}: widest |difference| "
                  f"{gap:.3e} of the widest |reference|")
            err = max(err, diff)
        print(f"layer norm {name}: {100 * same:.4f} % bit-equal to "
              f"F.layer_norm + .to, widest {gap:.3e} "
              f"{'ulp' if out_dtype == BF16 else 'of the widest |reference|'}",
              flush=True)
        del x, gamma, beta, got, want
    torch.cuda.empty_cache()

    total = {"kernel": 0.0, "library": 0.0}
    timed = {}
    for what, rows, c, in_dtype, out_dtype, norms in LN_SHAPES:
        x, gamma, beta = _ln_case(rows, c, in_dtype, gd)
        ms, call = kernel_ms(lambda: L.layer_norm_kernel(
            x, gamma, beta, eps, out_dtype), "launches.ln", calls=10)
        lib = cuda_ms(lambda: L.layer_norm_reference(
            x, gamma, beta, eps, out_dtype), iters=10)
        nbytes = rows * c * (x.element_size()
                             + torch.finfo(out_dtype).bits // 8)
        bound = nbytes / H100_BYTES_PER_S * 1e3
        timed[what] = (ms, call, lib, bound)
        total["kernel"] += norms * ms
        total["library"] += norms * lib
        print(f"layer norm {what} ({rows} x {c}, {in_dtype} -> {out_dtype}, "
              f"{norms} a forward): kernel {ms:.4f} ms (per call from "
              f"Python {call:.4f}), bytes bound {bound:.4f} "
              f"({100 * bound / ms:.1f} % of it, {nbytes / ms / 1e6:.0f} "
              f"GB/s of {nbytes / 1e6:.1f} MB); F.layer_norm + .to "
              f"{lib:.4f} ms on {smi}", flush=True)
        del x, gamma, beta
        torch.cuda.empty_cache()
    bound_fwd = ln_bound_per_forward_s(S_BATCH) * 1e3
    print(f"layer norm: a Swin-S forward's 53 norms at {S_BATCH} chips: "
          f"kernel {total['kernel']:.3f} ms, F.layer_norm + .to "
          f"{total['library']:.3f} ms, bytes bound {bound_fwd:.3f} ms "
          f"({100 * bound_fwd / total['kernel']:.1f} % of it)", flush=True)

    limits = json.loads((Path(__file__).resolve().parent / "bench_torch" /
                         "configs" / "swin_s_face112.json").read_text()
                        )["limits"]
    real = vit_module.layer_norm

    @contextlib.contextmanager
    def norms(fn):
        vit_module.layer_norm = fn
        try:
            yield
        finally:
            vit_module.layer_norm = real

    g = torch.Generator().manual_seed(SEED + 23)
    fm = FaceModel(FaceSwin_S(generator=g, device=dev).eval())
    chips = (torch.rand((S_BATCH, 112, 112, 3), generator=g) * 255).to(dev)
    with counting() as made:
        emb = fm.get_feature(chips[:S_FORWARD])
    with norms(L.layer_norm_reference):
        emb_plain = fm.get_feature(chips[:S_FORWARD])
    embed_gap = float(torch.linalg.vector_norm(emb - emb_plain, dim=1).max())
    check(made["launches.ln"] == LN_NORMS["swin"] and
          embed_gap <= limits["embed_gap"], f"layer norm: Swin-S forward "
          f"{made['launches.ln']} launches, embeddings {embed_gap:.3e} from "
          f"the plain norms'")
    launches = made["launches.ln"]

    log_dir = Path(__file__).resolve().parent / "build" / "chip_smoke" / "ln"
    with profiling.trace(str(log_dir)) as prof:
        fm.get_feature(chips)
        torch.cuda.synchronize()
    launches += LN_NORMS["swin"]

    def kernels(evt) -> list:
        own = [k.name for k in getattr(evt, "kernels", ())]
        return own + [x for c in evt.cpu_children for x in kernels(c)]

    spans = [e for e in prof.events()
             if e.name == profiling.SPAN_PREFIX + "ln"
             and e.device_type != torch.autograd.DeviceType.CUDA]
    inside = [x for e in spans for x in kernels(e)]
    ran = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith(profiling.SPAN_PREFIX)),
                 key=lambda e: e.time_range.start)
    after = [b.name for a, b in zip(ran, ran[1:])
             if "layer_norm_kernel" in a.name]
    casts = [x for x in after if "copy" in x]
    counted = json.loads((log_dir / "counters.json").read_text())
    check(len(spans) == LN_NORMS["swin"] and
          counted["launches.ln"] == LN_NORMS["swin"] and
          len(inside) == LN_NORMS["swin"] and
          all("layer_norm_kernel" in x for x in inside) and not casts,
          f"layer norm: {len(spans)} ln spans, kernels inside "
          f"{sorted(set(inside))} ({len(inside)}), casts after a norm "
          f"{sorted(set(casts))}")
    print(f"layer norm: one Swin-S forward ({S_BATCH}), {len(ran)} kernels; "
          f"inside the {len(spans)} alink/ln spans only {len(inside)} "
          f"layer_norm_kernel launches; after them "
          f"{sorted(set(x[:60] for x in after))}, no copy; counters.json "
          f"launches.ln {counted['launches.ln']}", flush=True)

    times = {real: [], L.layer_norm_reference: []}
    for fn in (real, L.layer_norm_reference, L.layer_norm_reference, real):
        with norms(fn):
            times[fn].append(cuda_ms(lambda: fm.get_feature(chips), iters=5,
                                     warmup=2))
    best = min(times[real])
    print("layer norm: Swin-S forward at batch {} ms (per call from Python, "
          "in turns): kernel norms {}, F.layer_norm + .to {}; {:.0f} "
          "chips/s; embeddings {:.3e} from the plain norms' (limit "
          "{:g})".format(S_BATCH, [f"{x:.2f}" for x in times[real]],
                        [f"{x:.2f}" for x in
                         times[L.layer_norm_reference]],
                        S_BATCH / best * 1e3, embed_gap,
                        limits["embed_gap"]), flush=True)
    del fm, chips, emb, emb_plain, prof
    torch.cuda.empty_cache()

    vit = FaceViT_L(generator=g, device=dev).eval()
    faces = (torch.rand((8, 112, 112, 3), generator=g) * 255).to(dev)
    with torch.no_grad(), counting() as made:
        emb = vit(faces)
    with torch.no_grad(), norms(L.layer_norm_reference):
        emb_plain = vit(faces)
    vit_gap = float(torch.linalg.vector_norm(emb - emb_plain, dim=1).max())
    vit_limit = json.loads((Path(__file__).resolve().parent / "bench_torch" /
                            "configs" / "insightface_vitl_mtcnn.json"
                            ).read_text())["limits"]["embed_gap"]
    check(made["launches.ln"] == LN_NORMS["vit"] and vit_gap <= vit_limit,
          f"layer norm: ViT-L forward {made['launches.ln']} launches, "
          f"embeddings {vit_gap:.3e} from the plain norms'")
    launches += made["launches.ln"]
    print(f"layer norm: ViT-L forward (8 faces) {made['launches.ln']} "
          f"launches.ln, embeddings {vit_gap:.3e} from the plain norms'; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    del vit, faces
    torch.cuda.empty_cache()
    # The kernels line: stage 3's block norm, 36 of a forward's 53.
    ms, call, lib, bound = timed["stage 3"]
    return launches, {"err": err, "ms": ms, "call_ms": call,
                      "plain_ms": lib, "bound_ms": bound,
                      "bound_by": "bytes", "library_ms": lib}


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
    ingest_counts = phase_ingest(dev, smi)
    torch.cuda.empty_cache()
    stamp("o")
    numbers["bn_act"] = phase_bn_act(dev, smi)
    torch.cuda.empty_cache()
    vgg_bn_act = phase_bn_act_vgg(dev, smi)
    torch.cuda.empty_cache()
    stamp("p")
    counts["attention"], numbers["attention"] = phase_attention(dev, smi)
    torch.cuda.empty_cache()
    stamp("q")
    retina_counts, numbers["nms"] = phase_retina(dev, smi)
    torch.cuda.empty_cache()
    stamp("r")
    counts["window_attention"], numbers["window_attention"] = phase_swin(
        dev, smi)
    torch.cuda.empty_cache()
    counts["layer_norm"], numbers["layer_norm"] = phase_ln(dev, smi)
    torch.cuda.empty_cache()
    stamp("s")
    # Each kernel's count is the one from the main paths that run it:
    # serving, evaluation, (k)'s score matrix and (l)'s top-1 tail for K1,
    # serving, the augmented loop and (k)'s profiles and L-Net chips for
    # K2, training, the A2 channel, evaluation, the augmented loop,
    # run_alink_mtp, existing_al and ResNet50Classifier's fit for K3, its
    # own op path for K4; (n)'s sharded paths for K1, K2 and K3; (o)'s
    # staging featurize for K3; and (r)'s RetinaFace pipeline for K2, K3,
    # bn_act and the NMS kernel, with its K2 check.
    counts["bottleneck"] = (alink_counts["bottleneck"] + a2_launches
                            + eval_counts["bottleneck"]
                            + resume_counts["bottleneck"]
                            + mtp_counts["bottleneck"]
                            + classify_counts["bottleneck"]
                            + par_counts["bottleneck"]
                            + ingest_counts["bottleneck"]
                            + retina_counts["bottleneck"])
    counts["pair_score"] += (eval_counts["pair_score"]
                             + rest_counts["pair_score"]
                             + mtp_counts["pair_score"]
                             + par_counts["pair_score"])
    # bn_act: the r100 forwards of the serving slice (c), of (k)'s
    # profiles and of (r)'s pipeline call, 149 each, and (p)'s held VGG
    # featurize calls, 10 each.
    counts["bn_act"] += (rest_counts["bn_act"] + retina_counts["bn_act"]
                         + vgg_bn_act)
    counts["affine_warp"] += (resume_counts["affine_warp"]
                              + rest_counts["affine_warp"]
                              + par_counts["affine_warp"]
                              + retina_counts["affine_warp"])
    counts["nms"] = retina_counts["nms"]

    sources = {"pair_score": ("alink_tpu_torch/csrc/pair_score.cu",
                              "alink_tpu/ops/pairwise.py:134"),
               "affine_warp": ("alink_tpu_torch/csrc/affine_warp.cu",
                               "alink_tpu/ops/image.py:230"),
               "bottleneck": ("alink_tpu_torch/csrc/bottleneck.cu",
                              "alink_tpu/ops/resblock.py:72"),
               "qconv": ("alink_tpu_torch/csrc/qconv.cu",
                         "alink_tpu/ops/qconv.py:116"),
               "bn_act": ("alink_tpu_torch/csrc/bn_act.cu",
                          "none: XLA fuses BN and PReLU"),
               "attention": ("alink_tpu_torch/csrc/attention.cu",
                             "none: the JAX package has no ViT"),
               "nms": ("alink_tpu_torch/csrc/nms.cu",
                       "none: alink_tpu/ops/nms.py is array arithmetic"),
               "window_attention": ("alink_tpu_torch/csrc/attention.cu",
                                    "none: the JAX package has no Swin"),
               "layer_norm": ("alink_tpu_torch/csrc/layer_norm.cu",
                              "none: the JAX package has no transformer")}
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
