"""Fixed-budget MTCNN cascade + 5-landmark alignment.

Counterpart of ``alink_tpu/detect/cascade.py``.  Every stage carries a
fixed candidate budget and a validity mask, so shapes never depend on the
data; the batch dimension is written out (the JAX package vmaps a
per-image function).  Stages, per image:

1. pyramid + P-Net: scales ``12/min_size * factor^i`` while the scaled short
   side stays above 12; per level the top cells above threshold[0] decode
   to boxes, NMS 0.5 per level, then global NMS 0.7, first-stage
   regression and squaring;
2. R-Net on 24x24 crops: threshold[1], NMS 0.7, calibration, squaring;
3. O-Net on 48x48 crops: threshold[2], landmarks from the pre-calibration
   squares, calibration, NMS 0.7 "min";
4. alignment: Umeyama similarity to the ArcFace template, then the batched
   affine warp (the CUDA kernel on the card).

Crops are f32 in this port: the JAX package's ``crop_dtype="auto"`` means
bf16 only on a TPU.  The JAX package's ``optimization_barrier`` fences are
TPU scheduling knobs and are dropped.  Not ported yet: the crowd profile
(pooled budgets, ``crop_and_resize_gather``), ``detect_faces_limited``,
``profile_cascade`` and the L-Net landmark refinement.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from alink_tpu_torch.models import preprocess
from alink_tpu_torch.models.mtcnn import ONet, PNet, RNet
from alink_tpu_torch.ops.boxes import (calibrate_box, clip_to_image,
                                       convert_to_square, generate_bbox,
                                       refine_with_reg, select_topk)
from alink_tpu_torch.ops.image import affine_warp_batch, crop_and_resize, resize
from alink_tpu_torch.ops.nms import nms, nms_batch
from alink_tpu_torch.ops.umeyama import arcface_template, umeyama


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Cascade knobs; ``typical()`` for few-face imagery, ``worst_case()``
    for the lossless dense-scene budgets.  The JAX config's
    ``accurate_landmark`` (L-Net), ``crop_dtype`` and crowd totals are not
    ported yet (crops are f32)."""

    min_size: int = 20
    factor: float = 0.709
    thresholds: tuple[float, float, float] = (0.6, 0.7, 0.8)
    stage1_scale_budget: int = 128   # candidates decoded per pyramid level
    stage1_budget: int = 256         # after global NMS
    stage2_budget: int = 128
    stage3_budget: int = 64
    output_size: tuple[int, int] = (112, 112)

    @staticmethod
    def typical(**overrides) -> "CascadeConfig":
        kw = dict(min_size=40, stage1_scale_budget=32, stage1_budget=32,
                  stage2_budget=8, stage3_budget=4)
        kw.update(overrides)
        return CascadeConfig(**kw)

    @staticmethod
    def worst_case(**overrides) -> "CascadeConfig":
        kw = dict(stage1_scale_budget=128, stage1_budget=256,
                  stage2_budget=128, stage3_budget=64)
        kw.update(overrides)
        return CascadeConfig(**kw)


class MTCNNParams(NamedTuple):
    """The cascade's three towers (each carries its own weights)."""

    pnet: nn.Module
    rnet: nn.Module
    onet: nn.Module


class Detections(NamedTuple):
    """Padded per-image detections."""

    boxes: torch.Tensor      # (N, K, 4) [x1, y1, x2, y2]
    scores: torch.Tensor     # (N, K)
    landmarks: torch.Tensor  # (N, K, 5, 2) in (x, y)
    valid: torch.Tensor      # (N, K) bool


# MTCNN mean-face template in box-relative coordinates (x1..x5, y1..y5): a
# trained O-Net predicts landmarks near this prior.
_MEAN_FACE = (0.224152, 0.75610125, 0.490127, 0.254149, 0.726104,
              0.2119465, 0.2119465, 0.628106, 0.780233, 0.780233)


def init_cascade_params(generator: torch.Generator | None = None,
                        dtype: torch.dtype = torch.bfloat16,
                        device=None) -> MTCNNParams:
    """Random-init towers, with the O-Net landmark head seeded at the
    mean-face prior (kernel x 0.01, bias = the prior): an unseeded random
    head sends every alignment warp to degenerate geometry."""
    pnet = PNet(dtype, generator, device)
    rnet = RNet(dtype, generator, device)
    onet = ONet(dtype, generator, device)
    with torch.no_grad():
        lmk = onet.dense[3]
        lmk.weight.mul_(0.01)
        lmk.bias.copy_(torch.tensor(_MEAN_FACE))
    return MTCNNParams(pnet.eval(), rnet.eval(), onet.eval())


def pyramid_scales(h: int, w: int, min_size: int, factor: float
                   ) -> list[float]:
    """Scales 12/min_size * factor^i while the scaled short side > 12."""
    m = min(h, w) * (12.0 / min_size)
    scale = 12.0 / min_size
    scales = []
    while m > 12.0:
        scales.append(scale)
        scale *= factor
        m *= factor
    return scales


def _stage1(params: MTCNNParams, images: torch.Tensor, cfg: CascadeConfig):
    """Pyramid P-Net pass over (N, H, W, 3) -> (boxes, scores, valid),
    each (N, stage1_budget, ...)."""
    n, h, w = images.shape[:3]
    dev = images.device
    boxes_l, scores_l, regs_l, valid_l = [], [], [], []
    for scale in pyramid_scales(h, w, cfg.min_size, cfg.factor):
        sh, sw = int(math.ceil(h * scale)), int(math.ceil(w * scale))
        if sh < 12 or sw < 12:
            continue
        prob, reg = params.pnet(preprocess.mtcnn(resize(images, (sh, sw))))
        b, s, r, v = generate_bbox(prob[..., 1], reg, scale,
                                   cfg.thresholds[0], cfg.stage1_scale_budget)
        boxes_l.append(b)
        scores_l.append(s)
        regs_l.append(r)
        valid_l.append(v)
    k = cfg.stage1_budget
    if not boxes_l:  # empty pyramid: no detections
        return (torch.zeros((n, k, 4), device=dev),
                torch.zeros((n, k), device=dev),
                torch.zeros((n, k), dtype=torch.bool, device=dev))
    # Per-level NMS 0.5, every level at once (levels share one budget).
    stacked_valid = torch.stack(valid_l, dim=1)             # (N, S, Kb)
    keep = nms_batch(torch.stack(boxes_l, dim=1),
                     torch.stack(scores_l, dim=1), stacked_valid, 0.5)
    boxes = torch.cat(boxes_l, dim=1)
    scores = torch.cat(scores_l, dim=1)
    regs = torch.cat(regs_l, dim=1)
    valid = (stacked_valid & keep).reshape(n, -1)
    valid = valid & nms(boxes, scores, valid, 0.7)          # global NMS
    boxes = torch.round(convert_to_square(refine_with_reg(boxes, regs)))
    return select_topk(boxes, scores, valid, k)


def _stage2_tail(boxes, scores, valid, reg, cfg: CascadeConfig):
    """Threshold, NMS, calibrate, square (``boxes`` are clipped squares,
    ``scores`` R-Net's face probabilities)."""
    valid = valid & (scores > cfg.thresholds[1])
    valid = valid & nms(boxes, scores, valid, 0.7)
    boxes = torch.round(convert_to_square(calibrate_box(boxes, reg)))
    return select_topk(boxes, scores, valid, cfg.stage2_budget)


def _crops(images, boxes, size):
    """Tower input crops (N*K, s, s, 3), mtcnn centering folded in f32."""
    crops = crop_and_resize(images, boxes, size, offset=127.5,
                            scale=0.0078125)
    return crops.reshape((-1,) + crops.shape[2:])


def _stage2(params: MTCNNParams, images, boxes, valid, cfg: CascadeConfig):
    n, k = boxes.shape[:2]
    # Crops keep the unclipped extent; everything after sees clipped boxes.
    crops = _crops(images, boxes, (24, 24))
    boxes = clip_to_image(boxes, images.shape[2], images.shape[1])
    prob, reg = params.rnet(crops)
    return _stage2_tail(boxes, prob[:, 1].reshape(n, k), valid,
                        reg.reshape(n, k, 4), cfg)


def _stage3_tail(boxes, scores, valid, reg, lmk, cfg: CascadeConfig):
    """Threshold, landmarks from the pre-calibration squares, calibrate,
    Min-mode NMS, budget."""
    valid = valid & (scores > cfg.thresholds[2])
    bw = (boxes[..., 2] - boxes[..., 0] + 1.0)[..., None]
    bh = (boxes[..., 3] - boxes[..., 1] + 1.0)[..., None]
    lx = boxes[..., 0:1] + lmk[..., 0:5] * bw
    ly = boxes[..., 1:2] + lmk[..., 5:10] * bh
    landmarks = torch.stack([lx, ly], dim=-1)               # (..., K, 5, 2)
    boxes = calibrate_box(boxes, reg)
    valid = valid & nms(boxes, scores, valid, 0.7, mode="min")
    return select_topk(boxes, scores, valid, cfg.stage3_budget, landmarks)


def _stage3(params: MTCNNParams, images, boxes, valid, cfg: CascadeConfig):
    n, k = boxes.shape[:2]
    crops = _crops(images, boxes, (48, 48))
    boxes = clip_to_image(boxes, images.shape[2], images.shape[1])
    prob, reg, lmk = params.onet(crops)
    return _stage3_tail(boxes, prob[:, 1].reshape(n, k), valid,
                        reg.reshape(n, k, 4), lmk.reshape(n, k, 10), cfg)


@torch.no_grad()
def detect_faces(params: MTCNNParams, images: torch.Tensor,
                 cfg: CascadeConfig = CascadeConfig()) -> Detections:
    """Run the cascade over an (N, H, W, 3) raw-RGB batch."""
    b, _, v = _stage1(params, images, cfg)
    b, _, v = _stage2(params, images, b, v, cfg)
    b, s, v, lmk = _stage3(params, images, b, v, cfg)
    return Detections(boxes=b, scores=s, landmarks=lmk, valid=v)


def alignment_transforms(landmarks: torch.Tensor,
                         output_size: tuple[int, int] = (112, 112)
                         ) -> torch.Tensor:
    """(..., 5, 2) landmarks -> (..., 2, 3) similarity transforms onto the
    ArcFace template."""
    return umeyama(landmarks.float(),
                   arcface_template(output_size, landmarks.device))


@torch.no_grad()
def align_faces(images: torch.Tensor, landmarks: torch.Tensor,
                output_size: tuple[int, int] = (112, 112)) -> torch.Tensor:
    """Warp each face onto the ArcFace template: ``images`` (N, H, W, 3),
    ``landmarks`` (N, K, 5, 2) -> chips (N, K, oh, ow, 3)."""
    n, k = landmarks.shape[:2]
    Ms = alignment_transforms(landmarks, output_size).reshape(n * k, 2, 3)
    imgs = images[:, None].expand((n, k) + images.shape[1:]).reshape(
        (n * k,) + images.shape[1:])
    chips = affine_warp_batch(imgs, Ms, output_size)
    return chips.reshape((n, k) + chips.shape[1:])
