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
4. with ``accurate_landmark``, L-Net refines each landmark on a patch
   around it;
5. alignment: Umeyama similarity to the ArcFace template, then the batched
   affine warp (the CUDA kernel on the card).

The ``crowd()`` profile pools the stage-2/3 budgets across the batch
(``_detect_faces_crowd``); ``detect_faces_limited`` starts at R-Net from
given boxes; ``profile_cascade`` counts candidates for
``tools/calibrate_budgets.py``.  ``crop_dtype="auto"`` means f32 crops
here: bf16 is the JAX package's choice on a TPU only.  The JAX package's
``optimization_barrier`` fences are TPU scheduling knobs and are dropped.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from alink_tpu_torch.models import preprocess
from alink_tpu_torch.models.mtcnn import LNet, ONet, PNet, RNet
from alink_tpu_torch.ops.boxes import (calibrate_box, clip_to_image,
                                       convert_to_square, generate_bbox,
                                       refine_with_reg, select_topk)
from alink_tpu_torch.ops.image import (affine_warp_batch, crop_and_resize,
                                      crop_and_resize_gather, resize)
from alink_tpu_torch.ops.nms import nms, nms_batch
from alink_tpu_torch.ops.umeyama import arcface_template, umeyama
from alink_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Cascade knobs; ``typical()`` for few-face imagery, ``worst_case()``
    for the lossless dense-scene budgets, ``crowd()`` for budgets pooled
    across the batch (lossy by contract).

    ``crop_dtype``: the stage-2/3 crops' dtype, "auto" or "float32" for
    f32 (``"auto"`` is bf16 on a TPU in the JAX package), "bfloat16" for
    bf16 crops.  ``stage2_total``/``stage3_total``: 0 keeps per-image
    budgets; nonzero pools that many candidates across the batch.
    """

    min_size: int = 20
    factor: float = 0.709
    thresholds: tuple[float, float, float] = (0.6, 0.7, 0.8)
    stage1_scale_budget: int = 128   # candidates decoded per pyramid level
    stage1_budget: int = 256         # after global NMS
    stage2_budget: int = 128
    stage3_budget: int = 64
    accurate_landmark: bool = False
    output_size: tuple[int, int] = (112, 112)
    crop_dtype: str = "auto"
    stage2_total: int = 0
    stage3_total: int = 0

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

    @staticmethod
    def crowd(**overrides) -> "CascadeConfig":
        """``worst_case`` budgets per image, with stages 2 and 3 run on the
        top ``stage2_total``/``stage3_total`` candidates by score pooled
        across the batch.  Lossy by contract: a batch over a pooled budget
        drops its globally lowest-scoring candidates, and each image keeps
        at most its per-image cap.  Within budget it equals the lossless
        path.  The defaults price the pools at 1/4 and 1/2 of
        ``worst_case``'s totals for a 64-image batch."""
        kw = dict(stage1_scale_budget=128, stage1_budget=256,
                  stage2_budget=128, stage3_budget=64,
                  stage2_total=4096, stage3_total=4096)
        kw.update(overrides)
        return CascadeConfig(**kw)


class MTCNNParams(NamedTuple):
    """The cascade's towers (each carries its own weights); ``lnet`` only
    for ``accurate_landmark``."""

    pnet: nn.Module
    rnet: nn.Module
    onet: nn.Module
    lnet: nn.Module | None = None


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
                        device=None, with_lnet: bool = True) -> MTCNNParams:
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
    lnet = LNet(dtype, generator, device).eval() if with_lnet else None
    return MTCNNParams(pnet.eval(), rnet.eval(), onet.eval(), lnet)


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
    with span("detect.stage1_select"):
        # Per-level NMS 0.5, every level at once (levels share one budget).
        stacked_valid = torch.stack(valid_l, dim=1)         # (N, S, Kb)
        keep = nms_batch(torch.stack(boxes_l, dim=1),
                         torch.stack(scores_l, dim=1), stacked_valid, 0.5)
        boxes = torch.cat(boxes_l, dim=1)
        scores = torch.cat(scores_l, dim=1)
        regs = torch.cat(regs_l, dim=1)
        valid = (stacked_valid & keep).reshape(n, -1)
        valid = valid & nms(boxes, scores, valid, 0.7)      # global NMS
        boxes = torch.round(convert_to_square(refine_with_reg(boxes, regs)))
        return select_topk(boxes, scores, valid, k)


def _stage2_tail(boxes, scores, valid, reg, cfg: CascadeConfig):
    """Threshold, NMS, calibrate, square (``boxes`` are clipped squares,
    ``scores`` R-Net's face probabilities)."""
    valid = valid & (scores > cfg.thresholds[1])
    valid = valid & nms(boxes, scores, valid, 0.7)
    boxes = torch.round(convert_to_square(calibrate_box(boxes, reg)))
    return select_topk(boxes, scores, valid, cfg.stage2_budget)


def _crop_dtype(cfg: CascadeConfig) -> torch.dtype | None:
    """The stage-2/3 crops' dtype; None is f32."""
    if cfg.crop_dtype in ("auto", "float32", "none"):
        return None
    dtype = getattr(torch, cfg.crop_dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown crop_dtype {cfg.crop_dtype!r}")
    return dtype


# The tower inputs' mtcnn centering, folded into the crops' f32 result.
_FOLD = dict(offset=127.5, scale=0.0078125)


def _crops(images, boxes, size, cfg: CascadeConfig):
    """Tower input crops (N*K, s, s, 3) in the crop dtype."""
    cdt = _crop_dtype(cfg)
    crops = crop_and_resize(images, boxes, size, compute_dtype=cdt,
                            out_dtype=cdt, **_FOLD)
    return crops.reshape((-1,) + crops.shape[2:])


def _stage2(params: MTCNNParams, images, boxes, valid, cfg: CascadeConfig):
    n, k = boxes.shape[:2]
    with span("detect.stage2"):
        # Crops keep the unclipped extent; everything after sees clipped
        # boxes.
        crops = _crops(images, boxes, (24, 24), cfg)
        boxes = clip_to_image(boxes, images.shape[2], images.shape[1])
        prob, reg = params.rnet(crops)
        return _stage2_tail(boxes, prob[:, 1].reshape(n, k), valid,
                            reg.reshape(n, k, 4), cfg)


def _stage3_tail(boxes, scores, valid, reg, lmk, cfg: CascadeConfig):
    """Threshold, landmarks from the pre-calibration squares, calibrate,
    Min-mode NMS, budget."""
    with span("detect.stage3_select"):
        valid = valid & (scores > cfg.thresholds[2])
        bw = (boxes[..., 2] - boxes[..., 0] + 1.0)[..., None]
        bh = (boxes[..., 3] - boxes[..., 1] + 1.0)[..., None]
        lx = boxes[..., 0:1] + lmk[..., 0:5] * bw
        ly = boxes[..., 1:2] + lmk[..., 5:10] * bh
        landmarks = torch.stack([lx, ly], dim=-1)           # (..., K, 5, 2)
        boxes = calibrate_box(boxes, reg)
        valid = valid & nms(boxes, scores, valid, 0.7, mode="min")
        return select_topk(boxes, scores, valid, cfg.stage3_budget,
                           landmarks)


def _stage3(params: MTCNNParams, images, boxes, valid, cfg: CascadeConfig):
    n, k = boxes.shape[:2]
    crops = _crops(images, boxes, (48, 48), cfg)
    boxes = clip_to_image(boxes, images.shape[2], images.shape[1])
    prob, reg, lmk = params.onet(crops)
    return _stage3_tail(boxes, prob[:, 1].reshape(n, k), valid,
                        reg.reshape(n, k, 4), lmk.reshape(n, k, 10), cfg)


def _pool_by_score(scores_flat, valid_flat, n: int, k: int, total: int):
    """The top ``total`` of the flat (n*k) candidates by score ->
    (flat_idx, img_id, valid), each (total,), sorted by (image, -score);
    invalid slots last, with ``img_id`` n.  A stable descending sort is
    ``lax.top_k``'s order (ties to the lower index), and a stable sort on
    the image id keeps the score order within each image."""
    masked = torch.where(valid_flat, scores_flat, float("-inf"))
    top, idx = torch.sort(masked, descending=True, stable=True)
    top, idx = top[:total], idx[:total]
    tvalid = top > float("-inf")
    img_id = torch.where(tvalid, torch.div(idx, k, rounding_mode="floor"), n)
    order = torch.argsort(img_id, stable=True)
    return idx[order], img_id[order], tvalid[order]


def _scatter_per_image(img_id, tvalid, n: int, cap: int, *arrays):
    """Pooled candidates, sorted by (image, -score) with ``img_id`` in
    [0, n] (n: invalid), back into per-image slots: each image's valid
    candidates fill slots 0..cap-1 in score order and the rest are dropped.
    Returns (arrays as (n, cap, ...), valid mask (n, cap)).

    Dropped candidates write to an overflow column ``cap`` (duplicate
    writes there, never summed) that is sliced away."""
    cumv = torch.cumsum(tvalid.long(), 0)
    padded = torch.cat([cumv.new_zeros(1), cumv])
    first = torch.searchsorted(img_id, torch.arange(n, device=img_id.device))
    iid = img_id.clamp(0, n - 1)
    slot = cumv - 1 - padded[first][iid]    # rank among the image's valid
    keep = tvalid & (slot < cap) & (img_id < n)
    sl = torch.where(keep, slot, cap)
    outs = []
    for a in arrays:
        o = a.new_zeros((n, cap + 1) + a.shape[1:])
        o.index_put_((iid, sl), a)
        outs.append(o[:, :cap])
    vmask = keep.new_zeros((n, cap + 1))
    vmask.index_put_((iid, sl), keep)
    return tuple(outs), vmask[:, :cap]


def _pooled_tower(net: nn.Module, images, boxes, img_ids, size,
                  cfg: CascadeConfig):
    """One tower pass over the pooled candidates' crops."""
    cdt = _crop_dtype(cfg)
    return net(crop_and_resize_gather(images, boxes, img_ids, size,
                                      compute_dtype=cdt, out_dtype=cdt,
                                      **_FOLD))


def _detect_faces_crowd(params: MTCNNParams, images, cfg: CascadeConfig):
    """Stage 1 per image, stages 2 and 3 on the candidates pooled by score
    across the batch (one crop and tower pass each), scattered back to
    per-image slots for the per-image tails (boxes of different images
    never suppress each other)."""
    n, h, w = images.shape[:3]
    b1, s1, v1 = _stage1(params, images, cfg)

    k1 = b1.shape[1]
    t2 = min(cfg.stage2_total or n * k1, n * k1)
    with span("detect.stage2"):
        idx2, iid2, tv2 = _pool_by_score(s1.reshape(-1), v1.reshape(-1), n,
                                         k1, t2)
        bx2 = b1.reshape(-1, 4)[idx2]
        prob2, reg2 = _pooled_tower(params.rnet, images, bx2, iid2, (24, 24),
                                    cfg)
        bx2 = clip_to_image(bx2, w, h)
        sc2 = prob2[:, 1]
        tv2 = tv2 & (sc2 > cfg.thresholds[1])
        # Scatter cap stage1_budget, the lossless path's width before NMS:
        # stage2_budget applies after NMS, in the tail.
        (sb, ss, sr), sv = _scatter_per_image(iid2, tv2, n,
                                              cfg.stage1_budget, bx2, sc2,
                                              reg2)
        b2, s2, v2 = _stage2_tail(sb, ss, sv, sr, cfg)

    k2 = b2.shape[1]
    t3 = min(cfg.stage3_total or n * k2, n * k2)
    idx3, iid3, tv3 = _pool_by_score(s2.reshape(-1), v2.reshape(-1), n, k2,
                                     t3)
    bx3 = b2.reshape(-1, 4)[idx3]
    prob3, reg3, lmk3 = _pooled_tower(params.onet, images, bx3, iid3,
                                      (48, 48), cfg)
    bx3 = clip_to_image(bx3, w, h)
    sc3 = prob3[:, 1]
    tv3 = tv3 & (sc3 > cfg.thresholds[2])
    (tb, ts, tr, tl), tv = _scatter_per_image(iid3, tv3, n, cfg.stage2_budget,
                                              bx3, sc3, reg3, lmk3)
    return _stage3_tail(tb, ts, tv, tr, tl, cfg)


def _refine_landmarks(params: MTCNNParams, images, boxes, landmarks):
    """L-Net refinement of (N, K, 5, 2) landmarks.

    Around each landmark a patch of side ``round(max(w, h) / 4)`` (made
    even) is cropped and resized to 24x24; the five patches stack on the
    channel axis.  L-Net's (dx, dy) in [0, 1] patch coordinates replace
    the landmark, and a row that moves either coordinate more than 0.35
    from the centre is reset whole to the centre.  The result truncates
    toward zero, kept in float.
    """
    n, k = boxes.shape[:2]
    patchw = torch.maximum(boxes[..., 2] - boxes[..., 0] + 1.0,
                           boxes[..., 3] - boxes[..., 1] + 1.0)
    patchw = torch.round(patchw * 0.25)
    patchw = torch.where(patchw % 2 == 1, patchw + 1, patchw)[..., None]
    x0 = torch.round(landmarks[..., 0] - 0.5 * patchw)        # (N, K, 5)
    y0 = torch.round(landmarks[..., 1] - 0.5 * patchw)
    patch_boxes = torch.stack([x0, y0, x0 + patchw - 1.0, y0 + patchw - 1.0],
                              dim=-1)
    crops = crop_and_resize(images, patch_boxes.reshape(n, k * 5, 4),
                            (24, 24))
    # (N, K*5, 24, 24, 3) -> (N*K, 24, 24, 15), patch-major channels.
    stacked = crops.reshape(n, k, 5, 24, 24, 3).permute(0, 1, 3, 4, 2, 5)
    stacked = stacked.reshape(n * k, 24, 24, 15)
    offsets = params.lnet(preprocess.mtcnn(stacked)).reshape(n, k, 5, 2)
    bad = torch.any(torch.abs(offsets - 0.5) > 0.35, dim=-1, keepdim=True)
    offsets = torch.where(bad, 0.5, offsets)
    rx = x0 + offsets[..., 0] * patchw
    ry = y0 + offsets[..., 1] * patchw
    return torch.trunc(torch.stack([rx, ry], dim=-1))


def _check_lnet(params: MTCNNParams, cfg: CascadeConfig) -> None:
    if cfg.accurate_landmark and params.lnet is None:
        raise ValueError("accurate_landmark requires lnet params")


def _finish(params, images, boxes, scores, valid, landmarks,
            cfg: CascadeConfig) -> Detections:
    if cfg.accurate_landmark:
        landmarks = _refine_landmarks(params, images, boxes, landmarks)
    return Detections(boxes=boxes, scores=scores, landmarks=landmarks,
                      valid=valid)


@torch.no_grad()
def detect_faces(params: MTCNNParams, images: torch.Tensor,
                 cfg: CascadeConfig = CascadeConfig()) -> Detections:
    """Run the cascade over an (N, H, W, 3) raw-RGB batch.

    Spans: ``detect`` around it; inside, ``detect.stage1_select`` (the
    NMS, squaring and top-k after the pyramid), ``detect.stage2`` (crops,
    R-Net, its tail) and ``detect.stage3_select`` (the tail after O-Net).
    None encloses the pyramid or a tower call alone."""
    _check_lnet(params, cfg)
    with span("detect"):
        if cfg.stage2_total or cfg.stage3_total:
            return _finish(params, images,
                           *_detect_faces_crowd(params, images, cfg), cfg)
        b, _, v = _stage1(params, images, cfg)
        b, _, v = _stage2(params, images, b, v, cfg)
        return _finish(params, images, *_stage3(params, images, b, v, cfg),
                       cfg)


@torch.no_grad()
def detect_faces_limited(params: MTCNNParams, images: torch.Tensor,
                         boxes: torch.Tensor, valid: torch.Tensor,
                         cfg: CascadeConfig = CascadeConfig()) -> Detections:
    """Refine known candidate boxes (N, K, 4) with validity (N, K), without
    the P-Net pyramid: the cascade starts at R-Net, which crops the given
    boxes as they are (no squaring first), and refines landmarks under
    ``accurate_landmark`` as the full cascade does."""
    _check_lnet(params, cfg)
    b, _, v = _stage2(params, images, boxes, valid, cfg)
    return _finish(params, images, *_stage3(params, images, b, v, cfg), cfg)


@torch.no_grad()
def profile_cascade(params: MTCNNParams, images: torch.Tensor,
                    cfg: CascadeConfig = CascadeConfig()
                    ) -> dict[str, torch.Tensor]:
    """Per-image candidate counts at each cascade point, (N,) each:

    - ``scale_raw_max``: the largest count of P-Net cells above
      threshold[0] on one pyramid level, read off the probability maps, so
      exact whatever ``stage1_scale_budget`` is;
    - ``stage1``/``stage2``/``stage3``: survivors of each stage under
      ``cfg``'s budgets (a count at its budget may have been truncated).

    The raw counts run the P-Net pyramid a second time (an offline tool).
    """
    n, h, w = images.shape[:3]
    raw = []
    for scale in pyramid_scales(h, w, cfg.min_size, cfg.factor):
        sh, sw = int(math.ceil(h * scale)), int(math.ceil(w * scale))
        if sh < 12 or sw < 12:
            continue
        prob, _ = params.pnet(preprocess.mtcnn(resize(images, (sh, sw))))
        raw.append(torch.sum(prob[..., 1] > cfg.thresholds[0], dim=(1, 2)))
    scale_raw_max = (torch.stack(raw).amax(0) if raw else
                     torch.zeros(n, dtype=torch.long, device=images.device))
    b, _, v1 = _stage1(params, images, cfg)
    b, _, v2 = _stage2(params, images, b, v1, cfg)
    v3 = _stage3(params, images, b, v2, cfg)[2]
    return {"scale_raw_max": scale_raw_max, "stage1": v1.sum(1),
            "stage2": v2.sum(1), "stage3": v3.sum(1)}


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
