"""MTCNN box arithmetic over fixed candidate budgets.

Counterpart of ``alink_tpu/ops/boxes.py``.  Every function takes optional
leading batch dims: boxes (..., K, 4), scores and masks (..., K).
"""

from __future__ import annotations

import torch

STRIDE = 2     # P-Net output stride
CELLSIZE = 12  # P-Net receptive cell


def _sort_desc(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Descending sort along the last axis, ties to the lower index — the
    order of ``lax.top_k``, which ``torch.topk`` does not promise."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., K, *rest)[idx (..., k)] along the candidate axis."""
    rest = x.shape[idx.dim():]
    full = idx.reshape(idx.shape + (1,) * len(rest)).expand(idx.shape + rest)
    return torch.gather(x, idx.dim() - 1, full)


def generate_bbox(prob_map: torch.Tensor, reg_map: torch.Tensor,
                  scale: float, threshold: float, budget: int):
    """Decode P-Net outputs into a fixed budget of candidate boxes.

    ``prob_map`` (..., h, w) face probabilities, ``reg_map`` (..., h, w, 4).
    Keeps the ``budget`` top-scoring cells; a cell's box is
    ``round((STRIDE * index + 1 [+ CELLSIZE]) / scale)``.  Returns boxes
    (..., budget, 4), scores (zero where invalid), regs and valid.
    """
    h, w = prob_map.shape[-2:]
    flat = prob_map.flatten(-2)
    k = min(budget, h * w)
    scores, idx = _sort_desc(flat)
    scores, idx = scores[..., :k], idx[..., :k]
    if k < budget:
        pad = budget - k
        scores = torch.cat([scores, scores.new_full(
            scores.shape[:-1] + (pad,), float("-inf"))], dim=-1)
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-1] + (pad,))], dim=-1)
    rows = torch.div(idx, w, rounding_mode="floor").float()
    cols = (idx % w).float()
    valid = scores > threshold
    x1 = torch.round((STRIDE * cols + 1) / scale)
    y1 = torch.round((STRIDE * rows + 1) / scale)
    x2 = torch.round((STRIDE * cols + 1 + CELLSIZE) / scale)
    y2 = torch.round((STRIDE * rows + 1 + CELLSIZE) / scale)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    regs = _take(reg_map.flatten(-3, -2), idx)
    return boxes, torch.where(valid, scores, 0.0), regs, valid


def calibrate_box(boxes: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """Regression offsets scaled by box size (also the stage-1 refine)."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return boxes + torch.stack([w, h, w, h], dim=-1) * reg


def convert_to_square(boxes: torch.Tensor) -> torch.Tensor:
    """Expand boxes to squares about their centres."""
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    side = torch.maximum(h, w)
    x1 = boxes[..., 0] + w * 0.5 - side * 0.5
    y1 = boxes[..., 1] + h * 0.5 - side * 0.5
    return torch.stack([x1, y1, x1 + side - 1.0, y1 + side - 1.0], dim=-1)


def clip_to_image(boxes: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """Clamp box corners to the image (the reference pad()'s in-place clip
    that every later stage sees)."""
    return torch.stack([
        torch.clamp(boxes[..., 0], min=0.0),
        torch.clamp(boxes[..., 1], min=0.0),
        torch.clamp(boxes[..., 2], max=w - 1.0),
        torch.clamp(boxes[..., 3], max=h - 1.0),
    ], dim=-1)


def refine_with_reg(boxes: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """First-stage refinement: the same arithmetic as ``calibrate_box``."""
    return calibrate_box(boxes, reg)


def select_topk(boxes: torch.Tensor, scores: torch.Tensor,
                valid: torch.Tensor, budget: int, *extras: torch.Tensor):
    """Compact a masked candidate set into a fixed budget by score; a
    budget larger than the candidate count pads with invalid slots.
    Returns (boxes, scores (zero where invalid), valid, *extras)."""
    neg = torch.finfo(scores.dtype).min
    k = scores.shape[-1]
    if budget > k:
        pad = budget - k
        lead = scores.shape[:-1]

        def padded(x, fill):
            return torch.cat([x, x.new_full(lead + (pad,) + x.shape[len(lead) + 1:],
                                            fill)], dim=len(lead))

        boxes, scores = padded(boxes, 0.0), padded(scores, neg)
        valid = padded(valid, False)
        extras = tuple(padded(e, 0) for e in extras)
    top, idx = _sort_desc(torch.where(valid, scores, neg))
    top, idx = top[..., :budget], idx[..., :budget]
    new_valid = top > neg
    return (_take(boxes, idx), torch.where(new_valid, top, 0.0), new_valid) + \
        tuple(_take(e, idx) for e in extras)
