"""Fixed-budget masked non-max suppression.

Counterpart of ``alink_tpu/ops/nms.py``.  The keep-mask equals greedy NMS
(candidates visited by descending score, ties to the lower index; a box is
suppressed when its overlap with a kept earlier box is strictly above the
threshold; inclusive-pixel areas; ``mode="min"`` divides by the smaller
area).  One implementation serves every budget: the JAX package's blocked
path for K >= 256 is a TPU scheduling choice with the same result.
"""

from __future__ import annotations

import torch

from alink_tpu_torch.utils.profiling import count, span


def iou_matrix(boxes: torch.Tensor, mode: str = "union") -> torch.Tensor:
    """Pairwise overlap of (..., K, 4) boxes -> (..., K, K)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (torch.clamp(xx2 - xx1 + 1.0, min=0.0)
             * torch.clamp(yy2 - yy1 + 1.0, min=0.0))
    if mode == "min":
        denom = torch.minimum(area[..., :, None], area[..., None, :])
    else:
        denom = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(denom, min=1e-12)


@torch.no_grad()
def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
        threshold: float, mode: str = "union") -> torch.Tensor:
    """Greedy NMS keep-mask over (..., K) candidates, aligned with the input.

    ``dom[j, i]`` says that a live candidate j comes before i in the visit
    order, (score_j, -j) > (score_i, -i), and overlaps it past the
    threshold.  The greedy keep-mask is the fixed point of
    ``keep = valid & ~any_j(dom[j, i] & keep[j])`` iterated from
    ``keep = valid``: after t sweeps every candidate whose chain of
    dominators is at most t long holds its greedy value, so the loop ends
    after (longest chain + 1) sweeps, at most K + 1.  Each sweep ends in a
    host sync (``torch.equal``); the ``nms.sweeps`` counter counts them.
    """
    with span("nms"):
        k = boxes.shape[-2]
        overlap = iou_matrix(boxes, mode=mode)
        idx = torch.arange(k, device=boxes.device)
        s_j, s_i = scores[..., :, None], scores[..., None, :]
        higher = (s_j > s_i) | ((s_j == s_i) & (idx[:, None] < idx[None, :]))
        dom = (overlap > threshold) & higher & valid[..., :, None]
        keep = valid
        for sweeps in range(1, k + 2):
            new = valid & ~torch.any(dom & keep[..., :, None], dim=-2)
            if torch.equal(new, keep):
                break
            keep = new
        count("nms.calls")
        count("nms.sweeps", sweeps)
        return keep


def nms_batch(boxes, scores, valid, threshold, mode="union") -> torch.Tensor:
    """``nms`` over a leading batch axis (``nms`` takes any leading dims)."""
    return nms(boxes, scores, valid, threshold, mode=mode)
