"""Fixed-budget masked non-max suppression.

Counterpart of ``alink_tpu/ops/nms.py``.  The keep-mask equals greedy NMS
(candidates visited by descending score, ties to the lower index; a box is
suppressed when its overlap with a kept earlier box is strictly above the
threshold; inclusive-pixel areas; ``mode="min"`` divides by the smaller
area).  ``nms`` serves the cascade's budgets: the JAX package's blocked
path for K >= 256 is a TPU scheduling choice with the same result.

``nms_kernel`` gives ``nms``'s union-mode keep-mask for any K without a
K x K array, on candidates already in visit order (as
``ops.boxes.select_topk`` returns them): ``csrc/nms.cu`` writes one bit a
pair (the overlap above the threshold) in 64-candidate words and sweeps
them greedily on the device, one block a photo, with no host sync.
"""

from __future__ import annotations

import torch

from alink_tpu_torch import _build
from alink_tpu_torch.utils.profiling import count, span

WORD = 64        # candidates a mask word of csrc/nms.cu covers


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


def _launch(boxes: torch.Tensor, valid: torch.Tensor,
            threshold: float) -> torch.Tensor:
    """The CUDA implementation of the ``alink_tpu_torch::nms`` op: the mask
    scratch (n x k x ceil(k / 64) words) and the keep flags allocated here,
    ``alink_nms`` launched on the current stream."""
    n, k = valid.shape
    keep = torch.empty((n, k), dtype=torch.bool, device=valid.device)
    mask = torch.empty((n, k, -(-k // WORD)), dtype=torch.int64,
                       device=valid.device)
    _build.launch("alink_nms", valid.device, boxes.data_ptr(),
                  valid.data_ptr(), mask.data_ptr(), keep.data_ptr(), n, k,
                  threshold)
    return keep


# A dispatcher op of its own, as ``alink_tpu_torch::attention_core``: the
# profiler links a kernel to the op open at its launch, so a launch under
# ``span("nms")`` alone would count under no event of the span.
_OPS = torch.library.Library("alink_tpu_torch", "FRAGMENT")
_OPS.define("nms(Tensor boxes, Tensor valid, float threshold) -> Tensor")
_OPS.impl("nms", _launch, "CUDA")


@torch.no_grad()
def nms_kernel(boxes: torch.Tensor, valid: torch.Tensor,
               threshold: float) -> torch.Tensor:
    """``nms(boxes, scores, valid, threshold)``'s keep-mask (union mode) by
    ``csrc/nms.cu`` for candidates in ``nms``'s visit order (descending
    score, ties to the lower index): (N, K, 4) boxes and (N, K) valid on a
    CUDA device -> (N, K) bool.  Span ``nms``; counters ``nms.calls`` and
    ``nms.sweeps`` (one device sweep a call) and ``launches.nms``."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or \
            valid.shape != boxes.shape[:2]:
        raise ValueError(f"nms_kernel takes (N, K, 4) boxes and (N, K) "
                         f"valid, got {tuple(boxes.shape)}, "
                         f"{tuple(valid.shape)}")
    if not boxes.is_cuda:
        raise ValueError(f"nms_kernel needs CUDA tensors, got {boxes.device}")
    with span("nms"):
        keep = torch.ops.alink_tpu_torch.nms(
            boxes.float().contiguous(), valid.bool().contiguous(),
            float(threshold))
        count("nms.calls")
        count("nms.sweeps")
        return keep
