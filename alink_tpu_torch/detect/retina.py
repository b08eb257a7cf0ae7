"""RetinaFace's detector around ``models.RetinaFaceR50``: priors, decode and
post-process as Pytorch_Retinaface's ``detect.py`` and
``test_widerface.py`` (``layers/functions/prior_box.py``,
``utils/box_utils.py``), returning the cascade's ``Detections``.

Per photo of H x W:

1. priors, built once per photo size: for each level (steps 8, 16, 32),
   row i, column j and min size (16, 32 / 64, 128 / 256, 512), in that
   order, (cx, cy, sx, sy) = ((j + 0.5) step / W, (i + 0.5) step / H,
   min / W, min / H), computed in double and held in float32: 16,800 at
   640^2;
2. decode with variances (0.1, 0.2): centre = p_c + loc_xy 0.1 p_s, size =
   p_s exp(loc_wh 0.2), then corners, times (W, H); landmark k = p_c +
   pre_k 0.1 p_s, times (W, H); the score is softmax(conf)[1], P(face);
3. keep scores > 0.02, take the top 5,000 by score (ties to the lower
   anchor index, where numpy's reversed argsort sends them the other way),
   greedy NMS at IoU 0.4 (``py_cpu_nms``'s inclusive-pixel areas,
   suppressed strictly above 0.4: ``ops.nms``'s semantics; on a CUDA
   tensor the kernel ``csrc/nms.cu``, ``ops.nms.nms_kernel``), keep the
   first 750.

Everything past the model runs in float32.  Spans: ``detect`` around a
call; inside, the model's ``retina.*`` spans and ``retina.post`` around
steps 2-3 (``nms`` inside it); counters ``retina.candidates`` (valid
candidates into NMS) and ``retina.kept`` (detections returned), kept on
the device (``profiling.count_on_device``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from alink_tpu_torch.detect.cascade import Detections
from alink_tpu_torch.ops.boxes import select_topk
from alink_tpu_torch.ops.nms import nms, nms_kernel
from alink_tpu_torch.utils.profiling import count_on_device, span


@dataclasses.dataclass(frozen=True)
class RetinaConfig:
    """``cfg_re50``'s priors and ``detect.py``'s inference defaults."""

    steps: tuple[int, ...] = (8, 16, 32)
    min_sizes: tuple[tuple[int, ...], ...] = ((16, 32), (64, 128),
                                              (256, 512))
    variances: tuple[float, float] = (0.1, 0.2)
    confidence: float = 0.02
    top_k: int = 5000
    nms_threshold: float = 0.4
    keep_top_k: int = 750


@functools.lru_cache(maxsize=16)
def _priors(h: int, w: int, steps, min_sizes, device) -> torch.Tensor:
    rows = []
    for step, sizes in zip(steps, min_sizes):
        fh, fw = -(-h // step), -(-w // step)
        i = torch.arange(fh, dtype=torch.float64)[:, None, None]
        j = torch.arange(fw, dtype=torch.float64)[None, :, None]
        m = torch.tensor(sizes, dtype=torch.float64)[None, None, :]
        shape = (fh, fw, len(sizes))
        rows.append(torch.stack([((j + 0.5) * step / w).expand(shape),
                                 ((i + 0.5) * step / h).expand(shape),
                                 (m / w).expand(shape),
                                 (m / h).expand(shape)], -1).reshape(-1, 4))
    return torch.cat(rows).float().to(device)


def priors(h: int, w: int, cfg: RetinaConfig = RetinaConfig(),
           device=None) -> torch.Tensor:
    """(A, 4) priors (cx, cy, sx, sy) of an H x W photo, in the order level,
    row, column, min size; cached per size and device."""
    return _priors(h, w, cfg.steps, cfg.min_sizes, torch.device(device or
                                                               "cpu"))


def decode(loc: torch.Tensor, landms: torch.Tensor, pri: torch.Tensor,
           h: int, w: int, variances=(0.1, 0.2)
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., A, 4) box offsets and (..., A, 10) landmark offsets against
    (A, 4) priors -> boxes (..., A, 4) [x1, y1, x2, y2] and landmarks
    (..., A, 5, 2) in pixels of an H x W photo (``box_utils.decode`` and
    ``decode_landm``, then the scale)."""
    v0, v1 = variances
    pc, ps = pri[:, :2], pri[:, 2:]
    centre = pc + loc[..., :2] * v0 * ps
    size = ps * torch.exp(loc[..., 2:] * v1)
    x1y1 = centre - size / 2
    scale = torch.tensor([w, h], dtype=torch.float32, device=loc.device)
    boxes = torch.cat([x1y1, size + x1y1], -1) * scale.repeat(2)
    pts = landms.reshape(landms.shape[:-1] + (5, 2))
    marks = (pc[:, None] + pts * v0 * ps[:, None]) * scale
    return boxes, marks


class RetinaFaceDetector:
    """``model`` (a ``RetinaFaceR50``) and the post-process under ``cfg``:
    (N, H, W, 3) RGB photos -> ``Detections`` with K = ``keep_top_k``,
    each photo's kept detections first, by descending score.

    ``decode`` and ``select`` are the steps a call makes after the model,
    each an attribute so that a caller can observe them."""

    def __init__(self, model: torch.nn.Module,
                 cfg: RetinaConfig = RetinaConfig()):
        self.model = model.eval()
        self.cfg = cfg

    def decode(self, loc, conf, landms, h: int, w: int):
        """(boxes (N, A, 4), scores (N, A), landmarks (N, A, 5, 2))."""
        pri = priors(h, w, self.cfg, loc.device)
        boxes, marks = decode(loc, landms, pri, h, w, self.cfg.variances)
        return boxes, torch.softmax(conf, dim=-1)[..., 1], marks

    def select(self, boxes, scores, landmarks
               ) -> tuple[Detections, torch.Tensor]:
        """Threshold, top-k, NMS and keep-top-k -> (``Detections``, the
        anchor index of each detection (N, keep_top_k))."""
        c = self.cfg
        n, a = scores.shape
        anchor = torch.arange(a, device=scores.device).expand(n, a)
        b, s, v, marks, anchor = select_topk(
            boxes, scores, scores > c.confidence, c.top_k, landmarks, anchor)
        count_on_device("retina.candidates", v.sum())
        if b.is_cuda:
            keep = nms_kernel(b, v, c.nms_threshold)
        else:
            keep = nms(b, s, v, c.nms_threshold)
        keep &= torch.cumsum(keep, dim=1) <= c.keep_top_k
        order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True)[1]
        order = order[:, :c.keep_top_k]
        valid = torch.gather(keep, 1, order)
        count_on_device("retina.kept", valid.sum())
        take = lambda x: torch.gather(x, 1, order.reshape(  # noqa: E731
            order.shape + (1,) * (x.dim() - 2)).expand(
                order.shape + x.shape[2:]))
        return Detections(boxes=take(b), scores=torch.where(valid, take(s),
                                                            0.0),
                          landmarks=take(marks), valid=valid), take(anchor)

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> Detections:
        with span("detect"):
            h, w = images.shape[1:3]
            loc, conf, landms = self.model(images)
            with span("retina.post"):
                boxes, scores, marks = self.decode(loc, conf, landms, h, w)
                return self.select(boxes, scores, marks)[0]
