"""FaceModel: detect -> align -> embed (counterpart of
``alink_tpu/detect/face_model.py``).

The embedder and the cascade towers carry their own weights and device;
images may arrive as numpy arrays or tensors on any device and are moved
to the embedder's device.  The cascade's options (crowd budgets, L-Net,
crop dtype) come with ``cfg`` through ``detect_faces``.  A ``detector``
(``detect.retina.RetinaFaceDetector``, the port's own) takes the
cascade's place where one is given; alignment, the found mask and the
embedder are the same for both.  JAX's ``__setattr__`` only drops stale
jit traces and has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from alink_tpu_torch.detect.cascade import (CascadeConfig, Detections,
                                            MTCNNParams, align_faces,
                                            detect_faces)
from alink_tpu_torch.models.genderage import decode_ga
from alink_tpu_torch.ops.image import resize
from alink_tpu_torch.utils.profiling import count, span


class FaceModel:
    """Batched detect -> align -> embed pipeline.

    Args:
        embedder: an embedder module, ArcFace, the ViT or the Swin
            (``(N, 112, 112, 3) -> (N, D)``).
        cascade_params: MTCNN towers, or None to skip detection (images are
            then pre-cropped faces, resized to ``cfg.output_size``) unless a
            ``detector`` is given.
        cfg: cascade budgets and thresholds, and the chips' size.
        detector: a callable (N, H, W, 3) photos -> ``Detections`` that
            detects in the cascade's place (``RetinaFaceDetector``), or
            None for the cascade.
    """

    def __init__(self, embedder: nn.Module,
                 cascade_params: MTCNNParams | None = None,
                 cfg: CascadeConfig = CascadeConfig(), detector=None):
        self.embedder = embedder.eval()
        self.cascade_params = cascade_params
        self.cfg = cfg
        self.detector = detector

    @property
    def detects(self) -> bool:
        """Whether photos go through a detector (else they are faces)."""
        return self.detector is not None or self.cascade_params is not None

    @property
    def device(self) -> torch.device:
        return next(self.embedder.parameters()).device

    def _to_device(self, images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = np.ascontiguousarray(images)  # views may have - strides
        return torch.as_tensor(images, device=self.device)

    def detect(self, images) -> Detections:
        if not self.detects:
            raise ValueError("no cascade params loaded (detection disabled)")
        return self._detect(self._to_device(images))

    def _detect(self, images: torch.Tensor) -> Detections:
        if self.detector is not None:
            return self.detector(images)
        return detect_faces(self.cascade_params, images, self.cfg)

    @torch.no_grad()
    def _best_chips(self, images: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Best-scoring face per image, aligned -> (chips, found).

        ``found`` is False where an image had no valid detection, and where
        its best detection cannot be aligned: five coinciding landmarks (a
        zero-size box) give a similarity of scale 0, whose warp divides by
        zero.  Such a chip is zeroed with a ``where`` (not a multiply: it
        may have warped to NaN, and 0 * NaN is NaN).
        """
        det = self._detect(images)
        with span("align"):
            neg = torch.finfo(det.scores.dtype).min
            best = torch.argmax(torch.where(det.valid, det.scores, neg),
                                dim=1)
            lmk = det.landmarks[torch.arange(images.shape[0],
                                             device=images.device), best]
            found = torch.any(det.valid, dim=1) & (
                (lmk - lmk[:, :1]).abs().amax(dim=(1, 2)) > 0)
            chips = align_faces(images, lmk[:, None],
                                self.cfg.output_size)[:, 0]
            return torch.where(found[:, None, None, None], chips, 0.0), found

    def get_input(self, images) -> torch.Tensor:
        """Aligned face chips (zero where no face was found)."""
        return self.get_input_valid(images)[0]

    def get_input_valid(self, images) -> tuple[torch.Tensor, torch.Tensor]:
        """(chips, found): ``get_input`` plus the per-image found mask."""
        images = self._to_device(images)
        if not self.detects:
            chips = resize(images, self.cfg.output_size)
            return chips, torch.ones(images.shape[0], dtype=torch.bool,
                                     device=images.device)
        return self._best_chips(images)

    @torch.no_grad()
    def get_feature(self, aligned) -> torch.Tensor:
        """Embeddings of aligned chips.  Span ``embed``; counter
        ``embed.calls``."""
        with span("embed"):
            count("embed.calls")
            return self.embedder(self._to_device(aligned))

    def process(self, images) -> torch.Tensor:
        """End to end: raw images -> embeddings (zero chip where no face)."""
        if not self.detects:
            return self.get_feature(self.get_input(images))
        return self.pipeline(images)

    def pipeline(self, images) -> torch.Tensor:
        """detect -> align -> embed; no-face images embed a zero chip."""
        return self.pipeline_valid(images)[0]

    @torch.no_grad()
    def pipeline_valid(self, images) -> tuple[torch.Tensor, torch.Tensor]:
        """(embeddings, found).  Spans ``pipeline``, and inside it
        ``detect``, ``align`` and ``embed``; counters ``pipeline.calls``
        and ``pipeline.photos``."""
        with span("pipeline"):
            images = self._to_device(images)
            count("pipeline.calls")
            count("pipeline.photos", images.shape[0])
            chips, found = self._best_chips(images)
            with span("embed"):
                return self.embedder(chips), found

    @torch.no_grad()
    def get_ga(self, aligned, ga_model: nn.Module
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(gender, age) of aligned chips from a genderage network
        (``GenderAgeResNet50``, or any module giving (N, 202))."""
        return decode_ga(ga_model(self._to_device(aligned)))

    @torch.no_grad()
    def get_ga_from_embedding(self, aligned, ga_head: nn.Module
                              ) -> tuple[torch.Tensor, torch.Tensor]:
        """(gender, age) from a ``GenderAgeHead`` over this model's own
        embeddings: one trunk forward serves both tasks."""
        return decode_ga(ga_head(self.get_feature(aligned)))
