"""Input preprocessing (counterpart of ``alink_tpu/models/preprocess.py``)."""

from __future__ import annotations

import torch


def mtcnn(x: torch.Tensor) -> torch.Tensor:
    """MTCNN input scaling ``(x - 127.5) * 0.0078125``.  Integer inputs
    promote to f32 first: uint8 arithmetic would wrap."""
    if not x.is_floating_point():
        x = x.float()
    return (x - 127.5) * 0.0078125


def identity(x: torch.Tensor) -> torch.Tensor:
    """Raw passthrough (ArcFace takes raw RGB; its stem BN scales it)."""
    return x
