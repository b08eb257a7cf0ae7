"""Input preprocessing (counterpart of ``alink_tpu/models/preprocess.py``)."""

from __future__ import annotations

import torch

# keras_vggface per-channel BGR means.
_VGGFACE_V1_MEAN_BGR = (93.5940, 104.7624, 129.1863)
_VGGFACE_V2_MEAN_BGR = (91.4953, 103.8827, 131.0912)


def vggface(x: torch.Tensor, version: int = 2) -> torch.Tensor:
    """keras_vggface ``preprocess_input`` on NHWC RGB input: RGB -> BGR and
    per-channel mean subtraction.  Integer inputs promote to f32 first (a
    uint8 subtraction would wrap); float inputs stay in their dtype."""
    mean = _VGGFACE_V1_MEAN_BGR if version == 1 else _VGGFACE_V2_MEAN_BGR
    if not x.is_floating_point():
        x = x.float()
    return x.flip(-1) - torch.tensor(mean, dtype=x.dtype, device=x.device)


def mtcnn(x: torch.Tensor) -> torch.Tensor:
    """MTCNN input scaling ``(x - 127.5) * 0.0078125``.  Integer inputs
    promote to f32 first: uint8 arithmetic would wrap."""
    if not x.is_floating_point():
        x = x.float()
    return (x - 127.5) * 0.0078125


def smallres(x: torch.Tensor) -> torch.Tensor:
    """SmallRes input scaling ``(x - 128) / 128`` (code/siamese.py:179-181).
    Integer inputs promote to f32 first: uint8 arithmetic would wrap."""
    if not x.is_floating_point():
        x = x.float()
    return (x - 128.0) / 128.0


def identity(x: torch.Tensor) -> torch.Tensor:
    """Raw passthrough (ArcFace takes raw RGB; its stem BN scales it)."""
    return x
