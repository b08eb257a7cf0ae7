"""Frozen batch norm (counterpart of ``alink_tpu/models/resnet.py:37-62``).

Only what ArcFace needs for now; the VGGFace backbones come later.
"""

from __future__ import annotations

import torch
from torch import nn

KERAS_BN_EPS = 1e-3
MXNET_BN_EPS = 2e-5


class _FrozenBN(nn.Module):
    """Inference batch norm on channel axis 1 (NCHW or (N, C)):
    y = (x - mean) / sqrt(var + eps) * gamma + beta.

    Scale and shift are formed in f32, cast to ``dtype``, and applied in
    ``dtype``, as in the JAX module.  ``eps`` must match the framework
    that produced the statistics (2e-5 for insightface MXNet checkpoints).
    """

    def __init__(self, channels: int, eps: float = KERAS_BN_EPS,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        for name, fill in (("gamma", 1.0), ("beta", 0.0), ("mean", 0.0),
                           ("var", 1.0)):
            self.register_buffer(
                name, torch.full((channels,), fill, dtype=torch.float32,
                                 device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        root = torch.sqrt(self.var + self.eps)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = (self.gamma / root).to(self.dtype).reshape(shape)
        shift = (self.beta - self.mean * self.gamma / root).to(
            self.dtype).reshape(shape)
        return x.to(self.dtype) * scale + shift
