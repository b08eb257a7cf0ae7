"""MTCNN cascade networks (counterpart of ``alink_tpu/models/mtcnn.py``).

VALID convolutions, channel-wise PReLU, Caffe ceil-mode max pooling and
dense heads over the NHWC flatten.  Inputs are NHWC, already scaled by
``preprocess.mtcnn``; the towers run in ``dtype`` (bf16 by default) and
their output layers in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from alink_tpu_torch.models.arcface import _PReLU
from alink_tpu_torch.models.resnet import (_conv, _dense, _make_conv,
                                           _make_dense)


def _ceil_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Max pool (NCHW) with ceil-mode output size: pad the bottom/right
    with -inf exactly as the JAX module does, then pool VALID."""
    h, w = x.shape[2], x.shape[3]
    pad_h = max(0, (-(h - window) % stride) if h > window else window - h)
    pad_w = max(0, (-(w - window) % stride) if w > window else window - w)
    if pad_h or pad_w:
        x = F.pad(x, (0, pad_w, 0, pad_h), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def _nhwc_flat(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class _Tower(nn.Module):
    """Shared parameter layout: ``conv``, ``prelu`` and ``dense`` lists in
    the JAX module's creation order (Conv_i, _PReLU_i, Dense_i)."""

    def __init__(self, convs, prelus, denses, dtype, generator, device):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.ModuleList(
            _make_conv(ci, co, k, True, generator, device)
            for ci, co, k in convs)
        self.prelu = nn.ModuleList(_PReLU(c, dtype, device) for c in prelus)
        self.dense = nn.ModuleList(
            _make_dense(ci, co, generator, device) for ci, co in denses)

    def _act(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return self.prelu[i](_conv(x, self.conv[i], self.dtype))


class PNet(_Tower):
    """Proposal network -> (prob (N, h', w', 2), reg (N, h', w', 4))."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None, device=None):
        super().__init__([(3, 10, 3), (10, 16, 3), (16, 32, 3), (32, 2, 1),
                          (32, 4, 1)], [10, 16, 32], [], dtype, generator,
                         device)

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        x = _ceil_pool(self._act(x, 0), 2, 2)
        x = self._act(self._act(x, 1), 2).float()
        prob = torch.softmax(_conv(x, self.conv[3], torch.float32), dim=1)
        reg = _conv(x, self.conv[4], torch.float32)
        return prob.permute(0, 2, 3, 1), reg.permute(0, 2, 3, 1)


class RNet(_Tower):
    """Refine network on 24x24 crops -> (prob (N, 2), reg (N, 4))."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None, device=None):
        super().__init__([(3, 28, 3), (28, 48, 3), (48, 64, 2)],
                         [28, 48, 64, 128],
                         [(3 * 3 * 64, 128), (128, 2), (128, 4)],
                         dtype, generator, device)

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        x = _ceil_pool(self._act(x, 0), 3, 2)
        x = _ceil_pool(self._act(x, 1), 3, 2)
        x = _nhwc_flat(self._act(x, 2))
        x = self.prelu[3](_dense(x, self.dense[0], self.dtype)).float()
        prob = torch.softmax(_dense(x, self.dense[1], torch.float32), dim=-1)
        return prob, _dense(x, self.dense[2], torch.float32)


class ONet(_Tower):
    """Output network on 48x48 crops -> (prob (N, 2), reg (N, 4),
    landmarks (N, 10) as x1..x5, y1..y5)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None, device=None):
        super().__init__([(3, 32, 3), (32, 64, 3), (64, 64, 3), (64, 128, 2)],
                         [32, 64, 64, 128, 256],
                         [(3 * 3 * 128, 256), (256, 2), (256, 4), (256, 10)],
                         dtype, generator, device)

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        x = _ceil_pool(self._act(x, 0), 3, 2)
        x = _ceil_pool(self._act(x, 1), 3, 2)
        x = _ceil_pool(self._act(x, 2), 2, 2)
        x = _nhwc_flat(self._act(x, 3))
        x = self.prelu[4](_dense(x, self.dense[0], self.dtype)).float()
        prob = torch.softmax(_dense(x, self.dense[1], torch.float32), dim=-1)
        return (prob, _dense(x, self.dense[2], torch.float32),
                _dense(x, self.dense[3], torch.float32))


class LNet(_Tower):
    """Landmark refinement over five 24x24 patches stacked on the channel
    axis (N, 24, 24, 15) -> per-landmark (dx, dy) in [0, 1] patch
    coordinates (N, 5, 2).  ``prelu.3`` follows ``dense.0``, as flax
    creates them."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None, device=None):
        super().__init__([(15, 28, 3), (28, 48, 3), (48, 64, 2)],
                         [28, 48, 64, 256],
                         [(3 * 3 * 64, 256)] + [(256, 2)] * 5,
                         dtype, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = _ceil_pool(self._act(x, 0), 3, 2)
        x = _ceil_pool(self._act(x, 1), 3, 2)
        x = _nhwc_flat(self._act(x, 2))
        x = self.prelu[3](_dense(x, self.dense[0], self.dtype)).float()
        return torch.stack([torch.sigmoid(_dense(x, d, torch.float32))
                            for d in self.dense[1:]], dim=1)
