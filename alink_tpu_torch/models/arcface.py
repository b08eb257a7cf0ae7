"""ArcFace LResNet100E-II embedder (counterpart of
``alink_tpu/models/arcface.py``).

- "improved residual" units: BN - Conv3x3 - BN - PReLU - Conv3x3(s) - BN,
  with a Conv1x1(s) + BN shortcut on a change of shape;
- stem Conv3x3 (64) - BN - PReLU on 112x112 input;
- stages of (3, 13, 30, 3) units at widths (64, 128, 256, 512), stride 2
  at each stage entry -> 7x7x512;
- head "E": BN - flatten - Dense(512) - affine (the folded fc1 BN), then
  L2 normalisation.

Input is raw NHWC RGB in [0, 255].  Inside the tower the layout is NCHW
(a permuted view of the NHWC input, so cuDNN sees channels-last memory).
The flatten before fc1 is NHWC order, as in the JAX model, so converted
fc1 weights need no permutation.  Parameters are f32; convolutions and BN
run in ``dtype`` (bf16 by default), fc1 in f32.  Each BN with the PReLU
or the residual add that follows it is one call of ``ops.bn_act.bn_act``
(a fused CUDA pass on the card, the modules' own arithmetic bit for bit;
three a unit), on the parameters of the ``bn``/``prelu`` modules, whose
names the converters and the tensor-parallel shards use.  The JAX model's
``scan_units`` is a TPU compile-time knob and is not ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from alink_tpu_torch.models.resnet import (MXNET_BN_EPS, _conv, _FrozenBN,
                                           _make_conv, _make_dense)
from alink_tpu_torch.ops.bn_act import bn_act, prelu


class _PReLU(nn.Module):
    """Channel-wise PReLU on axis 1 (alpha initialised to 0.25)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.alpha = nn.Parameter(torch.full((channels,), 0.25, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prelu(x, self.alpha, self.dtype)


class _IRUnit(nn.Module):
    """Improved-residual unit of LResNetE (BN-first)."""

    def __init__(self, cin: int, filters: int, stride: int, dtype, generator,
                 device):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        project = stride != 1 or cin != filters
        self.conv = nn.ModuleList(
            [_make_conv(cin, filters, 3, False, generator, device),
             _make_conv(filters, filters, 3, False, generator, device)]
            + ([_make_conv(cin, filters, 1, False, generator, device)]
               if project else []))
        self.bn = nn.ModuleList(
            _FrozenBN(c, MXNET_BN_EPS, dtype, device)
            for c in (cin, filters, filters) + ((filters,) if project else ()))
        self.prelu = nn.ModuleList([_PReLU(filters, dtype, device)])

    def forward(self, x: torch.Tensor, reduce=None) -> torch.Tensor:
        """``reduce`` is applied to the second conv's output: the tensor-
        parallel split (``parallel/tp.py``) passes its all-reduce over the
        model axis."""
        dt = self.dtype
        y = bn_act(x, self.bn[0])
        y = _conv(y, self.conv[0], dt, padding=1)
        y = bn_act(y, self.bn[1], prelu=self.prelu[0])
        # Symmetric (1, 1) padding on the strided conv (MXNet/Caffe grid).
        y = _conv(y, self.conv[1], dt, self.stride, padding=1)
        if reduce is not None:
            y = reduce(y)
        if len(self.conv) == 3:
            return bn_act(y, self.bn[2],
                          shortcut=_conv(x, self.conv[2], dt, self.stride),
                          shortcut_bn=self.bn[3])
        return bn_act(y, self.bn[2], shortcut=x)


class ArcFaceResNet100(nn.Module):
    """LResNet100E-II to the L2-normalised fc1 embedding.

    ``input_size`` fixes fc1's width (the JAX module infers it on first
    call).  ``normalize=False`` returns the raw fc1 output.
    """

    def __init__(self, stage_sizes: Sequence[int] = (3, 13, 30, 3),
                 stage_widths: Sequence[int] = (64, 128, 256, 512),
                 embedding_dim: int = 512, dtype: torch.dtype = torch.bfloat16,
                 normalize: bool = True,
                 input_size: tuple[int, int] = (112, 112),
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.stage_widths = tuple(stage_widths)
        self.embedding_dim = embedding_dim
        self.dtype = dtype
        self.normalize = normalize
        g, dev = generator, device
        self.conv = nn.ModuleList([_make_conv(3, 64, 3, False, g, dev)])
        self.prelu = nn.ModuleList([_PReLU(64, dtype, dev)])
        units = []
        cin = 64
        h, w = input_size
        for blocks, width in zip(self.stage_sizes, self.stage_widths):
            for b in range(blocks):
                units.append(_IRUnit(cin, width, 2 if b == 0 else 1, dtype, g,
                                     dev))
                cin = width
            h, w = -(-h // 2), -(-w // 2)
        self.units = nn.ModuleList(units)
        self.bn = nn.ModuleList([_FrozenBN(64, MXNET_BN_EPS, dtype, dev),
                                 _FrozenBN(cin, MXNET_BN_EPS, dtype, dev)])
        self.dense = nn.ModuleList([_make_dense(cin * h * w, embedding_dim, g,
                                                dev)])
        self.fc1_gamma = nn.Parameter(torch.ones(embedding_dim, device=dev))
        self.fc1_beta = nn.Parameter(torch.zeros(embedding_dim, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) raw RGB -> (N, embedding_dim) f32."""
        x = self.stem(x)
        for unit in self.units:
            x = unit(x)
        return self.head(x)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) raw RGB -> the first unit's input (N, 64, H, W).
        The stem, the units and the head are the one copy of the topology
        that the tensor- and pipeline-parallel forwards share."""
        x = x.permute(0, 3, 1, 2)
        return bn_act(_conv(x, self.conv[0], self.dtype, padding=1),
                      self.bn[0], prelu=self.prelu[0])

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The last unit's output -> (N, embedding_dim) f32."""
        x = bn_act(x, self.bn[1])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()
        x = F.linear(x, self.dense[0].weight, self.dense[0].bias)
        x = x * self.fc1_gamma + self.fc1_beta
        if not self.normalize:
            return x
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / torch.clamp(norm, min=1e-12)


def ArcFaceResNet50(**kwargs) -> ArcFaceResNet100:
    """LResNet50E-IR: unit counts (3, 4, 14, 3)."""
    return ArcFaceResNet100(stage_sizes=(3, 4, 14, 3), **kwargs)


def ArcFaceResNet34(**kwargs) -> ArcFaceResNet100:
    """LResNet34E-IR: unit counts (3, 4, 6, 3)."""
    return ArcFaceResNet100(stage_sizes=(3, 4, 6, 3), **kwargs)
