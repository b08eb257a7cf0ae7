"""Siamese verification models (counterpart of
``alink_tpu/models/siamese.py``).

``SiameseHead``, the feature-pair head of M1 and of the DFW student M2:

    L1 = |left - right|
    h  = relu(Dense(512)(L1)); h = relu(Dense(64)(h))
    p  = softmax(Dense(2)(h))          (head="sigmoid": Dense(1) + sigmoid)

The hidden layers run in ``dtype`` (bf16 by default), the output layer in
f32.

``SmallRes``, the raw-pixel student of the Multi-PIE experiment
(code/siamese.py:134-170): a shared conv tower on each image, then a
``SiameseHead`` of widths (128, 32).  The tower is

    Conv32 SAME, Conv32 VALID, MaxPool 2, Dropout 0.25,
    Conv64 SAME, Conv64 VALID, MaxPool 2, Dropout 0.25,
    Flatten (NHWC order, Keras channels_last), Dense(feature_dim), ReLU,

in ``dtype`` with an f32 output; the convolutions go to cuDNN.  Dropout is
on only in a training forward (``train=True``), with its keep masks drawn
from an explicit ``torch.Generator`` on the model's device through the
tower's ``draw`` hook (a test feeds another framework's masks there).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from alink_tpu_torch.models.resnet import (_conv, _dense, _make_conv,
                                           _make_dense)


class SiameseHead(nn.Module):
    """Feature-pair verification head over ``in_features``-wide inputs
    (the JAX module infers the width on first call)."""

    def __init__(self, in_features: int, widths: Sequence[int] = (512, 64),
                 head: str = "softmax", dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if head not in ("softmax", "sigmoid"):
            raise ValueError(f"unknown head {head!r}")
        self.head = head
        self.dtype = dtype
        dims = (in_features,) + tuple(widths)
        self.hidden = nn.ModuleList(
            _make_dense(a, b, generator, device) for a, b in zip(dims, dims[1:]))
        self.out = _make_dense(dims[-1], 1 if head == "sigmoid" else 2,
                               generator, device)
        # The fused scorer's packed copy of the weights
        # (``ops.pairwise.packed_head``): keyed on each parameter's identity
        # and version, and dropped when the module moves or loads a state.
        self._packed = None
        self.register_load_state_dict_post_hook(_drop_packed)

    def _apply(self, fn, recurse=True):
        self._packed = None
        return super()._apply(fn, recurse)

    def logits(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        """Two-class logits; a sigmoid head exports ``[0, logit]`` so that
        class 1 is always P(genuine)."""
        x = torch.abs(left.to(self.dtype) - right.to(self.dtype))
        for layer in self.hidden:
            x = torch.relu(_dense(x, layer, self.dtype))
        raw = F.linear(x.float(), self.out.weight, self.out.bias)
        if self.head == "sigmoid":
            return torch.cat([torch.zeros_like(raw), raw], dim=-1)
        return raw

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.logits(left, right), dim=-1)


def _drop_packed(module: SiameseHead, incompatible_keys) -> None:
    module._packed = None


DROPOUT_RATE = 0.25
KEEP = 1.0 - DROPOUT_RATE

# draw(shape, generator, device) -> bool keep mask of the NHWC ``shape``.
DrawFn = Callable[[tuple, torch.Generator, torch.device], torch.Tensor]


def torch_keep(shape: tuple, generator: torch.Generator | None,
               device, keep: float = KEEP) -> torch.Tensor:
    """The default ``draw``: keep each unit with probability ``keep``."""
    if generator is None:
        raise ValueError("a training forward with dropout needs a "
                         "torch.Generator on the model's device")
    return torch.rand(shape, generator=generator, device=device) < keep


class SmallResTower(nn.Module):
    """The SmallRes student's shared conv tower: ``(N, H, W, 3)`` ->
    ``(N, feature_dim)`` f32.  ``input_size`` (h, w) fixes the dense
    layer's width (the JAX module infers it on first call): 6,400 at 48^2;
    10^2 is the smallest input the two VALID convs and pools leave a pixel
    of."""

    def __init__(self, feature_dim: int = 2048,
                 dtype: torch.dtype = torch.bfloat16,
                 input_size: tuple[int, int] = (48, 48),
                 generator: torch.Generator | None = None, device=None,
                 draw: DrawFn | None = None):
        super().__init__()
        self.dtype = dtype
        self.draw = draw if draw is not None else torch_keep
        self.conv = nn.ModuleList(
            _make_conv(a, b, 3, True, generator, device)
            for a, b in ((3, 32), (32, 32), (32, 64), (64, 64)))
        h, w = input_size
        for _ in range(2):
            h, w = (h - 2) // 2, (w - 2) // 2
        if h < 1 or w < 1:
            raise ValueError(f"input {input_size} is below the tower's "
                             "smallest, 10^2")
        self.dense = nn.ModuleList(
            [_make_dense(64 * h * w, feature_dim, generator, device)])

    def _dropout(self, x: torch.Tensor, train: bool,
                 generator: torch.Generator | None) -> torch.Tensor:
        if not train:
            return x
        n, c, h, w = x.shape
        keep = torch.as_tensor(self.draw((n, h, w, c), generator, x.device),
                               device=x.device).bool().permute(0, 3, 1, 2)
        return torch.where(keep, x / KEEP, torch.zeros_like(x))

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = self.dtype
        x = x.permute(0, 3, 1, 2)
        for block in (0, 2):
            x = torch.relu(_conv(x, self.conv[block], dt, padding=1))
            x = torch.relu(_conv(x, self.conv[block + 1], dt))
            x = self._dropout(F.max_pool2d(x, 2, 2), train, generator)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return torch.relu(_dense(x, self.dense[0], dt)).float()


class SmallRes(nn.Module):
    """Twin-tower siamese over raw low-resolution pixels; callers scale
    them with ``preprocess.smallres`` first (code/siamese.py:179-184)."""

    def __init__(self, feature_dim: int = 2048, head: str = "softmax",
                 dtype: torch.dtype = torch.bfloat16,
                 input_size: tuple[int, int] = (48, 48),
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.tower = SmallResTower(feature_dim, dtype, input_size, generator,
                                   device)
        self.verify_head = SiameseHead(feature_dim, (128, 32), head, dtype,
                                       generator, device)

    def embed(self, x: torch.Tensor, *, train: bool = False,
              generator: torch.Generator | None = None) -> torch.Tensor:
        return self.tower(x, train=train, generator=generator)

    def logits(self, left: torch.Tensor, right: torch.Tensor, *,
               train: bool = False,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """The head's two-class logits over the towers' embeddings; the
        left image's masks are drawn before the right's."""
        return self.verify_head.logits(
            self.embed(left, train=train, generator=generator),
            self.embed(right, train=train, generator=generator))

    def forward(self, left: torch.Tensor, right: torch.Tensor, *,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return torch.softmax(self.logits(left, right, train=train,
                                         generator=generator), dim=-1)
