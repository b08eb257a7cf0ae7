"""Siamese verification head (counterpart of ``alink_tpu/models/siamese.py``).

    L1 = |left - right|
    h  = relu(Dense(512)(L1)); h = relu(Dense(64)(h))
    p  = softmax(Dense(2)(h))          (head="sigmoid": Dense(1) + sigmoid)

The hidden layers run in ``dtype`` (bf16 by default), the output layer in
f32.  ``SmallRes`` is not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from alink_tpu_torch.models.arcface import _dense, _make_dense


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
