"""Identification classifiers (counterpart of
``alink_tpu/models/classify.py``; reference: code/model.py).

A softmax identification head on each backbone:

- ``VGG16Classifier``    — pool5 -> fc6/fc7 (hid_dim, ReLU) -> softmax
  (model.py:85-103);
- ``ResNet50Classifier`` — avg_pool -> softmax over a trainable
  ``VGGFaceResNet50``: its 13 stride-1 blocks run through kernel K3 on the
  card in every forward, their gradients by recompute
  (``ops.resblock.BottleneckS1``) (model.py:106-123);
- ``SENet50Classifier``  — the same over ``SENet50`` (model.py:126-141);
- ``SmallResClassifier`` — the SmallRes conv tower at feature_dim 512 ->
  Dropout(0.5) -> softmax, with the (x - 128) / 128 scaling of
  ``preprocess.smallres`` (model.py:144-176).

Hidden Dense layers run in ``dtype`` with their ReLU output cast to f32;
the output Dense is f32.  Each exposes ``logits(x, train=, generator=)``
and a softmax ``forward``.  Parameters are named as the flax modules'
(``backbone``, ``dense.i``; ``tower``, ``dense.0``, see ``convert.py``).
Dropout (SmallRes only) is on in a training forward, its keep masks drawn
from ``generator``, a ``torch.Generator`` on the model's device, through
the ``draw`` hooks: the tower's (rate 0.25, twice), then the classifier's
(rate 0.5).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from alink_tpu_torch.models import preprocess
from alink_tpu_torch.models.resnet import (SENet50, VGGFace16, VGGFaceResNet50,
                                           _dense, _make_dense)
from alink_tpu_torch.models.siamese import DrawFn, SmallResTower, torch_keep

CLASSIFIER_KEEP = 0.5     # SmallResClassifier's Dropout(0.5)


class _BackboneClassifier(nn.Module):
    """Backbone features -> optional hidden MLP -> ``out_dim`` logits; the
    backbone's ``feature_dim`` sets the first Dense layer's width."""

    def __init__(self, backbone: nn.Module, out_dim: int,
                 hidden: tuple[int, ...] = (),
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.backbone = backbone
        self.dtype = dtype
        dims = (backbone.feature_dim,) + tuple(hidden) + (out_dim,)
        self.dense = nn.ModuleList(
            _make_dense(a, b, generator, device)
            for a, b in zip(dims, dims[1:]))

    def logits(self, x: torch.Tensor, *, train: bool = False,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """(N, H, W, 3) -> (N, out_dim) f32; ``train`` and ``generator``
        change nothing (no dropout)."""
        h = self.backbone(x)
        for layer in self.dense[:-1]:
            h = torch.relu(_dense(h, layer, self.dtype)).float()
        out = self.dense[-1]
        return F.linear(h.float(), out.weight, out.bias)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return torch.softmax(self.logits(x, train=train, generator=generator),
                             dim=-1)


def VGG16Classifier(out_dim: int, hid_dim: int = 512,
                    dtype: torch.dtype = torch.bfloat16,
                    input_size: tuple[int, int] = (224, 224),
                    generator: torch.Generator | None = None,
                    device=None) -> _BackboneClassifier:
    """fc6/fc7 MLP head over VGG16 pool5 (model.py:85-103); ``input_size``
    fixes fc6's width."""
    return _BackboneClassifier(
        VGGFace16(dtype, input_size, generator, device), out_dim,
        (hid_dim, hid_dim), dtype, generator, device)


def ResNet50Classifier(out_dim: int, dtype: torch.dtype = torch.bfloat16,
                       generator: torch.Generator | None = None,
                       device=None) -> _BackboneClassifier:
    """Softmax head over a trainable ResNet50's avg_pool (model.py:106-123).
    """
    return _BackboneClassifier(
        VGGFaceResNet50(dtype=dtype, generator=generator, device=device,
                        trainable=True),
        out_dim, (), dtype, generator, device)


def SENet50Classifier(out_dim: int, dtype: torch.dtype = torch.bfloat16,
                      generator: torch.Generator | None = None,
                      device=None) -> _BackboneClassifier:
    """Softmax head over SENet50 (model.py:126-141)."""
    return _BackboneClassifier(
        SENet50(dtype=dtype, generator=generator, device=device), out_dim,
        (), dtype, generator, device)


class SmallResClassifier(nn.Module):
    """Small conv classifier (model.py:144-176): ``SmallResTower`` at
    feature_dim 512 on ``preprocess.smallres`` pixels, Dropout(0.5), then an
    f32 Dense to ``out_dim``.  ``input_size`` fixes the tower's Dense width.
    ``draw(shape, generator, device)`` gives the classifier dropout's keep
    mask of the (N, 512) ``shape``."""

    def __init__(self, out_dim: int, dtype: torch.dtype = torch.bfloat16,
                 input_size: tuple[int, int] = (48, 48),
                 generator: torch.Generator | None = None, device=None,
                 draw: DrawFn | None = None):
        super().__init__()
        self.tower = SmallResTower(512, dtype, input_size, generator, device)
        self.dense = nn.ModuleList([_make_dense(512, out_dim, generator,
                                                device)])
        self.draw = draw if draw is not None else functools.partial(
            torch_keep, keep=CLASSIFIER_KEEP)

    def logits(self, x: torch.Tensor, *, train: bool = False,
               generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.tower(preprocess.smallres(x), train=train,
                       generator=generator)
        if train:
            keep = torch.as_tensor(self.draw(tuple(h.shape), generator,
                                             h.device), device=h.device)
            h = torch.where(keep.bool(), h / CLASSIFIER_KEEP,
                            torch.zeros_like(h))
        out = self.dense[0]
        return F.linear(h, out.weight, out.bias)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return torch.softmax(self.logits(x, train=train, generator=generator),
                             dim=-1)
