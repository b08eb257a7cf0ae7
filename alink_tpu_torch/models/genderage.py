"""Gender/age estimation (counterpart of ``alink_tpu/models/genderage.py``).

The genderage output is a flat 202-d vector: gender is the argmax of its
first two units, age the sum of the argmaxes of the other 200 taken as
(100, 2) pairs (the InsightFace convention).

- ``GenderAgeResNet50``: the full model, the LResNet50E trunk of the
  recognition zoo ending in a raw (unnormalised) 202-d fc1;
- ``GenderAgeHead``: a light head over embeddings already computed, so one
  trunk forward serves both tasks;
- ``decode_ga``: the decoding.
"""

from __future__ import annotations

import torch
from torch import nn

from alink_tpu_torch.models.arcface import ArcFaceResNet100
from alink_tpu_torch.models.resnet import _dense, _make_dense


def GenderAgeResNet50(**kwargs) -> ArcFaceResNet100:
    """LResNet50E trunk to a raw 202-d fc1 output; feed aligned 112x112
    chips."""
    kwargs.setdefault("stage_sizes", (3, 4, 14, 3))
    return ArcFaceResNet100(embedding_dim=202, normalize=False, **kwargs)


class GenderAgeHead(nn.Module):
    """(N, in_features) embeddings -> (N, 202): Dense(hidden) in ``dtype``,
    relu, Dense(202) in f32 (the JAX module infers ``in_features``)."""

    def __init__(self, in_features: int = 512, hidden: int = 256,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.ModuleList([
            _make_dense(in_features, hidden, generator, device),
            _make_dense(hidden, 202, generator, device)])

    def forward(self, embeddings: torch.Tensor) -> torch.Tensor:
        x = torch.relu(_dense(embeddings, self.dense[0], self.dtype))
        return _dense(x.float(), self.dense[1], torch.float32)


def decode_ga(output: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, 202) -> (gender (N,) in {0, 1}, age (N,) in 0..100); ties go to
    the first unit, as ``jnp.argmax``."""
    gender = torch.argmax(output[:, 0:2], dim=-1)
    age = torch.argmax(output[:, 2:202].reshape(-1, 100, 2), dim=-1).sum(-1)
    return gender, age
