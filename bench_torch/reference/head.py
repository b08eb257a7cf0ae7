"""The siamese verification head of A-LINK (the reference's
``SiameseNetwork``): |left - right| -> Dense(512) ReLU -> Dense(64) ReLU
-> Dense(2) softmax, plain float32 (the features enter in the precision
of the arithmetic, as every other operand).  Weights keyed ``hidden.<i>``
and ``out`` as the harness made them."""

from __future__ import annotations

import torch

from bench_torch.reference.numerics import Numerics


def logits(w: dict, left, right, nx: Numerics) -> torch.Tensor:
    x = (nx.q(left) - nx.q(right)).abs()
    i = 0
    while f"hidden.{i}.weight" in w:
        x = torch.relu(nx.linear(x, w[f"hidden.{i}.weight"],
                                 w[f"hidden.{i}.bias"]))
        i += 1
    return nx.linear(x, w["out.weight"], w["out.bias"])


def genuine(w: dict, left, right, nx: Numerics) -> torch.Tensor:
    """P(genuine) per pair."""
    return torch.softmax(logits(w, left, right, nx), dim=-1)[:, 1]
