"""Keras loss and metric semantics (counterpart of
``alink_tpu/train/losses.py``).

``binary_crossentropy`` is Keras' BCE over a 2-class softmax and one-hot
targets: the mean of the per-class terms ``y log p + (1 - y) log(1 - p)``,
not categorical cross-entropy.  Class weights follow ``customTrainModel``:
inversely proportional to each class's batch count, normalised to sum to 1.
Every function reduces over the last axis only, so a leading member axis
(the committee's (E, B, ...) batches) gives one value per member.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-7  # Keras backend epsilon


def binary_crossentropy(logits: torch.Tensor, targets: torch.Tensor,
                        sample_weight: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """(..., N, 2) logits, one-hot targets, optional (..., N) weights ->
    (...) mean loss.  Weighted: Keras 2's ``mean(loss * w)`` corrected only
    for zero-weight rows (not ``sum(loss * w) / sum(w)``)."""
    p = torch.clamp(torch.softmax(logits, dim=-1), _EPS, 1.0 - _EPS)
    bce = -(targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p))
    per_sample = bce.mean(dim=-1)
    if sample_weight is None:
        return per_sample.mean(dim=-1)
    nonzero = (sample_weight != 0).float().mean(dim=-1)
    return (per_sample * sample_weight).mean(dim=-1) / torch.clamp(nonzero,
                                                                   min=_EPS)


def accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Keras 'accuracy': argmax agreement with one-hot targets, (...)."""
    return (logits.argmax(dim=-1) == targets.argmax(dim=-1)).float().mean(
        dim=-1)


def class_weights_from_labels(labels: torch.Tensor) -> torch.Tensor:
    """(..., N) int {0, 1} -> (..., N) weights w_c = (N / n_c) / (w_0 + w_1).
    A single-class batch counts as balanced: the absent class takes the
    present one's weight (an n/1 guard weight would shrink the step)."""
    n = labels.shape[-1]
    n1 = (labels == 1).sum(dim=-1, keepdim=True)
    n0 = n - n1
    w1 = n / torch.clamp(n1, min=1).float()
    w0 = n / torch.clamp(n0, min=1).float()
    w1 = torch.where(n1 > 0, w1, w0)
    w0 = torch.where(n0 > 0, w0, w1)
    scale = w0 + w1
    return torch.where(labels == 1, w1 / scale, w0 / scale)


def one_hot(labels: torch.Tensor, num_classes: int = 2) -> torch.Tensor:
    """to_categorical: (...,) int -> (..., num_classes) f32."""
    return F.one_hot(labels.long(), num_classes).float()
