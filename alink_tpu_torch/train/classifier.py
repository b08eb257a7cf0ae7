"""Training steps for single-input identification classifiers (counterpart
of ``alink_tpu/train/classifier.py``).

Reference: ``code/model.py:15-82`` (CustomModel): ``fit`` with
EarlyStopping(min_delta 0.1, patience 5) and validation_split 0.2,
categorical cross-entropy, optional sample weights, and a per-batch
augmentation variant (``trainWithAugmentation``, model.py:41-61).  The
siamese trainer's machinery (``TrainState``, Adadelta, ``EpochLog``,
``_PlateauControl``, ``train/trainer.py``) on (x, y) batches.

Every parameter trains under Adadelta, BN statistics included: the JAX
``_FrozenBN`` holds gamma, beta, mean and var as params and
``create_classifier_state`` puts all params under the optimizer, so the
port's classifiers hold them as ``nn.Parameter``s
(``VGGFaceResNet50(trainable=True)``, ``SENet50``).  A step can drive a
variance below -eps, and its BN then gives NaN, as in JAX.

Shuffles draw from a CPU ``torch.Generator`` (they cannot match
``jax.random``'s); dropout masks from ``dropout_generator``, a generator on
the model's device.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from alink_tpu_torch.train.losses import accuracy, one_hot
from alink_tpu_torch.train.trainer import (EpochLog, TrainState,
                                           _PlateauControl, _as)

_EPS = 1e-7  # Keras backend epsilon


def create_classifier_state(model: nn.Module,
                            learning_rate: float = 1.0) -> TrainState:
    """A ``TrainState`` (Adadelta over every parameter) for a model with
    ``logits(x, train=, generator=)``.  Raises if the model holds a
    parameter that does not require grad or a buffer: the JAX state would
    train it."""
    frozen = ([n for n, p in model.named_parameters() if not p.requires_grad]
              + [n for n, _ in model.named_buffers()])
    if frozen:
        raise ValueError(f"the JAX classifier state trains every tensor; "
                         f"{frozen[:3]} would stay fixed (build the backbone "
                         "trainable)")
    return TrainState(model, learning_rate)


def categorical_crossentropy(logits: torch.Tensor, targets: torch.Tensor,
                             sample_weight: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Keras categorical_crossentropy (model.py:114) from logits.  Weighted:
    Keras 2's ``mean(loss * w)`` corrected for zero-weight rows only (see
    ``losses.binary_crossentropy``), not ``sum(loss * w) / sum(w)``."""
    per_sample = -(targets * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
    if sample_weight is None:
        return per_sample.mean()
    nonzero = (sample_weight != 0).float().mean()
    return (per_sample * sample_weight).mean() / torch.clamp(nonzero,
                                                             min=_EPS)


def classifier_train_step(state: TrainState, x, labels,
                          dropout_generator: torch.Generator | None = None,
                          sample_weight=None
                          ) -> tuple[TrainState, torch.Tensor, torch.Tensor]:
    """One gradient step on (x, labels); the forward runs in train mode, a
    model with dropout drawing its masks from ``dropout_generator``.
    Returns (state, loss, acc)."""
    dev = state.device
    labels = _as(labels, dev)
    logits = state.module.logits(_as(x, dev), train=True,
                                 generator=dropout_generator)
    targets = one_hot(labels, logits.shape[-1])
    sw = None if sample_weight is None else _as(sample_weight, dev)
    loss = categorical_crossentropy(logits, targets, sw)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return state, loss.detach(), accuracy(logits.detach(), targets)


@torch.no_grad()
def classifier_eval_step(state: TrainState, x, labels
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unweighted loss and accuracy on (x, labels)."""
    dev = state.device
    labels = _as(labels, dev)
    logits = state.module.logits(_as(x, dev))
    targets = one_hot(labels, logits.shape[-1])
    return categorical_crossentropy(logits, targets), accuracy(logits,
                                                               targets)


def fit_classifier(state: TrainState, x, labels, *, epochs: int,
                   batch_size: int, generator: torch.Generator | None = None,
                   validation_split: float = 0.2,
                   augment_fn: Callable | None = None,
                   log_fn: Callable[[EpochLog], None] | None = None,
                   dropout_generator: torch.Generator | None = None
                   ) -> tuple[TrainState, list[EpochLog]]:
    """CustomModel.finetune / trainWithoutVal (model.py:33-66): the tail
    ``validation_split`` validates (Keras slices before shuffling, split at
    ``int(n * (1 - split))``), the train rows reshuffle every epoch in
    ``ceil(n_train / batch_size)`` steps (the last may be short), early stop
    and LR drops on val loss.  Shuffles draw from ``generator``;
    ``augment_fn(generator, batch) -> batch`` augments each batch
    (trainWithAugmentation, model.py:41-61)."""
    dev = state.device
    x, labels = _as(x, dev), _as(labels, dev)
    n = labels.shape[0]
    if n == 0:
        raise ValueError("fit_classifier() called with zero examples")
    n_train = int(n * (1.0 - validation_split)) if validation_split else n
    if n_train == 0:
        n_train = n  # degenerate tiny fit: train on all rows, no val
    n_val = n - n_train
    tx, ty = x[:n_train], labels[:n_train]
    vx, vy = x[n_train:], labels[n_train:]
    steps = max(1, -(-n_train // batch_size))
    control = _PlateauControl()
    logs: list[EpochLog] = []
    for epoch in range(epochs):
        perm = torch.randperm(n_train, generator=generator).to(dev)
        tloss = torch.zeros((), device=dev)
        tacc = torch.zeros((), device=dev)
        for s in range(steps):
            idx = perm[s * batch_size:(s + 1) * batch_size]
            bx = tx[idx]
            if augment_fn is not None:
                bx = augment_fn(generator, bx)
            state, loss, acc = classifier_train_step(state, bx, ty[idx],
                                                     dropout_generator)
            tloss += loss
            tacc += acc
        tloss, tacc = float(tloss), float(tacc)
        if n_val:
            vloss, vacc = (float(v) for v in classifier_eval_step(state, vx,
                                                                  vy))
        else:
            vloss, vacc = tloss / steps, tacc / steps
        log = EpochLog(epoch, tloss / steps, tacc / steps, vloss, vacc,
                       state.learning_rate)
        logs.append(log)
        if log_fn:
            log_fn(log)
        state, stop = control.update(state, vloss)
        if stop:
            break
    return state, logs
