"""Training steps and host-side epoch control with Keras semantics
(counterpart of ``alink_tpu/train/trainer.py``).

- optimizer: Adadelta (rho 0.95, eps 1e-8; ``torch.optim.Adadelta`` keeps
  optax's two accumulators and update order), with a live learning rate for
  ReduceLROnPlateau;
- ``fit``: Keras ``model.fit`` for the finetune: validation from the tail,
  ceil steps, EarlyStopping(min_delta 0.1, patience 5) and
  ReduceLROnPlateau(0.2, patience 5, min 0.01) on val_loss;
- ``custom_train``: ``customTrainModel``: per-batch random train/val split,
  class-weighted steps, running epoch means;
- ``test_accuracy``: all-pairs accuracy through ``ops.pairwise.score_matrix``
  (kernel K1 on CUDA tensors).

A ``TrainState`` holds a module and its optimizer and is updated in place
(the JAX state is immutable and returned anew; the port returns the same
object so call sites read alike).  Shuffles draw from a CPU
``torch.Generator``; they cannot match ``jax.random``'s.

Dropout (the SmallRes student's) is on only in ``train_step``'s forward:
a module whose ``logits`` takes ``train`` gets ``train=True`` and
``dropout_generator``, a generator on the module's device; ``eval_step``
and every predict path run deterministically.  A module without dropout
(``SiameseHead``) is called exactly as before.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch
from torch import nn

from alink_tpu_torch.train.losses import (accuracy, binary_crossentropy,
                                          class_weights_from_labels, one_hot)

RHO = 0.95
EPS = 1e-8


def adadelta(params, learning_rate: float) -> torch.optim.Adadelta:
    """Keras-default Adadelta over ``params``."""
    return torch.optim.Adadelta(params, lr=learning_rate, rho=RHO, eps=EPS)


class _OptimizerState:
    """Learning-rate access shared by the single and the stacked states."""

    optimizer: torch.optim.Optimizer
    step: int

    @property
    def learning_rate(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def with_learning_rate(self, lr: float):
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)
        return self


class TrainState(_OptimizerState):
    """A siamese model (with a ``logits(left, right)`` method) + Adadelta."""

    def __init__(self, module: nn.Module, learning_rate: float = 1.0):
        self.module = module
        self.optimizer = adadelta(module.parameters(), learning_rate)
        self.step = 0

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def logits(self, left: torch.Tensor, right: torch.Tensor, *,
               train: bool = False,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """The module's logits; ``train=True`` turns on the dropout of a
        module that has it, its masks drawn from ``generator``."""
        if train and _takes_train(self.module):
            return self.module.logits(left, right, train=True,
                                      generator=generator)
        return self.module.logits(left, right)


def _takes_train(module: nn.Module) -> bool:
    return "train" in inspect.signature(module.logits).parameters


def _as(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device)


def train_step(state: TrainState, left, right, labels, weighted: bool = True,
               dropout_generator: torch.Generator | None = None
               ) -> tuple[TrainState, torch.Tensor, torch.Tensor]:
    """One gradient step; ``labels`` (N,) int.  Returns (state, loss, acc).
    ``weighted`` applies the customTrainModel class weights; ``fit`` (the
    finetune) passes none.  The forward runs in train mode: a module with
    dropout draws its masks from ``dropout_generator``."""
    dev = state.device
    labels = _as(labels, dev)
    targets = one_hot(labels)
    sw = class_weights_from_labels(labels) if weighted else None
    logits = state.logits(_as(left, dev), _as(right, dev), train=True,
                          generator=dropout_generator)
    loss = binary_crossentropy(logits, targets, sw)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return state, loss.detach(), accuracy(logits.detach(), targets)


@torch.no_grad()
def eval_step(state: TrainState, left, right, labels
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unweighted loss and accuracy (test_on_batch)."""
    dev = state.device
    targets = one_hot(_as(labels, dev))
    logits = state.logits(_as(left, dev), _as(right, dev))
    return binary_crossentropy(logits, targets), accuracy(logits, targets)


class EpochLog(NamedTuple):
    epoch: int
    train_loss: float
    train_acc: float
    val_loss: float
    val_acc: float
    learning_rate: float


@dataclasses.dataclass
class _PlateauControl:
    """EarlyStopping + ReduceLROnPlateau on val_loss, each with its own best
    (Keras instantiates them separately): EarlyStopping moves its best only
    on an improvement of more than ``min_delta``; ReduceLROnPlateau rescales
    the LR by ``factor`` after ``patience`` stalled epochs, floored at
    ``min_lr``."""

    min_delta: float = 0.1
    es_patience: int = 5
    lr_patience: int = 5
    factor: float = 0.2
    min_lr: float = 0.01

    best_es: float = float("inf")
    best_lr: float = float("inf")
    es_wait: int = 0
    lr_wait: int = 0
    _LR_MIN_DELTA = 1e-4  # Keras ReduceLROnPlateau default

    def update(self, state, val_loss: float):
        if val_loss < self.best_es - self.min_delta:
            self.best_es = val_loss
            self.es_wait = 0
        else:
            self.es_wait += 1
        if val_loss < self.best_lr - self._LR_MIN_DELTA:
            self.best_lr = val_loss
            self.lr_wait = 0
        else:
            self.lr_wait += 1
            if self.lr_wait >= self.lr_patience:
                new_lr = max(state.learning_rate * self.factor, self.min_lr)
                if new_lr < state.learning_rate:
                    state = state.with_learning_rate(new_lr)
                self.lr_wait = 0
        return state, self.es_wait >= self.es_patience


def fit(state: TrainState, left, right, labels, *, epochs: int,
        batch_size: int, generator: torch.Generator | None = None,
        validation_split: float = 0.2, weighted: bool = False,
        log_fn: Callable[[EpochLog], None] | None = None,
        dropout_generator: torch.Generator | None = None
        ) -> tuple[TrainState, list[EpochLog]]:
    """Keras ``model.fit`` for the finetune: the tail ``validation_split``
    is the validation set (Keras slices before shuffling); the train rows
    reshuffle every epoch, the last batch may be short.  Shuffles draw
    from ``generator``, dropout masks from ``dropout_generator``."""
    dev = state.device
    left, right, labels = _as(left, dev), _as(right, dev), _as(labels, dev)
    n = labels.shape[0]
    if n == 0:
        raise ValueError("fit() called with zero examples")
    n_train = int(n * (1.0 - validation_split)) if validation_split else n
    if n_train == 0:
        # Everything would be validation: train on all rows, skip it.
        n_train = n
    n_val = n - n_train
    tl, tr, ty = left[:n_train], right[:n_train], labels[:n_train]
    vl, vr, vy = left[n_train:], right[n_train:], labels[n_train:]
    steps = max(1, -(-n_train // batch_size))
    control = _PlateauControl()
    logs: list[EpochLog] = []
    for epoch in range(epochs):
        perm = torch.randperm(n_train, generator=generator).to(dev)
        tloss = torch.zeros((), device=dev)
        tacc = torch.zeros((), device=dev)
        for s in range(steps):
            idx = perm[s * batch_size:(s + 1) * batch_size]
            state, loss, acc = train_step(state, tl[idx], tr[idx], ty[idx],
                                          weighted=weighted,
                                          dropout_generator=dropout_generator)
            tloss += loss
            tacc += acc
        tloss, tacc = float(tloss), float(tacc)
        if n_val:
            vloss, vacc = (float(v) for v in eval_step(state, vl, vr, vy))
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


def custom_train(state: TrainState,
                 data_iter: Iterator[tuple[tuple, np.ndarray]], *,
                 epochs: int, batch_size: int,
                 generator: torch.Generator | None = None,
                 val_ratio: float = 0.2, n_steps: int = 320000,
                 preprocess: Callable | None = None,
                 log_fn: Callable[[EpochLog], None] | None = None,
                 dropout_generator: torch.Generator | None = None
                 ) -> tuple[TrainState, list[EpochLog]]:
    """``customTrainModel``: ``int(n_steps / batch_size)`` batches per
    epoch; per batch a random ``val_ratio`` split, a class-weighted step on
    the rest and an unweighted evaluation of the held-out part.  Splits
    draw from ``generator``, dropout masks from ``dropout_generator``."""
    dev = state.device
    steps_per_epoch = int(n_steps / batch_size)
    logs: list[EpochLog] = []
    for eno in range(epochs):
        sums = torch.zeros(4, device=dev)   # tloss, tacc, vloss, vacc
        for _ in range(steps_per_epoch):
            (xl, xr), y = next(data_iter)
            if preprocess is not None:
                xl, xr = preprocess(xl), preprocess(xr)
            xl, xr, y = _as(xl, dev), _as(xr, dev), _as(y, dev)
            perm = torch.randperm(y.shape[0], generator=generator).to(dev)
            split = int(y.shape[0] * val_ratio)
            tr_idx, va_idx = perm[split:], perm[:split]
            state, loss, acc = train_step(
                state, xl[tr_idx], xr[tr_idx], y[tr_idx], weighted=True,
                dropout_generator=dropout_generator)
            sums[0] += loss
            sums[1] += acc
            if split:
                vl, va = eval_step(state, xl[va_idx], xr[va_idx], y[va_idx])
                sums[2] += vl
                sums[3] += va
        m = (sums / steps_per_epoch).tolist()
        log = EpochLog(eno, m[0], m[1], m[2], m[3], state.learning_rate)
        logs.append(log)
        if log_fn:
            log_fn(log)
    return state, logs


@torch.no_grad()
def test_accuracy(state: TrainState, feats, labels) -> float:
    """All-pairs verification accuracy (``testAccuracy``): one score-matrix
    pass (kernel K1 on CUDA) against the label outer product."""
    from alink_tpu_torch.ops.pairwise import score_matrix

    dev = state.device
    feats, labels = _as(feats, dev).float(), _as(labels, dev)
    pred = score_matrix(state.module, feats, feats) > 0.5
    same = labels[:, None] == labels[None, :]
    return float((pred == same).float().mean())
