"""The committee trained as one program over stacked parameters
(counterpart of ``alink_tpu/train/ensemble.py``).

The E members' parameters carry a leading member axis
(``torch.func.stack_module_state``); the forward is one
``vmap(functional_call)``, the members' losses are summed for one backward
(a member's loss depends only on its own slice, so each slice receives its
own gradient) and one Adadelta steps all of them (Adadelta is elementwise,
so that is each member's own update).  Each step draws E batches from the
shared stream, member m training on batch m, as in the JAX package.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, stack_module_state, vmap

from alink_tpu_torch.train.losses import (accuracy, binary_crossentropy,
                                          class_weights_from_labels, one_hot)
from alink_tpu_torch.train.trainer import _as, _OptimizerState, adadelta


class _Logits(nn.Module):
    """``head.logits`` as a forward, for ``functional_call``."""

    def __init__(self, head: nn.Module):
        super().__init__()
        self.head = head

    def forward(self, left, right):
        return self.head.logits(left, right)


def stacked_logits(head: nn.Module, params: dict, left: torch.Tensor,
                   right: torch.Tensor) -> torch.Tensor:
    """Member logits.  ``params``: {name: (E, ...)} of ``head``; ``left`` and
    ``right``: (E, B, D) per-member batches -> (E, B, 2)."""
    view = _Logits(head)
    named = {f"head.{k}": v for k, v in params.items()}
    return vmap(lambda p, le, ri: functional_call(view, p, (le, ri)))(
        named, left, right)


class EnsembleState(_OptimizerState):
    """Stacked member parameters {name: (E, ...)} + one Adadelta."""

    def __init__(self, head: nn.Module, params: dict,
                 learning_rate: float = 0.1):
        self.head = head
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.optimizer = adadelta(list(self.params.values()), learning_rate)
        self.step = 0

    @property
    def num_members(self) -> int:
        return next(iter(self.params.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def logits(self, left, right) -> torch.Tensor:
        return stacked_logits(self.head, self.params, left, right)


def create_ensemble_state(heads: list[nn.Module],
                          learning_rate: float = 0.1) -> EnsembleState:
    """Stack independently initialised members (same architecture)."""
    params, _ = stack_module_state(heads)
    return EnsembleState(heads[0], params, learning_rate)


def ensemble_train_step(state: EnsembleState, left, right, labels, *,
                        weighted: bool = True
                        ) -> tuple[EnsembleState, torch.Tensor, torch.Tensor]:
    """One step for all members: ``left``/``right`` (E, B, D), ``labels``
    (E, B).  Returns per-member (loss, acc) of shape (E,)."""
    dev = state.device
    labels = _as(labels, dev)
    targets = one_hot(labels)
    sw = class_weights_from_labels(labels) if weighted else None
    logits = state.logits(_as(left, dev), _as(right, dev))
    losses = binary_crossentropy(logits, targets, sw)
    state.optimizer.zero_grad(set_to_none=True)
    losses.sum().backward()
    state.optimizer.step()
    state.step += 1
    return state, losses.detach(), accuracy(logits.detach(), targets)


def train_ensemble(state: EnsembleState, data_iter: Iterator, *, epochs: int,
                   batch_size: int, n_steps: int = 320000
                   ) -> tuple[EnsembleState, list]:
    """customTrainModel-style epochs for the whole committee at once."""
    e = state.num_members
    steps_per_epoch = int(n_steps / batch_size)
    logs = []
    for _ in range(epochs):
        tl = torch.zeros(e, device=state.device)
        ta = torch.zeros(e, device=state.device)
        for _ in range(steps_per_epoch):
            draws = [next(data_iter) for _ in range(e)]
            state, loss, acc = ensemble_train_step(
                state, np.stack([d[0][0] for d in draws]),
                np.stack([d[0][1] for d in draws]),
                np.stack([d[1] for d in draws]))
            tl += loss
            ta += acc
        logs.append({"loss": (tl / steps_per_epoch).tolist(),
                     "acc": (ta / steps_per_epoch).tolist()})
    return state, logs
