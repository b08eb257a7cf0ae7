"""The M1 committee over stacked parameters (counterpart of
``alink_tpu/active/committee.py``).

The members' parameters live in one dict of (E, ...) tensors; prediction
is one ``vmap(functional_call)`` over the member axis.  ``attack_model``
fans the noise bank over a raw pair batch.  The model-backed channels
("adversarial", the one-pixel DE attack, and "fgsm") are not ported yet:
asking for one raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.func import functional_call, vmap

from alink_tpu_torch.ops import noise as noise_ops
from alink_tpu_torch.ops.image import resize

MODEL_CHANNELS = ("adversarial", "fgsm")
NOT_PORTED = ("the {} noise channel needs ops/de.py and ops/attack.py, which "
              "are not ported yet (ROADMAP.md, queue item 1: the A2 channel)")


def stack_params(param_dicts: Sequence[dict]) -> dict:
    """E per-member {name: tensor} -> {name: (E, ...)}."""
    return {k: torch.stack([d[k].detach() for d in param_dicts])
            for k in param_dicts[0]}


def unstack_params(stacked: dict, index: int) -> dict:
    """Member ``index`` of a stacked dict."""
    return {k: v[index].detach() for k, v in stacked.items()}


def check_noise_names(names: Sequence[str]) -> None:
    """Raise for a channel the port cannot run yet."""
    # Divergence: the DE one-pixel channel (and FGSM) is not available yet.
    for name in names:
        if name in MODEL_CHANNELS:
            raise NotImplementedError(NOT_PORTED.format(repr(name)))


class Committee:
    """Ensemble of siamese heads (``Bagging``).

    Args:
        head: a module of the members' architecture (its own parameters are
            not used).
        stacked_params: {name: (E, ...)} of ``head``.
        noise_names: the noise bank, in order.
    """

    def __init__(self, head: nn.Module, stacked_params: dict,
                 noise_names: Sequence[str] = ()):
        self.head = head
        self.params = {k: v.detach() for k, v in stacked_params.items()}
        self.noise_names = tuple(noise_names)

    @classmethod
    def from_param_list(cls, head, param_dicts, noise_names=()):
        return cls(head, stack_params(param_dicts), noise_names)

    @property
    def num_members(self) -> int:
        return next(iter(self.params.values())).shape[0]

    @torch.no_grad()
    def member_probs(self, left: torch.Tensor,
                     right: torch.Tensor) -> torch.Tensor:
        """(E, N, 2) per-member probabilities."""
        return vmap(lambda p: functional_call(self.head, p, (left, right)))(
            self.params)

    def predict(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        """Mean member probabilities, (N, 2)."""
        return self.member_probs(left, right).mean(dim=0)

    @torch.no_grad()
    def attack_model(self, g: torch.Generator, left: torch.Tensor,
                     right: torch.Tensor, target_res: tuple[int, int]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """The noise bank over a raw pair batch: (K, N, h, w, C) left and
        right stacks resized to ``target_res`` = (h, w), channels in
        ``noise_names`` order; a same-resolution target skips the resize."""
        check_noise_names(self.noise_names)
        ls, rs = noise_ops.apply_noise_bank(self.noise_names, g, left, right)
        if tuple(target_res) == tuple(ls.shape[2:4]):
            return ls, rs
        k, n = ls.shape[:2]
        rl = resize(ls.reshape((k * n,) + ls.shape[2:]), target_res)
        rr = resize(rs.reshape((k * n,) + rs.shape[2:]), target_res)
        return (rl.reshape((k, n) + rl.shape[1:]),
                rr.reshape((k, n) + rr.shape[1:]))
