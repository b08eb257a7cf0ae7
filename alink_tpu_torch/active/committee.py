"""The M1 committee over stacked parameters (counterpart of
``alink_tpu/active/committee.py``).

The members' parameters live in one dict of (E, ...) tensors; prediction
is one ``vmap(functional_call)`` over the member axis.  ``attack_model``
fans the noise bank over a raw pair batch; its model channels, the
one-pixel DE attack ("adversarial") and "fgsm", attack the live student
through an end-to-end predict function.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn
from torch.func import functional_call, vmap

from alink_tpu_torch.ops import attack as attack_ops
from alink_tpu_torch.ops import noise as noise_ops
from alink_tpu_torch.ops.image import resize
from alink_tpu_torch.utils.profiling import count, span

MODEL_CHANNELS = ("adversarial", "fgsm")


def stack_params(param_dicts: Sequence[dict]) -> dict:
    """E per-member {name: tensor} -> {name: (E, ...)}."""
    return {k: torch.stack([d[k].detach() for d in param_dicts])
            for k in param_dicts[0]}


def unstack_params(stacked: dict, index: int) -> dict:
    """Member ``index`` of a stacked dict."""
    return {k: v[index].detach() for k, v in stacked.items()}


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

    def member_params(self, index: int) -> dict:
        """Member ``index``'s {name: tensor}."""
        return unstack_params(self.params, index)

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
                     right: torch.Tensor, target_res: tuple[int, int],
                     m1_labels: torch.Tensor | None = None,
                     adversarial_predict: Callable | None = None,
                     adversarial_params=None,
                     adversarial_kwargs: dict | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """The noise bank over a raw pair batch: (K, N, h, w, C) left and
        right stacks resized to ``target_res`` = (h, w), channels in
        ``noise_names`` order; a same-resolution target skips the resize.

        The model channels need the student's end-to-end ``(params, left,
        right) -> (N, 2)`` probabilities as ``adversarial_predict``, its
        live state as ``adversarial_params`` and the committee's one-hot
        ``m1_labels``.  ``adversarial_kwargs`` go to the one-pixel attack;
        ``proxy_hw`` among them selects its low-resolution surrogate.  The
        plain channels draw from ``g`` first, then the DE attack.

        Spans ``noise.plain``, ``noise.adversarial``, ``noise.fgsm`` and
        ``noise.resize``; the counter ``noise.pairs``."""
        count("noise.pairs", left.shape[0])
        plain = tuple(n for n in self.noise_names if n not in MODEL_CHANNELS)
        by_name = {}
        if plain:
            with span("noise.plain"):
                ls, rs = noise_ops.apply_noise_bank(plain, g, left, right)
            by_name = {n: (ls[i], rs[i]) for i, n in enumerate(plain)}
        outs = []
        for name in self.noise_names:
            if name not in MODEL_CHANNELS:
                outs.append(by_name[name])
                continue
            if adversarial_predict is None or m1_labels is None:
                raise ValueError(f"{name} channel requires adversarial_predict "
                                 "and m1_labels")
            if name == "adversarial":
                akw = dict(adversarial_kwargs or {})
                attack = (attack_ops.one_pixel_attack_pairs_proxy
                          if "proxy_hw" in akw
                          else attack_ops.one_pixel_attack_pairs)
                with span("noise.adversarial"):
                    outs.append(attack(adversarial_predict,
                                       adversarial_params, left, right,
                                       m1_labels, g, **akw))
            else:
                with span("noise.fgsm"):
                    outs.append(attack_ops.fgsm_pairs(
                        adversarial_predict, adversarial_params, left, right,
                        m1_labels))
        ls = torch.stack([o[0].float() for o in outs])
        rs = torch.stack([o[1].float() for o in outs])
        if tuple(target_res) == tuple(ls.shape[2:4]):
            return ls, rs
        with span("noise.resize"):
            k, n = ls.shape[:2]
            rl = resize(ls.reshape((k * n,) + ls.shape[2:]), target_res)
            rr = resize(rs.reshape((k * n,) + rs.shape[2:]), target_res)
            return (rl.reshape((k, n) + rl.shape[1:]),
                    rr.reshape((k, n) + rr.shape[1:]))
