"""Disparity selection and the oracle gate as masked tensor computation
(counterpart of ``alink_tpu/active/selection.py``, the reference's
ALINK.py:171-204).

1. per noise channel, compare the student's P(genuine) under that noise
   with the committee's clean P(genuine): keep the top ``disparity_ratio``
   fraction by |c1 - c2| (or, ``blind_strategy``, the pairs whose 0.5
   decisions differ);
2. intersect the per-noise masks;
3. oracle gate: a selected pair outside the grey band (0.5 +- eps) charges
   one query, and joins the training queue only if the committee agrees
   with the oracle's label.

Both argsorts are stable (``jnp.argsort`` is; ``torch.argsort`` is not by
default), so ties rank by index as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SelectionResult(NamedTuple):
    selected: torch.Tensor        # (N,) bool — survived every channel
    queried: torch.Tensor         # (N,) bool — selected, gated, agreed
    oracle_charges: torch.Tensor  # () int — ACTIVE_COUNT increment
    pseudo_labels: torch.Tensor   # (N,) int — committee decision


def disparity_masks(student_probs: torch.Tensor,
                    committee_probs: torch.Tensor, disparity_ratio: float,
                    blind_strategy: bool, valid: torch.Tensor | None = None,
                    k_take: int | torch.Tensor | None = None) -> torch.Tensor:
    """(K, N) student and (N,) committee probabilities -> (K, N) bool.

    ``valid``: (N,) bool, False rows are padding and never selected; the
    take count is then ``k_take`` (pass the host-exact ``int(n * ratio)``),
    or floor(valid count * ratio) in f32.  Without ``valid`` the take count
    is ``int(N * ratio)`` and ``k_take`` is ignored, as in the JAX package.
    """
    c2 = committee_probs[None, :]
    if blind_strategy:
        m = (student_probs >= 0.5) != (c2 >= 0.5)
        return m if valid is None else m & valid[None, :]
    n = student_probs.shape[1]
    disparity = (student_probs - c2).abs()
    if valid is None:
        k_take = int(n * disparity_ratio)
    else:
        if k_take is None:
            k_take = (valid.sum().float() * disparity_ratio).int()
        disparity = torch.where(valid[None, :], disparity, -torch.inf)
    order = torch.argsort(-disparity, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    return ranks < k_take


def intersect_masks(masks: torch.Tensor) -> torch.Tensor:
    """All-noise intersection: (K, N) -> (N,)."""
    return masks.all(dim=0)


def oracle_gate(selected: torch.Tensor, committee_probs: torch.Tensor,
                oracle_labels: torch.Tensor, eps: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Grey-band gate + pseudo-oracle agreement: (queried, charges)."""
    confident = (committee_probs <= 0.5 - eps) | (committee_probs >= 0.5 + eps)
    charged = selected & confident
    agree = (committee_probs >= 0.5) == (oracle_labels >= 0.5)
    return charged & agree, charged.sum()


def select_queries(student_probs: torch.Tensor, committee_probs: torch.Tensor,
                   oracle_labels: torch.Tensor, *, disparity_ratio: float,
                   blind_strategy: bool, eps: float,
                   valid: torch.Tensor | None = None,
                   k_take: int | torch.Tensor | None = None
                   ) -> SelectionResult:
    """The whole selection block; see ``disparity_masks`` for ``valid`` and
    ``k_take``."""
    masks = disparity_masks(student_probs, committee_probs, disparity_ratio,
                            blind_strategy, valid=valid, k_take=k_take)
    selected = intersect_masks(masks)
    queried, charges = oracle_gate(selected, committee_probs, oracle_labels,
                                   eps)
    pseudo = (committee_probs >= 0.5).int()
    return SelectionResult(selected, queried, charges, pseudo)
