"""Classical acquisition functions, modAL-style (counterpart of
``alink_tpu/active/uncertainty.py``).

Reference: ``code/uncertainty.py``: the three measures
(``_proba_uncertainty/_proba_margin/_proba_entropy``, :15-60) and their
sampling wrappers (:133-216) used by the ``existing_al*.py`` baselines.
Pure batched functions over (N, C) probability tensors; the sampling
functions return indices (the reference's wrappers return pair queries
built from ``X[0]`` twice, uncertainty.py:159, a latent bug).  Ties go to
the lower index, as ``lax.top_k`` orders them: saturated probabilities tie
often.
"""

from __future__ import annotations

import torch

from alink_tpu_torch.ops.pairwise import _topk_stable


def classifier_uncertainty(probs: torch.Tensor) -> torch.Tensor:
    """1 - max class probability (uncertainty.py:15-25, 63-83)."""
    return 1.0 - torch.amax(probs, dim=-1)


def classifier_margin(probs: torch.Tensor) -> torch.Tensor:
    """Top-1 minus top-2 probability (uncertainty.py:28-43, 86-106)."""
    top2 = torch.topk(probs, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def classifier_entropy(probs: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of the class distribution (uncertainty.py:46-60)."""
    p = torch.clamp(probs, 1e-12, 1.0)
    return -torch.sum(p * torch.log(p), dim=-1)


def _multi_argmax(values: torch.Tensor, n_instances: int) -> torch.Tensor:
    """Indices of the n largest values, ties to the lower index (modAL
    utils.selection semantics, in ``lax.top_k``'s order)."""
    return _topk_stable(values, n_instances)[1]


def uncertainty_sampling(probs: torch.Tensor,
                         n_instances: int = 1) -> torch.Tensor:
    """Most-uncertain indices (uncertainty.py:133-159)."""
    return _multi_argmax(classifier_uncertainty(probs), n_instances)


def margin_sampling(probs: torch.Tensor, n_instances: int = 1) -> torch.Tensor:
    """Smallest-margin indices (uncertainty.py:162-187)."""
    return _multi_argmax(-classifier_margin(probs), n_instances)


def entropy_sampling(probs: torch.Tensor, n_instances: int = 1) -> torch.Tensor:
    """Highest-entropy indices (uncertainty.py:190-216)."""
    return _multi_argmax(classifier_entropy(probs), n_instances)


STRATEGIES = {
    "uncertainty_sampling": uncertainty_sampling,
    "margin_sampling": margin_sampling,
    "entropy_sampling": entropy_sampling,
}


def get_strategy(name: str):
    """Strategy dispatch mirroring existing_al.py:43-49."""
    try:
        return STRATEGIES[name]
    except KeyError:
        raise NotImplementedError(f"unknown query strategy {name}") from None
