"""Estimator-agnostic active learners over train states (counterpart of
``alink_tpu/active/learners.py``).

Reference: the modAL fork in ``code/base.py`` (BaseLearner: training-data
accumulation, fit/predict/query/teach, :23-213) and ``code/learners.py``
(ActiveLearner.teach with ``only_new``, :81-99; query-by-committee with
vote/consensus, :239-416), adapted to pair data ``(left, right, y)``.  The
reference's Keras adapter (``code/keras_wrapper.py``) is not needed: a
``train.TrainState`` is the estimator.

The state is trained in place (``train.fit``), as the port's trainer does;
shuffles draw from ``generator`` (CPU), which cannot match ``jax.random``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from alink_tpu_torch import train as T
from alink_tpu_torch.active.uncertainty import uncertainty_sampling
from alink_tpu_torch.evaluation.roc import to_numpy
from alink_tpu_torch.ops.pairwise import _topk_stable


class ActiveLearner:
    """Pool-based active learner (base.py:23-213 + learners.py:15-105).

    Args:
        state: a ``train.TrainState`` for a siamese model.
        query_strategy: ``(probs, n_instances) -> indices`` (the sampling
            functions of ``active.uncertainty``).
        generator: the shuffles of every (re)fit.
        dropout_generator: the dropout masks of every (re)fit, on the
            state's device (needed by a student with dropout, SmallRes).
        fit_kwargs: forwarded to ``train.fit`` on every (re)fit.
    """

    def __init__(self, state: T.TrainState,
                 query_strategy: Callable = uncertainty_sampling, *,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None,
                 **fit_kwargs):
        self.state = state
        self.query_strategy = query_strategy
        self.generator = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        self.dropout_generator = dropout_generator
        self.fit_kwargs = dict(fit_kwargs)
        self._left = None
        self._right = None
        self._y = None

    # -- training-data bookkeeping (base.py:62-128) --

    def _add_training_data(self, left, right, y):
        left, right, y = to_numpy(left), to_numpy(right), to_numpy(y)
        if self._y is None:
            self._left, self._right, self._y = left, right, y
        else:
            self._left = np.concatenate([self._left, left])
            self._right = np.concatenate([self._right, right])
            self._y = np.concatenate([self._y, y])

    def fit(self, left, right, y, **overrides):
        """Fit on exactly the given data (base.py:131-151)."""
        self._left, self._right, self._y = (to_numpy(left), to_numpy(right),
                                            to_numpy(y))
        return self._fit(left, right, y, **overrides)

    def _fit(self, left, right, y, **overrides):
        kwargs = {**self.fit_kwargs, **overrides}
        kwargs.setdefault("epochs", 1)
        kwargs.setdefault("batch_size", min(64, len(to_numpy(y))))
        dev = self.state.device
        self.state, logs = T.fit(
            self.state, torch.as_tensor(to_numpy(left), device=dev),
            torch.as_tensor(to_numpy(right), device=dev),
            torch.as_tensor(to_numpy(y), device=dev),
            generator=self.generator,
            dropout_generator=self.dropout_generator, **kwargs)
        return logs

    def teach(self, left, right, y, only_new: bool = False, **overrides):
        """Add data and refit (learners.py:81-99).  ``only_new=True`` fits
        on just the new samples (the baseline's usage, existing_al.py:117)."""
        self._add_training_data(left, right, y)
        if only_new:
            return self._fit(left, right, y, **overrides)
        return self._fit(self._left, self._right, self._y, **overrides)

    # -- inference (base.py:154-176) --

    @torch.no_grad()
    def predict_logits(self, left, right) -> torch.Tensor:
        """Raw pre-softmax outputs."""
        dev = self.state.device
        return self.state.logits(torch.as_tensor(to_numpy(left), device=dev),
                                 torch.as_tensor(to_numpy(right), device=dev))

    def predict_proba(self, left, right) -> torch.Tensor:
        """Class probabilities: the modAL/sklearn predict_proba contract
        (base.py:154-176), what the acquisition functions consume."""
        return torch.softmax(self.predict_logits(left, right), dim=-1)

    def predict(self, left, right) -> torch.Tensor:
        return torch.argmax(self.predict_logits(left, right), dim=-1)

    def score(self, left, right, y) -> float:
        pred = self.predict(left, right)
        y = torch.as_tensor(to_numpy(y), device=pred.device)
        return float((pred == y).float().mean())

    # -- querying (base.py:179-195) --

    def query(self, left, right, n_instances: int = 1) -> np.ndarray:
        probs = self.predict_proba(left, right)
        return to_numpy(self.query_strategy(probs, n_instances))


class BayesianOptimizer(ActiveLearner):
    """Pool-based Bayesian optimisation (learners.py:108-230).

    Tracks the best (X, y) seen and queries by an acquisition function over
    the predictions; only max-score acquisition is exercised in the
    reference.  ``query_strategy`` maps ``(probs, n_instances) ->
    indices``; the default takes the highest predicted genuine scores.
    """

    def __init__(self, state, query_strategy=None, **kwargs):
        if query_strategy is None:
            def query_strategy(probs, n):  # max predicted score (greedy EI)
                return _topk_stable(probs[:, 1], n)[1]
        super().__init__(state, query_strategy, **kwargs)
        self.X_max = None
        self.y_max = -np.inf

    def _record_max(self, left, right, y):
        y = to_numpy(y)
        if y.size and float(y.max()) > self.y_max:
            i = int(np.argmax(y))
            self.y_max = float(y.max())
            self.X_max = (to_numpy(left)[i], to_numpy(right)[i])

    def fit(self, left, right, y, **overrides):
        logs = super().fit(left, right, y, **overrides)
        self._record_max(left, right, y)
        return logs

    def teach(self, left, right, y, only_new: bool = False, **overrides):
        logs = super().teach(left, right, y, only_new=only_new, **overrides)
        self._record_max(left, right, y)
        return logs

    def get_max(self):
        """Best observation so far (learners.py get_max)."""
        return self.X_max, self.y_max


class CommitteeRegressor:
    """Query-by-committee for regressors (learners.py:419-505).

    Members are ``(params, predict_fn)`` pairs over pair inputs, ``fn(params,
    left, right) -> (N,)``; consensus is the member mean, disagreement the
    member standard deviation (population, as ``jnp.std``; the reference's
    ``max_std_sampling`` default).
    """

    def __init__(self, members):
        self.members = list(members)

    def predict_members(self, left, right) -> torch.Tensor:
        return torch.stack([fn(p, torch.as_tensor(left),
                               torch.as_tensor(right))
                            for p, fn in self.members])  # (E, N)

    def predict(self, left, right, return_std: bool = False):
        preds = self.predict_members(left, right)
        mean = torch.mean(preds, dim=0)
        if return_std:
            return mean, torch.std(preds, dim=0, correction=0)
        return mean

    def query(self, left, right, n_instances: int = 1) -> np.ndarray:
        """Max-std disagreement sampling (modAL max_std_sampling)."""
        _, std = self.predict(left, right, return_std=True)
        return to_numpy(_topk_stable(std, n_instances)[1])


class QueryCommittee:
    """Query-by-committee (learners.py:239-416) over a stacked ensemble.

    Wraps ``active.committee.Committee`` with modAL's committee API:
    ``vote`` (per-member hard labels), ``vote_proba``, ``consensus``
    (mean probability), and vote-entropy disagreement querying.
    """

    def __init__(self, committee, n_classes: int = 2):
        self.committee = committee
        self.n_classes = n_classes

    def vote_proba(self, left, right) -> torch.Tensor:
        return self.committee.member_probs(torch.as_tensor(left),
                                           torch.as_tensor(right))  # (E,N,C)

    def vote(self, left, right) -> torch.Tensor:
        return torch.argmax(self.vote_proba(left, right), dim=-1)  # (E, N)

    def consensus_proba(self, left, right) -> torch.Tensor:
        return torch.mean(self.vote_proba(left, right), dim=0)  # (N, C)

    def predict(self, left, right) -> torch.Tensor:
        return torch.argmax(self.consensus_proba(left, right), dim=-1)

    def vote_entropy(self, left, right) -> torch.Tensor:
        """Disagreement = entropy of the members' hard-vote histogram
        (modAL vote_entropy; learners.py consensus machinery)."""
        votes = self.vote(left, right)  # (E, N)
        e = votes.shape[0]
        counts = torch.stack([torch.sum(votes == c, dim=0)
                              for c in range(self.n_classes)], dim=-1) / e
        p = torch.clamp(counts, 1e-12, 1.0)
        return -torch.sum(p * torch.log(p), dim=-1)

    def query(self, left, right, n_instances: int = 1) -> np.ndarray:
        disagreement = self.vote_entropy(left, right)
        return to_numpy(_topk_stable(disagreement, n_instances)[1])
