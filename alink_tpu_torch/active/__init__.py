"""Active learning (counterpart of ``alink_tpu.active``): the committee,
disparity selection, the A-LINK loop, and the classical baselines'
learners (``learners``: ActiveLearner, BayesianOptimizer,
CommitteeRegressor, QueryCommittee) and acquisition functions
(``uncertainty``)."""

from alink_tpu_torch.active.committee import Committee
from alink_tpu_torch.active.learners import (ActiveLearner,
                                             BayesianOptimizer,
                                             CommitteeRegressor,
                                             QueryCommittee)
from alink_tpu_torch.active.loop import ALinkLoop, ALinkState, IterationLog
from alink_tpu_torch.active.selection import (SelectionResult,
                                              disparity_masks,
                                              intersect_masks, oracle_gate,
                                              select_queries)
from alink_tpu_torch.active.uncertainty import (STRATEGIES, get_strategy,
                                                uncertainty_sampling)

__all__ = ["Committee", "ActiveLearner", "BayesianOptimizer",
           "CommitteeRegressor", "QueryCommittee", "ALinkLoop", "ALinkState",
           "IterationLog", "SelectionResult", "disparity_masks",
           "intersect_masks", "oracle_gate", "select_queries", "STRATEGIES",
           "get_strategy", "uncertainty_sampling"]
