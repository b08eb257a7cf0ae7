"""Active learning (counterpart of ``alink_tpu.active``): the committee,
disparity selection and the A-LINK loop.  The classical AL baselines
(``learners``, ``uncertainty``) are not ported yet."""

from alink_tpu_torch.active.committee import Committee
from alink_tpu_torch.active.loop import ALinkLoop, ALinkState, IterationLog
from alink_tpu_torch.active.selection import (SelectionResult,
                                              disparity_masks,
                                              intersect_masks, oracle_gate,
                                              select_queries)

__all__ = ["Committee", "ALinkLoop", "ALinkState", "IterationLog",
           "SelectionResult", "disparity_masks", "intersect_masks",
           "oracle_gate", "select_queries"]
