"""Framework utilities (counterpart of ``alink_tpu.utils``).

- ``profiling`` — per-phase wall-clock timing + ``torch.profiler`` trace
  capture;
- ``metrics``   — structured JSONL metrics logging;
- ``resilience``— failure detection + retry/elastic recovery:
  ``run_with_retries`` supervision, shared-fs ``Heartbeat`` peer liveness,
  deadline ``barrier``;
- ``helpers``   — the label utilities of code/helpers.py (roundoff,
  one_hot, unisonSplit, calculate_accuracy, confusion matrix);
- ``debug``     — the opt-in NaN/Inf guard;
- ``tree``      — ``map_leaves`` over nested dicts, tuples and lists.
"""

from alink_tpu_torch.utils.profiling import Timings, trace  # noqa: F401
from alink_tpu_torch.utils.metrics import MetricsLogger  # noqa: F401
from alink_tpu_torch.utils.resilience import (  # noqa: F401
    Heartbeat,
    PeerFailure,
    RetryReport,
    barrier,
    run_with_retries,
)
from alink_tpu_torch.utils.helpers import (  # noqa: F401
    calculate_accuracy,
    confusion_counts,
    one_hot,
    roundoff,
    unison_split,
)
