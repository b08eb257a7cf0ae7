"""Label utilities (reference: code/helpers.py; counterpart of
``alink_tpu/utils/helpers.py``), on numpy.

- ``roundoff``            — probability -> hard {0,1} label
  (helpers.py:39-46);
- ``one_hot``             — to_categorical (helpers.py:33-36);
- ``unison_split``        — shuffled two-way split of (X, Y)
  (helpers.py:106-112);
- ``calculate_accuracy``  — argmax agreement; the reference defines it
  twice and the second definition shadows the first (helpers.py:66, 84 —
  SURVEY.md section 7 quirk, only one kept here);
- ``confusion_counts``    — the confusion matrix behind the (vestigial)
  plotting helper (helpers.py:12-30) without the matplotlib dependency.

The paired augmentation that used to live here (helpers.py:114-141) is
``alink_tpu_torch.ops.augment``.
"""

from __future__ import annotations

import numpy as np


def roundoff(y: np.ndarray) -> np.ndarray:
    """Probabilities -> hard labels at 0.5 (helpers.py:39-46)."""
    return (np.asarray(y) >= 0.5).astype(np.int32)


def one_hot(labels: np.ndarray, num_classes: int = 2) -> np.ndarray:
    """to_categorical (helpers.py:33-36)."""
    return np.eye(num_classes, dtype=np.float32)[np.asarray(labels)]


def unison_split(x: np.ndarray, y: np.ndarray, left_ratio: float = 0.4,
                 seed: int | None = None):
    """Shuffle X/Y together and split (helpers.py:106-112)."""
    rng = np.random.default_rng(seed)
    indices = rng.permutation(len(x))
    cut = int(len(x) * left_ratio)
    li, ri = indices[:cut], indices[cut:]
    return (x[li], y[li]), (x[ri], y[ri])


def calculate_accuracy(predictions: np.ndarray, labels: np.ndarray) -> float:
    """Mean argmax agreement over one-hot or probability arrays."""
    return float(np.mean(np.argmax(predictions, axis=-1)
                         == np.argmax(labels, axis=-1)))


def confusion_counts(y_true: np.ndarray, y_pred: np.ndarray,
                     num_classes: int | None = None) -> np.ndarray:
    """Confusion matrix counts[true, pred] (helpers.py:12-30's data)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    n = num_classes or int(max(y_true.max(), y_pred.max())) + 1
    counts = np.zeros((n, n), np.int64)
    np.add.at(counts, (y_true, y_pred), 1)
    return counts
