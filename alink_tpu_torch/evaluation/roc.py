"""Masked ROC computation and verification statistics (counterpart of
``alink_tpu/evaluation/roc.py``).

Reference semantics, as in the JAX package:

- ``utilities/ROC_precompute.py:19-40``: only the strict upper triangle of
  the score matrix is scored.  Mask codes: 1 = genuine (impersonation),
  2 = genuine (obfuscation), 3 = imposter (impersonation), 4 = imposter
  (obfuscation).  ROC case 1 uses {1}/{3}, case 2 {2}/{4}, case 3
  (overall) {1,2}/{3,4}.
- ``utilities/ROC_precompute.py:48-66``: TPR/FPR per threshold with
  ``score >= threshold`` accept semantics.
- ``utilities/getStats.py:9-25``: AUC (trapezoid over the swept curve),
  EER = FPR at argmin |FNR - FPR|, GAR@FAR via the nearest swept FPR.
- ``utilities/histogram.py:14-36``: genuine/imposter score histograms.

The split and the sweep run on the scores' device (at the DFW size the
grid is 7,771^2 f32 and stays on the card): ``torch.triu`` and
``torch.isin`` pick the pairs, one sort and ``torch.searchsorted`` per
class give the whole curve, thresholds in f32 as the JAX package casts
them.  The statistics are float64 numpy on the host, with the JAX
package's ``nanargmin``, ``lexsort`` and trapezoid.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Mask codes (ROC_precompute.py:24-37).
GENUINE_IMPERSONATION = 1
GENUINE_OBFUSCATION = 2
IMPOSTER_IMPERSONATION = 3
IMPOSTER_OBFUSCATION = 4

# Case code -> label (create_figure_3.m's three reported cases).
CASE_NAMES = {1: "impersonation", 2: "obfuscation", 3: "overall"}

_CASES = {
    1: ((GENUINE_IMPERSONATION,), (IMPOSTER_IMPERSONATION,)),
    2: ((GENUINE_OBFUSCATION,), (IMPOSTER_OBFUSCATION,)),
    3: ((GENUINE_IMPERSONATION, GENUINE_OBFUSCATION),
        (IMPOSTER_IMPERSONATION, IMPOSTER_OBFUSCATION)),
}


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def masked_scores(scores, mask, case: int = 3
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a score matrix into genuine/imposter scores by mask code, on
    the scores' device, in row-major order of the pairs.

    Only strict upper-triangle entries participate
    (ROC_precompute.py:21-23).  ``case``: 1 = impersonation,
    2 = obfuscation, 3 = overall.
    """
    if case not in _CASES:
        raise ValueError("roc_case must be 1, 2 or 3")
    gen_codes, imp_codes = _CASES[case]
    scores = torch.as_tensor(scores)
    mask = torch.as_tensor(mask, device=scores.device)
    if mask.shape != scores.shape:
        raise ValueError(f"mask {tuple(mask.shape)} does not match scores "
                         f"{tuple(scores.shape)}")

    def pick(codes):
        sel = torch.isin(mask, torch.tensor(codes, dtype=mask.dtype,
                                            device=mask.device))
        return scores[torch.triu(sel, diagonal=1)]

    return pick(gen_codes), pick(imp_codes)


def threshold_sweep(genuine, imposter, thresholds
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """TPR/FPR at each threshold (ROC_precompute.py:48-66 semantics:
    accept when ``score >= threshold``), f32, on the genuine scores'
    device.

    Sort + searchsorted: O((n + t) log n) instead of the reference's
    O(n * t) double loop.
    """
    genuine = torch.sort(torch.as_tensor(genuine).float()).values
    imposter = torch.sort(torch.as_tensor(imposter).float().to(
        genuine.device)).values
    thresholds = torch.as_tensor(thresholds, dtype=torch.float32,
                                 device=genuine.device)
    # Count of scores >= t == n - first index where score >= t.
    tp = genuine.shape[0] - torch.searchsorted(genuine, thresholds,
                                               right=False)
    fp = imposter.shape[0] - torch.searchsorted(imposter, thresholds,
                                                right=False)
    tpr = tp.float() / float(max(genuine.shape[0], 1))
    fpr = fp.float() / float(max(imposter.shape[0], 1))
    return tpr, fpr


class EvalStats(NamedTuple):
    auc: float
    eer: float
    gar_at_1pct_far: float
    gar_at_01pct_far: float


def gar_at_far(tpr, fpr, far: float) -> float:
    """GAR at the swept point whose FAR is nearest ``far``
    (getStats.find_nearest, getStats.py:5-7, 18-25)."""
    idx = int(np.argmin(np.abs(to_numpy(fpr) - far)))
    return float(to_numpy(tpr)[idx])


def roc_stats(tpr, fpr) -> EvalStats:
    """AUC / EER / GAR@{1%, 0.1%}FAR from a swept curve (getStats.py:9-25),
    float64 on the host."""
    tpr = to_numpy(tpr).astype(np.float64)
    fpr = to_numpy(fpr).astype(np.float64)
    fnr = 1.0 - tpr
    eer = float(fpr[np.nanargmin(np.abs(fnr - fpr))])
    # Lexicographic (fpr, then tpr) ordering keeps the step curve's
    # vertical jumps zero-width, so the trapezoid uses the attained TPR at
    # each FPR.
    order = np.lexsort((tpr, fpr))
    auc = float(np.trapezoid(tpr[order], fpr[order]))
    return EvalStats(
        auc=auc,
        eer=eer,
        gar_at_1pct_far=gar_at_far(tpr, fpr, 0.010),
        gar_at_01pct_far=gar_at_far(tpr, fpr, 0.0010),
    )


def roc_from_scores(scores, mask, case: int = 3, thresholds=None
                    ) -> tuple[np.ndarray, np.ndarray, EvalStats]:
    """The whole ROC_precompute + getStats chain in one call: the split and
    the sweep on the scores' device, TPR/FPR returned as host arrays."""
    genuine, imposter = masked_scores(scores, mask, case)
    if thresholds is None:
        thresholds = np.linspace(0.0, 1.0, 10001)
    tpr, fpr = threshold_sweep(genuine, imposter, thresholds)
    tpr, fpr = to_numpy(tpr), to_numpy(fpr)
    return tpr, fpr, roc_stats(tpr, fpr)


def score_histograms(genuine, imposter, bins: int = 100
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Genuine/imposter histograms over [0, 1] (utilities/histogram.py)."""
    edges = np.linspace(0.0, 1.0, bins + 1)
    hg, _ = np.histogram(to_numpy(genuine), bins=edges)
    hi, _ = np.histogram(to_numpy(imposter), bins=edges)
    return hg, hi, edges
