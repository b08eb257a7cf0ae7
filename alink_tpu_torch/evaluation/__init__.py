"""Evaluation (counterpart of ``alink_tpu.evaluation``): masked ROC,
AUC/EER/GAR@FAR, identification.

Reference chain: ``generatePredictions.py`` -> ``generateMatrixDFW.py`` ->
``ROC_precompute.py`` -> ``getStats.py``.  Here the matrix comes from the
pairwise scorer (``ops.pairwise.score_matrix``: kernel K1 on the card) and
the split and the sweep run where the matrix lies:

- ``roc``            — upper-triangle mask split (codes 1-4, three ROC
  cases), threshold sweep, AUC/EER/GAR@FAR, histograms;
- ``identification`` — Multi-PIE gallery top-1 (ALINK_MTP.py:271-289).
"""

from alink_tpu_torch.evaluation.identification import gallery_top1
from alink_tpu_torch.evaluation.roc import (CASE_NAMES, EvalStats,
                                            gar_at_far, masked_scores,
                                            roc_from_scores, roc_stats,
                                            score_histograms,
                                            threshold_sweep)

__all__ = ["CASE_NAMES", "EvalStats", "gar_at_far", "masked_scores",
           "roc_from_scores", "roc_stats", "score_histograms",
           "threshold_sweep", "gallery_top1"]
