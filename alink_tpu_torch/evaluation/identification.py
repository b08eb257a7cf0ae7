"""Gallery identification (counterpart of
``alink_tpu/evaluation/identification.py``).

Reference: ``code/ALINK_MTP.py:271-289``: the gallery is the first image of
every test subject, every remaining image is a probe, and a probe is
correct when the student scores it highest against its own subject's
gallery entry.  The whole probe x gallery grid is one scored pass.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from alink_tpu_torch.data.loader import PersonStacks
from alink_tpu_torch.evaluation.roc import to_numpy


def gallery_top1(score_fn: Callable, subjects: PersonStacks) -> float:
    """Top-1 identification accuracy over a subject gallery.

    Args:
        score_fn: ``(probes (N, ...), gallery (G, ...)) -> (N, G)`` genuine
            scores (a tensor on any device, or an array), typically the
            pairwise scorer over an image model.
        subjects: per-subject stacks; image 0 of each subject is its
            gallery entry (ALINK_MTP.py:272-275), the rest are probes.

    Returns the fraction of probes whose argmax gallery entry is their own
    subject (ALINK_MTP.py:278-289; ties to the first entry).
    """
    live = np.flatnonzero(subjects.counts > 0)
    gallery = subjects.images[live, 0]
    probes, truth = [], []
    for gi, p in enumerate(live):
        for s in range(1, int(subjects.counts[p])):
            probes.append(subjects.images[p, s])
            truth.append(gi)
    if not probes:
        return 0.0
    scores = to_numpy(score_fn(np.stack(probes), gallery))
    return float(np.mean(np.argmax(scores, axis=1) == np.asarray(truth)))
