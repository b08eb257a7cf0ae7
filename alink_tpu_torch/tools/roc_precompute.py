"""Masked ROC sweep: score matrix + mask -> TPR/FPR file (counterpart of
``alink_tpu/tools/roc_precompute.py``).

Reference: ``utilities/ROC_precompute.py``: upper-triangle mask split
(codes 1-4, roc_case 1/2/3) and an O(n*t) Python threshold sweep
(:48-66), saving ``np.savetxt([TPR, FPR])``.  Same file contract; the
split and the sweep are ``evaluation.roc``'s, on ``--device``.

    python -m alink_tpu_torch.tools.roc_precompute scores.npy tprfpr.txt 3 \\
        --mask updated_testing_mask.txt [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from alink_tpu_torch.evaluation import masked_scores, threshold_sweep
from alink_tpu_torch.evaluation.roc import to_numpy


def load_matrix(path: str) -> np.ndarray:
    return np.load(path) if path.endswith(".npy") else np.loadtxt(path)


def main(argv=None) -> None:
    from alink_tpu_torch.drivers.common import resolve_device

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("score_matrix")
    parser.add_argument("out", help="output TPR/FPR file (savetxt)")
    parser.add_argument("roc_case", type=int, choices=(1, 2, 3),
                        help="1=impersonation 2=obfuscation 3=overall")
    parser.add_argument("--mask", default="updated_testing_mask.txt")
    parser.add_argument("--thresholds", default=None,
                        help="thresholds file (default: 10001 in [0,1])")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device, "roc_precompute")
    scores = torch.as_tensor(load_matrix(args.score_matrix), device=device)
    mask = torch.as_tensor(load_matrix(args.mask).astype(int), device=device)
    thresholds = (np.loadtxt(args.thresholds) if args.thresholds
                  else np.linspace(0.0, 1.0, 10001))
    genuine, imposter = masked_scores(scores, mask, args.roc_case)
    print("Genuine and Imposter score generated")
    tpr, fpr = threshold_sweep(genuine, imposter, thresholds)
    np.savetxt(args.out, np.array([to_numpy(tpr), to_numpy(fpr)]))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
