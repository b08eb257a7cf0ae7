"""One-shot DFW evaluation: features -> score matrix -> masked ROC -> stats
(counterpart of ``alink_tpu/tools/evaluate.py``).

The reference's offline evaluation is four chained scripts passing files
(``generatePredictions.py`` -> ``generateMatrixDFW.py`` ->
``ROC_precompute.py`` -> ``getStats.py``).  This runs the whole chain in
one command on one card: featurization in batches (VGGFace-ResNet50,
kernel K3), the all-pairs matrix in one call (kernel K1), the split and
the sweep on the card; it prints the reference's stat lines plus one JSON
line per ROC case.

    python -m alink_tpu_torch.tools.evaluate --model_ckpt ckpt \\
        --mask mask.txt --prefix DFW_Data/          # featurize the test list
    python -m alink_tpu_torch.tools.evaluate --model_ckpt ckpt \\
        --mask mask.txt --features processedData.npy   # reuse features

``--device cpu`` runs the chain on the CPU (the kernels' plain versions).
Intermediate artifacts are optional outputs (``--save_matrix``,
``--save_tprfpr``), so the individual reference-compatible tools can pick
them up.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from alink_tpu_torch.evaluation import CASE_NAMES as _CASES
from alink_tpu_torch.evaluation import roc_from_scores
from alink_tpu_torch.tools.generate_matrix import restore_head_and_score
from alink_tpu_torch.tools.get_stats import print_stats
from alink_tpu_torch.tools.roc_precompute import load_matrix


def evaluate_scores(scores, mask, roc_case: int, thresholds):
    """Masked split + sweep + stats for one ROC case
    (= ``evaluation.roc_from_scores``; kept as the tool's seam)."""
    return roc_from_scores(scores, mask, roc_case, thresholds)


def main(argv=None):
    """Run the chain; returns the features (host array) and the score
    matrix (on the device) for callers that go on with them."""
    from alink_tpu_torch.drivers.common import resolve_device

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_ckpt", required=True,
                        help="train.save checkpoint of the head's state dict")
    parser.add_argument("--mask", required=True,
                        help="mask matrix (codes 1-4, ROC_precompute.py)")
    parser.add_argument("--prefix", default=None,
                        help="dataset prefix with Testing_data_face_name.txt"
                             " (featurizes the test list)")
    parser.add_argument("--features", default=None,
                        help="saved feature stack (skips featurization)")
    parser.add_argument("--backbone_ckpt", default=None,
                        help="featurizer state dict (with --prefix)")
    parser.add_argument("--roc_case", type=int, default=0,
                        choices=(0, 1, 2, 3),
                        help="1=impersonation 2=obfuscation 3=overall "
                             "0=all three")
    parser.add_argument("--thresholds", default=None,
                        help="thresholds file (default: 10001 in [0,1])")
    parser.add_argument("--save_matrix", default=None)
    parser.add_argument("--save_tprfpr", default=None,
                        help="savetxt [TPR, FPR] path (per case, suffixed "
                             "when --roc_case 0)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if (args.prefix is None) == (args.features is None):
        parser.error("exactly one of --prefix / --features is required")
    device = resolve_device(args.device, "evaluate")

    if args.features:
        feats = np.load(args.features)
    else:
        from alink_tpu_torch.tools.generate_predictions import (
            generate_predictions, read_face_names, resnet50_featurizer)

        featurize = resnet50_featurizer(args.backbone_ckpt, device)
        feats = generate_predictions(args.prefix,
                                     read_face_names(args.prefix),
                                     featurize, device=device)
    print(f"features: {feats.shape}")

    scores = restore_head_and_score(args.model_ckpt, feats, device)
    print(f"score matrix: {tuple(scores.shape)}")
    if args.save_matrix:
        np.save(args.save_matrix, scores.cpu().numpy())

    mask = torch.as_tensor(load_matrix(args.mask).astype(int), device=device)
    thresholds = (np.loadtxt(args.thresholds) if args.thresholds
                  else np.linspace(0.0, 1.0, 10001))

    cases = (1, 2, 3) if args.roc_case == 0 else (args.roc_case,)
    for case in cases:
        tpr, fpr, stats = evaluate_scores(scores, mask, case, thresholds)
        if args.save_tprfpr:
            path = args.save_tprfpr
            if len(cases) > 1:
                root, ext = os.path.splitext(path)
                path = f"{root}_{_CASES[case]}{ext}"
            np.savetxt(path, np.array([tpr, fpr]))
        # The reference's getStats.py output lines, per case.
        print(f"[{_CASES[case]}]")
        print_stats(stats)
        print(json.dumps({
            "case": _CASES[case], "auc": round(float(stats.auc), 6),
            "eer": round(float(stats.eer), 6),
            "gar_at_1pct_far": round(float(stats.gar_at_1pct_far), 6),
            "gar_at_01pct_far": round(float(stats.gar_at_01pct_far), 6),
        }))
    return feats, scores


if __name__ == "__main__":
    main()
