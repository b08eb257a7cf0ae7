"""Verification statistics from a swept TPR/FPR file (counterpart of
``alink_tpu/tools/get_stats.py``).

Reference: ``utilities/getStats.py``: prints AUC, EER and GAR at 1% /
0.1% FAR from a ``[TPR, FPR]`` savetxt file.  Same inputs, same output
lines.  Host only (float64 numpy).

    python -m alink_tpu_torch.tools.get_stats tprfpr.txt
"""

from __future__ import annotations

import argparse

import numpy as np

from alink_tpu_torch.evaluation import roc_stats


def print_stats(stats) -> None:
    """The reference's getStats.py output lines, verbatim."""
    print("AUC %f" % stats.auc)
    print("EER %f" % stats.eer)
    print("GAR is %f for %f FAR" % (stats.gar_at_1pct_far, 0.010))
    print("GAR is %f for %f FAR" % (stats.gar_at_01pct_far, 0.0010))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("tpr_fpr_file")
    args = parser.parse_args(argv)

    tpr, fpr = np.loadtxt(args.tpr_fpr_file)
    print_stats(roc_stats(tpr, fpr))


if __name__ == "__main__":
    main()
