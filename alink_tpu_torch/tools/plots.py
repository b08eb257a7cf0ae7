"""ROC and score-histogram plots (counterpart of
``alink_tpu/tools/plots.py``).

Reference: ``utilities/ROC.py`` (single curve, log-x), ``ROC_all.py``
(overlaid curves) and ``histogram.py`` (genuine/imposter histograms).
Matplotlib is optional and imported only when a plot is drawn — the tools
degrade to saving the underlying arrays when it is unavailable::

    python -m alink_tpu_torch.tools.plots roc a.txt b.txt out.png --log_x
    python -m alink_tpu_torch.tools.plots histogram scores.npy mask.txt out.png
"""

from __future__ import annotations

import argparse

import numpy as np

from alink_tpu_torch.evaluation import masked_scores, score_histograms


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        return None


def roc_plot(inputs: list[str], out: str, log_x: bool = False) -> None:
    """Overlay TPR/FPR curves (ROC_all.py:1-40; ROC.py uses log x)."""
    plt = _plt()
    curves = [(p, np.loadtxt(p)) for p in inputs]
    if plt is None:
        np.savez(out + ".npz", **{p: c for p, c in curves})
        return
    for path, (tpr, fpr) in curves:
        label = path.split("/")[-1].rsplit(".", 1)[0]
        plt.plot(fpr, tpr, label=label)
    plt.plot([0, 1], [1, 0], "r--")
    plt.xlabel("False Positive Rate", fontsize=14)
    plt.ylabel("True Positive Rate", fontsize=14)
    plt.title("ROC Curve", fontsize=14)
    plt.legend()
    if log_x:
        plt.xscale("log")
    plt.savefig(out, dpi=500)
    plt.close()


def histogram_plot(matrix_path: str, mask_path: str, out: str) -> None:
    """Genuine vs imposter score histograms (histogram.py:14-36)."""
    scores = (np.load(matrix_path) if matrix_path.endswith(".npy")
              else np.loadtxt(matrix_path))
    mask = (np.load(mask_path) if mask_path.endswith(".npy")
            else np.loadtxt(mask_path)).astype(int)
    genuine, imposter = masked_scores(scores, mask, case=3)
    # Bin once (the DFW matrix yields ~30M scores); plot the precomputed
    # counts rather than re-binning inside plt.hist.
    hg, hi, edges = score_histograms(genuine, imposter)
    plt = _plt()
    if plt is None:
        np.savez(out + ".npz", genuine=hg, imposter=hi, edges=edges)
        return
    plt.stairs(hg, edges, fill=True, label="Genuine", alpha=0.5)
    plt.stairs(hi, edges, fill=True, label="Imposter", alpha=0.5)
    plt.xscale("log")
    plt.yscale("log")
    plt.legend(loc="upper right")
    plt.savefig(out, dpi=500)
    plt.close()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    roc = sub.add_parser("roc")
    roc.add_argument("inputs", nargs="+")
    roc.add_argument("out")
    roc.add_argument("--log_x", action="store_true")
    hist = sub.add_parser("histogram")
    hist.add_argument("score_matrix")
    hist.add_argument("mask")
    hist.add_argument("out")
    args = parser.parse_args(argv)
    if args.cmd == "roc":
        roc_plot(args.inputs, args.out, args.log_x)
    else:
        histogram_plot(args.score_matrix, args.mask, args.out)


if __name__ == "__main__":
    main()
