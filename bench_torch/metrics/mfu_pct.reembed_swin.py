"""The embedder's share of the bf16 peak: the model operations the
window's chips need (``roofline_swin.swin_flops``, from shapes: 17.46
GFLOP a Swin-S chip at 112^2) over the window, over 989 TFLOP/s."""

from bench_torch import roofline as R
from bench_torch import roofline_swin as RS


def read(run):
    e, win = run.config["embedder"], run.window.counters
    per_chip = RS.swin_flops(e["input_size"][0], e["patch_size"],
                             e["embed_dim"], tuple(e["depths"]),
                             e["window_size"], e["mlp_ratio"],
                             e["embedding_dim"])
    return 100.0 * per_chip * win["faces"] / win["window_s"] / (
        R.H100_BF16_TFLOPS * 1e12)
