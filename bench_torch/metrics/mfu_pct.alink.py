"""The loop's share of the bf16 peak: the teacher's operations for every
image featurized in the window, plus a siamese head for every pair of
them, from shapes, over the window, over 989 TFLOP/s."""

from bench_torch import roofline as R


def read(run):
    c, t = run.window.counters, run.config["teacher"]
    per_image = R.vgg_r50_flops(t["input"][0], tuple(t["stage_sizes"]))
    heads = R.head_flops(t["feature_dim"], tuple(run.config["head"]["widths"]))
    need = c["images"] * per_image + c["images"] / 2 * heads
    return 100.0 * need / c["window_s"] / (R.H100_BF16_TFLOPS * 1e12)
