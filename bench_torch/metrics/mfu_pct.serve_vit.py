"""The whole pipeline's share of the bf16 peak: the model operations the
window's photos need (the cascade's towers at the configured budgets and
the ViT embedder, from shapes) over the window, over 989 TFLOP/s."""

from bench_torch import roofline as R
from bench_torch import roofline_vit as RV


def read(run):
    cfg, win = run.config, run.window.counters
    c, e = cfg["cascade"], cfg["embedder"]
    h, w, _ = run.traffic["photo"]
    per_face = (R.cascade_flops(h, w, c["min_size"], c["factor"],
                                c["stage1_budget"], c["stage2_budget"])
                + RV.vit_flops(e["input_size"][0], e["patch_size"],
                               e["embed_dim"], e["depth"], e["mlp_dim"],
                               e["embedding_dim"]))
    return 100.0 * per_face * win["faces"] / win["window_s"] / (
        R.H100_BF16_TFLOPS * 1e12)
