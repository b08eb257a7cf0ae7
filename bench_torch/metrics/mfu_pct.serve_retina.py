"""The whole pipeline's share of the bf16 peak: the model operations the
window's photos need (RetinaFace-R50 at the photos' size, ``roofline_retina.
retina_flops``, and the ArcFace embedder, from shapes) over the window,
over 989 TFLOP/s."""

from bench_torch import roofline as R
from bench_torch import roofline_retina as RR


def read(run):
    cfg, win = run.config, run.window.counters
    d, e = cfg["detector"], cfg["embedder"]
    b = d["backbone"]
    per_face = (RR.retina_flops(run.traffic["photo"][0],
                                tuple(b["stage_sizes"]), tuple(b["widths"]),
                                d["fpn"]["out_channels"],
                                d["anchors_per_cell"])
                + R.arcface_flops(tuple(e["stage_sizes"]),
                                  tuple(e["stage_widths"]),
                                  e["input_size"][0], e["embedding_dim"]))
    return 100.0 * per_face * win["faces"] / win["window_s"] / (
        R.H100_BF16_TFLOPS * 1e12)
