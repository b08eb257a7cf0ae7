"""The attention cores' share of their roofline: each block's least time
at the call's faces (``roofline_vit.attn_bound_s``: operations over the
TF32 tensor peak or bf16 bytes over 3.35 TB/s, whichever is larger),
summed over the profiled stretch's calls, over the device time inside the
program's ``alink/vit.attn`` spans."""

from bench_torch import program_device as D
from bench_torch import roofline_vit as RV


def read(run):
    s = D.span_device_s(run, "vit.attn")
    if not s or not run.spans.units:
        return None
    e = run.config["embedder"]
    bound = e["depth"] * RV.attn_bound_s(run.traffic["batch"], e["tokens"],
                                         e["embed_dim"])
    return 100.0 * bound * run.spans.units / s
