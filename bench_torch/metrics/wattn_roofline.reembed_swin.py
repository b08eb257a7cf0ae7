"""The windowed cores' share of their roofline: each block's least time
at the call's chips (``roofline_swin.wattn_bound_s``: 4 x tokens x 49 x C
operations over the bf16 tensor peak or 8 x tokens x C bytes over
3.35 TB/s, whichever is larger), summed over the forward's blocks and the
profiled stretch's calls, over the device time inside the program's
``alink/swin.attn`` spans."""

from bench_torch import program_device as D
from bench_torch import roofline_swin as RS


def read(run):
    s = D.span_device_s(run, "swin.attn")
    if not s or not run.spans.units:
        return None
    e = run.config["embedder"]
    bound = RS.wattn_bound_per_forward_s(
        run.traffic["batch"], e["input_size"][0], e["patch_size"],
        e["embed_dim"], tuple(e["depths"]), e["window_size"])
    return 100.0 * bound * run.spans.units / s
