"""The LayerNorms' share of their roofline: a forward's least time at the
call's chips (``roofline_ln.ln_bound_per_forward_s``: each norm's input
read once and its output written once, in the dtypes they arrive in and
leave in, over 3.35 TB/s), summed over the profiled stretch's calls, over
the device time inside the program's ``alink/ln`` spans.  None where the
program opens no such span."""

from bench_torch import program_device as D
from bench_torch import roofline_ln as RL


def read(run):
    s = D.span_device_s(run, "ln")
    if not s or not run.spans.units:
        return None
    e = run.config["embedder"]
    bound = RL.ln_bound_per_forward_s(
        run.traffic["batch"], e["input_size"][0], e["patch_size"],
        e["embed_dim"], tuple(e["depths"]), e["window_size"])
    return 100.0 * bound * run.spans.units / s
