"""The NMS kernel's share of its roofline: for each call of the card-only
profiled stretch, the least time of one launch over the call's photos at
the top-k budget (``roofline_retina.nms_bound_s``: K (K - 1) / 2 overlap
tests a photo at 17 float32 operations over the card's float32 rate, or
the boxes, flags and upper-triangle mask words over the memory rate,
whichever is larger), over the device time of ``csrc/nms.cu``'s two
kernels (``nms_mask``, ``nms_sweep``)."""

from bench_torch import roofline_retina as RR


def read(run):
    t, launches = run.trace.kernel("nms_")
    if not launches or t <= 0 or not run.units:
        return None
    bound = RR.nms_bound_s(run.traffic["batch"],
                           run.config["detector"]["top_k"])
    return 100.0 * bound * run.units / t
