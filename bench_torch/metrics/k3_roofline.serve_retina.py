"""K3's share of its roofline in RetinaFace-R50's backbone: for each call of
the card-only profiled stretch, the least time of the 13 stride-1 block
launches of one forward at the call's photos (160^2, 80^2, 40^2, 20^2 at
640^2; each the larger of its operations at the unpadded widths over the
bf16 peak and its bytes - input, bf16 weights, output - over the memory
rate, as ``k3_roofline.alink`` counts them), over K3's device time."""

from bench_torch import roofline as R
from bench_torch import roofline_retina as RR


def read(run):
    t, launches = run.trace.kernel("bottleneck_kernel")
    if not launches or t <= 0 or not run.units:
        return None
    d, n = run.config["detector"], run.traffic["batch"]
    b = d["backbone"]
    bound = sum(R.bound_s(R.k3_flops(n, *blk), R.H100_BF16_TFLOPS,
                          RR.k3_bytes(n, *blk))[0]
                for blk in RR.retina_stride1_blocks(
                    d["input_size"][0], tuple(b["stage_sizes"]),
                    tuple(b["widths"])))
    return 100.0 * bound * run.units / t
