"""K3's share of its roofline: for each featurize call of the card-only
profiled stretch, the least time of its 13 stride-1 block launches (each the larger
of its operations at the unpadded widths over the bf16 peak and its bytes
- input, bf16 weights, output - over the memory rate), over K3's device
time."""

from bench_torch import roofline as R


def read(run):
    t, launches = run.trace.kernel("bottleneck_kernel")
    if not launches or t <= 0:
        return None
    blocks = R.vgg_stride1_blocks(run.config["teacher"]["input"][0],
                                  tuple(run.config["teacher"]["stage_sizes"]))
    bound = 0.0
    for n, calls in run.driver.tail_calls[0].items():
        for hw, cin, cm, cout, proj in blocks:
            ops = R.k3_flops(n, hw, cin, cm, cout, proj)
            nbytes = 2 * (n * hw * hw * (cin + cout) + cin * cm + 9 * cm * cm
                          + cm * cout + (cin * cout if proj else 0))
            bound += calls * R.bound_s(ops, R.H100_BF16_TFLOPS, nbytes)[0]
    return 100.0 * bound / t
