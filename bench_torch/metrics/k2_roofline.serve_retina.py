"""K2's share of its roofline over the card-only profiled stretch of
``serve_retina_r100``: each launch's least time is the larger of its
operations (~12 an output value, float32) over 67 TFLOP/s and its bytes
over 3.35 TB/s, the bytes being the chips written once and the photo
pixels that the chips' bilinear taps need, read once
(``pipeline_closed_retina.Driver.k2_input_bytes``: the footprint of each
face on its 640^2 photo, from the detector's best kept landmarks); over
K2's device time."""

from bench_torch import roofline as R


def read(run):
    t, launches = run.trace.kernel("affine_warp_kernel")
    if not launches or t <= 0:
        return None
    c = run.traffic["photo"][2]
    oh, ow = run.config["align"]["output_size"]
    n = run.traffic["batch"]
    needed = run.driver.k2_input_bytes()
    bound = 0.0
    for i in range(run.units):      # tail call i warps pool batch i % P
        nbytes = needed[i % len(needed)] + n * oh * ow * c * 4
        bound += R.bound_s(R.k2_flops(n, oh, ow, c), R.H100_F32_TFLOPS,
                           nbytes)[0]
    return 100.0 * bound / t
