"""The operations of RetinaFace-R50 and the least time of its NMS kernel,
from shapes, as ``roofline.py`` counts them: convolutions at 2 operations
a multiply-add, no padding; BN, activations, pooling, upsampling, softmax
and decode not counted.

At 640^2 a photo takes 88.53 GFLOP: the stem 1.93, the 13 stride-1
bottlenecks (K3) 46.56, the three strided blocks 18.25, the FPN 12.37,
the three SSH modules 9.29 and the heads 0.14.

The NMS kernel's least time: a photo's K (K - 1) / 2 overlap tests, each
``IOU_OPS`` float32 operations (two maxima, two minima, two subtractions
and two additions of 1 for the intersection's sides, their two clamps,
the product, the union's addition, subtraction and clamp, the division
and the comparison), over the card's float32 rate outside the tensor
cores; or its bytes, whichever is larger: the boxes (16 bytes) and the
flags (1 byte) read once, the keep flags written once, and the upper
triangle of 64-bit mask words (``csrc/nms.cu``) written once and read
once.
"""

from __future__ import annotations

from bench_torch import roofline as R

IOU_OPS = 16
STEPS = (8, 16, 32)


def _side(size: int, stride: int) -> int:
    return -(-size // stride)


def retina_stride1_blocks(size: int = 640, stage_sizes=(3, 4, 6, 3),
                          widths=(64, 128, 256, 512)
                          ) -> list[tuple[int, int, int, int, bool]]:
    """(hw, cin, cm, cout, proj) of the backbone's stride-1 bottlenecks,
    the blocks K3 runs: every block of stage 1 (at size / 4, the first
    projecting) and all but the first of the later stages."""
    out, cin = [], widths[0]
    for stage, (n, f) in enumerate(zip(stage_sizes, widths)):
        hw = _side(size, 4 * 2 ** stage)
        for b in range(n):
            if stage > 0 and b == 0:
                cin = 4 * f
                continue
            out.append((hw, cin, f, 4 * f, stage == 0 and b == 0))
            cin = 4 * f
    return out


def retina_flops(size: int = 640, stage_sizes=(3, 4, 6, 3),
                 widths=(64, 128, 256, 512), out_channels: int = 256,
                 anchors: int = 2) -> float:
    """One photo of size x size through RetinaFace-R50's convolutions."""
    total = R.conv_flops(_side(size, 2), _side(size, 2), 3, widths[0], 7)
    total += sum(R.k3_flops(1, *b) for b in retina_stride1_blocks(
        size, stage_sizes, widths))
    cin = 4 * widths[0]
    for stage, f in enumerate(widths[1:], start=1):
        hi, lo = _side(size, 2 ** (stage + 1)), _side(size, 2 ** (stage + 2))
        total += (R.conv_flops(hi, hi, cin, f, 1)
                  + R.conv_flops(lo, lo, f, f, 3)
                  + R.conv_flops(lo, lo, f, 4 * f, 1)
                  + R.conv_flops(lo, lo, cin, 4 * f, 1))
        cin = 4 * f
    c = out_channels
    sides = [_side(size, s) for s in STEPS]
    for hw, cin in zip(sides, (4 * w for w in widths[1:])):
        total += R.conv_flops(hw, hw, cin, c, 1)                    # lateral
    total += sum(R.conv_flops(hw, hw, c, c, 3) for hw in sides[:2])  # merges
    for hw in sides:
        total += (R.conv_flops(hw, hw, c, c // 2, 3)
                  + R.conv_flops(hw, hw, c, c // 4, 3)
                  + 3 * R.conv_flops(hw, hw, c // 4, c // 4, 3))
        total += R.conv_flops(hw, hw, c, anchors * (2 + 4 + 10), 1)
    return total


def mask_words(k: int) -> int:
    """The 64-bit mask words ``csrc/nms.cu`` writes for one photo of ``k``
    candidates: row block r's rows times the column blocks from r on."""
    words = -(-k // 64)
    return sum(min(64, k - 64 * r) * (words - r) for r in range(words))


def nms_ops(n: int, k: int) -> float:
    return n * k * (k - 1) / 2 * IOU_OPS


def nms_bytes(n: int, k: int) -> float:
    return n * (k * (16 + 1 + 1) + 2 * 8 * mask_words(k))


def nms_bound_s(n: int, k: int) -> float:
    """The least time of one NMS launch over n photos of k candidates."""
    return R.bound_s(nms_ops(n, k), R.H100_F32_TFLOPS, nms_bytes(n, k))[0]


def k3_bytes(n: int, hw: int, cin: int, cm: int, cout: int,
             proj: bool) -> float:
    """One stride-1 block's bytes as ``k3_roofline.alink`` counts them:
    input and output at bf16, the bf16 weights once."""
    return 2 * (n * hw * hw * (cin + cout) + cin * cm + 9 * cm * cm
                + cm * cout + (cin * cout if proj else 0))
