"""The card's peaks and the operations and bytes of each kernel and model,
computed from shapes.

Counts are the work the algorithm needs for its inputs: convolutions and
matrix products at 2 operations per multiply-add, no padding, no
recomputation; elementwise work (BN, activations, pooling, softmax) is
not counted.  A kernel's bytes are each input byte read once and each
output byte written once.  The peaks are NVIDIA's data-sheet rates of one
H100 SXM (dense, no sparsity), which assume its full 700 W power limit.
"""

from __future__ import annotations

import math

H100_BF16_TFLOPS = 989.0
H100_F32_TFLOPS = 67.0          # outside the tensor cores
H100_BYTES_PER_S = 3.35e12


def bound_s(ops: float, peak_tflops: float, nbytes: float
            ) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over the peak for their type and the bytes over the memory rate, with
    which of the two bounds it."""
    t_ops = ops / (peak_tflops * 1e12)
    t_bytes = nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def conv_flops(oh: int, ow: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * oh * ow * cin * cout * k * k


def dense_flops(cin: int, cout: int) -> float:
    return 2.0 * cin * cout


# -- ArcFace LResNet100E-IR ---------------------------------------------

def arcface_flops(stage_sizes=(3, 13, 30, 3), widths=(64, 128, 256, 512),
                  size: int = 112, embedding: int = 512) -> float:
    """One face through the improved-residual ResNet (stem 3x3, units
    conv3x3 -> conv3x3(stride) + 1x1(stride) shortcut on a change of
    shape, fc over the NHWC flatten)."""
    r = size
    total = conv_flops(r, r, 3, 64, 3)
    cin = 64
    for units, f in zip(stage_sizes, widths):
        for u in range(units):
            s = 2 if u == 0 else 1
            ro = -(-r // s)
            total += conv_flops(r, r, cin, f, 3) + conv_flops(ro, ro, f, f, 3)
            if s != 1 or cin != f:
                total += conv_flops(ro, ro, cin, f, 1)
            cin, r = f, ro
    return total + dense_flops(cin * r * r, embedding)


# -- MTCNN ----------------------------------------------------------------

def _valid(r: int, k: int) -> int:
    return r - k + 1


def _ceil_pool(r: int, window: int, stride: int) -> int:
    return max(1, math.ceil((r - window) / stride) + 1) if r > window else 1


def pnet_flops(h: int, w: int) -> float:
    h1, w1 = _valid(h, 3), _valid(w, 3)
    t = conv_flops(h1, w1, 3, 10, 3)
    h2, w2 = _ceil_pool(h1, 2, 2), _ceil_pool(w1, 2, 2)
    h3, w3 = _valid(h2, 3), _valid(w2, 3)
    t += conv_flops(h3, w3, 10, 16, 3)
    h4, w4 = _valid(h3, 3), _valid(w3, 3)
    t += conv_flops(h4, w4, 16, 32, 3)
    return t + conv_flops(h4, w4, 32, 2 + 4, 1)


def rnet_flops() -> float:
    t = conv_flops(22, 22, 3, 28, 3)          # 24 -> 22, pool 3/2 -> 11
    t += conv_flops(9, 9, 28, 48, 3)          # 11 -> 9, pool 3/2 -> 4
    t += conv_flops(3, 3, 48, 64, 2)          # 4 -> 3
    return t + dense_flops(576, 128) + dense_flops(128, 2 + 4)


def onet_flops() -> float:
    t = conv_flops(46, 46, 3, 32, 3)          # 48 -> 46, pool 3/2 -> 23
    t += conv_flops(21, 21, 32, 64, 3)        # 23 -> 21, pool 3/2 -> 10
    t += conv_flops(8, 8, 64, 64, 3)          # 10 -> 8, pool 2/2 -> 4
    t += conv_flops(3, 3, 64, 128, 2)         # 4 -> 3
    return t + dense_flops(1152, 256) + dense_flops(256, 2 + 4 + 10)


def pyramid_sizes(h: int, w: int, min_size: int, factor: float
                  ) -> list[tuple[int, int]]:
    """The P-Net pyramid's level sizes: scales 12/min_size * factor^i while
    the scaled short side stays above 12 (the MTCNN paper's pyramid)."""
    m = min(h, w) * (12.0 / min_size)
    scale = 12.0 / min_size
    out = []
    while m > 12.0:
        sh, sw = math.ceil(h * scale), math.ceil(w * scale)
        if sh >= 12 and sw >= 12:
            out.append((sh, sw))
        scale *= factor
        m *= factor
    return out


def cascade_flops(h: int, w: int, min_size: int, factor: float,
                  rnet_crops: int, onet_crops: int) -> float:
    """One photo through the cascade: P-Net on every pyramid level, R-Net
    on ``rnet_crops`` candidates and O-Net on ``onet_crops``."""
    return (sum(pnet_flops(a, b) for a, b in
                pyramid_sizes(h, w, min_size, factor))
            + rnet_crops * rnet_flops() + onet_crops * onet_flops())


# -- VGGFace2 ResNet-50 and K3 ----------------------------------------------

def k3_flops(n, hw, cin, cm, cout, proj) -> float:
    """One stride-1 bottleneck (1x1, 3x3, 1x1, optional 1x1 projection) on
    n images of hw x hw, at the unpadded widths."""
    return 2.0 * n * hw * hw * (cin * cm + 9 * cm * cm + cm * cout
                                + (cin * cout if proj else 0))


def vgg_stride1_blocks(size: int = 224, stage_sizes=(3, 4, 6, 3)
                       ) -> list[tuple[int, int, int, int, bool]]:
    """(hw, cin, cm, cout, proj) of the stride-1 bottlenecks, the blocks
    that run through K3: every block of stage 1 (its first projects) and
    all but the first of the later stages."""
    hw = stem_out(size)
    out, cin = [], 64
    for stage, (n, f) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
        if stage > 0:
            hw, cin = -(-hw // 2), 4 * f
        for b in range(n):
            if stage > 0 and b == 0:
                continue
            out.append((hw, cin, f, 4 * f, stage == 0 and b == 0))
            cin = 4 * f
    return out


def stem_out(size: int) -> int:
    """Side after the keras stem: 7x7 s2 SAME conv, VALID 3x3 s2 pool."""
    return (-(-size // 2) - 3) // 2 + 1


def vgg_r50_flops(size: int = 224, stage_sizes=(3, 4, 6, 3)) -> float:
    """One image through the keras_vggface ResNet-50 to its avg pool."""
    c1 = -(-size // 2)
    total = conv_flops(c1, c1, 3, 64, 7)
    total += sum(k3_flops(1, *b) for b in vgg_stride1_blocks(size,
                                                             stage_sizes))
    hw = stem_out(size)
    for stage, f in enumerate((128, 256, 512), start=1):
        cin, hw = 2 * f if stage > 1 else 256, -(-hw // 2)
        total += (conv_flops(hw, hw, cin, f, 1) + conv_flops(hw, hw, f, f, 3)
                  + conv_flops(hw, hw, f, 4 * f, 1)
                  + conv_flops(hw, hw, cin, 4 * f, 1))
    return total


# -- heads and K2 -------------------------------------------------------------

def head_flops(d: int, widths=(512, 64), classes: int = 2) -> float:
    """One pair through the siamese head (|l - r|, then the MLP)."""
    dims = (d,) + tuple(widths) + (classes,)
    return sum(dense_flops(a, b) for a, b in zip(dims, dims[1:]))


def k2_bytes(n: int, h: int, w: int, c: int, oh: int, ow: int,
             in_bytes: int = 4, out_bytes: int = 4) -> float:
    """The warp reads its images once and writes its chips once."""
    return n * h * w * c * in_bytes + n * oh * ow * c * out_bytes


def k2_flops(n: int, oh: int, ow: int, c: int) -> float:
    """Four taps a channel, a multiply and an add each, plus the
    coordinate map: about 12 operations an output value."""
    return 12.0 * n * oh * ow * c
