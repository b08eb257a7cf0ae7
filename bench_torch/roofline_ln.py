"""The least time of the Swin face embedder's LayerNorms, from shapes, as
``roofline.py`` counts a kernel's bytes: each norm reads its input once,
in the dtype it arrives in, and writes its output once, in the dtype its
consumer takes, whatever implements it.  The operations (a few an
element) are far below the card's ridge, so the bound is the bytes.

A forward's 53 norms at 112^2 and patch 2 (grids 56 / 28 / 14 / 7 from
``roofline_swin.stages``):

- the patch norm: the convolution's bf16 in, float32 out (the residual
  stream), 6 bytes an element;
- the 48 block norms and the 3 merge norms: float32 in, bf16 out (the
  next Linear's input), 6 bytes an element;
- the final norm: float32 in, float32 out (the head), 8 bytes.

That is 33,266,688 bytes a chip: 34.07 GB and 10.17 ms at 3.35 TB/s for
1,024 chips.
"""

from __future__ import annotations

from bench_torch import roofline as R
from bench_torch import roofline_swin as RS

BF16, F32 = 2, 4


def ln_norms(size: int = 112, patch: int = 2, dim: int = 96,
             depths=(2, 2, 18, 2), window: int = 7
             ) -> list[tuple[int, int, int]]:
    """(rows a chip, width, bytes an element) of each norm of a forward,
    in the order they run."""
    st = RS.stages(size, patch, dim, depths, window)
    side0, c0 = st[0][0], st[0][1]
    out = [(side0 * side0, c0, BF16 + F32)]
    for i, (side, c, depth, _) in enumerate(st):
        out += [(side * side, c, F32 + BF16)] * (2 * depth)
        if i < len(st) - 1:
            out.append(((side // 2) ** 2, 4 * c, F32 + BF16))
    side, c = st[-1][0], st[-1][1]
    out.append((side * side, c, F32 + F32))
    return out


def ln_bytes_per_chip(size: int = 112, patch: int = 2, dim: int = 96,
                      depths=(2, 2, 18, 2), window: int = 7) -> int:
    """The bytes one chip's forward moves through its norms."""
    return sum(rows * c * b for rows, c, b in
               ln_norms(size, patch, dim, depths, window))


def ln_bound_per_forward_s(chips: int, size: int = 112, patch: int = 2,
                           dim: int = 96, depths=(2, 2, 18, 2),
                           window: int = 7) -> float:
    """The norms' least time over a forward of ``chips`` chips."""
    return R.bound_s(0.0, R.H100_BF16_TFLOPS, chips * ln_bytes_per_chip(
        size, patch, dim, depths, window))[0]
