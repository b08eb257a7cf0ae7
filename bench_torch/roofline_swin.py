"""The operations of the Swin face embedder and the least time of its
windowed attention core, from shapes, as ``roofline.py`` counts them:
products at 2 operations a multiply-add; LayerNorm, GELU, the softmax,
the bias and mask additions, the mean and BN not counted.

At 112^2 and patch 2 (grids 56, 28, 14, 7) a Swin-S chip takes 17.46
GFLOP: the patch convolution 0.0072, the 24 blocks' Linears 16.65, their
windowed cores 0.46, the three merges 0.35 and the head 0.0008.

The core's least time, a block: the larger of its operations (q k^T and
P v over 49 keys: 4 x tokens x 49 x C) over the bf16 tensor peak and its
bytes (q, k and v read once and the output written once, all bf16 as the
qkv product gives them and proj takes them: 8 x tokens x C) over
3.35 TB/s.  At 49 operations a byte it is bound by bytes at every batch.
"""

from __future__ import annotations

from bench_torch import roofline as R


def stages(size: int = 112, patch: int = 2, dim: int = 96,
           depths=(2, 2, 18, 2), window: int = 7
           ) -> list[tuple[int, int, int, int]]:
    """(grid side, width, blocks, window) of each stage: the window is the
    grid where the grid is no larger."""
    out, side = [], size // patch
    for i, depth in enumerate(depths):
        out.append((side, dim, depth, min(window, side)))
        if i < len(depths) - 1:
            side, dim = side // 2, 2 * dim
    return out


def wattn_flops(tokens: int, dim: int, window: int = 7) -> float:
    """One chip through one block's windowed core: q k^T and P v."""
    return 4.0 * tokens * window * window * dim


def wattn_bytes(tokens: int, dim: int) -> float:
    """One chip through one block's core: q, k, v in and the output out,
    bf16."""
    return 8.0 * tokens * dim


def wattn_bound_s(chips: int, side: int, dim: int, window: int = 7) -> float:
    """The least time of one block's core over ``chips`` chips."""
    tokens = side * side
    return R.bound_s(chips * wattn_flops(tokens, dim, window),
                     R.H100_BF16_TFLOPS, chips * wattn_bytes(tokens, dim))[0]


def wattn_bound_per_forward_s(chips: int, size: int = 112, patch: int = 2,
                              dim: int = 96, depths=(2, 2, 18, 2),
                              window: int = 7) -> float:
    """The cores' least time summed over a forward's blocks."""
    return sum(depth * wattn_bound_s(chips, side, c, w)
               for side, c, depth, w in stages(size, patch, dim, depths,
                                                window))


def swin_flops(size: int = 112, patch: int = 2, dim: int = 96,
               depths=(2, 2, 18, 2), window: int = 7, mlp_ratio: int = 4,
               embedding: int = 512) -> float:
    """One chip through the embedder: the patch convolution, per block
    qkv, the core, proj, fc1 and fc2, the merges' reductions and the
    head's Linear."""
    st = stages(size, patch, dim, depths, window)
    total = (size // patch) ** 2 * R.dense_flops(3 * patch * patch, dim)
    for i, (side, c, depth, w) in enumerate(st):
        tokens = side * side
        block = tokens * (R.dense_flops(c, 3 * c) + R.dense_flops(c, c)
                          + R.dense_flops(c, mlp_ratio * c)
                          + R.dense_flops(mlp_ratio * c, c))
        total += depth * (block + wattn_flops(tokens, c, w))
        if i < len(st) - 1:
            total += (side // 2) ** 2 * R.dense_flops(4 * c, 2 * c)
    return total + R.dense_flops(st[-1][1], embedding)
