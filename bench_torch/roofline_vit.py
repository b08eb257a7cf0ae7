"""The operations of insightface's ViT face embedder and the least time of
its attention core, from shapes, as ``roofline.py`` counts them: products
at 2 operations a multiply-add, elementwise work (LayerNorm, ReLU6, the
softmax, BN) not counted.

The core's least time counts the same work whatever implements it: the
larger of its two products' operations (4 T^2 D a face) over the card's
dense TF32 tensor peak, 494.7 TFLOP/s (no float32-accurate method runs
faster, so a core that emulates float32 on TF32, as 3xTF32 does, cannot
read above 100 %), and its bytes (q, k and v read once and the output
written once, each at 2 bytes, the bf16 that the qkv product gives and
proj takes) over 3.35 TB/s.
"""

from __future__ import annotations

from bench_torch import roofline as R

H100_TF32_TFLOPS = 494.7


def attn_flops(tokens: int, dim: int) -> float:
    """One face through one block's core: q k^T and the weighted v."""
    return 4.0 * tokens * tokens * dim


def attn_bytes(tokens: int, dim: int) -> float:
    """One face through one block's core: q, k, v in, the output out."""
    return 4.0 * tokens * dim * 2


def attn_bound_s(faces: int, tokens: int, dim: int) -> float:
    """The least time of one block's core over ``faces`` faces."""
    return R.bound_s(faces * attn_flops(tokens, dim), H100_TF32_TFLOPS,
                     faces * attn_bytes(tokens, dim))[0]


def vit_flops(size: int = 112, patch: int = 9, dim: int = 768,
              depth: int = 24, mlp: int = 3072,
              embedding: int = 512) -> float:
    """One face through the embedder: the patch convolution, per block
    qkv, the core, proj, fc1 and fc2, then the feature head's two
    Linears."""
    tokens = (size // patch) ** 2
    block = tokens * (R.dense_flops(dim, 3 * dim) + R.dense_flops(dim, dim)
                      + R.dense_flops(dim, mlp) + R.dense_flops(mlp, dim))
    block += attn_flops(tokens, dim)
    return (tokens * R.dense_flops(3 * patch * patch, dim) + depth * block
            + R.dense_flops(tokens * dim, dim)
            + R.dense_flops(dim, embedding))
