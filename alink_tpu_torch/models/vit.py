"""insightface's vision-transformer face embedder (``arcface_torch``
``backbones/vit.py``, trained with Partial FC, arXiv:2203.15565); ViT-L at
its published sizes is ``FaceViT_L`` (the factory's
``vit_l_dp005_mask_005``).  No JAX counterpart.

Raw NHWC RGB chips in [0, 255] -> (N, 512) float32 embeddings:

1. x = chip / 127.5 - 1 (insightface's (img / 255 - 0.5) / 0.5), NCHW;
2. patch embedding ``patch_embed.proj``: Conv2d(3 -> D, kernel = stride =
   P, bias).  At 112 and P = 9 a 12 x 12 grid: the last 4 pixel rows and
   columns are unused, 144 tokens in row-major order; then ``+ pos_embed``
   (1, T, D).  No class token;
3. ``depth`` pre-norm blocks, each t += proj(attn(LN1(t))), then
   t += fc2(ReLU6(fc1(LN2(t)))): LN eps 1e-6; qkv = Linear(D -> 3D, no
   bias) split as (N, T, 3, H, D / H); the attention core
   softmax(q k^T (D / H)^-1/2) v with the heads concatenated back to D;
   proj = Linear(D -> D, bias); fc1 = Linear(D -> M, bias), ReLU6,
   fc2 = Linear(M -> D, bias);
4. LN(t), flattened token-major to T * D values;
5. ``feature``: Linear(T * D -> D, no bias) - BatchNorm1d(eps 2e-5) -
   Linear(D -> E, no bias) - BatchNorm1d(eps 2e-5).

Precision, as insightface runs under fp16 autocast with bf16 for fp16:
the patch convolution and every Linear of the blocks run in ``dtype``
(their weights are held in it, so nothing is cast per call); the residual
stream, every LayerNorm and the attention core run in float32 (the core
computes on the float32 values of q, k and v, as insightface does with
autocast off); the final LN and the feature head run in float32, as
ArcFace's fc1.  Each block's two LNs write the bf16 their product takes
in one pass (on the card one launch of ``ops.layer_norm``'s kernel a
norm, ``launches.ln``, 49 a ViT-L forward), rounding once where ``.to``
would.  Drop path, dropout and random masking are training-only
and absent.

The core is ``ops.attention.attention_core``: on the card one launch of a
hand-written kernel a block, which reads the bf16 q, k and v where the
qkv product left them and writes the merged heads in float32.  It is
float32-accurate without an upcast: a product of two bf16 values is exact
in float32, so S = q k^T runs on bf16 tensor cores with float32 sums, the
softmax is float32, and the probabilities enter P v split in three bf16
terms that carry all 24 of their bits.  On the CPU it is the plain
float32 matmul-softmax-matmul.  The card's kernel takes bf16 q, k, v
only (``dtype`` bf16); a float32 ViT runs its core on the CPU only.

Departure: the output is L2-normalised (insightface returns the raw
feature and normalises at evaluation); ``normalize=False`` gives the raw
feature.  LayerNorm and BatchNorm parameters are named ``gamma``/``beta``
(and ``mean``/``var``), as ``_FrozenBN``'s; ``convert.load_insightface_vit``
maps insightface's names.  Tensor and pipeline parallelism
(``parallel/tp.py``, ``pp.py``) serve ArcFace only.

Spans ``vit.patch``, ``vit.attn`` (the float32 core, once a block: one
launch of the kernel on the card, ``launches.attn``),
``vit.mlp`` (once a block), ``vit.head`` and ``ln`` (each LayerNorm,
49 a ViT-L forward); counters ``vit.forwards``
and ``vit.tokens`` (faces x tokens).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from alink_tpu_torch.models.resnet import (MXNET_BN_EPS, _FrozenBN,
                                           _lecun_normal_)
from alink_tpu_torch.ops.attention import attention_core
from alink_tpu_torch.ops.layer_norm import layer_norm, layer_norm_reference
from alink_tpu_torch.utils.profiling import count, span

LN_EPS = 1e-6


def _linear(cin: int, cout: int, bias: bool, dtype, generator,
            device) -> nn.Linear:
    lin = nn.Linear(cin, cout, bias=bias, dtype=dtype, device=device)
    _lecun_normal_(lin.weight, cin, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, computed in float32 whatever the
    input and written in ``out_dtype`` (float32 unless the consumer takes
    another), under span ``ln``.  With no gradient wanted, a CUDA input
    takes one launch of ``ops.layer_norm``'s kernel (``launches.ln``);
    where one is wanted, and on the CPU, it is ``F.layer_norm`` on the
    float32 upcast, then ``.to(out_dtype)``."""

    def __init__(self, dim: int, eps: float = LN_EPS, device=None):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim, device=device))
        self.beta = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, self.gamma, self.beta))
        with span("ln"):
            if grad:
                return layer_norm_reference(x, self.gamma, self.beta,
                                            self.eps, out_dtype)
            return layer_norm(x.contiguous(), self.gamma, self.beta,
                              self.eps, out_dtype)


class AttentionCore(nn.Module):
    """softmax(q k^T d^-1/2) v in float32: q, k, v (N, H, T, d) -> (N, T,
    H * d) float32, the heads merged (``ops.attention.attention_core``:
    bf16 views of the qkv product on the card, any float dtype on the
    CPU).  A module of its own so that forward hooks see its inputs and
    output."""

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        with span("vit.attn"):
            return attention_core(q, k, v)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dtype, generator, device):
        super().__init__()
        self.heads = heads
        self.qkv = _linear(dim, 3 * dim, False, dtype, generator, device)
        self.core = AttentionCore()
        self.proj = _linear(dim, dim, True, dtype, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, d = x.shape
        qkv = self.qkv(x).reshape(n, t, 3, self.heads, d // self.heads
                                  ).permute(2, 0, 3, 1, 4)
        return self.proj(self.core(qkv[0], qkv[1], qkv[2]).to(x.dtype))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype, generator, device):
        super().__init__()
        self.fc1 = _linear(dim, hidden, True, dtype, generator, device)
        self.fc2 = _linear(hidden, dim, True, dtype, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("vit.mlp"):
            return self.fc2(F.relu6(self.fc1(x)))


class Block(nn.Module):
    """Pre-norm block on the float32 residual stream; its products in
    ``dtype``."""

    def __init__(self, dim: int, heads: int, hidden: int, dtype, generator,
                 device):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = Attention(dim, heads, dtype, generator, device)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp = Mlp(dim, hidden, dtype, generator, device)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t + self.attn(self.norm1(t, self.dtype))
        return t + self.mlp(self.norm2(t, self.dtype))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int, dtype, generator, device):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch, dtype=dtype,
                              device=device)
        _lecun_normal_(self.proj.weight, 3 * patch * patch, generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) raw RGB -> (N, T, D) tokens in the conv's dtype."""
        x = (x.permute(0, 3, 1, 2).float() / 127.5 - 1.0).to(
            self.proj.weight.dtype)
        return self.proj(x).flatten(2).transpose(1, 2)


class FaceViT(nn.Module):
    """The ViT face embedder: (N, S, S, 3) raw RGB -> (N, embedding_dim)
    float32, L2-normalised unless ``normalize=False``."""

    def __init__(self, input_size: int = 112, patch_size: int = 9,
                 embed_dim: int = 768, depth: int = 24, num_heads: int = 8,
                 mlp_dim: int = 3072, embedding_dim: int = 512,
                 dtype: torch.dtype = torch.bfloat16, normalize: bool = True,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        g, dev = generator, device
        self.normalize = normalize
        self.embedding_dim = embedding_dim
        self.num_tokens = (input_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype, g, dev)
        self.pos_embed = nn.Parameter(torch.empty(
            1, self.num_tokens, embed_dim, device=dev))
        with torch.no_grad():
            # insightface's truncated normal of std 0.02 is cut at +-2, so
            # it is a plain normal.
            self.pos_embed.copy_(torch.randn(self.pos_embed.shape,
                                             generator=g) * 0.02)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_dim, dtype, g, dev)
            for _ in range(depth))
        self.norm = LayerNorm(embed_dim, device=dev)
        flat = self.num_tokens * embed_dim
        self.feature = nn.Sequential(
            _linear(flat, embed_dim, False, torch.float32, g, dev),
            _FrozenBN(embed_dim, MXNET_BN_EPS, torch.float32, dev),
            _linear(embed_dim, embedding_dim, False, torch.float32, g, dev),
            _FrozenBN(embedding_dim, MXNET_BN_EPS, torch.float32, dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        count("vit.forwards")
        count("vit.tokens", x.shape[0] * self.num_tokens)
        with span("vit.patch"):
            t = self.patch_embed(x) + self.pos_embed
        for block in self.blocks:
            t = block(t)
        with span("vit.head"):
            y = self.feature(self.norm(t).reshape(t.shape[0], -1))
            if not self.normalize:
                return y
            norm = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
            return y / torch.clamp(norm, min=1e-12)


def FaceViT_L(**kwargs) -> FaceViT:
    """insightface ``vit_l_dp005_mask_005``: 112 x 112, patch 9, 768 wide,
    24 blocks of 8 heads of 96, MLP 3,072, 512-d."""
    return FaceViT(input_size=112, patch_size=9, embed_dim=768, depth=24,
                   num_heads=8, mlp_dim=3072, embedding_dim=512, **kwargs)
