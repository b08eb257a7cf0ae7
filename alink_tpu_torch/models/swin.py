"""A Swin Transformer face embedder (Liu et al., arXiv:2103.14030,
``microsoft/Swin-Transformer`` ``models/swin_transformer.py``) on 112 x 112
aligned chips, as FaceX-Zoo (arXiv:2101.04407) and SwinFace
(arXiv:2308.11509) run Swin backbones for face recognition; Swin-S at its
published widths is ``FaceSwin_S``.  No JAX counterpart.

Raw NHWC RGB chips in [0, 255] -> (N, 512) float32 embeddings:

1. x = chip / 127.5 - 1, NCHW;
2. patch embedding ``patch_embed``: Conv2d(3 -> C, kernel = stride = 2,
   bias), the 56 x 56 grid of tokens in row-major order, LayerNorm; no
   absolute position embedding (``ape`` False);
3. four stages (``layers``) of depths (2, 2, 18, 2), widths C = 96, 192,
   384, 768 and heads 3, 6, 12, 24 of 32 over grids of 56, 28, 14, 7, each
   block x += proj(W-MSA(LN1(x))), then x += fc2(GELU(fc1(LN2(x)))):
   LN eps 1e-5; qkv = Linear(C -> 3C, bias), proj = Linear(C -> C, bias);
   fc1 = Linear(C -> 4C, bias), GELU (the exact erf form), fc2 =
   Linear(4C -> C, bias).  W-MSA attends inside 7 x 7 windows:
   softmax(q k^T 32^-1/2 + B) v with B[h, i, j] = table[(dy + 6) 13 +
   (dx + 6), h], (dy, dx) the offset of token i from token j in the window;
   odd blocks shift the grid cyclically by 3 first (``torch.roll(x, (-3,
   -3))``), add -100 between tokens whose regions of the shifted frame
   differ (each axis cut at S - 7 and S - 3), and shift back after.  Where
   the grid is no larger than the window (stage 4, 7 x 7) the window is the
   grid and nothing shifts, as the published code sets: 11 shifted blocks of
   24, and 64, 16, 4 and 1 windows a chip in stages 1-4;
4. patch merging (``downsample``) after stages 1-3: concat[x(0::2, 0::2),
   x(1::2, 0::2), x(0::2, 1::2), x(1::2, 1::2)] (the published order, which
   real weights assume), LN(4C), Linear(4C -> 2C, no bias);
5. the final LN(768) and the mean over the tokens, then the face head
   ``feature``: Linear(768 -> 512, no bias) - BatchNorm1d(eps 1e-5).

Precision, as Swin trains under fp16 autocast, with bf16 for fp16: the
patch convolution and every Linear of the blocks and merges run in
``dtype`` (their weights held in it); the residual stream, every
LayerNorm, the bias and mask additions and the softmax are float32; P
enters P v in bf16 with float32 sums, as autocast's matmul takes it, and
the core writes bf16; the final LN and the head are float32.  Each LN is
computed in float32 and written in the dtype its consumer takes: the bf16
the next Linear reads (the 48 block norms and the 3 merge norms), float32
for the patch norm and the final norm.  On the card that is one launch of
``ops.layer_norm``'s kernel a norm (``launches.ln``, 53 a Swin-S forward),
which rounds once at its store, where ``.to`` rounds on the CPU.

The windowed core is ``ops.attention.window_attention``: on the card one
launch of a hand-written kernel a block (``launches.wattn``), which reads
the qkv product's bf16 output in grid order with the shift and the
partition folded into its loads and writes the merged heads in grid order;
on the CPU the plain float32 roll, partition, products and softmax.

Departures: S = q k^T is kept in float32 (autocast would round it to bf16
before the bias), and the scale multiplies S rather than q (q 32^-1/2 is
not a bf16 value); the output is L2-normalised (face embedders normalise
at evaluation; ``normalize=False`` gives the raw feature); the face head
is FaceX-Zoo's embedding layer in place of Swin's classifier.  The bias
table's index and the shift mask are computed where they are used
(``ops.attention.relative_position_index``, ``shift_mask``), not held as
buffers.  LayerNorm and BatchNorm parameters are named ``gamma``/``beta``
(and ``mean``/``var``), as ``models/vit.py``'s.  Drop path is
training-only and absent.  The kernel takes bf16 only: a float32 Swin runs
its core on the CPU only.

Spans ``swin.patch``, ``swin.attn`` (the windowed core alone, once a
block), ``swin.mlp`` (once a block), ``swin.merge`` (3), ``swin.head`` and
``ln`` (each LayerNorm, 53 a Swin-S forward);
counters ``swin.forwards``, ``swin.tokens`` (chips x the tokens of the
four grids, 4,165 at 112) and ``swin.windows`` (chips x the window
attentions of a forward, 234 at 112).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from alink_tpu_torch.models.resnet import _FrozenBN, _lecun_normal_
from alink_tpu_torch.models.vit import LayerNorm, _linear
from alink_tpu_torch.ops.attention import window_attention
from alink_tpu_torch.utils.profiling import count, span

LN_EPS = 1e-5
BN_EPS = 1e-5


class WindowCore(nn.Module):
    """The windowed core, (N, S, S, 3C) qkv and the bias table -> (N, S,
    S, C) (``ops.attention.window_attention``).  A module of its own so
    that forward hooks see its inputs and output."""

    def __init__(self, shift: int, window: int):
        super().__init__()
        self.shift = shift
        self.window = window

    def forward(self, qkv: torch.Tensor, table: torch.Tensor
                ) -> torch.Tensor:
        with span("swin.attn"):
            return window_attention(qkv, table, self.shift, self.window)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, dtype,
                 generator, device):
        super().__init__()
        self.heads = heads
        self.qkv = _linear(dim, 3 * dim, True, dtype, generator, device)
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            (2 * window - 1) ** 2, heads, device=device))
        with torch.no_grad():
            # The published truncated normal of std 0.02 is cut at +-2, so
            # it is a plain normal.
            self.relative_position_bias_table.copy_(torch.randn(
                self.relative_position_bias_table.shape,
                generator=generator) * 0.02)
        self.core = WindowCore(shift, window)
        self.proj = _linear(dim, dim, True, dtype, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, S, S, C) in the products' dtype -> the same."""
        core = self.core(self.qkv(x), self.relative_position_bias_table)
        return self.proj(core.to(x.dtype))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype, generator, device):
        super().__init__()
        self.fc1 = _linear(dim, hidden, True, dtype, generator, device)
        self.fc2 = _linear(hidden, dim, True, dtype, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("swin.mlp"):
            return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """Pre-norm block on the float32 residual stream, (N, S, S, C); its
    products in ``dtype``.  A grid no larger than the window takes the
    whole grid as its window and does not shift."""

    def __init__(self, dim: int, heads: int, size: int, window: int,
                 shift: int, mlp_ratio: int, dtype, generator, device):
        super().__init__()
        if size <= window:
            window, shift = size, 0
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, LN_EPS, device=device)
        self.attn = WindowAttention(dim, heads, window, shift, dtype,
                                    generator, device)
        self.norm2 = LayerNorm(dim, LN_EPS, device=device)
        self.mlp = Mlp(dim, mlp_ratio * dim, dtype, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x, self.dtype))
        return x + self.mlp(self.norm2(x, self.dtype))


class PatchMerging(nn.Module):
    """(N, S, S, C) float32 -> (N, S / 2, S / 2, 2C) float32: the 2 x 2
    gather in the published order, LN(4C), Linear(4C -> 2C, no bias)."""

    def __init__(self, dim: int, dtype, generator, device):
        super().__init__()
        self.norm = LayerNorm(4 * dim, LN_EPS, device=device)
        self.reduction = _linear(4 * dim, 2 * dim, False, dtype, generator,
                                 device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("swin.merge"):
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                           x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
            return self.reduction(self.norm(
                x, self.reduction.weight.dtype)).float()


class Stage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, size: int,
                 window: int, mlp_ratio: int, merge: bool, dtype, generator,
                 device):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, size, window, 0 if i % 2 == 0
                      else window // 2, mlp_ratio, dtype, generator, device)
            for i in range(depth))
        self.downsample = (PatchMerging(dim, dtype, generator, device)
                           if merge else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int, dtype, generator, device):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch, dtype=dtype,
                              device=device)
        _lecun_normal_(self.proj.weight, 3 * patch * patch, generator)
        nn.init.zeros_(self.proj.bias)
        self.norm = LayerNorm(dim, LN_EPS, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) raw RGB -> (N, S, S, C) float32 tokens."""
        x = (x.permute(0, 3, 1, 2).float() / 127.5 - 1.0).to(
            self.proj.weight.dtype)
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class FaceSwin(nn.Module):
    """The Swin face embedder: (N, S, S, 3) raw RGB -> (N, embedding_dim)
    float32, L2-normalised unless ``normalize=False``."""

    def __init__(self, input_size: int = 112, patch_size: int = 2,
                 embed_dim: int = 96, depths=(2, 2, 18, 2),
                 num_heads=(3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: int = 4, embedding_dim: int = 512,
                 dtype: torch.dtype = torch.bfloat16, normalize: bool = True,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if len(depths) != len(num_heads):
            raise ValueError(f"depths {depths} and num_heads {num_heads} "
                             f"differ in length")
        g, dev = generator, device
        self.normalize = normalize
        self.embedding_dim = embedding_dim
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype, g, dev)
        size, dim = input_size // patch_size, embed_dim
        self.grids, layers = [], []
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            if dim % heads or size % 2 and i < len(depths) - 1:
                raise ValueError(f"stage {i}: width {dim} over {heads} heads "
                                 f"on a {size} grid")
            if size > window_size and size % window_size:
                raise ValueError(f"stage {i}: a {size} grid is not a whole "
                                 f"number of {window_size} windows")
            self.grids.append(size)
            layers.append(Stage(dim, depth, heads, size, window_size,
                                mlp_ratio, i < len(depths) - 1, dtype, g,
                                dev))
            if i < len(depths) - 1:
                size, dim = size // 2, 2 * dim
        self.layers = nn.ModuleList(layers)
        self.num_features = dim
        self.norm = LayerNorm(dim, LN_EPS, device=dev)
        self.feature = nn.Sequential(
            _linear(dim, embedding_dim, False, torch.float32, g, dev),
            _FrozenBN(embedding_dim, BN_EPS, torch.float32, dev))
        self.num_tokens = sum(s * s for s in self.grids)
        self.num_windows = sum(
            len(stage.blocks) * (s // stage.blocks[0].attn.core.window) ** 2
            for stage, s in zip(self.layers, self.grids))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        count("swin.forwards")
        count("swin.tokens", x.shape[0] * self.num_tokens)
        count("swin.windows", x.shape[0] * self.num_windows)
        with span("swin.patch"):
            t = self.patch_embed(x)
        for stage in self.layers:
            t = stage(t)
        with span("swin.head"):
            y = self.feature(self.norm(t).mean(dim=(1, 2)))
            if not self.normalize:
                return y
            norm = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
            return y / torch.clamp(norm, min=1e-12)


def FaceSwin_S(**kwargs) -> FaceSwin:
    """Swin-S (``swin_small_patch4_window7_224``'s widths) on 112 x 112
    chips at patch 2: C 96, depths (2, 2, 18, 2), heads (3, 6, 12, 24) of
    32, window 7, MLP ratio 4, 512-d."""
    return FaceSwin(input_size=112, patch_size=2, embed_dim=96,
                    depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24),
                    window_size=7, mlp_ratio=4, embedding_dim=512, **kwargs)
