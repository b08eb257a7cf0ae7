"""Frozen batch norm and the VGGFace-ResNet50 teacher featurizer
(counterpart of ``alink_tpu/models/resnet.py``).

``VGGFaceResNet50`` is the keras_vggface resnet50 to its flattened avg_pool
(2048-d).  Its parameters are laid out as the flax module's (``Conv_0``,
``_FrozenBN_0``, ``_Bottleneck_i/{Conv_j, _FrozenBN_j}``, see ``convert.py``)
and its forward is the counterpart of ``vggface_resnet50_fused_apply``: the
13 stride-1 bottlenecks run through ``ops.resblock.bottleneck_chain`` (kernel
K3 on a CUDA tensor, its plain version on a CPU tensor), the stem and the 3
strided blocks are plain PyTorch in bf16.  The JAX model's ``s2d_stem`` and
``scan_units`` are TPU-only knobs and are not ported.  ``VGGFace16`` and
``SENet50`` are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from alink_tpu_torch.ops.resblock import (BottleneckWeights, bottleneck_chain,
                                          kernel_weights)

KERAS_BN_EPS = 1e-3
MXNET_BN_EPS = 2e-5


class _FrozenBN(nn.Module):
    """Inference batch norm on channel axis 1 (NCHW or (N, C)):
    y = (x - mean) / sqrt(var + eps) * gamma + beta.

    Scale and shift are formed in f32, cast to ``dtype``, and applied in
    ``dtype``, as in the JAX module.  ``eps`` must match the framework
    that produced the statistics (2e-5 for insightface MXNet checkpoints).
    """

    def __init__(self, channels: int, eps: float = KERAS_BN_EPS,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        for name, fill in (("gamma", 1.0), ("beta", 0.0), ("mean", 0.0),
                           ("var", 1.0)):
            self.register_buffer(
                name, torch.full((channels,), fill, dtype=torch.float32,
                                 device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        root = torch.sqrt(self.var + self.eps)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = (self.gamma / root).to(self.dtype).reshape(shape)
        shift = (self.beta - self.mean * self.gamma / root).to(
            self.dtype).reshape(shape)
        return x.to(self.dtype) * scale + shift


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   generator: torch.Generator | None) -> None:
    """N(0, 1/fan_in) init (flax's default kernel scale), drawn on the CPU
    from ``generator`` so a seed gives the same weights on every device."""
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator) * fan_in ** -0.5)


def _make_conv(cin: int, cout: int, k: int, bias: bool, generator,
               device) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, bias=bias, device=device)
    _lecun_normal_(conv.weight, cin * k * k, generator)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


def _fold_bn(bn: _FrozenBN) -> tuple[torch.Tensor, torch.Tensor]:
    """Frozen BN -> (scale, shift) in f32, as the JAX ``_fold_bn``."""
    s = bn.gamma / torch.sqrt(bn.var + bn.eps)
    return s, bn.beta - bn.mean * s


class _Bottleneck(nn.Module):
    """ResNet-v1 bottleneck 1x1 -> 3x3 -> 1x1 (+ projection), parameters
    named as the flax ``_Bottleneck``: conv.0-2 (+ conv.3), bn.0-2 (+ bn.3).
    """

    def __init__(self, cin: int, filters: int, project: bool, dtype,
                 generator, device):
        super().__init__()
        f = filters
        self.dtype = dtype
        self.conv = nn.ModuleList(
            [_make_conv(cin, f, 1, False, generator, device),
             _make_conv(f, f, 3, False, generator, device),
             _make_conv(f, 4 * f, 1, False, generator, device)]
            + ([_make_conv(cin, 4 * f, 1, False, generator, device)]
               if project else []))
        self.bn = nn.ModuleList(
            _FrozenBN(c, KERAS_BN_EPS, dtype, device=device)
            for c in (f, f, 4 * f) + ((4 * f,) if project else ()))

    def strided(self, y: torch.Tensor) -> torch.Tensor:
        """Stride-2 block in plain PyTorch, BN in ``dtype`` (the JAX fused
        forward's ``strided_block``).  NCHW in and out."""
        w = [c.weight.to(self.dtype) for c in self.conv]
        ys = y[:, :, ::2, ::2]
        z = torch.relu(self.bn[0](F.conv2d(ys, w[0])))
        z = torch.relu(self.bn[1](F.conv2d(z, w[1], padding=1)))
        z = self.bn[2](F.conv2d(z, w[2]))
        return torch.relu(z + self.bn[3](F.conv2d(ys, w[3])))


def bottleneck_weights(block: _Bottleneck) -> BottleneckWeights:
    """A bottleneck's parameters -> ``ops.resblock.BottleneckWeights`` (1x1
    kernels as (in, out) matrices, the 3x3 as HWIO, BN folded)."""
    c = block.conv
    mat = lambda conv: conv.weight[:, :, 0, 0].t()  # noqa: E731
    s1, b1 = _fold_bn(block.bn[0])
    s2, b2 = _fold_bn(block.bn[1])
    s3, b3 = _fold_bn(block.bn[2])
    proj = len(c) == 4
    sp, bp = _fold_bn(block.bn[3]) if proj else (None, None)
    hwio = c[1].weight.permute(2, 3, 1, 0)
    return BottleneckWeights(mat(c[0]), s1, b1, hwio, s2, b2, mat(c[2]), s3,
                             b3, mat(c[3]) if proj else None, sp, bp)


def _tf_same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """TF 'SAME' padding (before, after): asymmetric, (2, 3) for 7x7 s2 at
    224."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class VGGFaceResNet50(nn.Module):
    """keras_vggface resnet50 to the flattened avg_pool: (N, H, W, 3)
    preprocessed NHWC -> (N, 2048) f32.

    Numerics: the stem (TF-'SAME' 7x7 s2 conv, BN, ReLU, VALID 3x3 s2
    max-pool: 55x55 at 224) and the strided blocks run in ``dtype`` (bf16),
    the stride-1 blocks in the fused block's numerics on every device (f32
    BN epilogues, bf16 at y1, y2 and the output), where the JAX default
    forward runs flax's bf16 BN; the two agree to a relative max error of
    0.02 (``tests/test_resblock.py``).

    The stride-1 blocks' weights are folded into the kernel's layout once
    and cached; loading a state dict or moving the module drops the cache.
    Call ``refold()`` after editing parameters in place.  The parameters do
    not require grad: the teacher is frozen.
    """

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        self.conv = nn.ModuleList([_make_conv(3, 64, 7, False, generator,
                                              device)])
        self.bn = nn.ModuleList([_FrozenBN(64, KERAS_BN_EPS, dtype,
                                           device=device)])
        blocks = []
        cin = 64
        for blocks_n, w in zip(self.stage_sizes, (64, 128, 256, 512)):
            for b in range(blocks_n):
                blocks.append(_Bottleneck(cin, w, b == 0, dtype, generator,
                                          device))
                cin = 4 * w
        self.blocks = nn.ModuleList(blocks)
        # The frozen teacher: gradients flow to the input only (FGSM).
        self.requires_grad_(False)
        self._folded: tuple[torch.device, list] | None = None
        self.register_load_state_dict_post_hook(_drop_folded)

    def refold(self) -> None:
        """Drop the cached stride-1 weights; the next forward folds them."""
        self._folded = None

    def _apply(self, fn, recurse=True):
        self.refold()
        return super()._apply(fn, recurse)

    def _stride1_weights(self, device) -> list[tuple[BottleneckWeights, ...]]:
        """Each stage's stride-1 blocks, BN folded, in the kernel's layout
        on ``device`` (``ops.resblock.kernel_weights``)."""
        if self._folded is None or self._folded[0] != device:
            stages, idx = [], 0
            for stage, n_blocks in enumerate(self.stage_sizes):
                first = 1 if stage > 0 else 0
                stages.append(tuple(
                    kernel_weights(bottleneck_weights(blk), device)
                    for blk in self.blocks[idx + first:idx + n_blocks]))
                idx += n_blocks
            self._folded = (device, stages)
        return self._folded[1]

    def forward(self, x: torch.Tensor,
                chain: Callable = bottleneck_chain) -> torch.Tensor:
        """``chain`` runs each stage's stride-1 blocks (NHWC in and out);
        the default dispatches on the tensor's device.

        Differentiable in ``x`` when grad is enabled (FGSM): the stride-1
        blocks then give dx only (``ops.resblock.BottleneckS1``), so the
        featurizer is frozen; inference callers run it under
        ``torch.no_grad``."""
        dt = self.dtype
        y = x.to(dt).permute(0, 3, 1, 2)
        ph = _tf_same_pad(y.shape[2], 7, 2)
        pw = _tf_same_pad(y.shape[3], 7, 2)
        y = F.conv2d(F.pad(y, pw + ph), self.conv[0].weight.to(dt), None, 2)
        y = F.max_pool2d(torch.relu(self.bn[0](y)), 3, 2)
        idx = 0
        for stage, run in enumerate(self._stride1_weights(x.device)):
            if stage > 0:
                y = self.blocks[idx].strided(y)
            idx += self.stage_sizes[stage]
            if run:
                # Divergence from the JAX default forward: fused-block
                # numerics (f32 BN epilogues) here on every device, where
                # flax runs bf16 BN; relative max error <= 0.02 between them.
                y = chain(y.permute(0, 2, 3, 1), run).permute(0, 3, 1,
                                                              2).to(dt)
        return y.float().mean(dim=(2, 3))


def _drop_folded(module: VGGFaceResNet50, incompatible_keys) -> None:
    module.refold()
