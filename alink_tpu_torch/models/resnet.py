"""Frozen batch norm and the VGGFace backbones (counterpart of
``alink_tpu/models/resnet.py``).

``VGGFaceResNet50`` is the keras_vggface resnet50 to its flattened avg_pool
(2048-d).  Its parameters are laid out as the flax module's (``Conv_0``,
``_FrozenBN_0``, ``_Bottleneck_i/{Conv_j, _FrozenBN_j}``, see ``convert.py``)
and its forward is the counterpart of ``vggface_resnet50_fused_apply``: the
13 stride-1 bottlenecks run through ``ops.resblock.bottleneck_chain`` (kernel
K3 on a CUDA tensor, its plain version on a CPU tensor), the stem and the 3
strided blocks are cuDNN convolutions in bf16, each BN with its ReLU (and a
block's residual add) one ``ops.bn_act`` pass, 10 a forward.
``trainable=True`` gives the classifier's backbone (``models/classify.py``):
every parameter, BN statistics included, trains, and the stride-1 blocks
fold on every forward.

``ResNet50V15`` is torchvision's ResNet-50 (v1.5: a strided block's stride
on its 3x3) to its three last stages' maps, RetinaFace-R50's backbone
(``models/retinaface.py``).  Both ResNet-50s share ``_FusedTrunk``: the
bottlenecks by stage, the 13 stride-1 ones through ``bottleneck_chain``
with their weights folded into K3's layout once and cached.  The
torchvision trunk's stem and strided blocks are cuDNN convolutions in
``dtype`` with each BN folded into its convolution's weights and bias
(cached beside K3's weights), where the keras trunk applies its BNs
unfolded.

``SENet50`` (keras_vggface senet50, 2048-d) and ``VGGFace16`` (vgg16 to its
NHWC-flattened pool5, 25,088-d at 224^2) back the identification
classifiers only; they run as cuDNN convolutions in ``dtype``: SENet50's SE
gate sits between a block's last BN and its add, so K3 cannot fuse its
blocks (the JAX package runs them outside any Pallas kernel too).  The JAX
models' ``s2d_stem`` and ``scan_units`` are TPU-only knobs and are not
ported.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from alink_tpu_torch.ops.bn_act import bn_act, bn_params, frozen_bn
from alink_tpu_torch.ops.resblock import (BottleneckWeights, bottleneck_chain,
                                          kernel_weights)

KERAS_BN_EPS = 1e-3
MXNET_BN_EPS = 2e-5
TORCH_BN_EPS = 1e-5


class _FrozenBN(nn.Module):
    """Inference batch norm on channel axis 1 (NCHW or (N, C)):
    y = (x - mean) / sqrt(var + eps) * gamma + beta.

    Scale and shift are formed in f32, cast to ``dtype``, and applied in
    ``dtype``, as in the JAX module.  ``eps`` must match the framework
    that produced the statistics (2e-5 for insightface MXNet checkpoints).
    gamma, beta, mean and var are buffers, or with ``trainable`` parameters
    (the same state-dict names): the JAX module holds all four as params,
    and its classifier trainer gradient-steps the statistics too.
    """

    def __init__(self, channels: int, eps: float = KERAS_BN_EPS,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 trainable: bool = False):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        for name, fill in (("gamma", 1.0), ("beta", 0.0), ("mean", 0.0),
                           ("var", 1.0)):
            t = torch.full((channels,), fill, dtype=torch.float32,
                           device=device)
            if trainable:
                self.register_parameter(name, nn.Parameter(t))
            else:
                self.register_buffer(name, t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return frozen_bn(x, bn_params(self), self.dtype)


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


def _make_dense(cin: int, cout: int, generator, device) -> nn.Linear:
    lin = nn.Linear(cin, cout, device=device)
    _lecun_normal_(lin.weight, cin, generator)
    nn.init.zeros_(lin.bias)
    return lin


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype,
          stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Convolution in ``dtype``; the bias is added afterwards in ``dtype``
    (flax's order of rounding)."""
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, stride, padding)
    if conv.bias is not None:
        y = y + conv.bias.to(dtype).reshape(1, -1, 1, 1)
    return y


def _dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)


def _fold_bn(bn: _FrozenBN) -> tuple[torch.Tensor, torch.Tensor]:
    """Frozen BN -> (scale, shift) in f32, as the JAX ``_fold_bn``."""
    s = bn.gamma / torch.sqrt(bn.var + bn.eps)
    return s, bn.beta - bn.mean * s


class _Bottleneck(nn.Module):
    """ResNet-v1 bottleneck 1x1 -> 3x3 -> 1x1 (+ projection), parameters
    named as the flax ``_Bottleneck``: conv.0-2 (+ conv.3), bn.0-2 (+ bn.3).
    """

    def __init__(self, cin: int, filters: int, project: bool, dtype,
                 generator, device, trainable: bool = False,
                 eps: float = KERAS_BN_EPS):
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
            _FrozenBN(c, eps, dtype, device, trainable)
            for c in (f, f, 4 * f) + ((4 * f,) if project else ()))

    def strided(self, y: torch.Tensor) -> torch.Tensor:
        """Stride-2 block, BN in ``dtype`` (the JAX fused forward's
        ``strided_block``): convolutions, then each BN with its ReLU, and
        the last BN with the projection's BN, the add and the ReLU, in
        three ``bn_act`` passes.  NCHW in and out."""
        w = [c.weight.to(self.dtype) for c in self.conv]
        # One channels-last copy of the strided input for both 1x1
        # convolutions: cuDNN then writes their outputs channels-last, as
        # bn_act reads them.
        ys = y[:, :, ::2, ::2].contiguous(memory_format=torch.channels_last)
        z = bn_act(F.conv2d(ys, w[0]), self.bn[0], relu=True)
        z = bn_act(F.conv2d(z, w[1], padding=1), self.bn[1], relu=True)
        return bn_act(F.conv2d(z, w[2]), self.bn[2],
                      shortcut=F.conv2d(ys, w[3]), shortcut_bn=self.bn[3],
                      relu=True)


def fold_conv(conv: nn.Conv2d, bn: _FrozenBN, dtype: torch.dtype
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """A bias-free convolution followed by a frozen BN as one convolution:
    (weight * scale, shift), folded in f32 and cast to ``dtype``."""
    s, b = _fold_bn(bn)
    return ((conv.weight * s.reshape(-1, 1, 1, 1)).to(dtype).contiguous(),
            b.to(dtype))


def _strided_v15(y: torch.Tensor, folded) -> torch.Tensor:
    """torchvision's strided bottleneck (v1.5: the stride on the 3x3, pad
    1, and on the projection) on NCHW ``y``, from ``fold_conv``'s (weight,
    bias) of its four convolutions: cuDNN convolutions with the bias, the
    ReLUs in place."""
    (w1, b1), (w3, b3), (w2, b2), (wp, bp) = folded
    z = torch.relu_(F.conv2d(y, w1, b1))
    z = torch.relu_(F.conv2d(z, w3, b3, stride=2, padding=1))
    z = F.conv2d(z, w2, b2)
    return torch.relu_(z.add_(F.conv2d(y, wp, bp, stride=2)))


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


def _stem(x: torch.Tensor, conv: nn.Conv2d, bn: _FrozenBN,
          dtype: torch.dtype) -> torch.Tensor:
    """The keras_vggface stem on NHWC ``x``: TF-'SAME' 7x7 s2 conv (pads
    asymmetrically, (2, 3) at 224), BN and ReLU (one ``bn_act`` pass), then
    a VALID 3x3 s2 max-pool (55x55 at 224).  NCHW out."""
    # NHWC packed (one cast, or one copy where ``x`` is a permuted NCHW
    # tensor), so the convolution writes channels-last, as bn_act reads.
    y = x.to(dtype, memory_format=torch.contiguous_format).permute(0, 3, 1, 2)
    ph = _tf_same_pad(y.shape[2], 7, 2)
    pw = _tf_same_pad(y.shape[3], 7, 2)
    y = F.conv2d(F.pad(y, pw + ph), conv.weight.to(dtype), None, 2)
    return F.max_pool2d(bn_act(y, bn, relu=True), 3, 2)


class FoldCache(nn.Module):
    """A frozen module whose weights are prepared for inference (BN folded,
    laid out for a kernel) once per device and cached: ``_cached(device,
    build)``.  Loading a state dict or moving the module drops the cache,
    and ``refold()`` drops it, and every such submodule's, after an edit in
    place."""

    def __init__(self):
        super().__init__()
        self._folded: tuple[torch.device, object] | None = None
        self.register_load_state_dict_post_hook(_drop_folded)

    def refold(self) -> None:
        """Drop the cached weights; the next forward prepares them."""
        for m in self.modules():
            if isinstance(m, FoldCache):
                m._folded = None

    def _apply(self, fn, recurse=True):
        self._folded = None
        return super()._apply(fn, recurse)

    def _cached(self, device, build: Callable):
        if self._folded is None or self._folded[0] != device:
            self._folded = (device, build())
        return self._folded[1]


class _FusedTrunk(FoldCache):
    """What both ResNet-50s share: bottleneck stages of ``stage_sizes``
    blocks (``self.blocks``, built by the subclass), whose stride-1 blocks
    (every block of stage 1, all but the first of the later stages) run
    through ``bottleneck_chain``.

    Frozen (``trainable`` False), their weights are folded into the
    kernel's layout once and cached (``FoldCache``) with whatever
    ``_prepare_more`` adds (the torchvision trunk's folded cuDNN weights).
    Trainable, the blocks fold on every forward, inside autograd when grad
    is enabled."""

    def __init__(self, stage_sizes: Sequence[int], trainable: bool):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.trainable = trainable

    def _fold(self) -> list[tuple[BottleneckWeights, ...]]:
        """Each stage's stride-1 blocks, BN folded (differentiable f32)."""
        stages, idx = [], 0
        for stage, n_blocks in enumerate(self.stage_sizes):
            first = 1 if stage > 0 else 0
            stages.append(tuple(
                bottleneck_weights(blk)
                for blk in self.blocks[idx + first:idx + n_blocks]))
            idx += n_blocks
        return stages

    def _prepare_more(self):
        """What a subclass caches beside K3's weights (nothing here)."""
        return None

    def _prepared(self, device) -> tuple[list[tuple[BottleneckWeights, ...]],
                                         object]:
        """(the stride-1 blocks' weights, ``_prepare_more()``): for a
        frozen model the blocks in the kernel's layout on ``device``
        (``ops.resblock.kernel_weights``), all cached; for a trainable one
        folded anew (``bottleneck_chain`` lays them out for the kernel)."""
        if self.trainable:
            return self._fold(), self._prepare_more()
        return self._cached(device, lambda: ([
            tuple(kernel_weights(w, device) for w in run)
            for run in self._fold()], self._prepare_more()))

    def _stages(self, y: torch.Tensor, runs, strided: Callable,
                chain: Callable) -> list[torch.Tensor]:
        """Each stage's output from the stem's NCHW ``y``: the stage's
        first block by ``strided(y, index)`` past stage 1, then its
        stride-1 blocks by ``chain`` (NHWC in and out)."""
        outs, idx = [], 0
        for stage, run in enumerate(runs):
            if stage > 0:
                y = strided(y, idx)
            idx += self.stage_sizes[stage]
            if run:
                y = chain(y.permute(0, 2, 3, 1), run)
                y = y.permute(0, 3, 1, 2).to(self.dtype)
            outs.append(y)
        return outs


class VGGFaceResNet50(_FusedTrunk):
    """keras_vggface resnet50 to the flattened avg_pool: (N, H, W, 3)
    preprocessed NHWC -> (N, 2048) f32.

    Numerics: the stem (TF-'SAME' 7x7 s2 conv, BN, ReLU, VALID 3x3 s2
    max-pool: 55x55 at 224) and the strided blocks run in ``dtype`` (bf16),
    the stride-1 blocks in the fused block's numerics on every device (f32
    BN epilogues, bf16 at y1, y2 and the output), where the JAX default
    forward runs flax's bf16 BN; the two agree to a relative max error of
    0.02 (``tests/test_resblock.py``).

    Frozen (the default, the teacher): the parameters do not require grad,
    BN statistics are buffers, and the stride-1 blocks' weights are folded
    into the kernel's layout once and cached (``_FusedTrunk``).

    ``trainable=True`` (the classifier's backbone): every parameter trains,
    BN gamma, beta, mean and var included (parameters, as in the JAX
    module), and the stride-1 blocks fold on every forward, inside autograd
    when grad is enabled (``ops.resblock.BottleneckS1`` then gives the
    weight gradients); nothing is cached.
    """

    feature_dim = 2048

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None, device=None,
                 trainable: bool = False):
        super().__init__(stage_sizes, trainable)
        self.dtype = dtype
        self.conv = nn.ModuleList([_make_conv(3, 64, 7, False, generator,
                                              device)])
        self.bn = nn.ModuleList([_FrozenBN(64, KERAS_BN_EPS, dtype, device,
                                           trainable)])
        blocks = []
        cin = 64
        for blocks_n, w in zip(self.stage_sizes, (64, 128, 256, 512)):
            for b in range(blocks_n):
                blocks.append(_Bottleneck(cin, w, b == 0, dtype, generator,
                                          device, trainable))
                cin = 4 * w
        self.blocks = nn.ModuleList(blocks)
        if not trainable:
            # The frozen teacher: gradients flow to the input only (FGSM).
            self.requires_grad_(False)

    def forward(self, x: torch.Tensor,
                chain: Callable = bottleneck_chain) -> torch.Tensor:
        """``chain`` runs each stage's stride-1 blocks (NHWC in and out);
        the default dispatches on the tensor's device.

        Frozen, the forward is differentiable in ``x`` when grad is enabled
        (FGSM): the stride-1 blocks then give dx only; inference callers
        run it under ``torch.no_grad``.  Trainable, it is differentiable in
        ``x`` and every parameter."""
        y = _stem(x, self.conv[0], self.bn[0], self.dtype)
        runs, _ = self._prepared(x.device)
        # Divergence from the JAX default forward: fused-block numerics
        # (f32 BN epilogues) in the stride-1 blocks on every device, where
        # flax runs bf16 BN; relative max error <= 0.02 between them.
        y = self._stages(y, runs, lambda t, i: self.blocks[i].strided(t),
                         chain)[-1]
        return y.float().mean(dim=(2, 3))


class ResNet50V15(_FusedTrunk):
    """torchvision's ResNet-50 (v1.5) without its pool and classifier:
    (N, 3, H, W) NCHW input in ``dtype`` -> the outputs of stages 2, 3 and
    4 (C3, C4, C5: 512, 1,024 and 2,048 channels at H / 8, / 16, / 32),
    NCHW in ``dtype`` (channels-last memory on the cuDNN path).

    Stem: 7x7 stride-2 convolution, padding 3, BN, ReLU, 3x3 stride-2
    max-pool, padding 1.  Stages (3, 4, 6, 3) of 1x1 -> 3x3 -> 1x1
    bottlenecks, widths 64 to 512 (x 4 out); the first block of each stage
    projects its shortcut, and past stage 1 has stride 2 on its 3x3 and on
    the projection (``_strided_v15``).  Frozen BN with eps 1e-5, folded
    into the stem's and the strided blocks' convolutions (cuDNN in
    ``dtype``); the 13 stride-1 blocks run on K3 (``_FusedTrunk``).
    Inference only: the parameters do not require grad."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None, device=None):
        super().__init__(stage_sizes, trainable=False)
        self.dtype = dtype
        self.widths = tuple(widths)
        stem = self.widths[0]
        self.conv = nn.ModuleList([_make_conv(3, stem, 7, False, generator,
                                              device)])
        self.bn = nn.ModuleList([_FrozenBN(stem, TORCH_BN_EPS, dtype,
                                           device)])
        blocks, cin = [], stem
        for blocks_n, w in zip(self.stage_sizes, self.widths):
            for b in range(blocks_n):
                blocks.append(_Bottleneck(cin, w, b == 0, dtype, generator,
                                          device, eps=TORCH_BN_EPS))
                cin = 4 * w
        self.blocks = nn.ModuleList(blocks)
        self.channels = tuple(4 * w for w in self.widths[1:])
        self.requires_grad_(False)

    def _prepare_more(self):
        """The stem's and each strided block's convolutions with their BN
        folded (``fold_conv``), keyed by block index."""
        dt = self.dtype
        strided, idx = {}, 0
        for n_blocks in self.stage_sizes:
            if idx:
                blk = self.blocks[idx]
                strided[idx] = [fold_conv(c, b, dt)
                                for c, b in zip(blk.conv, blk.bn)]
            idx += n_blocks
        return fold_conv(self.conv[0], self.bn[0], dt), strided

    @torch.no_grad()
    def forward(self, x: torch.Tensor, chain: Callable = bottleneck_chain
                ) -> list[torch.Tensor]:
        runs, (stem, strided) = self._prepared(x.device)
        y = torch.relu_(F.conv2d(x.to(self.dtype), *stem, stride=2,
                                 padding=3))
        y = F.max_pool2d(y, 3, 2, padding=1)
        return self._stages(y, runs, lambda t, i: _strided_v15(t, strided[i]),
                            chain)[1:]


def _drop_folded(module: FoldCache, incompatible_keys) -> None:
    module.refold()


class _SEBottleneck(nn.Module):
    """ResNet-v1 bottleneck with a squeeze-and-excitation gate (reduction
    16) between its last BN and the add, parameters named as the flax
    ``_SEBottleneck``: conv.0-2 (+ conv.3), bn.0-2 (+ bn.3), dense.0-1.
    NCHW in and out."""

    def __init__(self, cin: int, filters: int, stride: int, project: bool,
                 dtype, generator, device, reduction: int = 16):
        super().__init__()
        f = filters
        self.stride = stride
        self.dtype = dtype
        self.conv = nn.ModuleList(
            [_make_conv(cin, f, 1, False, generator, device),
             _make_conv(f, f, 3, False, generator, device),
             _make_conv(f, 4 * f, 1, False, generator, device)]
            + ([_make_conv(cin, 4 * f, 1, False, generator, device)]
               if project else []))
        self.bn = nn.ModuleList(
            _FrozenBN(c, KERAS_BN_EPS, dtype, device, trainable=True)
            for c in (f, f, 4 * f) + ((4 * f,) if project else ()))
        self.dense = nn.ModuleList(
            [_make_dense(4 * f, 4 * f // reduction, generator, device),
             _make_dense(4 * f // reduction, 4 * f, generator, device)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        xs = x[:, :, ::self.stride, ::self.stride]   # a strided 1x1 conv
        y = torch.relu(self.bn[0](_conv(xs, self.conv[0], dt)))
        y = torch.relu(self.bn[1](_conv(y, self.conv[1], dt, padding=1)))
        y = self.bn[2](_conv(y, self.conv[2], dt))
        # SE gate in f32: spatial mean -> Dense + ReLU -> Dense + sigmoid,
        # the channel scale applied in ``dtype``.
        se = y.float().mean(dim=(2, 3))
        se = torch.relu(F.linear(se, self.dense[0].weight, self.dense[0].bias))
        se = torch.sigmoid(F.linear(se, self.dense[1].weight,
                                    self.dense[1].bias))
        y = y * se.to(dt)[:, :, None, None]
        if len(self.conv) == 4:
            shortcut = self.bn[3](_conv(xs, self.conv[3], dt))
        else:
            shortcut = x.to(dt)
        return torch.relu(y + shortcut)


class SENet50(nn.Module):
    """keras_vggface senet50 to the flattened avg_pool: (N, H, W, 3)
    preprocessed NHWC -> (N, 2048) f32 (reference: code/model.py:126-141).
    The keras_vggface stem of ``VGGFaceResNet50``, then 16 SE bottlenecks
    (3, 4, 6, 3), all in ``dtype``; every parameter trains, BN statistics
    included (parameters, as in the JAX module)."""

    feature_dim = 2048

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        self.conv = nn.ModuleList([_make_conv(3, 64, 7, False, generator,
                                              device)])
        self.bn = nn.ModuleList([_FrozenBN(64, KERAS_BN_EPS, dtype, device,
                                           trainable=True)])
        blocks = []
        cin = 64
        for stage, (blocks_n, w) in enumerate(zip(self.stage_sizes,
                                                  (64, 128, 256, 512))):
            for b in range(blocks_n):
                stride = 2 if (b == 0 and stage > 0) else 1
                blocks.append(_SEBottleneck(cin, w, stride, b == 0, dtype,
                                            generator, device))
                cin = 4 * w
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _stem(x, self.conv[0], self.bn[0], self.dtype)
        for blk in self.blocks:
            y = blk(y)
        return y.float().mean(dim=(2, 3))


_VGG16_WIDTHS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
                 (512, 512, 512))


class VGGFace16(nn.Module):
    """keras_vggface vgg16 to the flattened pool5: (N, H, W, 3) preprocessed
    NHWC -> (N, 512 * (H / 32) * (W / 32)) f32, 25,088-d at 224^2
    (reference: code/siamese.py:187-200).  13 biased 3x3 SAME convs with
    ReLU and five 2x2 max-pools, in ``dtype``.  pool5 flattens in NHWC
    order, as the JAX module does, so converted fc6 rows need no
    permutation; ``input_size`` fixes ``feature_dim`` (the JAX module
    infers its consumer's width on first call)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 input_size: tuple[int, int] = (224, 224),
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.dtype = dtype
        convs, cin = [], 3
        for widths in _VGG16_WIDTHS:
            for w in widths:
                convs.append(_make_conv(cin, w, 3, True, generator, device))
                cin = w
        self.conv = nn.ModuleList(convs)
        h, w = input_size
        self.feature_dim = 512 * (h // 32) * (w // 32)
        if not self.feature_dim:
            raise ValueError(f"input {input_size} is below VGG16's "
                             "smallest, 32^2")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.permute(0, 3, 1, 2)
        convs = iter(self.conv)
        for widths in _VGG16_WIDTHS:
            for _ in widths:
                y = torch.relu(_conv(y, next(convs), self.dtype, padding=1))
            y = F.max_pool2d(y, 2, 2)
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1).float()
