"""Fused stride-1 ResNet bottleneck blocks (kernel K3).

Counterpart of ``alink_tpu/ops/resblock.py``.  One block is

    y1  = bf16(relu(x . W1 * s1 + b1))                 1x1 reduce
    y2  = bf16(relu(conv3x3_SAME(y1, W3) * s2 + b2))   zero padding
    y3  = y2 . W2 * s3 + b3                            1x1 expand
    out = bf16(relu(y3 + shortcut)),  shortcut = x . Wp * sp + bp  or  x

with bf16 operands, f32 accumulation and BN folded to f32 scale/shift: the
rounding points of the TPU kernel ``_block_kernel``.  Layout is NHWC, as in
the JAX package; the kernel keeps its own flat halo layout in shared
memory (``ops/qconv.py`` holds the chainable flat layout of K4).

- ``bottleneck_s1_reference`` — plain PyTorch (f32 products of bf16-rounded
  operands; TF32 is off package-wide, ``alink_tpu_torch/__init__.py``).
- ``bottleneck_s1_kernel``    — the hand-written kernel ``csrc/bottleneck.cu``;
  it takes weights already in its layout (``kernel_weights``), so a model
  prepares them once and no launch copies a weight.
- ``bottleneck_chain``        — dispatcher over a chain of blocks: the kernel
  on CUDA tensors, the plain version on CPU tensors.  With grad enabled and
  an input that requires it, each block runs as ``BottleneckS1``, a
  ``torch.autograd.Function`` whose forward is that dispatch and whose
  backward gives dx only (the teacher is frozen): it recomputes y1, y2 and
  the ReLU masks with differentiable PyTorch ops (f32, the 3x3 as a
  convolution) and back-propagates through them.  The TPU kernel has no
  backward either: the JAX package's FGSM gradient comes from XLA's
  autodiff of unfused convolutions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from alink_tpu_torch import _build


class BottleneckWeights(NamedTuple):
    """One stride-1 bottleneck, BN folded to (scale, shift), JAX layouts.

    w1: (Cin, Cm)        s1/b1: (Cm,)
    w3: (3, 3, Cm, Cm)   s2/b2: (Cm,)     HWIO
    w2: (Cm, Cout)       s3/b3: (Cout,)
    wp: (Cin, Cout) projection shortcut (None = identity, Cin == Cout)
    sp/bp: (Cout,)
    """

    w1: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    w3: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    w2: torch.Tensor
    s3: torch.Tensor
    b3: torch.Tensor
    wp: torch.Tensor | None = None
    sp: torch.Tensor | None = None
    bp: torch.Tensor | None = None


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and hold in f32."""
    return t.to(torch.bfloat16).float()


@torch.no_grad()
def bottleneck_s1_reference(x: torch.Tensor,
                            wts: BottleneckWeights) -> torch.Tensor:
    """Plain stride-1 bottleneck: (N, H, W, Cin) -> (N, H, W, Cout) bf16."""
    return _block_plain(x, wts)


def _block_plain(x: torch.Tensor, wts: BottleneckWeights) -> torch.Tensor:
    """The plain version's arithmetic, differentiable when grad is enabled
    (the card check of the backward compares against its autograd)."""
    n, h, w, cin = x.shape
    cm, cout = wts.w2.shape
    f = lambda t: t.float()  # noqa: E731
    xf = _bf16(x).reshape(-1, cin)
    y1 = torch.relu(xf @ _bf16(wts.w1) * f(wts.s1) + f(wts.b1))
    # The 3x3 as 9 shifted products over the zero-padded y1: plain f32
    # matmuls, where a cuDNN f32 convolution may pick a Winograd or FFT
    # algorithm that rounds differently.
    y1 = F.pad(_bf16(y1).reshape(n, h, w, cm), (0, 0, 1, 1, 1, 1))
    k3 = _bf16(wts.w3)
    y2 = sum(y1[:, dy:dy + h, dx:dx + w].reshape(-1, cm) @ k3[dy, dx]
             for dy in range(3) for dx in range(3))
    y2 = _bf16(torch.relu(y2 * f(wts.s2) + f(wts.b2)))
    y3 = y2 @ _bf16(wts.w2) * f(wts.s3) + f(wts.b3)
    if wts.wp is not None:
        sc = xf @ _bf16(wts.wp) * f(wts.sp) + f(wts.bp)
    else:
        sc = xf
    out = torch.relu(y3 + sc).to(torch.bfloat16)
    return out.reshape(n, h, w, cout)


# Limits of csrc/bottleneck.cu: x is staged 32 channels at a time (kKC),
# products run on 16-wide fragments, and y1 (113 rows) plus y2 (64 rows) of
# Cm bf16 channels and 23.5 KB of staging must fit the 227 KB of shared
# memory a block can have on an H100, which bounds Cm at 576.
_CIN_STEP = 32
_C_STEP = 16
_MAX_CM = 576


_MATRICES = ("w1", "w3", "w2", "wp")


@torch.no_grad()
def kernel_weights(wts: BottleneckWeights, device=None) -> BottleneckWeights:
    """``wts`` in the layout ``bottleneck_s1_kernel`` reads: the weight
    matrices bf16, scale and shift f32, all contiguous on ``device``.  The
    plain version gives the same result on either form (it rounds the
    matrices to bf16 itself)."""
    return BottleneckWeights(*(
        None if t is None else t.to(
            device, torch.bfloat16 if name in _MATRICES else torch.float32
        ).contiguous()
        for name, t in zip(BottleneckWeights._fields, wts)))


def _check_kernel_layout(wts: BottleneckWeights, dev) -> None:
    for name, t in zip(BottleneckWeights._fields, wts):
        want = torch.bfloat16 if name in _MATRICES else torch.float32
        if t is not None and (t.device != dev or t.dtype != want
                              or not t.is_contiguous()):
            raise ValueError(
                f"bottleneck_s1_kernel: {name} is {t.dtype} on {t.device}"
                f"{'' if t.is_contiguous() else ', not contiguous'}; pass "
                f"weights from kernel_weights(wts, {dev}) ({want} contiguous)")


@torch.no_grad()
def bottleneck_s1_kernel(x: torch.Tensor,
                         wts: BottleneckWeights) -> torch.Tensor:
    """Launch ``csrc/bottleneck.cu`` on a CUDA tensor (N, H, W, Cin), with
    ``wts`` from ``kernel_weights`` on the same device.

    Takes Cin % 32 == 0, Cm and Cout % 16 == 0, Cm <= 576.
    ``bottleneck_s1_kernel.launches`` counts the launches.
    """
    if not x.is_cuda:
        raise ValueError("bottleneck_s1_kernel needs a CUDA tensor")
    n, h, w, cin = x.shape
    cin_w, cm = wts.w1.shape
    cout = wts.w2.shape[1]
    if cin_w != cin or tuple(wts.w3.shape) != (3, 3, cm, cm) \
            or wts.w2.shape[0] != cm:
        raise ValueError(f"bottleneck weights do not chain: x has {cin} "
                         f"channels, w1 {tuple(wts.w1.shape)}, w3 "
                         f"{tuple(wts.w3.shape)}, w2 {tuple(wts.w2.shape)}")
    if wts.wp is None and cin != cout:
        raise ValueError("identity shortcut requires Cin == Cout")
    if cin % _CIN_STEP or cm % _C_STEP or cout % _C_STEP or cm > _MAX_CM:
        raise ValueError(
            f"bottleneck kernel takes Cin % {_CIN_STEP} == 0, Cm and Cout % "
            f"{_C_STEP} == 0 and Cm <= {_MAX_CM} (shared memory); got Cin "
            f"{cin}, Cm {cm}, Cout {cout}")
    dev = x.device
    _check_kernel_layout(wts, dev)
    x = x.to(torch.bfloat16).contiguous()
    out = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=dev)
    # w3 is HWIO (3, 3, Cm, Cm) contiguous: the (9, Cm, Cm) taps the .cu reads.
    ptrs = [None if t is None else t.data_ptr() for t in wts]
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.alink_bottleneck(x.data_ptr(), n, h, w, cin, cm, cout,
                                      *ptrs, out.data_ptr(), stream)
    bottleneck_s1_kernel.launches += 1
    _build.check(status, "bottleneck")
    return out


bottleneck_s1_kernel.launches = 0


def bottleneck_chain_reference(x: torch.Tensor,
                               blocks: tuple[BottleneckWeights, ...]
                               ) -> torch.Tensor:
    """A chain of plain stride-1 bottlenecks: NHWC in, NHWC bf16 out."""
    for wts in blocks:
        x = bottleneck_s1_reference(x, wts)
    return x


def _block_forward(x: torch.Tensor, wts: BottleneckWeights) -> torch.Tensor:
    """One block without autograd: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.is_cuda:
        return bottleneck_s1_kernel(x, wts)
    if x.device.type != "cpu":
        raise ValueError(f"no bottleneck for device {x.device}")
    return bottleneck_s1_reference(x, wts)


def _block_recompute(x: torch.Tensor, wts: BottleneckWeights) -> torch.Tensor:
    """The block as differentiable f32 ops on NHWC ``x`` (the backward's
    recompute): the operands and y1, y2 rounded to bf16 as the kernel
    rounds them, so the ReLU masks are the forward's up to the order of
    f32 sums; the rounding passes gradients through unchanged."""
    n, h, w, cin = x.shape
    cm = wts.w1.shape[1]
    f = lambda t: t.float()  # noqa: E731
    y1 = _bf16(torch.relu(x.reshape(-1, cin) @ _bf16(f(wts.w1)) * f(wts.s1)
                          + f(wts.b1)))
    y1 = y1.reshape(n, h, w, cm).permute(0, 3, 1, 2)
    k3 = _bf16(f(wts.w3)).permute(3, 2, 0, 1)        # HWIO -> OIHW
    y2 = F.conv2d(y1, k3, padding=1).permute(0, 2, 3, 1).reshape(-1, cm)
    y2 = _bf16(torch.relu(y2 * f(wts.s2) + f(wts.b2)))
    y3 = y2 @ _bf16(f(wts.w2)) * f(wts.s3) + f(wts.b3)
    xf = x.reshape(-1, cin)
    sc = xf if wts.wp is None else \
        xf @ _bf16(f(wts.wp)) * f(wts.sp) + f(wts.bp)
    return torch.relu(y3 + sc).reshape(n, h, w, -1)


class BottleneckS1(torch.autograd.Function):
    """One stride-1 block with a gradient for its input only."""

    @staticmethod
    def forward(ctx, x, *wts):
        wts = BottleneckWeights(*wts)
        ctx.wts = wts
        ctx.save_for_backward(x)
        return _block_forward(x, wts)

    @staticmethod
    def backward(ctx, grad_out):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xr = _bf16(x.detach()).requires_grad_(True)
            out = _block_recompute(xr, ctx.wts)
            (dx,) = torch.autograd.grad(out, xr, grad_out.float())
        return (dx.to(x.dtype),) + (None,) * len(BottleneckWeights._fields)


def bottleneck_chain(x: torch.Tensor,
                     blocks: tuple[BottleneckWeights, ...]) -> torch.Tensor:
    """A chain of stride-1 bottlenecks: the kernel on a CUDA tensor, the
    plain version on a CPU tensor; differentiable in ``x`` when grad is
    enabled and ``x`` requires it.  NHWC in, NHWC bf16 out."""
    grad = torch.is_grad_enabled() and x.requires_grad
    for wts in blocks:
        x = BottleneckS1.apply(x, *wts) if grad else _block_forward(x, wts)
    return x
