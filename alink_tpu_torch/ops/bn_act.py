"""The elementwise chain around a ResNet's convolutions, fused: a frozen
batch norm, then a PReLU, a residual add or a ReLU, in one pass over the
activation.

Each mode is one read of its inputs and one write:

- ``bn``: ``y = round(round(x * s) + b)``, the ``_FrozenBN`` forward;
- ``bn_prelu``: ``bn``, then ``where(y >= 0, y, round(round(alpha) * y))``,
  the ``_PReLU`` forward (ArcFace);
- ``bn_add``: ``round(bn(x) + shortcut)``, where ``shortcut`` passes
  through its own frozen BN when one is given (a projecting unit's
  ``bn.3``), else is added as it is (ArcFace);
- ``bn_relu`` and ``bn_add_bn_relu``: ``bn``, or ``bn_add`` with the
  shortcut's BN, then ``torch.relu`` (the keras ResNet-50's stem and
  strided bottlenecks).

``s`` and ``b`` are formed from the BN's f32 statistics as ``_FrozenBN``
forms them (``root = sqrt(var + eps)``, ``s = gamma / root``,
``b = beta - mean * gamma / root``), each rounded to the working type;
``round`` is a rounding to the working type (bf16 or f32).

``bn_act_reference`` is the plain PyTorch version, the modules' own
operations in their order.  ``bn_act`` takes it for CPU tensors and
launches ``csrc/bn_act.cu`` for CUDA tensors (``bn_act_kernel``, bit-equal
to the plain version on the card).  Where a gradient is wanted, the call
is an autograd function.  Its backward gives the activations' gradients
by ``bn_act_backward_reference``, the plain path's own backward
operations (the gradient times the scale, through the PReLU's mask from
the recomputed BN output first, through the ReLU's mask from the saved
output), which CUDA tensors take in one launch of the kernel's backward
(``bn_act_backward_kernel``, bit-equal); only a
PReLU slope or a trainable statistic that wants a gradient adds the
plain sums over the channels and the statistics' own chain under
autograd.  The gradients equal plain autograd's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from alink_tpu_torch import _build


class BNParams(NamedTuple):
    """A frozen BN's f32 statistics (each (C,)) and its epsilon."""
    gamma: torch.Tensor
    beta: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor
    eps: float


def bn_params(bn) -> BNParams:
    """The statistics a ``_FrozenBN`` holds now (under ``functional_call``
    the substituted ones)."""
    return BNParams(bn.gamma, bn.beta, bn.mean, bn.var, bn.eps)


def scale_shift(bn: BNParams, dtype: torch.dtype,
                dims: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A frozen BN's scale and shift, formed from its f32 statistics and
    rounded to ``dtype``, shaped to broadcast over channel axis 1 of a
    ``dims``-D activation."""
    root = torch.sqrt(bn.var + bn.eps)
    shape = (1, -1) + (1,) * (dims - 2)
    scale = (bn.gamma / root).to(dtype).reshape(shape)
    shift = (bn.beta - bn.mean * bn.gamma / root).to(dtype).reshape(shape)
    return scale, shift


def frozen_bn(x: torch.Tensor, bn: BNParams,
              dtype: torch.dtype) -> torch.Tensor:
    """The frozen BN on channel axis 1 in ``dtype`` (``_FrozenBN``'s
    forward): ``x * scale + shift``."""
    scale, shift = scale_shift(bn, dtype, x.dim())
    return x.to(dtype) * scale + shift


def prelu(x: torch.Tensor, alpha: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """The channel-wise PReLU on axis 1 in ``dtype`` (``_PReLU``'s
    forward), the slope rounded to ``dtype``."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    x = x.to(dtype)
    return torch.where(x >= 0, x, alpha.to(dtype).reshape(shape) * x)


def bn_act_reference(x: torch.Tensor, bn: BNParams, dtype: torch.dtype,
                     alpha: torch.Tensor | None = None,
                     shortcut: torch.Tensor | None = None,
                     shortcut_bn: BNParams | None = None,
                     relu: bool = False) -> torch.Tensor:
    """``bn``, ``bn_prelu`` (``alpha`` given) or ``bn_add`` (``shortcut``
    given), then with ``relu`` the ReLU, in plain PyTorch, as
    ``_FrozenBN``, ``_PReLU``, ``+`` and ``torch.relu`` run."""
    y = frozen_bn(x, bn, dtype)
    if alpha is not None:
        return prelu(y, alpha, dtype)
    if shortcut is not None:
        shortcut = (shortcut.to(dtype) if shortcut_bn is None
                    else frozen_bn(shortcut, shortcut_bn, dtype))
        y = y + shortcut
    return torch.relu(y) if relu else y


def bn_act_backward_reference(
        grad: torch.Tensor, saved: torch.Tensor | None, bn: BNParams,
        dtype: torch.dtype, alpha: torch.Tensor | None = None,
        shortcut: bool = False, shortcut_bn: BNParams | None = None,
        relu: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The gradients of ``bn_act_reference``'s output with respect to ``x``
    and the shortcut (None without one), in ``dtype``, as plain autograd
    computes them from the output's gradient ``grad``: ``g * scale``, and
    ``g`` or ``g * scale'`` for the shortcut, where ``g`` is ``grad``
    through the PReLU ``where(y >= 0, grad, grad * alpha)`` or the ReLU's
    ``threshold_backward``.  ``saved`` is read only for those masks: the
    BN's input ``x`` for the PReLU (its BN recomputed), the forward's
    output for the ReLU.  (Autograd's sum of the PReLU's two branches can
    differ from the ``where`` in the sign of a zero only.)"""
    scale, _ = scale_shift(bn, dtype, grad.dim())
    g = grad
    if alpha is not None:
        y = frozen_bn(saved, bn, dtype)
        g = torch.where(y >= 0, grad,
                        grad * alpha.to(dtype).reshape(scale.shape))
    if relu:
        g = torch.ops.aten.threshold_backward(grad, saved, 0)
    dr = None
    if shortcut:
        dr = (g if shortcut_bn is None
              else g * scale_shift(shortcut_bn, dtype, grad.dim())[0])
    return g * scale, dr


# The kernel's codes (``alink_bn_act``, ``alink_bn_act_backward``).
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"bn": 0, "bn_prelu": 1, "bn_add": 2, "bn_add_bn": 3, "bn_relu": 4,
          "bn_add_bn_relu": 5}


def _mode(alpha: torch.Tensor | None, shortcut: bool,
          shortcut_bn: BNParams | None, relu: bool) -> str:
    """The mode of a call; raises on a combination no mode takes."""
    if alpha is not None and (shortcut or relu):
        raise ValueError("bn_act: a PReLU takes no shortcut and no ReLU")
    if not shortcut and shortcut_bn is not None:
        raise ValueError("bn_act: shortcut_bn without a shortcut")
    if alpha is not None:
        return "bn_prelu"
    if not shortcut:
        return "bn_relu" if relu else "bn"
    if shortcut_bn is None:
        if relu:
            raise ValueError("bn_act: a ReLU after a shortcut takes the "
                             "shortcut's BN")
        return "bn_add"
    return "bn_add_bn_relu" if relu else "bn_add_bn"


def _activation(t: torch.Tensor, dtype: torch.dtype, what: str,
                shape: torch.Size | None = None) -> torch.Tensor:
    if t.dim() != 4 or (shape is not None and t.shape != shape):
        raise ValueError(f"bn_act: {what} must be (N, C, H, W)"
                         f"{'' if shape is None else f' {tuple(shape)}'}, "
                         f"got {tuple(t.shape)}")
    t = t.to(dtype)
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"bn_act: {what} must be channels-last in memory")
    return t


def _vector(t: torch.Tensor, c: int, dev: torch.device,
            what: str) -> torch.Tensor:
    if t.dtype != torch.float32 or t.shape != (c,) or t.device != dev:
        raise TypeError(f"bn_act: {what} must be f32 ({c},) on {dev}, got "
                        f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _checked(t: torch.Tensor, dtype: torch.dtype, what: str) -> torch.Tensor:
    """A CUDA activation in ``dtype``, channels-last, of fewer than 2^31
    rows."""
    if not t.is_cuda:
        raise ValueError(f"bn_act_kernel needs a CUDA tensor ({what})")
    if dtype not in _DTYPES:
        raise TypeError(f"bn_act kernel takes float32 or bfloat16, not "
                        f"{dtype}")
    t = _activation(t, dtype, what)
    n, _, h, w = t.shape
    if n * h * w >= 2 ** 31:
        raise ValueError(f"bn_act kernel takes fewer than 2^31 rows, got "
                         f"{tuple(t.shape)}")
    return t


def _launch(entry: str, mode: str, dtype: torch.dtype, acts: list,
            like: torch.Tensor, bn: BNParams, shortcut_bn: BNParams | None,
            alpha: torch.Tensor | None) -> None:
    """Call the C entry ``entry`` on the activations ``acts`` (pointers in
    its order, None where absent) of ``like``'s shape, with the
    statistics, epsilons and slope checked as f32 (C,) vectors on its
    device."""
    n, c, h, w = like.shape
    dev = like.device
    keep = []

    def vec(t, what):
        if t is None:
            return None
        keep.append(_vector(t, c, dev, what))
        return keep[-1].data_ptr()

    names = ("gamma", "beta", "mean", "var")
    p = [vec(t, f"bn.{k}") for k, t in zip(names, bn[:4])]
    q, eps2 = [None] * 4, 0.0
    if shortcut_bn is not None:
        q = [vec(t, f"shortcut_bn.{k}") for k, t in
             zip(names, shortcut_bn[:4])]
        eps2 = shortcut_bn.eps
    _build.launch(entry, dev, _MODES[mode], _DTYPES[dtype],
                  *(None if t is None else t.data_ptr() for t in acts),
                  n * h * w, c, *p, bn.eps, *q, eps2, vec(alpha, "alpha"))


def bn_act_kernel(x: torch.Tensor, bn: BNParams, dtype: torch.dtype,
                  alpha: torch.Tensor | None = None,
                  shortcut: torch.Tensor | None = None,
                  shortcut_bn: BNParams | None = None,
                  relu: bool = False) -> torch.Tensor:
    """Launch ``csrc/bn_act.cu`` on channels-last CUDA activations in
    ``dtype`` (bf16 or f32; other input types are cast first, as the
    plain version casts them) with f32 statistics; raises on anything
    else."""
    mode = _mode(alpha, shortcut is not None, shortcut_bn, relu)
    x = _checked(x, dtype, "x")
    if shortcut is not None:
        shortcut = _activation(shortcut, dtype, "shortcut", x.shape)
    out = torch.empty_like(x)
    _launch("alink_bn_act", mode, dtype, [x, shortcut, out], x, bn,
            shortcut_bn, alpha)
    return out


def bn_act_backward_kernel(
        grad: torch.Tensor, saved: torch.Tensor | None, bn: BNParams,
        dtype: torch.dtype, alpha: torch.Tensor | None = None,
        shortcut: bool = False, shortcut_bn: BNParams | None = None,
        relu: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``bn_act_backward_reference`` by one launch of
    ``alink_bn_act_backward`` (bit-equal on the card): ``grad`` (made
    channels-last in ``dtype`` where autograd gives it otherwise) and, for
    the PReLU or the ReLU, ``saved`` in; the gradients of ``x`` and of the
    shortcut out (``grad`` itself for a shortcut without BN).  Raises as
    ``bn_act_kernel`` does."""
    mode = _mode(alpha, shortcut, shortcut_bn, relu)
    if grad.dim() == 4 and dtype in _DTYPES:
        grad = grad.to(dtype).contiguous(memory_format=torch.channels_last)
    grad = _checked(grad, dtype, "grad")
    saved = (_activation(saved, dtype, "saved", grad.shape)
             if alpha is not None or relu else None)
    dx = torch.empty_like(grad)
    dr = torch.empty_like(grad) if shortcut_bn is not None else None
    _launch("alink_bn_act_backward", mode, dtype, [grad, saved, dx, dr],
            grad, bn, shortcut_bn, alpha)
    return dx, (grad if mode == "bn_add" else dr)


def _forward(x, bn, dtype, alpha, shortcut, shortcut_bn, relu):
    if x.is_cuda:
        return bn_act_kernel(x, bn, dtype, alpha, shortcut, shortcut_bn,
                             relu)
    if x.device.type != "cpu":
        raise ValueError(f"no bn_act for device {x.device}")
    return bn_act_reference(x, bn, dtype, alpha, shortcut, shortcut_bn, relu)


def _backward(grad, saved, bn, dtype, alpha, shortcut, shortcut_bn, relu):
    if grad.is_cuda:
        return bn_act_backward_kernel(grad, saved, bn, dtype, alpha,
                                      shortcut, shortcut_bn, relu)
    return bn_act_backward_reference(grad, saved, bn, dtype, alpha, shortcut,
                                     shortcut_bn, relu)


class _Inputs(NamedTuple):
    """The autograd function's tensor inputs, in ``apply``'s order (None
    where absent): the activation, the shortcut, the PReLU slope, the
    BN's statistics and the shortcut BN's."""
    x: torch.Tensor | None
    shortcut: torch.Tensor | None
    alpha: torch.Tensor | None
    gamma: torch.Tensor | None
    beta: torch.Tensor | None
    mean: torch.Tensor | None
    var: torch.Tensor | None
    gamma2: torch.Tensor | None
    beta2: torch.Tensor | None
    mean2: torch.Tensor | None
    var2: torch.Tensor | None

    @classmethod
    def of(cls, x, bn: BNParams, alpha, shortcut,
           shortcut_bn: BNParams | None) -> "_Inputs":
        bn2 = shortcut_bn[:4] if shortcut_bn is not None else (None,) * 4
        return cls(x, shortcut, alpha, *bn[:4], *bn2)

    def bn(self, eps: float) -> BNParams:
        return BNParams(self.gamma, self.beta, self.mean, self.var, eps)

    def shortcut_bn(self, eps: float) -> BNParams | None:
        if self.gamma2 is None:
            return None
        return BNParams(self.gamma2, self.beta2, self.mean2, self.var2, eps)


class _BnAct(torch.autograd.Function):
    """The fused forward; the backward is ``_backward`` for the
    activations (one launch on the card) and, only where the PReLU's slope
    or a trainable statistic wants a gradient, the plain path's sums over
    the channels sent through the statistics' own chain (C-element
    vectors) under autograd.  ``forward``'s inputs after ``dtype``, the
    two epsilons and ``relu`` are an ``_Inputs``."""

    @staticmethod
    def forward(ctx, dtype, eps, eps2, relu, *tensors):
        t = _Inputs(*tensors)
        need = _Inputs(*ctx.needs_input_grad[4:])
        ctx.dtype, ctx.eps, ctx.eps2, ctx.relu = dtype, eps, eps2, relu
        ctx.x_dtype = t.x.dtype
        ctx.shortcut_dtype = None if t.shortcut is None else t.shortcut.dtype
        ctx.has_shortcut = t.shortcut is not None
        out = _forward(t.x, t.bn(eps), dtype, t.alpha, t.shortcut,
                       t.shortcut_bn(eps2), relu)
        # The activations are kept only where the backward reads them:
        # the output for the ReLU's mask (one read, where recomputing it
        # would read x and the shortcut), x for the PReLU's mask or a
        # statistic's gradient, the shortcut for its BN's statistics'.
        keep_x = t.alpha is not None or any(need[3:7])
        keep_sc = any(need[7:11])
        ctx.save_for_backward(out if relu else None, *t._replace(
            x=t.x if keep_x else None,
            shortcut=t.shortcut if keep_sc else None))
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        need = _Inputs(*ctx.needs_input_grad[4:])
        dtype = ctx.dtype
        y, *saved = ctx.saved_tensors
        t = _Inputs(*saved)
        bn, bn2 = t.bn(ctx.eps), t.shortcut_bn(ctx.eps2)
        out = [None] * len(need)
        if need.x or need.shortcut:
            dx, dr = _backward(grad, y if ctx.relu else t.x, bn, dtype,
                               t.alpha, ctx.has_shortcut, bn2, ctx.relu)
            if need.x:
                out[0] = dx.to(ctx.x_dtype)
            if need.shortcut:
                out[1] = dr.to(ctx.shortcut_dtype)
        if any(need[2:]):
            out[2:] = _vector_grads(grad, t, need, bn, bn2, dtype, y)
        return (None, None, None, None) + tuple(out)


def _vector_grads(grad, t: _Inputs, need: _Inputs, bn: BNParams,
                  bn2: BNParams | None, dtype: torch.dtype,
                  relu_out: torch.Tensor | None) -> list:
    """The gradients of the slope and the statistics (``_Inputs`` order
    from ``alpha`` on; None where not wanted), as plain autograd computes
    them: the sums over (N, H, W) of the output's gradient (through the
    ReLU's mask on its output ``relu_out`` where there is one) times the
    tensor each C-element vector multiplied, sent through the vectors' own
    chain under autograd."""
    leaves = _Inputs(*(v.detach().requires_grad_(n) if v is not None
                       else None for v, n in zip(t, need)))
    dims = grad.dim()
    small, small_grads = [], []

    def give(v: torch.Tensor, g: torch.Tensor) -> None:
        if v.requires_grad:
            small.append(v)
            small_grads.append(g.sum_to_size(v.shape))

    with torch.enable_grad():
        scale, shift = scale_shift(leaves.bn(bn.eps), dtype, dims)
        if bn2 is not None:
            scale2, shift2 = scale_shift(leaves.shortcut_bn(bn2.eps), dtype,
                                         dims)
        if t.alpha is not None:
            alpha = leaves.alpha.to(dtype).reshape(scale.shape)
    g = grad
    if relu_out is not None:
        g = torch.ops.aten.threshold_backward(grad, relu_out, 0)
    if t.alpha is not None:
        with torch.no_grad():
            y = _forward(t.x, bn, dtype, None, None, None, False)
        mask = y >= 0
        if alpha.requires_grad:
            give(alpha, torch.where(mask, 0, g) * y)
        g = torch.where(mask, g, g * alpha.detach())
    elif bn2 is not None:
        if scale2.requires_grad:
            give(scale2, g * t.shortcut.to(dtype))
        give(shift2, g)
    if scale.requires_grad:
        give(scale, g * t.x.to(dtype))
    give(shift, g)
    wanted = [v for v in leaves[2:] if v is not None and v.requires_grad]
    grads = iter(torch.autograd.grad(small, wanted, small_grads,
                                     allow_unused=True))
    return [next(grads) if v is not None and v.requires_grad else None
            for v in leaves[2:]]


def bn_act(x: torch.Tensor, bn, prelu=None, shortcut: torch.Tensor | None
           = None, shortcut_bn=None, relu: bool = False) -> torch.Tensor:
    """``bn(x)``, ``prelu(bn(x))`` or ``bn(x) + shortcut_bn(shortcut)``
    (``shortcut`` as it is without ``shortcut_bn``) for a ``_FrozenBN``
    ``bn`` (and ``shortcut_bn``) and a ``_PReLU`` ``prelu``, with ``relu``
    then ``torch.relu`` (no PReLU; a shortcut with its BN), in ``bn``'s
    dtype: the kernel on a CUDA tensor, the plain version on a CPU one."""
    dtype = bn.dtype
    if prelu is not None and prelu.dtype != dtype:
        raise ValueError(f"bn_act: the PReLU's dtype {prelu.dtype} differs "
                         f"from the BN's {dtype}")
    if shortcut_bn is not None and shortcut_bn.dtype != dtype:
        raise ValueError(f"bn_act: the shortcut BN's dtype "
                         f"{shortcut_bn.dtype} differs from the BN's {dtype}")
    p = bn_params(bn)
    alpha = prelu.alpha if prelu is not None else None
    p2 = bn_params(shortcut_bn) if shortcut_bn is not None else None
    _mode(alpha, shortcut is not None, p2, relu)
    tensors = _Inputs.of(x, p, alpha, shortcut, p2)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        return _BnAct.apply(dtype, p.eps, p2.eps if p2 else 0.0, relu,
                            *tensors)
    return _forward(x, p, dtype, alpha, shortcut, p2, relu)
