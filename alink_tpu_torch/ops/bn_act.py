"""The elementwise chain around an ArcFace unit's convolutions, fused: a
frozen batch norm, then a PReLU or a residual add, in one pass over the
activation.

Three modes, each one read of its inputs and one write:

- ``bn``: ``y = round(round(x * s) + b)``, the ``_FrozenBN`` forward;
- ``bn_prelu``: ``bn``, then ``where(y >= 0, y, round(round(alpha) * y))``,
  the ``_PReLU`` forward;
- ``bn_add``: ``round(bn(x) + shortcut)``, where ``shortcut`` passes
  through its own frozen BN when one is given (a projecting unit's
  ``bn.3``), else is added as it is.

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
the recomputed BN output first), which CUDA tensors take in one launch of
the kernel's backward (``bn_act_backward_kernel``, bit-equal); only a
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
                     shortcut_bn: BNParams | None = None) -> torch.Tensor:
    """``bn``, ``bn_prelu`` (``alpha`` given) or ``bn_add`` (``shortcut``
    given) in plain PyTorch, as ``_FrozenBN``, ``_PReLU`` and ``+`` run."""
    y = frozen_bn(x, bn, dtype)
    if alpha is not None:
        return prelu(y, alpha, dtype)
    if shortcut is not None:
        shortcut = (shortcut.to(dtype) if shortcut_bn is None
                    else frozen_bn(shortcut, shortcut_bn, dtype))
        return y + shortcut
    return y


def bn_act_backward_reference(
        grad: torch.Tensor, x: torch.Tensor | None, bn: BNParams,
        dtype: torch.dtype, alpha: torch.Tensor | None = None,
        shortcut: bool = False, shortcut_bn: BNParams | None = None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The gradients of ``bn_act_reference``'s output with respect to ``x``
    and the shortcut (None without one), in ``dtype``, as plain autograd
    computes them from the output's gradient ``grad``: ``grad * scale``,
    through the PReLU ``where(y >= 0, grad, grad * alpha)`` first (``x``
    is read only for that mask), and ``grad`` or ``grad * scale'`` for the
    shortcut.  (Autograd's sum of the PReLU's two branches can differ from
    the ``where`` in the sign of a zero only.)"""
    scale, _ = scale_shift(bn, dtype, grad.dim())
    g = grad
    if alpha is not None:
        y = frozen_bn(x, bn, dtype)
        g = torch.where(y >= 0, grad,
                        grad * alpha.to(dtype).reshape(scale.shape))
    dr = None
    if shortcut:
        dr = (grad if shortcut_bn is None
              else grad * scale_shift(shortcut_bn, dtype, grad.dim())[0])
    return g * scale, dr


# The kernel's codes (``alink_bn_act``, ``alink_bn_act_backward``).
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"bn": 0, "bn_prelu": 1, "bn_add": 2, "bn_add_bn": 3}


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
                  shortcut_bn: BNParams | None = None) -> torch.Tensor:
    """Launch ``csrc/bn_act.cu`` on channels-last CUDA activations in
    ``dtype`` (bf16 or f32; other input types are cast first, as the
    plain version casts them) with f32 statistics; raises on anything
    else."""
    if alpha is not None and shortcut is not None:
        raise ValueError("bn_act: a PReLU or a shortcut, not both")
    if shortcut is None and shortcut_bn is not None:
        raise ValueError("bn_act: shortcut_bn without a shortcut")
    x = _checked(x, dtype, "x")
    mode = "bn" if alpha is None else "bn_prelu"
    if shortcut is not None:
        mode = "bn_add" if shortcut_bn is None else "bn_add_bn"
        shortcut = _activation(shortcut, dtype, "shortcut", x.shape)
    out = torch.empty_like(x)
    _launch("alink_bn_act", mode, dtype, [x, shortcut, out], x, bn,
            shortcut_bn, alpha)
    return out


def bn_act_backward_kernel(
        grad: torch.Tensor, x: torch.Tensor | None, bn: BNParams,
        dtype: torch.dtype, alpha: torch.Tensor | None = None,
        shortcut: bool = False, shortcut_bn: BNParams | None = None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``bn_act_backward_reference`` by one launch of
    ``alink_bn_act_backward`` (bit-equal on the card): ``grad`` (made
    channels-last in ``dtype`` where autograd gives it otherwise) and, for
    the PReLU, ``x`` in; the gradients of ``x`` and of the shortcut out
    (``grad`` itself for a shortcut without BN).  Raises as
    ``bn_act_kernel`` does."""
    if alpha is not None and shortcut:
        raise ValueError("bn_act: a PReLU or a shortcut, not both")
    if not shortcut and shortcut_bn is not None:
        raise ValueError("bn_act: shortcut_bn without a shortcut")
    if grad.dim() == 4 and dtype in _DTYPES:
        grad = grad.to(dtype).contiguous(memory_format=torch.channels_last)
    grad = _checked(grad, dtype, "grad")
    mode = "bn" if alpha is None else "bn_prelu"
    if shortcut:
        mode = "bn_add" if shortcut_bn is None else "bn_add_bn"
    x = _activation(x, dtype, "x", grad.shape) if alpha is not None else None
    dx = torch.empty_like(grad)
    dr = torch.empty_like(grad) if mode == "bn_add_bn" else None
    _launch("alink_bn_act_backward", mode, dtype, [grad, x, dx, dr], grad,
            bn, shortcut_bn, alpha)
    return dx, (grad if mode == "bn_add" else dr)


def _forward(x, bn, dtype, alpha, shortcut, shortcut_bn):
    if x.is_cuda:
        return bn_act_kernel(x, bn, dtype, alpha, shortcut, shortcut_bn)
    if x.device.type != "cpu":
        raise ValueError(f"no bn_act for device {x.device}")
    return bn_act_reference(x, bn, dtype, alpha, shortcut, shortcut_bn)


def _backward(grad, x, bn, dtype, alpha, shortcut, shortcut_bn):
    if grad.is_cuda:
        return bn_act_backward_kernel(grad, x, bn, dtype, alpha, shortcut,
                                      shortcut_bn)
    return bn_act_backward_reference(grad, x, bn, dtype, alpha, shortcut,
                                     shortcut_bn)


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
    vectors) under autograd.  ``forward``'s inputs after ``dtype`` and the
    two epsilons are an ``_Inputs``."""

    @staticmethod
    def forward(ctx, dtype, eps, eps2, *tensors):
        t = _Inputs(*tensors)
        need = _Inputs(*ctx.needs_input_grad[3:])
        ctx.dtype, ctx.eps, ctx.eps2 = dtype, eps, eps2
        ctx.x_dtype = t.x.dtype
        ctx.shortcut_dtype = None if t.shortcut is None else t.shortcut.dtype
        ctx.has_shortcut = t.shortcut is not None
        # The activations are kept only where the backward reads them:
        # x for the PReLU's mask or a statistic's gradient, the shortcut
        # for its BN's statistics'.
        keep_x = t.alpha is not None or any(need[3:7])
        keep_sc = any(need[7:11])
        ctx.save_for_backward(*t._replace(
            x=t.x if keep_x else None,
            shortcut=t.shortcut if keep_sc else None))
        return _forward(t.x, t.bn(eps), dtype, t.alpha, t.shortcut,
                        t.shortcut_bn(eps2))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        need = _Inputs(*ctx.needs_input_grad[3:])
        dtype = ctx.dtype
        t = _Inputs(*ctx.saved_tensors)
        bn, bn2 = t.bn(ctx.eps), t.shortcut_bn(ctx.eps2)
        out = [None] * len(need)
        if need.x or need.shortcut:
            dx, dr = _backward(grad, t.x, bn, dtype, t.alpha,
                               ctx.has_shortcut, bn2)
            if need.x:
                out[0] = dx.to(ctx.x_dtype)
            if need.shortcut:
                out[1] = dr.to(ctx.shortcut_dtype)
        if any(need[2:]):
            out[2:] = _vector_grads(grad, t, need, bn, bn2, dtype)
        return (None, None, None) + tuple(out)


def _vector_grads(grad, t: _Inputs, need: _Inputs, bn: BNParams,
                  bn2: BNParams | None, dtype: torch.dtype) -> list:
    """The gradients of the slope and the statistics (``_Inputs`` order
    from ``alpha`` on; None where not wanted), as plain autograd computes
    them: the sums over (N, H, W) of the output's gradient times the
    tensor each C-element vector multiplied, sent through the vectors'
    own chain under autograd."""
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
    if t.alpha is not None:
        with torch.no_grad():
            y = _forward(t.x, bn, dtype, None, None, None)
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
           = None, shortcut_bn=None) -> torch.Tensor:
    """``bn(x)``, ``prelu(bn(x))`` or ``bn(x) + shortcut_bn(shortcut)``
    (``shortcut`` as it is without ``shortcut_bn``) for a ``_FrozenBN``
    ``bn`` (and ``shortcut_bn``) and a ``_PReLU`` ``prelu``, in ``bn``'s
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
    tensors = _Inputs.of(x, p, alpha, shortcut, p2)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        return _BnAct.apply(dtype, p.eps, p2.eps if p2 else 0.0, *tensors)
    return _forward(x, p, dtype, alpha, shortcut, p2)
