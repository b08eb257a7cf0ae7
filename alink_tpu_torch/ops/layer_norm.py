"""LayerNorm over the last axis that writes the dtype its consumer takes.

The transformers normalise their float32 residual stream before each bf16
product.  ``layer_norm_reference`` is the plain version: ``F.layer_norm``
on the float32 upcast, then ``.to(out_dtype)``.  ``layer_norm`` takes it
for CPU tensors and launches ``csrc/layer_norm.cu`` for CUDA tensors
(``layer_norm_kernel``): one pass reads each row once and writes it once
in ``out_dtype``, with float32 statistics and affine and one rounding at
the store, where ``.to`` rounds.  The kernel takes float32 or bf16 rows
and writes float32 or bf16, C a multiple of 32 up to 2,048, contiguous
rows and 16-byte aligned pointers, and raises on anything else: there is
no fallback on the card.  It has no backward: where a gradient is wanted
the caller takes the plain version (``models/vit.LayerNorm``).

The launch is the op ``alink_tpu_torch::layer_norm``, so that the
profiler links it to the span open around it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from alink_tpu_torch import _build

MAX_WIDTH = 2048
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_reference(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, eps: float,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """(..., C) in any float dtype -> the same shape in ``out_dtype``:
    the float32 LayerNorm of the upcast, rounded once to ``out_dtype``."""
    return F.layer_norm(x.float(), gamma.shape, gamma, beta, eps).to(
        out_dtype)


def check_inputs(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 out_dtype: torch.dtype) -> None:
    """Raise unless the kernel takes these: float32 or bf16 ``x`` with
    contiguous rows of C, C a multiple of 32 up to 2,048, float32
    contiguous (C,) gamma and beta on its device, a float32 or bf16
    ``out_dtype``.  Reads no data."""
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"layer norm kernel takes and writes float32 or "
                        f"bf16, got {x.dtype} -> {out_dtype}")
    c = x.shape[-1] if x.dim() else 0
    if c % 32 or not 32 <= c <= MAX_WIDTH:
        raise ValueError(f"layer norm kernel takes a width C that is a "
                         f"multiple of 32 up to {MAX_WIDTH}, got C {c}")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p.shape != (c,) or p.dtype != torch.float32 or \
                not p.is_contiguous():
            raise ValueError(f"layer norm kernel takes a contiguous float32 "
                             f"({c},) {name}, got {p.dtype} "
                             f"{tuple(p.shape)}")
        if p.device != x.device:
            raise ValueError(f"layer norm: {name} on {p.device}, x on "
                             f"{x.device}")
    if not x.is_contiguous():
        raise ValueError(f"layer norm kernel takes contiguous rows, got "
                         f"strides {x.stride()}")
    if x.numel() // c >= 2 ** 31:
        raise ValueError(f"layer norm kernel takes fewer than 2^31 rows, got "
                         f"{x.numel() // c}")


def _launch(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    """The CUDA implementation of ``alink_tpu_torch::layer_norm``:
    allocate the output, launch ``alink_layer_norm`` on the current
    stream."""
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    c = x.shape[-1]
    rows = x.numel() // c
    if rows:
        _build.launch("alink_layer_norm", x.device, _DTYPES[x.dtype],
                      _DTYPES[out_dtype], x.data_ptr(), gamma.data_ptr(),
                      beta.data_ptr(), out.data_ptr(), rows, c, eps)
    return out


_OPS = torch.library.Library("alink_tpu_torch", "FRAGMENT")
_OPS.define("layer_norm(Tensor x, Tensor gamma, Tensor beta, float eps, "
            "ScalarType out_dtype) -> Tensor")
_OPS.impl("layer_norm", _launch, "CUDA")


def layer_norm_kernel(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, eps: float,
                      out_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """One launch of ``csrc/layer_norm.cu`` on CUDA tensors as
    ``check_inputs`` describes -> ``x``'s shape in ``out_dtype``,
    contiguous, through the op ``torch.ops.alink_tpu_torch.layer_norm``.
    Raises on anything else."""
    check_inputs(x, gamma, beta, out_dtype)
    if any(t.data_ptr() % 16 for t in (x, gamma, beta)):
        raise ValueError("layer norm kernel: x, gamma and beta must start on "
                         "16-byte boundaries")
    if not x.is_cuda:
        raise ValueError(f"layer_norm_kernel needs CUDA tensors, got "
                         f"{x.device}")
    return torch.ops.alink_tpu_torch.layer_norm(x, gamma, beta, eps,
                                                out_dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float, out_dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """LayerNorm over the last axis, written in ``out_dtype``: the kernel
    on CUDA tensors, the plain version on CPU ones."""
    if x.is_cuda:
        return layer_norm_kernel(x, gamma, beta, eps, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"no layer norm for device {x.device}")
    return layer_norm_reference(x, gamma, beta, eps, out_dtype)
