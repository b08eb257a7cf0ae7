"""The arithmetic the references run in: float32 (TF32 off) or, for the
control, float8 e4m3 operands with a per-tensor scale."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_E4M3_MAX = 448.0


class Numerics:
    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"unknown numerics {mode!r}")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand as the arithmetic sees it, held in float32."""
        x = x.float()
        if self.mode == "f32":
            return x
        scale = x.abs().amax().clamp(min=1e-30) / _E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def conv(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(w), None if b is None else b.float(),
                        stride, padding)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), None if b is None else b.float())


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matrix products and convolutions, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def bn(x, w: dict, prefix: str, eps: float):
    """Inference batch norm over channel axis 1."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    g, b = w[prefix + ".gamma"].float(), w[prefix + ".beta"].float()
    m, v = w[prefix + ".mean"].float(), w[prefix + ".var"].float()
    return ((x - m.reshape(shape)) / torch.sqrt(v.reshape(shape) + eps)
            * g.reshape(shape) + b.reshape(shape))


def prelu(x, alpha):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return torch.where(x >= 0, x, alpha.float().reshape(shape) * x)
