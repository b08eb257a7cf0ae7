"""The ViT's attention core, softmax(q k^T d^-1/2) v with the heads merged,
float32-accurate from bf16 q, k and v.

``attention_core_reference`` is the plain version, the published
matmul-softmax-matmul in float32 on the upcast inputs.  ``attention_core``
takes it for CPU tensors and launches ``csrc/attention.cu`` for CUDA
tensors (``attention_core_kernel``): one launch a block computes every
(face, head) from the bf16 views the qkv product gives, with S on bf16
tensor cores (bf16 products are exact in float32), the softmax in
float32, and P v as three bf16 products of P split in three bf16 terms
(which carry its 24 bits), all accumulated in float32.  The kernel takes
bf16 (N, H, T, d) with unit stride along d, 1 <= T <= 256 and d a
multiple of 16 up to 128, and raises on anything else: there is no
fallback on the card.

Where a gradient is wanted the call is an autograd function whose
backward recomputes the reference in float32 from the saved q, k and v
and differentiates it (the ViT teacher's FGSM path).
"""

from __future__ import annotations

import torch

from alink_tpu_torch import _build

MAX_TOKENS = 256
MAX_WIDTH = 128


def attention_core_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """(N, H, T, d) q, k, v in any float dtype -> (N, T, H * d) float32:
    softmax(q k^T d^-1/2) v on the float32 upcasts, heads merged."""
    q, k, v = q.float(), k.float(), v.float()
    n, h, t, d = q.shape
    s = torch.softmax(q @ k.transpose(-2, -1) * d ** -0.5, dim=-1)
    return (s @ v).transpose(1, 2).reshape(n, t, h * d)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q, k and v are what the kernel takes: bf16, one shape
    (N, H, T, d) and device, 1 <= T <= 256, d a multiple of 16 up to 128,
    unit stride along d and the other strides multiples of 8 elements
    (16-byte rows).  Reads no data: CPU and ``meta`` tensors are checked
    as CUDA ones are."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention core: q, k and v must be one (N, H, T, "
                         f"d) shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("attention core: q, k and v on different devices")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"attention core kernel takes bf16 {name}, not "
                            f"{x.dtype}")
    n, h, t, d = q.shape
    if not 1 <= t <= MAX_TOKENS:
        raise ValueError(f"attention core kernel takes 1 to {MAX_TOKENS} "
                         f"tokens, got T {t}")
    if d % 16 or not 16 <= d <= MAX_WIDTH:
        raise ValueError(f"attention core kernel takes a head width d that "
                         f"is a multiple of 16 up to {MAX_WIDTH}, got d {d}")
    if n * h >= 2 ** 30:
        raise ValueError(f"attention core kernel takes fewer than 2^30 "
                         f"(face, head) problems, got {n} x {h}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(s % 8 or s >= 2 ** 31
                                   for s in x.stride()[:3]):
            raise ValueError(f"attention core kernel: {name} needs unit "
                             f"stride along d and strides that are "
                             f"multiples of 8 below 2^31, got {x.stride()}")


def _launch(q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """The CUDA implementation of the ``alink_tpu_torch::attention_core``
    op: allocate the output, launch ``alink_attention`` on the current
    stream."""
    n, h, t, d = q.shape
    out = torch.empty((n, t, h * d), dtype=torch.float32, device=q.device)
    if n:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        _build.launch("alink_attention", q.device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), n, h, t, d,
                      *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                      d ** -0.5, min(n * h, sms))
    return out


# The launch is a dispatcher op of its own: the profiler links a kernel to
# the innermost op (not user span) open when it was launched, so a launch
# straight from Python under ``span("vit.attn")`` would count under no
# event of that span.
_OPS = torch.library.Library("alink_tpu_torch", "DEF")
_OPS.define("attention_core(Tensor q, Tensor k, Tensor v) -> Tensor")
_OPS.impl("attention_core", _launch, "CUDA")


def attention_core_kernel(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/attention.cu`` on CUDA q, k, v as
    ``check_inputs`` describes (views of the qkv product are taken as they
    are, nothing is copied) -> (N, T, H * d) float32, contiguous, through
    the op ``torch.ops.alink_tpu_torch.attention_core``.  Raises on
    anything else."""
    check_inputs(q, k, v)
    if not q.is_cuda:
        raise ValueError(f"attention_core_kernel needs CUDA tensors, got "
                         f"{q.device}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("attention core kernel: q, k and v must start on "
                         "16-byte boundaries")
    return torch.ops.alink_tpu_torch.attention_core(q, k, v)


def _forward(q, k, v):
    if q.is_cuda:
        return attention_core_kernel(q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"no attention core for device {q.device}")
    return attention_core_reference(q, k, v)


class _Core(torch.autograd.Function):
    """The forward by ``_forward``; the backward differentiates the
    float32 reference recomputed from the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        leaves = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in leaves if t.requires_grad]
        with torch.enable_grad():
            out = attention_core_reference(*leaves)
        grads = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(grads) if t.requires_grad else None
                     for t in leaves)


def attention_core(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T d^-1/2) v, (N, H, T, d) -> (N, T, H * d) float32: the
    kernel on CUDA tensors, the plain version on CPU ones."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Core.apply(q, k, v)
    return _forward(q, k, v)
