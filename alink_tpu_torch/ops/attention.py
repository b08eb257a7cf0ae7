"""The transformers' attention cores: the ViT's full core and the Swin
embedder's windowed core.

The ViT's core is softmax(q k^T d^-1/2) v with the heads merged,
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

The windowed core (``window_attention``, Swin, arXiv:2103.14030) attends
inside W x W windows of a grid of tokens with a learned relative position
bias per head and, on shifted blocks, the grid cyclically shifted and a
-100 mask between the shifted frame's regions.
``window_attention_reference`` is the published sequence in float32: roll,
window partition, q k^T, the bias and the mask, softmax, P v, reverse
partition, roll back.  On CUDA tensors one launch of
``csrc/attention.cu``'s ``alink_window_attention`` reads the qkv product's
bf16 output in grid order (the shift and the partition folded into its
loads), adds the bias and the mask in float32 and writes the merged heads
in bf16 in grid order (the reverse folded into its stores), through the
op ``alink_tpu_torch::window_attention``; it takes W 7 and heads of 32 and
raises on anything else.  It has no backward: the Swin embedder serves
inference only.
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


# -- the windowed core -----------------------------------------------------

WINDOW = 7
WINDOW_HEAD = 32
WINDOW_GROUP = 4          # heads a thread block of the kernel takes, at most


def relative_position_index(window: int) -> torch.Tensor:
    """(W^2, W^2) int64: the row of the bias table for query i and key j,
    as the published code builds it, (dy + W - 1)(2W - 1) + (dx + W - 1)
    for (dy, dx) = position of i - position of j."""
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window),
                            indexing="ij")
    coords = torch.stack((ys, xs)).flatten(1)                  # 2, T
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def shift_mask(size: int, window: int, shift: int) -> torch.Tensor:
    """(windows, W^2, W^2) float32: -100 between tokens of a window whose
    regions of the shifted frame differ, else 0 (the published
    ``attn_mask``: each axis cut at S - W and S - shift)."""
    img = torch.zeros(size, size)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    label = 0
    for hs in cuts:
        for ws in cuts:
            img[hs, ws] = label
            label += 1
    side = size // window
    win = img.reshape(side, window, side, window).permute(0, 2, 1, 3)
    win = win.reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def window_attention_reference(qkv: torch.Tensor, bias: torch.Tensor,
                               shift: int, window: int) -> torch.Tensor:
    """(N, S, S, 3 H d) qkv in grid order (each token's row (3, H, d)) and
    the ((2W - 1)^2, H) bias table -> (N, S, S, H d) float32: the
    published roll, window partition, softmax((q d^-1/2) k^T + B + M) v,
    reverse partition and roll back, in float32 on the upcasts."""
    n, s, _, c3 = qkv.shape
    h = bias.shape[1]
    d = c3 // (3 * h)
    t, side = window * window, s // window
    x = qkv.float()
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    x = x.reshape(n, side, window, side, window, 3, h, d).permute(
        5, 0, 1, 3, 6, 2, 4, 7).reshape(3, n, side * side, h, t, d)
    q, k, v = x[0] * d ** -0.5, x[1], x[2]
    a = q @ k.transpose(-2, -1)
    index = relative_position_index(window).to(bias.device)
    a = a + bias.float()[index.reshape(-1)].reshape(t, t, h).permute(2, 0, 1)
    if shift:
        a = a + shift_mask(s, window, shift).to(a.device)[None, :, None]
    o = torch.softmax(a, dim=-1) @ v
    o = o.reshape(n, side, side, h, window, window, d).permute(
        0, 1, 4, 2, 5, 3, 6).reshape(n, s, s, h * d)
    if shift:
        o = torch.roll(o, (shift, shift), (1, 2))
    return o


def window_group(heads: int) -> int:
    """The heads a thread block of the kernel takes: the largest divisor
    of ``heads`` up to 4."""
    return max(g for g in range(1, WINDOW_GROUP + 1) if heads % g == 0)


def check_window_inputs(qkv: torch.Tensor, bias: torch.Tensor, shift: int,
                        window: int) -> None:
    """Raise unless the kernel takes these: bf16 (N, S, S, 3 H 32) qkv,
    contiguous, S a multiple of W = 7, 0 <= shift < W, a float32
    contiguous (169, H) table on the same device.  Reads no data."""
    if qkv.dim() != 4 or qkv.shape[1] != qkv.shape[2]:
        raise ValueError(f"window attention: qkv must be (N, S, S, 3C), got "
                         f"{tuple(qkv.shape)}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"window attention kernel takes bf16 qkv, not "
                        f"{qkv.dtype}")
    if window != WINDOW:
        raise ValueError(f"window attention kernel takes window {WINDOW}, "
                         f"got {window}")
    n, s, _, c3 = qkv.shape
    if s % window or not 0 <= shift < window:
        raise ValueError(f"window attention kernel: grid {s} must be a "
                         f"multiple of {window} and 0 <= shift < {window}, "
                         f"got shift {shift}")
    if bias.dim() != 2 or bias.shape[0] != (2 * window - 1) ** 2:
        raise ValueError(f"window attention: bias table must be "
                         f"({(2 * window - 1) ** 2}, H), got "
                         f"{tuple(bias.shape)}")
    h = bias.shape[1]
    if c3 != 3 * h * WINDOW_HEAD:
        raise ValueError(f"window attention kernel takes heads of "
                         f"{WINDOW_HEAD}: qkv width {c3} is not 3 x {h} x "
                         f"{WINDOW_HEAD}")
    if bias.dtype != torch.float32 or not bias.is_contiguous():
        raise TypeError("window attention kernel takes a contiguous float32 "
                        "bias table")
    if not qkv.is_contiguous():
        raise ValueError("window attention kernel takes a contiguous qkv")
    if qkv.device != bias.device:
        raise ValueError("window attention: qkv and the bias table on "
                         "different devices")
    if n * (s // window) ** 2 * (h // window_group(h)) >= 2 ** 31:
        raise ValueError(f"window attention kernel: too many windows "
                         f"({n} x {(s // window) ** 2})")


def _window_launch(qkv: torch.Tensor, bias: torch.Tensor, shift: int,
                   window: int) -> torch.Tensor:
    """The CUDA implementation of ``alink_tpu_torch::window_attention``:
    allocate the bf16 output, launch ``alink_window_attention`` on the
    current stream."""
    n, s, _, c3 = qkv.shape
    h = bias.shape[1]
    out = torch.empty((n, s, s, c3 // 3), dtype=torch.bfloat16,
                      device=qkv.device)
    if n:
        _build.launch("alink_window_attention", qkv.device, qkv.data_ptr(),
                      bias.data_ptr(), out.data_ptr(), n, s, h, window, shift,
                      window_group(h), WINDOW_HEAD ** -0.5)
    return out


_OPS.define("window_attention(Tensor qkv, Tensor bias, int shift, "
            "int window) -> Tensor")
_OPS.impl("window_attention", _window_launch, "CUDA")


def window_attention_kernel(qkv: torch.Tensor, bias: torch.Tensor,
                            shift: int, window: int) -> torch.Tensor:
    """One launch of the windowed core on CUDA tensors as
    ``check_window_inputs`` describes -> (N, S, S, H 32) bf16, through the
    op ``torch.ops.alink_tpu_torch.window_attention``.  Raises on
    anything else."""
    check_window_inputs(qkv, bias, shift, window)
    if not qkv.is_cuda:
        raise ValueError(f"window_attention_kernel needs CUDA tensors, got "
                         f"{qkv.device}")
    if qkv.data_ptr() % 16:
        raise ValueError("window attention kernel: qkv must start on a "
                         "16-byte boundary")
    return torch.ops.alink_tpu_torch.window_attention(qkv, bias, shift,
                                                      window)


def window_attention(qkv: torch.Tensor, bias: torch.Tensor, shift: int,
                     window: int) -> torch.Tensor:
    """The windowed core, (N, S, S, 3 H d) qkv and the ((2W - 1)^2, H)
    table -> (N, S, S, H d): the kernel (bf16 out) on CUDA tensors, the
    plain float32 version on CPU ones."""
    if qkv.is_cuda:
        if torch.is_grad_enabled() and (qkv.requires_grad
                                        or bias.requires_grad):
            raise RuntimeError("window attention kernel has no backward")
        return window_attention_kernel(qkv, bias, shift, window)
    if qkv.device.type != "cpu":
        raise ValueError(f"no window attention for device {qkv.device}")
    return window_attention_reference(qkv, bias, shift, window)
