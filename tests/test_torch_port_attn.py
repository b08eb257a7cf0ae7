"""The ViT's attention core (``ops/attention.py``; the kernel
``csrc/attention.cu`` runs on the card only) on the CPU: the plain version
against ``tests/plain_vit.core``; the kernel's arithmetic emulated in
float32 (S from the bf16 q and k, the softmax in float32, P split in
three bf16 terms, three products summed), which lands within 1e-6 of the
float32 reference while P in one bf16 term does not come within 1e-5;
the wrapper's checks on CPU and ``meta`` tensors; the autograd function's
backward against plain autograd of the reference; ``AttentionCore``'s
output; and ``launches.attn``.
"""

from __future__ import annotations

import math
from pathlib import Path

import pytest
import torch

import plain_vit
from alink_tpu_torch.models.vit import AttentionCore
from alink_tpu_torch.ops import attention as A
from alink_tpu_torch.utils import profiling

# As tests/test_torch_port_vit.py: float32 sum order only (~1e-7).
CORE_TOL = 1e-5
# The kernel's arithmetic against the float32 reference: every product
# exact, only the order and place of float32 roundings differ.
EMULATION_TOL = 1e-6


def _qkv(shape, seed: int) -> list[torch.Tensor]:
    """q, k, v as the qkv product gives them: bf16 values."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(torch.bfloat16)
            for _ in range(3)]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


def _views(n=2, t=144, h=8, d=96, seed=0, device="cpu"):
    """q, k, v as ``Attention.forward`` passes them: strided views of one
    (N, T, 3, H, d) bf16 tensor."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((n, t, 3 * h * d), generator=g).to(torch.bfloat16)
    qkv = qkv.to(device).reshape(n, t, 3, h, d).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def emulate(q, k, v, terms: int = 3) -> torch.Tensor:
    """``csrc/attention.cu``'s arithmetic in float32 on the CPU: S = q k^T
    of the (exact) float32 upcasts; s = S * scale; e = exp2((s - max) *
    log2 e); P = e * (1 / sum e); P v as the sum of ``terms`` products of
    P's bf16 terms (P = p1 + p2 + p3, each residual exact in float32) with
    v."""
    q, k, v = q.float(), k.float(), v.float()
    n, h, t, d = q.shape
    s = (q @ k.transpose(-2, -1)) * torch.tensor(d ** -0.5,
                                                 dtype=torch.float32)
    e = torch.exp2((s - s.amax(-1, keepdim=True))
                   * torch.tensor(math.log2(math.e), dtype=torch.float32))
    rest = e * torch.reciprocal(e.sum(-1, keepdim=True))
    out = torch.zeros_like(q)
    for _ in range(terms):
        part = rest.to(torch.bfloat16).float()
        out = out + part @ v
        rest = rest - part
    return out.transpose(1, 2).reshape(n, t, h * d)


@pytest.mark.parametrize("t,d", [(144, 16), (144, 96), (7, 32), (256, 64)])
def test_reference_is_the_plain_core(t, d):
    q, k, v = _qkv((2, 3, t, d), seed=t + d)
    got = A.attention_core_reference(q, k, v)
    want = plain_vit.core(q, k, v)
    assert got.dtype == torch.float32 and got.shape == (2, t, 3 * d)
    assert _rel(got, want) <= CORE_TOL


def test_emulated_kernel_arithmetic_is_float32_and_one_bf16_term_is_not():
    q, k, v = _qkv((2, 8, 144, 96), seed=1)
    want = A.attention_core_reference(q, k, v)
    three = _rel(emulate(q, k, v), want)
    one = _rel(emulate(q, k, v, terms=1), want)
    assert three < EMULATION_TOL
    assert one > CORE_TOL
    # The three terms sum to P exactly: the emulation's only roundings
    # are float32 sums and the final division.
    e = torch.rand((64, 144), generator=torch.Generator().manual_seed(2))
    p1 = e.to(torch.bfloat16).float()
    p2 = (e - p1).to(torch.bfloat16).float()
    p3 = (e - p1 - p2).to(torch.bfloat16).float()
    assert torch.equal(p1 + p2 + p3, e)


def test_emulated_kernel_masks_keys_past_t():
    """T 7 in a 144-key tile: the rows and keys the kernel pads are zero,
    and keys past T at -inf give the unpadded core."""
    q, k, v = _qkv((1, 2, 7, 32), seed=3)
    pad = [torch.nn.functional.pad(x.float(), (0, 0, 0, 137)) for x in
           (q, k, v)]
    s = (pad[0] @ pad[1].transpose(-2, -1)) * 32 ** -0.5
    s[..., 7:] = -math.inf
    p = torch.softmax(s, dim=-1)
    got = (p @ pad[2])[:, :, :7].transpose(1, 2).reshape(1, 7, 64)
    assert _rel(got, A.attention_core_reference(q, k, v)) <= CORE_TOL


def test_qkv_views_pass_the_checks_and_unsupported_shapes_raise():
    q, k, v = _views(device="meta")
    A.check_inputs(q, k, v)     # the ViT's own strided views
    with pytest.raises(ValueError, match="device meta"):
        A.attention_core(q, k, v)
    for t, d in [(144, 24), (144, 8), (144, 144), (257, 64)]:
        bad = _views(n=1, t=t, h=2, d=d, device="meta")
        with pytest.raises(ValueError, match="tokens" if t > 256 else "d"):
            A.check_inputs(*bad)
    with pytest.raises(TypeError, match="bf16"):
        A.check_inputs(*(x.float() for x in (q, k, v)))
    with pytest.raises(ValueError, match="shape"):
        A.check_inputs(q, k[:, :, :100], v)
    gaps = torch.empty((2, 8, 144, 192), dtype=torch.bfloat16,
                       device="meta")[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        A.check_inputs(gaps, gaps, gaps)
    odd = torch.empty((1, 2, 144, 100), dtype=torch.bfloat16,
                      device="meta")[..., :96]
    with pytest.raises(ValueError, match="multiples of 8"):
        A.check_inputs(odd, odd, odd)
    cpu = _views(n=1, h=2)
    with pytest.raises(ValueError, match="CUDA"):
        A.attention_core_kernel(*cpu)


def test_autograd_backward_is_plain_autograd_of_the_reference():
    q, k, v = (x.requires_grad_(True) for x in _qkv((2, 3, 144, 32), 4))
    grad = torch.randn((2, 144, 96),
                       generator=torch.Generator().manual_seed(5))
    out = A.attention_core(q, k, v)
    assert type(out.grad_fn).__name__ == "_CoreBackward"
    got = torch.autograd.grad(out, (q, k, v), grad)
    want = torch.autograd.grad(A.attention_core_reference(q, k, v),
                               (q, k, v), grad)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.bfloat16
        assert torch.equal(g_, w_)
    # Only the inputs that want a gradient get one.
    k2 = k.detach()
    got_q, = torch.autograd.grad(A.attention_core(q, k2, v), (q,), grad)
    want_q, = torch.autograd.grad(A.attention_core_reference(q, k2, v),
                                  (q,), grad)
    assert torch.equal(got_q, want_q)


def test_attention_core_module_output_stays_float32_merged():
    q, k, v = _views(n=2, t=144, h=4, d=16, seed=6)
    with profiling.counting() as made:
        out = AttentionCore()(q, k, v)
    assert out.dtype == torch.float32 and out.shape == (2, 144, 64)
    assert out.is_contiguous()
    assert _rel(out, plain_vit.core(q, k, v)) <= CORE_TOL
    assert made["launches.attn"] == 0   # CPU: no kernel


def test_the_port_never_names_the_library_attention():
    """The core on the card is the port's own kernel: no module of the
    package calls PyTorch's fused attention."""
    root = Path(A.__file__).resolve().parent.parent
    named = [str(p.relative_to(root)) for p in root.rglob("*.py")
             if "scaled_dot_product_attention" in p.read_text()]
    assert named == []


def test_the_launch_is_a_dispatcher_op_with_a_cuda_kernel_only():
    """The launch sits in an op of its own (the profiler links a kernel to
    the op open at its launch, so ``alink/vit.attn`` holds its device
    time); the op has a CUDA implementation and no other."""
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has("alink_tpu_torch::attention_core", "CUDA")
    assert not has("alink_tpu_torch::attention_core", "CPU")
