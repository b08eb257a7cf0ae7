"""The transformers' LayerNorm (``ops/layer_norm.py``, ``models/vit.LayerNorm``)
on the CPU: the plain path is ``F.layer_norm`` on the float32 upcast rounded
once to the consumer's dtype, bit for bit; the kernel's wrapper refuses what
``csrc/layer_norm.cu`` does not take and passes it what it does; the module
routes by what its input shows; and a forward of Swin-S's and ViT-L's depths
opens 53 and 49 ``alink/ln`` spans.  The kernel itself runs on the card
(``chip_smoke.py`` phase s).
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from alink_tpu_torch.models import FaceSwin, FaceViT
from alink_tpu_torch.models import vit as vit_module
from alink_tpu_torch.models.vit import LayerNorm
from alink_tpu_torch.ops import layer_norm as L
from alink_tpu_torch.utils import profiling as P

WIDTHS = (96, 192, 384, 768, 1536)


def _params(c: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return (1.0 + 0.1 * torch.randn(c, generator=g),
            0.1 * torch.randn(c, generator=g))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", WIDTHS)
def test_plain_path_is_layer_norm_then_one_rounding(c, out_dtype):
    g = torch.Generator().manual_seed(c)
    x = 3.0 * torch.randn((5, 7, c), generator=g) + 0.5
    gamma, beta = _params(c, c)
    got = L.layer_norm(x, gamma, beta, 1e-5, out_dtype)
    want = F.layer_norm(x.float(), (c,), gamma, beta, 1e-5).to(out_dtype)
    assert got.dtype == out_dtype and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_plain_path_takes_the_patch_norms_strided_bf16(out_dtype):
    """Swin's patch norm reads the convolution's bf16 NCHW output as an
    NHWC view."""
    g = torch.Generator().manual_seed(3)
    conv = torch.randn((2, 96, 6, 6), generator=g).to(torch.bfloat16)
    x = conv.permute(0, 2, 3, 1)
    assert not x.is_contiguous()
    gamma, beta = _params(96)
    got = L.layer_norm(x, gamma, beta, 1e-5, out_dtype)
    want = F.layer_norm(x.float(), (96,), gamma, beta, 1e-5).to(out_dtype)
    assert torch.equal(_bits(got), _bits(want))


def test_module_writes_float32_unless_told():
    norm = LayerNorm(192, 1e-5)
    with torch.no_grad():
        norm.gamma.copy_(_params(192)[0])
        norm.beta.copy_(_params(192)[1])
    x = torch.randn((4, 192), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        plain = norm(x)
        bf16 = norm(x, torch.bfloat16)
    assert plain.dtype == torch.float32
    assert torch.equal(plain, F.layer_norm(x, (192,), norm.gamma, norm.beta,
                                           1e-5))
    assert torch.equal(_bits(bf16), _bits(plain.to(torch.bfloat16)))


def test_module_routes_by_what_its_input_shows(monkeypatch):
    """No gradient wanted: the dispatch (the kernel on a card) on
    contiguous rows.  A gradient wanted: the plain path, which
    differentiates."""
    seen = []

    def dispatch(x, gamma, beta, eps, out_dtype):
        seen.append((x.is_contiguous(), out_dtype))
        return L.layer_norm_reference(x, gamma, beta, eps, out_dtype)

    monkeypatch.setattr(vit_module, "layer_norm", dispatch)
    norm = LayerNorm(96, 1e-5).requires_grad_(False)
    x = torch.randn((2, 4, 4, 96), generator=torch.Generator().manual_seed(2))
    view = x.permute(0, 2, 1, 3)
    norm(view, torch.bfloat16)
    with torch.no_grad():
        LayerNorm(96, 1e-5)(x)
    assert seen == [(True, torch.bfloat16), (True, torch.float32)]
    leaf = x.clone().requires_grad_(True)
    y = norm(leaf, torch.bfloat16)
    assert len(seen) == 2 and y.dtype == torch.bfloat16
    y.float().sum().backward()
    ref = x.clone().requires_grad_(True)
    F.layer_norm(ref, (96,), norm.gamma, norm.beta, 1e-5).to(
        torch.bfloat16).float().sum().backward()
    assert torch.equal(leaf.grad, ref.grad)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    gamma, beta = _params(96)
    x = torch.randn((8, 96))
    with pytest.raises(ValueError, match="needs CUDA"):
        L.layer_norm_kernel(x, gamma, beta, 1e-5, torch.bfloat16)
    for c in (80, 4096):
        g80, b80 = _params(c)
        with pytest.raises(ValueError, match="multiple of 32"):
            L.layer_norm_kernel(torch.randn((4, c)), g80, b80, 1e-5)
    with pytest.raises(ValueError, match="contiguous rows"):
        L.layer_norm_kernel(torch.randn((96, 8)).t(), gamma, beta, 1e-5)
    misaligned = torch.randn(8 * 96 + 1)[1:].view(8, 96)
    assert misaligned.is_contiguous()
    with pytest.raises(ValueError, match="16-byte"):
        L.layer_norm_kernel(misaligned, gamma, beta, 1e-5)
    with pytest.raises(TypeError, match="float32 or bf16"):
        L.layer_norm_kernel(x.half(), gamma, beta, 1e-5)
    with pytest.raises(ValueError, match="gamma"):
        L.layer_norm_kernel(x, gamma[:64], beta, 1e-5)


@pytest.mark.parametrize("in_dtype,out_dtype,codes", [
    (torch.float32, torch.bfloat16, (0, 1)),
    (torch.bfloat16, torch.float32, (1, 0)),
    (torch.float32, torch.float32, (0, 0))])
def test_launch_passes_rows_width_and_dtypes(monkeypatch, in_dtype,
                                             out_dtype, codes):
    calls = []
    monkeypatch.setattr(L._build, "launch",
                        lambda entry, dev, *args: calls.append((entry, args)))
    x = torch.zeros((3, 5, 384), dtype=in_dtype)
    gamma, beta = _params(384)
    out = L._launch(x, gamma, beta, 1e-6, out_dtype)
    assert out.dtype == out_dtype and out.shape == x.shape
    (entry, args), = calls
    assert entry == "alink_layer_norm"
    assert args == (*codes, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                    out.data_ptr(), 15, 384, 1e-6)
    L._launch(x[:0], gamma, beta, 1e-6, out_dtype)      # no rows: no launch
    assert len(calls) == 1


def _ln_spans(model, x) -> int:
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x)
    return sum(e.name == P.SPAN_PREFIX + "ln" for e in prof.events())


def test_published_depths_open_53_and_49_norm_spans():
    """Swin-S's depths (2, 2, 18, 2): the patch norm, 48 block norms, 3
    merge norms, the final norm.  ViT-L's 24 blocks: 48 and the final
    norm.  Widths cut; the number of norms is the depths'."""
    g = torch.Generator().manual_seed(5)
    swin = FaceSwin(input_size=56, patch_size=1, embed_dim=8,
                    depths=(2, 2, 18, 2), num_heads=(1, 1, 1, 1),
                    embedding_dim=8, dtype=torch.float32, generator=g).eval()
    chips = torch.rand((1, 56, 56, 3), generator=g) * 255
    assert _ln_spans(swin, chips) == 53
    vit = FaceViT(input_size=16, patch_size=4, embed_dim=16, depth=24,
                  num_heads=2, mlp_dim=32, embedding_dim=8,
                  dtype=torch.float32, generator=g).eval()
    assert _ln_spans(vit, torch.rand((1, 16, 16, 3), generator=g) * 255) \
        == 49
    with P.counting() as made:
        vit(torch.rand((1, 16, 16, 3), generator=g) * 255)
    assert made["launches.ln"] == 0                 # the CPU launches none
