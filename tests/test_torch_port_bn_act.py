"""The fused BN / PReLU / residual-add / ReLU op (``ops/bn_act.py``) on the
CPU.

Its plain version must be the modules' own arithmetic bit for bit
(``_FrozenBN``, ``_PReLU``, ``+``, ``torch.relu``), in bf16 and f32, at
vector-friendly and tensor-parallel padded widths, with NaN and signed
zeros planted; ArcFace and VGGFace-ResNet50 through it must equal the same
models run through the modules (forward and every gradient, the pixels'
for FGSM included); the op must dispatch as documented.  The CUDA kernel
itself is held to the plain version on the card by ``chip_smoke.py``
(phase p).
"""

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from alink_tpu_torch.models import ArcFaceResNet100, VGGFaceResNet50
from alink_tpu_torch.models.arcface import _IRUnit, _PReLU
from alink_tpu_torch.models.resnet import (MXNET_BN_EPS, _conv, _FrozenBN,
                                           _tf_same_pad)
from alink_tpu_torch.ops import bn_act as B
from alink_tpu_torch.ops.resblock import bottleneck_chain

DTYPES = [torch.bfloat16, torch.float32]


def _randomise(module: torch.nn.Module, seed: int) -> None:
    """Non-trivial BN statistics and PReLU slopes (the defaults are an
    identity BN and a constant slope)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(
                module.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            law = {"gamma": lambda n: rng.normal(1.0, 0.2, n),
                   "beta": lambda n: rng.normal(0.0, 0.3, n),
                   "mean": lambda n: rng.normal(0.0, 0.3, n),
                   "var": lambda n: rng.uniform(0.5, 2.0, n),
                   "alpha": lambda n: rng.uniform(0.05, 0.5, n)}.get(leaf)
            if law is not None:
                t.copy_(torch.as_tensor(law(t.shape), dtype=t.dtype))


def _bn(c: int, dtype, seed: int) -> _FrozenBN:
    bn = _FrozenBN(c, MXNET_BN_EPS, dtype)
    _randomise(bn, seed)
    return bn


def _act(shape, dtype, seed: int, scale: float = 2.0) -> torch.Tensor:
    """A channels-last (N, C, H, W) activation, as the convolutions give."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * scale).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


def _plant(x: torch.Tensor, bn: _FrozenBN | None = None) -> torch.Tensor:
    """``x`` with -0 and +0 in rows 0 and 1 of channels 0 and 1 and a NaN in
    channel 2; ``bn``'s shift made -0 in channel 0 and +0 in channel 1, so
    that the BN's output (and a ReLU's input) is a signed zero there."""
    x = x.clone()
    with torch.no_grad():
        x[:, :2, 0] = -0.0
        x[:, :2, 1] = 0.0
        x[:, 2, 2, 0] = float("nan")
        if bn is not None:
            bn.mean[:2] = 0.0
            bn.beta[0], bn.beta[1] = -0.0, 0.0
    return x


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (NaN and the sign of a zero included)."""
    bits = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(bits),
                            b.contiguous().view(bits)))


# -- the plain version against the modules -----------------------------------

@pytest.mark.parametrize("c", [64, 171, 2048])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["bn", "bn_prelu", "bn_add_identity",
                                  "bn_add_projecting", "bn_relu",
                                  "bn_add_bn_relu"])
def test_reference_is_the_modules_bit_for_bit(case, dtype, c):
    bn, bn3 = _bn(c, dtype, 3), _bn(c, dtype, 4)
    x = _plant(_act((3, c, 5, 4), dtype, 1), bn)
    r = _plant(_act((3, c, 5, 4), dtype, 2), bn3)
    prelu = _PReLU(c, dtype)
    _randomise(prelu, 5)
    p, p3 = B.bn_params(bn), B.bn_params(bn3)
    if case == "bn":
        want = bn(x)
        got = B.bn_act_reference(x, p, dtype)
        via = B.bn_act(x, bn)
    elif case == "bn_prelu":
        want = prelu(bn(x))
        got = B.bn_act_reference(x, p, dtype, alpha=prelu.alpha)
        via = B.bn_act(x, bn, prelu=prelu)
    elif case == "bn_add_identity":
        want = bn(x) + r.to(dtype)
        got = B.bn_act_reference(x, p, dtype, shortcut=r)
        via = B.bn_act(x, bn, shortcut=r)
    elif case == "bn_add_projecting":
        want = bn(x) + bn3(r)
        got = B.bn_act_reference(x, p, dtype, shortcut=r, shortcut_bn=p3)
        via = B.bn_act(x, bn, shortcut=r, shortcut_bn=bn3)
    elif case == "bn_relu":
        want = torch.relu(bn(x))
        got = B.bn_act_reference(x, p, dtype, relu=True)
        via = B.bn_act(x, bn, relu=True)
    else:
        want = torch.relu(bn(x) + bn3(r))
        got = B.bn_act_reference(x, p, dtype, shortcut=r, shortcut_bn=p3,
                                 relu=True)
        via = B.bn_act(x, bn, shortcut=r, shortcut_bn=bn3, relu=True)
    assert want.dtype == got.dtype == via.dtype == dtype
    assert _same(got, want)
    assert _same(via, want)
    # The planted values reach the output: NaN, and signed zeros where
    # nothing is added.
    assert bool(want[:, 2, 2, 0].isnan().all())
    if case in ("bn", "bn_prelu", "bn_relu"):
        assert bool(torch.signbit(bn(x)[:, 0, 0]).all())
    # The slope, the shortcut (and its BN) and the ReLU must matter here.
    assert (case == "bn") == _same(want, bn(x))


def _plain_unit(unit: _IRUnit, x: torch.Tensor) -> torch.Tensor:
    """``_IRUnit.forward`` through the modules, as it ran before the op."""
    dt = unit.dtype
    y = unit.bn[0](x)
    y = _conv(y, unit.conv[0], dt, padding=1)
    y = unit.prelu[0](unit.bn[1](y))
    y = _conv(y, unit.conv[1], dt, unit.stride, padding=1)
    y = unit.bn[2](y)
    if len(unit.conv) == 3:
        shortcut = unit.bn[3](_conv(x, unit.conv[2], dt, unit.stride))
    else:
        shortcut = x.to(dt)
    return y + shortcut


def _plain_forward(m: ArcFaceResNet100, x: torch.Tensor) -> torch.Tensor:
    """``ArcFaceResNet100.forward`` through the modules."""
    x = x.permute(0, 3, 1, 2)
    x = m.prelu[0](m.bn[0](_conv(x, m.conv[0], m.dtype, padding=1)))
    for unit in m.units:
        x = _plain_unit(unit, x)
    x = m.bn[1](x)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()
    x = torch.nn.functional.linear(x, m.dense[0].weight, m.dense[0].bias)
    x = x * m.fc1_gamma + m.fc1_beta
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,filters,stride", [(16, 16, 1), (16, 24, 2),
                                                (24, 24, 2)])
def test_unit_equals_the_module_chain(cin, filters, stride, dtype):
    unit = _IRUnit(cin, filters, stride, dtype,
                   torch.Generator().manual_seed(0), None)
    _randomise(unit, 6)
    x = _act((2, cin, 9, 9), dtype, 7)
    with torch.no_grad():
        assert torch.equal(unit(x), _plain_unit(unit, x))


def _tiny_arcface(dtype, seed: int = 0) -> ArcFaceResNet100:
    m = ArcFaceResNet100(stage_sizes=(1, 2, 1, 1), stage_widths=(8, 16, 16,
                                                                 24),
                         input_size=(24, 24), dtype=dtype,
                         generator=torch.Generator().manual_seed(seed))
    _randomise(m, seed + 1)
    return m


def _photos(n: int = 3, seed: int = 8) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 24, 24, 3), generator=g) * 255


@pytest.mark.parametrize("dtype", DTYPES)
def test_arcface_forward_equals_the_module_chain(dtype):
    m = _tiny_arcface(dtype)
    x = _photos()
    with torch.no_grad():
        assert torch.equal(m(x), _plain_forward(m, x))


@pytest.mark.parametrize("dtype", DTYPES)
def test_arcface_gradients_equal_the_module_chain(dtype):
    """The pixel gradient FGSM takes, and every parameter's, through the
    autograd function's backward against the modules' own."""
    m = _tiny_arcface(dtype)
    x = _photos()
    w = torch.randn((3, 512), generator=torch.Generator().manual_seed(9))
    grads = []
    for forward in (m, lambda t: _plain_forward(m, t)):
        m.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_(True)
        (forward(xi) * w).sum().backward()
        grads.append([xi.grad] + [p.grad for p in m.parameters()])
    assert grads[0][0].abs().sum() > 0
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def _parent_stem(x, conv, bn, dtype):
    """``models.resnet._stem`` as it ran before the op: the BN module, then
    ``torch.relu``."""
    y = x.to(dtype).permute(0, 3, 1, 2)
    ph = _tf_same_pad(y.shape[2], 7, 2)
    pw = _tf_same_pad(y.shape[3], 7, 2)
    y = F.conv2d(F.pad(y, pw + ph), conv.weight.to(dtype), None, 2)
    return F.max_pool2d(torch.relu(bn(y)), 3, 2)


def _parent_strided(block, y):
    """``_Bottleneck.strided`` as it ran before the op: four BN modules,
    three ``torch.relu`` and the ``+``."""
    w = [c.weight.to(block.dtype) for c in block.conv]
    ys = y[:, :, ::2, ::2]
    z = torch.relu(block.bn[0](F.conv2d(ys, w[0])))
    z = torch.relu(block.bn[1](F.conv2d(z, w[1], padding=1)))
    z = block.bn[2](F.conv2d(z, w[2]))
    return torch.relu(z + block.bn[3](F.conv2d(ys, w[3])))


def _parent_vgg_forward(m: VGGFaceResNet50, x: torch.Tensor) -> torch.Tensor:
    """``VGGFaceResNet50.forward`` through the parent's stem and strided
    blocks (the stride-1 blocks as the model runs them)."""
    y = _parent_stem(x, m.conv[0], m.bn[0], m.dtype)
    runs, _ = m._prepared(x.device)
    y = m._stages(y, runs, lambda t, i: _parent_strided(m.blocks[i], t),
                  bottleneck_chain)[-1]
    return y.float().mean(dim=(2, 3))


def _tiny_vgg(trainable: bool, seed: int = 40) -> VGGFaceResNet50:
    """Published widths, one block a stage (stem, three strided blocks and
    one stride-1 block: the op's ten calls and K3's plain version)."""
    m = VGGFaceResNet50(stage_sizes=(1, 1, 1, 1), trainable=trainable,
                        generator=torch.Generator().manual_seed(seed))
    _randomise(m, seed + 1)
    m.refold()
    return m


def _vgg_photos(n: int = 2, seed: int = 42) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 40, 40, 3), generator=g) * 255 - 128


@pytest.mark.parametrize("layout", ["nhwc", "nchw_permuted"])
@pytest.mark.parametrize("trainable", [False, True])
def test_vggface_forward_equals_the_parent_chain(trainable, layout):
    """The stem's and strided blocks' ``bn_act`` passes against the chain
    they replace: the features, and the pixel gradient FGSM takes (with
    ``trainable`` every parameter's too), bit for bit, on packed NHWC
    photos and on NCHW ones permuted to NHWC (as the loop cells' synthetic
    people arrive)."""
    m = _tiny_vgg(trainable)
    x = _vgg_photos()
    if layout == "nchw_permuted":
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    w = torch.randn((2, 2048), generator=torch.Generator().manual_seed(43))
    with torch.no_grad():
        assert _same(m(x), _parent_vgg_forward(m, x))
    grads = []
    for forward in (m, lambda t: _parent_vgg_forward(m, t)):
        m.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_(True)
        (forward(xi) * w).sum().backward()
        grads.append([xi.grad] + [p.grad for p in m.parameters()])
    assert grads[0][0].abs().sum() > 0
    # Frozen, the parameters take no gradient; trainable, every one does.
    assert all(g is not None for g in grads[0][1:]) == trainable
    for got, want in zip(*grads):
        assert (got is None) == (want is None)
        if got is not None:
            assert _same(got, want)


def test_frozen_featurizer_gradient_flows_to_the_pixels_only():
    """``drivers/alink_arc``'s featurizer: parameters frozen, the pixels
    differentiable (FGSM)."""
    m = _tiny_arcface(torch.bfloat16).requires_grad_(False)
    x = _photos().requires_grad_(True)
    m(x).sum().backward()
    want = _photos().requires_grad_(True)
    _plain_forward(m, want).sum().backward()
    assert torch.equal(x.grad, want.grad)


# -- dispatch ---------------------------------------------------------------

def test_autograd_function_only_where_a_gradient_is_wanted():
    bn = _bn(8, torch.bfloat16, 10)
    x = _act((1, 8, 3, 3), torch.float32, 11)
    assert B.bn_act(x, bn).grad_fn is None
    y = B.bn_act(x.requires_grad_(True), bn)
    assert "_BnAct" in type(y.grad_fn).__name__
    with torch.no_grad():
        assert B.bn_act(x, bn).grad_fn is None


MODES = ["bn", "bn_prelu", "bn_add", "bn_add_bn", "bn_relu",
         "bn_add_bn_relu"]


@pytest.mark.parametrize("trainable", [False, True])
@pytest.mark.parametrize("x_dtype", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_backward_matches_plain_autograd(mode, dtype, x_dtype, trainable):
    """Every input's gradient through the function's backward against
    plain autograd through the modules, in each mode, working type and
    input type, with frozen and with trainable statistics."""
    c = 10
    bn = _FrozenBN(c, MXNET_BN_EPS, dtype, trainable=trainable)
    bn3 = _FrozenBN(c, MXNET_BN_EPS, dtype, trainable=trainable)
    prelu = _PReLU(c, dtype)
    for mod, seed in ((bn, 20), (bn3, 21), (prelu, 22)):
        _randomise(mod, seed)
    x, r = _act((2, c, 4, 3), x_dtype, 23), _act((2, c, 4, 3), x_dtype, 24)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(25))
    kw = {"bn": {}, "bn_prelu": {"prelu": prelu}, "bn_add": {"shortcut": 1},
          "bn_add_bn": {"shortcut": 1, "shortcut_bn": bn3},
          "bn_relu": {"relu": True},
          "bn_add_bn_relu": {"shortcut": 1, "shortcut_bn": bn3,
                             "relu": True}}[mode]
    runs = []
    for fused in (True, False):
        for mod in (bn, bn3, prelu):
            mod.zero_grad(set_to_none=True)
        a, b = x.clone().requires_grad_(), r.clone().requires_grad_()
        args = {k: (b if k == "shortcut" else v) for k, v in kw.items()}
        out = (B.bn_act(a, bn, **args) if fused
               else _module_chain(a, bn, **args))
        (out.float() * g).sum().backward()
        runs.append([a.grad, b.grad] + [
            p.grad for mod in (bn, bn3, prelu) for p in mod.parameters()])
    assert runs[0][0].abs().sum() > 0
    for got, want in zip(*runs):
        assert (got is None) == (want is None)
        if got is not None:
            assert got.dtype == want.dtype
            assert torch.equal(got, want)


def _module_chain(x, bn, prelu=None, shortcut=None, shortcut_bn=None,
                  relu=False):
    y = bn(x)
    if prelu is not None:
        return prelu(y)
    if shortcut is not None:
        y = y + (shortcut.to(bn.dtype) if shortcut_bn is None
                 else shortcut_bn(shortcut))
    return torch.relu(y) if relu else y


@pytest.mark.parametrize("mode", MODES)
def test_backward_keeps_the_activations_only_where_it_reads_them(mode):
    """With frozen statistics only the masks need an activation: the
    PReLU's x (to recompute the BN output), the ReLU's own output (one
    read, where recomputing it would read x and the shortcut); the add and
    the BN need none."""
    bn, bn3 = _bn(8, torch.bfloat16, 26), _bn(8, torch.bfloat16, 27)
    prelu = _PReLU(8, torch.bfloat16).requires_grad_(False)
    x = _act((1, 8, 3, 3), torch.bfloat16, 28).requires_grad_(True)
    r = _act((1, 8, 3, 3), torch.bfloat16, 29).requires_grad_(True)
    kw = {"bn": {}, "bn_prelu": {"prelu": prelu}, "bn_add": {"shortcut": r},
          "bn_add_bn": {"shortcut": r, "shortcut_bn": bn3},
          "bn_relu": {"relu": True},
          "bn_add_bn_relu": {"shortcut": r, "shortcut_bn": bn3,
                             "relu": True}}[mode]
    out = B.bn_act(x, bn, **kw)
    big = [t for t in out.grad_fn.saved_tensors
           if t is not None and t.dim() == 4]
    assert len(big) == (0 if mode in ("bn", "bn_add", "bn_add_bn") else 1)
    if "relu" in kw:
        assert big[0] is out or _same(big[0], out)


def test_kernel_entry_refuses_what_it_does_not_take():
    bn = _bn(8, torch.bfloat16, 18)
    x = _act((1, 8, 2, 2), torch.bfloat16, 19)
    with pytest.raises(ValueError, match="CUDA"):
        B.bn_act_kernel(x, B.bn_params(bn), torch.bfloat16)
    with pytest.raises(ValueError, match="device"):
        B.bn_act(x.to("meta"), bn)
    with pytest.raises(ValueError, match="dtype"):
        B.bn_act(x, bn, prelu=_PReLU(8, torch.float32))


def test_relu_takes_no_prelu_and_a_shortcut_with_its_bn():
    """No mode is a PReLU and a ReLU, or a ReLU after a shortcut without
    its BN: the op refuses both on every device."""
    bn = _bn(8, torch.bfloat16, 38)
    x = _act((1, 8, 2, 2), torch.bfloat16, 39)
    with pytest.raises(ValueError, match="PReLU"):
        B.bn_act(x, bn, prelu=_PReLU(8, torch.bfloat16), relu=True)
    with pytest.raises(ValueError, match="shortcut's BN"):
        B.bn_act(x, bn, shortcut=x, relu=True)
    with pytest.raises(ValueError, match="shortcut_bn without"):
        B.bn_act(x, bn, shortcut_bn=bn, relu=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_backward_reference_is_plain_autograd(mode, dtype):
    """``bn_act_backward_reference`` (what the backward kernel is held to
    on the card) against autograd through ``bn_act_reference``, at a
    vector-friendly, a padded and a wide width, with NaN and signed zeros
    planted (the ReLU's mask at 0 and at NaN)."""
    for c in (16, 171, 2048):
        bn, bn3 = _bn(c, dtype, 30), _bn(c, dtype, 31)
        prelu = _PReLU(c, dtype)
        _randomise(prelu, 32)
        x = _plant(_act((2, c, 3, 5), dtype, 33), bn).requires_grad_(True)
        r = _plant(_act((2, c, 3, 5), dtype, 34), bn3).requires_grad_(True)
        p, p3 = B.bn_params(bn), B.bn_params(bn3)
        grad = _act((2, c, 3, 5), dtype, 35)
        kw = {"bn": {}, "bn_prelu": {"alpha": prelu.alpha.detach()},
              "bn_add": {"shortcut": r},
              "bn_add_bn": {"shortcut": r, "shortcut_bn": p3},
              "bn_relu": {"relu": True},
              "bn_add_bn_relu": {"shortcut": r, "shortcut_bn": p3,
                                 "relu": True}}[mode]
        out = B.bn_act_reference(x, p, dtype, **kw)
        want = torch.autograd.grad(out, [x, r] if "shortcut" in kw else [x],
                                   grad)
        relu = kw.get("relu", False)
        got = B.bn_act_backward_reference(
            grad, (out if relu else x).detach(), p, dtype, kw.get("alpha"),
            "shortcut" in kw, kw.get("shortcut_bn"), relu)
        assert (got[1] is None) == ("shortcut" not in kw)
        if relu:  # the mask zeroes some gradients and passes the NaN's
            assert bool((got[0] == 0).any() & (got[0] != 0).any())
        for g_, w_ in zip(got, want):
            assert g_.dtype == w_.dtype == dtype
            # The PReLU's where and autograd's sum of its two branches
            # may differ in the sign of a zero (see the docstring).
            assert (torch.equal(g_, w_) if mode == "bn_prelu"
                    else _same(g_, w_))


def test_backward_kernel_entry_refuses_a_cpu_tensor():
    bn = _bn(8, torch.bfloat16, 36)
    g = _act((1, 8, 2, 2), torch.bfloat16, 37)
    with pytest.raises(ValueError, match="CUDA"):
        B.bn_act_backward_kernel(g, None, B.bn_params(bn), torch.bfloat16)


def test_r100_forward_makes_149_calls(monkeypatch):
    """Three a unit over 49 units, the stem's and the head's: the launches
    ``launches.bn_act`` counts for a forward on the card."""
    import alink_tpu_torch.models.arcface as A

    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return B.bn_act(*args, **kwargs)

    monkeypatch.setattr(A, "bn_act", counting)
    m = ArcFaceResNet100(input_size=(16, 16),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        m(torch.zeros((1, 16, 16, 3)))
    assert len(m.units) == 49
    assert len(calls) == 149


def test_vggface_forward_makes_10_calls(monkeypatch):
    """The stem's one and three a strided block: the launches
    ``launches.bn_act`` counts for a VGGFace-ResNet50 forward on the card
    (10 a ``featurize`` call in the loop cells)."""
    import alink_tpu_torch.models.resnet as R

    calls = []

    def counting(*args, **kwargs):
        calls.append(kwargs.get("shortcut") is not None)
        return B.bn_act(*args, **kwargs)

    monkeypatch.setattr(R, "bn_act", counting)
    m = VGGFaceResNet50(generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        m(torch.zeros((1, 32, 32, 3)))
    assert len(m.blocks) == 16
    assert len(calls) == 10
    assert sum(calls) == 3
