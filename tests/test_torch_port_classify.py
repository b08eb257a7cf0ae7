"""The port's side models and identification classifiers against the JAX
package, on the CPU: ``SENet50``, ``VGGFace16``, a trainable
``VGGFaceResNet50``, the four classifiers, K3's weight gradients
(``BottleneckS1``), and ``train.classifier``.

Inputs come from ``np.random``; JAX parameters (BN statistics made
non-trivial) pass through ``alink_tpu_torch.convert``.  Models run in f32
at 32^2 (16^2 for SmallRes), ``stage_sizes=(1, 1, 1, 1)`` where the test
builds the backbone itself.  ``jax.random`` and ``torch.Generator`` cannot
give the same numbers, so SmallResClassifier's dropout masks are drawn
here and given to both sides: to JAX through ``flax.linen.intercept_methods``
(each ``nn.Dropout`` call becomes ``where(mask, x / keep, 0)``), to the
port through the tower's and the classifier's ``draw`` hooks.  Tolerances,
each with its reason:

- SENet50, VGGFace16, SmallRes and their classifiers: relative 1e-4 (f32
  convolutions summed in other orders);
- ResNet50 and ResNet50Classifier against flax: relative 2e-2, the JAX
  package's bound for its fused forward (``tests/test_resblock.py``): the
  port's stride-1 blocks round to bf16 at y1, y2 and the output on every
  device, flax in f32 does not;
- gradients of every parameter, BN statistics included: relative L2 1e-4
  (SENet50Classifier); 2e-2 (ResNet50Classifier) against ``jax.grad`` of
  the JAX classifier with its stride-1 blocks run as the fused block's
  arithmetic (``_fused_blocks``: the same rounding points; the bf16
  cotangents still round at other points: 1.591e-3 when written).
  Against the flax f32 model they lie further than 2e-2 (0.118 when
  written: the bf16 roundings move ReLU masks), which the test checks; the port's
  chain with the roundings taken out matches it within 1e-4, so the fold
  carries every gradient exactly;
- train steps and the fit of ResNet50Classifier use the same
  ``_fused_blocks`` reference;
- two ``classifier_train_step``s: the losses within the forward's
  tolerance (the second on the first step's parameters), and each
  parameter's change within a relative L2 1e-3 of JAX's, its sign on 99 %
  of the elements.  A first Adadelta step is ~4.5e-4 * sign(g) where |g|
  exceeds 4.5e-4 and ~g below, so f32 gradient noise reaches the change
  only on the small gradients; with the fused numerics, whose gradients
  are 2e-3 apart (relative L2, measured), the sign-like step flips on the
  elements whose gradient is below that noise: ResNet50Classifier's
  changes are held over the whole model to a relative L2 0.2 and the same
  99 % of signs;
- ``fit_classifier`` on SENet50Classifier with ``batch_size`` >= n_train
  (one batch of every train row: the permutation cannot matter): every
  ``EpochLog`` field within 1e-4, the same early stop and LR drops.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu.models import classify as jclassify
from alink_tpu.models import resnet as jresnet
from alink_tpu.train import classifier as jclassifier
from alink_tpu_torch import train as T
from alink_tpu_torch.convert import load_flax, state_dict_from_flax
from alink_tpu_torch.models import classify, resnet
from alink_tpu_torch.ops import resblock

from test_torch_port_a2 import _jax_fused_chain

F32 = jnp.float32
T32 = torch.float32
OUT = 7


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _randomize(tree, seed: int):
    """numpy copy of a flax tree with non-trivial BN statistics and biases
    (the init's are 1, 0, 0, 1 and 0)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "gamma":
            return rng.uniform(0.7, 1.3, a.shape).astype(np.float32)
        if name in ("mean", "beta", "bias"):
            return rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _images(n: int, hw: int, seed: int, scale: float = 60.0) -> np.ndarray:
    return (scale * np.random.default_rng(seed).normal(
        size=(n, hw, hw, 3))).astype(np.float32)


def _pixels(n: int, hw: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (n, hw, hw, 3)).astype(np.float32)


# -- the four classifiers and their backbones, built on both sides ----------

def _senet_small():
    return (jclassify._BackboneClassifier(
        jresnet.SENet50(stage_sizes=(1, 1, 1, 1), dtype=F32), OUT, dtype=F32),
        lambda: classify._BackboneClassifier(
            resnet.SENet50((1, 1, 1, 1), T32), OUT, dtype=T32))


def _resnet_small():
    return (jclassify._BackboneClassifier(
        jresnet.VGGFaceResNet50(stage_sizes=(1, 1, 1, 1), dtype=F32), OUT,
        dtype=F32),
        lambda: classify._BackboneClassifier(
            resnet.VGGFaceResNet50((1, 1, 1, 1), T32, trainable=True), OUT,
            dtype=T32))


def _vgg(hid: int = 16, hw: int = 32):
    return (jclassify.VGG16Classifier(OUT, hid_dim=hid, dtype=F32),
            lambda: classify.VGG16Classifier(OUT, hid, T32, (hw, hw)))


def _smallres(hw: int = 16):
    return (jclassify.SmallResClassifier(OUT, dtype=F32),
            lambda: classify.SmallResClassifier(OUT, T32, (hw, hw)))


def _fused_blocks(next_fun, args, kwargs, context):
    """``flax.linen.intercept_methods`` hook: each stride-1 ``_Bottleneck``
    of a flax VGGFaceResNet50 runs as the fused block's arithmetic (bf16
    operands, f32 sums, y1, y2 and the output rounded to bf16), the port's
    numerics, differentiable by XLA."""
    m = context.module
    if (isinstance(m, jresnet._Bottleneck) and m.stride == 1
            and context.method_name == "__call__"):
        wts = jresnet.bottleneck_weights(m.variables["params"])
        return _jax_fused_chain(args[0], (wts,)).astype(m.dtype)
    return next_fun(*args, **kwargs)


def _pair(factory, x: np.ndarray, seed: int = 1):
    """(JAX model, its randomized params, port model loaded with them)."""
    jm, tm = factory()
    p = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1])), seed)
    return jm, p, load_flax(tm(), p)


# -- backbones ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["senet50", "vggface16", "resnet50"])
def test_backbone_matches_jax(name):
    x = _images(2, 32, 0)
    jm, tm, tol = {
        "senet50": (jresnet.SENet50(stage_sizes=(1, 1, 1, 1), dtype=F32),
                    resnet.SENet50((1, 1, 1, 1), T32), 1e-4),
        "vggface16": (jresnet.VGGFace16(dtype=F32),
                      resnet.VGGFace16(T32, (32, 32)), 1e-4),
        "resnet50": (jresnet.VGGFaceResNet50(stage_sizes=(1, 1, 1, 1),
                                             dtype=F32),
                     resnet.VGGFaceResNet50((1, 1, 1, 1), T32,
                                            trainable=True), 2e-2),
    }[name]
    p = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    got = load_flax(tm, p)(torch.from_numpy(x))
    assert got.dtype == T32 and tuple(got.shape) == want.shape
    assert tm.feature_dim == want.shape[1]
    assert _rel(got.detach(), want) <= tol


def test_bf16_senet50_is_as_far_from_f32_as_jax_bf16():
    """The bf16 SENet50 at 224^2 on 4 images, against the f32 model of the
    same tree, in each package: the port's relative max and L2 errors are
    no larger than 1.5x JAX's own (1.272e-2 and 6.640e-3 against 1.144e-2
    and 6.598e-3 when written).  Its relative max passes 1e-2 in both packages:
    it is bf16's tail through 16 SE blocks, so ``chip_smoke.py`` (m) holds
    the card's bf16 forward to its f32 copy by relative L2."""
    x = _images(4, 224, 19)
    jm = jresnet.SENet50(dtype=F32)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x[:1])))
    want = np.asarray(jax.jit(jm.apply)(p, jnp.asarray(x)))
    jb = np.asarray(jax.jit(jresnet.SENet50(dtype=jnp.bfloat16).apply)(
        p, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        tb = load_flax(resnet.SENet50(dtype=torch.bfloat16), p)(
            torch.from_numpy(x)).float().numpy()
    j_max, t_max = _rel(jb, want), _rel(tb, want)
    j_l2, t_l2 = _rel_l2(jb, want), _rel_l2(tb, want)
    print(f"bf16 SENet50 vs f32, relative max / L2: JAX {j_max:.3e} / "
          f"{j_l2:.3e}, port {t_max:.3e} / {t_l2:.3e}")
    assert j_max > 1e-2 and t_max <= 1.5 * j_max and t_l2 <= 1.5 * j_l2


def test_vggface16_flattens_nhwc_25088_at_224():
    """pool5 flattens NHWC, as flax's reshape does (fc6's rows): channel c
    of pixel (h, w) lands at (h * W + w) * 512 + c."""
    assert resnet.VGGFace16(T32).feature_dim == 25088
    model = resnet.VGGFace16(T32, (64, 64))
    with torch.no_grad():
        for conv in model.conv:
            conv.weight.zero_()
            conv.bias.fill_(1.0)
        model.conv[-1].bias.copy_(torch.arange(512.0))
        out = model(torch.zeros(1, 64, 64, 3))
    assert out.shape == (1, 2048)
    # Every pixel of pool5 holds channel c's bias c: NHWC puts channels
    # fastest.
    np.testing.assert_array_equal(out[0].numpy(),
                                  np.tile(np.arange(512.0), 4))


def test_senet50_and_vggface16_default_widths():
    """Full depth at 32^2 (the JAX test_classify size): the port's
    parameter names and shapes are the flax tree's."""
    for jm, tm in ((jresnet.SENet50(dtype=F32), resnet.SENet50(dtype=T32)),
                   (jresnet.VGGFace16(dtype=F32),
                    resnet.VGGFace16(T32, (32, 32)))):
        p = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                           jnp.zeros((1, 32, 32, 3)))
        want = {k: tuple(v.shape) for k, v in state_dict_from_flax(
            jax.tree.map(lambda s: np.zeros(s.shape, np.float32), p)
        ).items()}
        got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
        assert got == want


# -- classifiers: forwards (the JAX test_classify cases) ---------------------

@pytest.mark.parametrize("name,size,tol", [
    ("resnet50", 32, 2e-2), ("senet50", 32, 1e-4), ("vgg16", 32, 1e-4),
    ("smallres", 16, 1e-4)])
def test_classifier_forward_matches_jax(name, size, tol):
    jm, tm = {
        "resnet50": (jclassify.ResNet50Classifier(OUT, dtype=F32),
                     lambda: classify.ResNet50Classifier(OUT, T32)),
        "senet50": (jclassify.SENet50Classifier(OUT, dtype=F32),
                    lambda: classify.SENet50Classifier(OUT, T32)),
        "vgg16": _vgg(16, size),
        "smallres": _smallres(size),
    }[name]
    x = _pixels(2, size, 3) if name == "smallres" else _images(2, size, 3)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    port = load_flax(tm(), p)
    want_p = np.asarray(jm.apply(p, jnp.asarray(x)))
    want_l = np.asarray(jm.apply(p, jnp.asarray(x), method="logits"))
    with torch.no_grad():
        got_p = port(torch.from_numpy(x))
        got_l = port.logits(torch.from_numpy(x))
    assert got_p.shape == (2, OUT) and got_l.shape == (2, OUT)
    np.testing.assert_allclose(got_p.sum(-1).numpy(), 1.0, atol=1e-5)
    assert _rel(got_l, want_l) <= tol
    assert np.abs(got_p.numpy() - want_p).max() <= tol


# -- gradients ---------------------------------------------------------------

def _jax_grads(jm, p, x, labels):
    def loss(params):
        logits = jm.apply(params, x, train=True, method="logits")
        return jclassifier.categorical_crossentropy(
            logits, jax.nn.one_hot(labels, OUT))
    return jax.tree.map(np.asarray, jax.grad(loss)(p))


def _f32_chain(x, blocks):
    """The stride-1 blocks in f32 without the fused block's roundings:
    flax's arithmetic, on the port's folded (differentiable) weights."""
    for w in blocks:
        n, h, wd, cin = x.shape
        xf = x.float().reshape(-1, cin)
        y1 = torch.relu(xf @ w.w1 * w.s1 + w.b1).reshape(n, h, wd, -1)
        y2 = torch.nn.functional.conv2d(
            y1.permute(0, 3, 1, 2), w.w3.permute(3, 2, 0, 1), padding=1)
        y2 = torch.relu(y2.permute(0, 2, 3, 1).reshape(n * h * wd, -1)
                        * w.s2 + w.b2)
        sc = xf if w.wp is None else xf @ w.wp * w.sp + w.bp
        x = torch.relu(y2 @ w.w2 * w.s3 + w.b3 + sc).reshape(n, h, wd, -1)
    return x


@pytest.mark.parametrize("name,tol", [
    ("senet50", 1e-4), ("resnet50", 2e-2), ("resnet50_f32_chain", 1e-4)])
def test_every_parameter_gradient_matches_jax(name, tol):
    """``resnet50``: K3's autograd route (the plain forward on the CPU, the
    recompute backward) against JAX with the fused block's arithmetic;
    ``resnet50_f32_chain``: the same backbone and fold with the roundings
    taken out, against flax's own f32 forward."""
    x = _images(4, 32, 5)
    labels = np.array([0, 3, 6, 3])
    jm, p, port = _pair(_senet_small if name == "senet50" else _resnet_small,
                        x, seed=6)
    with fnn.intercept_methods(
            _fused_blocks if name == "resnet50"
            else (lambda f, a, kw, _: f(*a, **kw))):
        want = state_dict_from_flax(_jax_grads(jm, p, jnp.asarray(x),
                                               jnp.asarray(labels)))
    flax_f32 = state_dict_from_flax(_jax_grads(jm, p, jnp.asarray(x),
                                               jnp.asarray(labels)))
    if name == "resnet50_f32_chain":
        h = port.backbone(torch.from_numpy(x), chain=_f32_chain)
        logits = torch.nn.functional.linear(h, port.dense[0].weight,
                                            port.dense[0].bias)
    else:
        logits = port.logits(torch.from_numpy(x), train=True)
    loss = T.categorical_crossentropy(
        logits, T.one_hot(torch.from_numpy(labels), OUT))
    loss.backward()
    got = dict(port.named_parameters())
    assert set(got) == set(want)
    stats = [k for k in got if k.endswith((".mean", ".var"))]
    assert stats, "BN statistics are parameters"
    for k, w in want.items():
        g = got[k].grad
        assert g is not None, k
        assert _rel_l2(g, w) <= tol, (k, _rel_l2(g, w))
    worst = max(_rel_l2(got[k].grad, w) for k, w in want.items())
    flax_gap = max(_rel_l2(got[k].grad, w) for k, w in flax_f32.items())
    print(f"{name}: worst relative L2 {worst:.3e} against the reference, "
          f"{flax_gap:.3e} against flax f32")
    if name == "resnet50":
        # Why the reference is JAX with the fused arithmetic: the bf16
        # roundings move ReLU masks, and flax f32's gradients lie further.
        assert flax_gap > tol


def test_bottleneck_s1_weight_gradients_match_its_plain_autograd():
    """K3's autograd Function (its plain forward on the CPU, the f32
    recompute backward) gives each weight tensor the gradient of
    ``_block_recompute``'s autograd, and dx; weights that do not require
    grad get none."""
    rng = np.random.default_rng(7)
    cin, cm, cout = 16, 8, 32

    def t(*shape, scale=0.3):
        return torch.tensor(scale * rng.normal(size=shape), dtype=T32)

    wts = resblock.BottleneckWeights(
        t(cin, cm), 1 + t(cm), t(cm), t(3, 3, cm, cm), 1 + t(cm), t(cm),
        t(cm, cout), 1 + t(cout), t(cout), t(cin, cout), 1 + t(cout),
        t(cout))
    x = t(2, 5, 5, cin, scale=1.0).to(torch.bfloat16)
    gy = t(2, 5, 5, cout, scale=1.0).to(torch.bfloat16)  # the output's
    leaves = [w.clone().requires_grad_(i != 4)
              for i, w in enumerate(wts[:12])]
    xa = x.clone().requires_grad_(True)
    out = resblock.bottleneck_chain(xa, (resblock.BottleneckWeights(
        *leaves),))
    got = torch.autograd.grad(out, [xa] + leaves[:4] + leaves[5:], gy)
    xb = x.float().clone().requires_grad_(True)
    ref = [w.clone().requires_grad_(True) for w in wts[:12]]
    want = torch.autograd.grad(
        resblock._block_recompute(xb, resblock.BottleneckWeights(*ref)),
        [xb] + ref[:4] + ref[5:], gy.float())
    assert got[0].dtype == torch.bfloat16
    assert torch.equal(got[0], want[0].to(torch.bfloat16))
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == T32 and _rel_l2(a, b) <= 1e-6
    assert leaves[4].grad is None


def test_chain_takes_autograd_when_only_weights_require_grad():
    """``bottleneck_chain`` routes through ``BottleneckS1`` when a weight
    requires grad, though ``x`` does not, and not under no_grad; in a
    trainable backbone the stride-1 blocks' convolutions and BN statistics
    get gradients."""
    rng = np.random.default_rng(8)
    wts = resblock.BottleneckWeights(*(
        torch.tensor(rng.normal(size=s), dtype=T32) for s in (
            (8, 4), (4,), (4,), (3, 3, 4, 4), (4,), (4,), (4, 8), (8,),
            (8,))))
    wts = wts._replace(w3=wts.w3.requires_grad_(True))
    x = torch.tensor(rng.normal(size=(1, 3, 3, 8)), dtype=T32)
    out = resblock.bottleneck_chain(x, (wts,))
    assert out.requires_grad and "BottleneckS1" in type(out.grad_fn).__name__
    (g,) = torch.autograd.grad(out.float().sum(), wts.w3)
    assert float(g.abs().sum()) > 0
    with torch.no_grad():
        assert not resblock.bottleneck_chain(x, (wts,)).requires_grad
    model = resnet.VGGFaceResNet50((1, 1, 1, 1), T32, trainable=True)
    model(torch.from_numpy(_images(2, 32, 8))).sum().backward()
    w = model.blocks[0].conv[1].weight       # a stride-1 block's 3x3
    assert w.grad is not None and float(w.grad.abs().sum()) > 0
    assert model.blocks[0].bn[0].var.grad is not None


# -- the trainable backbone: no fold cache -----------------------------------

def test_trainable_resnet_refolds_every_forward_frozen_caches():
    x = torch.from_numpy(_images(2, 32, 9))
    trainable = resnet.VGGFaceResNet50((1, 1, 1, 1), T32, trainable=True,
                                       generator=torch.Generator()
                                       .manual_seed(0))
    assert all(p.requires_grad for p in trainable.parameters())
    assert not list(trainable.buffers())
    with torch.no_grad():
        trainable(x)
        trainable.blocks[0].conv[0].weight.mul_(-1.0)
        trainable.blocks[0].bn[1].var.mul_(4.0)
        got = trainable(x)
    fresh = resnet.VGGFaceResNet50((1, 1, 1, 1), T32, trainable=True)
    fresh.load_state_dict(trainable.state_dict())
    with torch.no_grad():
        assert torch.equal(got, fresh(x))
    # The frozen default keeps its cache until refold(), as before.
    frozen = resnet.VGGFaceResNet50((1, 1, 1, 1), T32)
    frozen.load_state_dict(trainable.state_dict())
    assert not any(p.requires_grad for p in frozen.parameters())
    assert {n for n, _ in frozen.named_buffers()} == {
        n for n, _ in trainable.named_parameters() if n.endswith(
            (".gamma", ".beta", ".mean", ".var"))}
    with torch.no_grad():
        before = frozen(x)
        frozen.blocks[0].conv[0].weight.mul_(-1.0)
        assert torch.equal(frozen(x), before)
        frozen.refold()
        assert not torch.equal(frozen(x), before)


# -- train steps -------------------------------------------------------------

class _Masks:
    """Dropout keep masks for both sides, in call order: the JAX side's
    through ``intercept_methods`` (``where(mask, x / keep, 0)`` at each
    ``nn.Dropout``'s own rate), the port's through the ``draw`` hooks."""

    def __init__(self, masks):
        self.jax = list(masks)
        self.port = list(masks)

    def interceptor(self, next_fun, args, kwargs, context):
        if (isinstance(context.module, fnn.Dropout)
                and context.method_name == "__call__"):
            x = args[0]
            if kwargs.get("deterministic", context.module.deterministic):
                return x
            m = jnp.asarray(self.jax.pop(0))
            assert m.shape == x.shape
            keep = 1.0 - context.module.rate
            return jnp.where(m, x / keep, jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    def draw(self, shape, generator, device):
        m = self.port.pop(0)
        assert m.shape == tuple(shape)
        return torch.from_numpy(m)


def _smallres_masks(n: int, hw: int, seed: int, steps: int) -> list:
    rng = np.random.default_rng(seed)
    s1 = (hw - 2) // 2
    s2 = (s1 - 2) // 2
    out = []
    for _ in range(steps):
        out += [rng.random((n, s1, s1, 32)) < 0.75,
                rng.random((n, s2, s2, 64)) < 0.75,
                rng.random((n, 512)) < 0.5]
    return out


@pytest.mark.parametrize("name,tol,change_tol", [
    ("resnet50", 2e-2, 0.2), ("senet50", 1e-4, 1e-3), ("vgg16", 1e-4, 1e-3),
    ("smallres", 1e-4, 1e-3)])
def test_two_train_steps_match_jax(name, tol, change_tol):
    n, hw = 6, 16 if name == "smallres" else 32
    factory = {"resnet50": _resnet_small, "senet50": _senet_small,
               "vgg16": _vgg, "smallres": _smallres}[name]
    x = _pixels(n, hw, 10) if name == "smallres" else _images(n, hw, 10)
    labels = np.array([0, 1, 2, 6, 1, 0], np.int32)
    jm, p, port = _pair(factory, x, seed=11)
    old = {k: v.clone() for k, v in port.state_dict().items()}
    masks = _Masks(_smallres_masks(n, hw, 12, 2)
                   if name == "smallres" else [])
    if name == "smallres":
        port.tower.draw = port.draw = masks.draw
    fused = _fused_blocks if name == "resnet50" else (
        lambda f, a, kw, _: f(*a, **kw))

    jstate = jclassifier.create_classifier_state(
        jm, jax.random.PRNGKey(0), jnp.asarray(x[:1]), learning_rate=0.5)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, p))
    step = jclassifier.classifier_train_step.__wrapped__  # fresh masks
    tstate = T.create_classifier_state(port, learning_rate=0.5)
    g = torch.Generator()
    for _ in range(2):
        with fnn.intercept_methods(masks.interceptor), \
                fnn.intercept_methods(fused):
            jstate, jloss, jacc = step(jstate, jnp.asarray(x),
                                       jnp.asarray(labels),
                                       jax.random.PRNGKey(1))
        tstate, tloss, tacc = T.classifier_train_step(
            tstate, torch.from_numpy(x), torch.from_numpy(labels), g)
        # The second step's loss runs on the first step's parameters.
        assert abs(float(tloss) - float(jloss)) <= tol * abs(float(jloss))
        assert float(tacc) == float(jacc)
    assert not masks.jax and not masks.port
    assert tstate.step == int(jstate.step) == 2
    want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    got = tstate.module.state_dict()
    assert set(got) == set(want)
    # Per tensor; for ResNet50Classifier over the whole model (a flipped
    # element of a 64-element BN vector alone moves that vector's L2 by
    # 2 / sqrt(64)).
    groups = [list(want)] if name == "resnet50" else [[k] for k in want]
    for keys in groups:
        change = torch.cat([(got[k] - old[k]).flatten() for k in keys])
        want_change = torch.cat([(want[k] - old[k]).flatten() for k in keys])
        assert float(want_change.abs().max()) > 0, keys[0]
        assert _rel_l2(change, want_change) <= change_tol, keys[0]
        agree = (torch.sign(change) == torch.sign(want_change)).float()
        assert float(agree.mean()) >= 0.99, keys[0]


def test_resnet_classifier_step_moves_bn_statistics():
    """Every BN mean and var of the trainable backbone is gradient-stepped,
    as the JAX classifier state steps its params."""
    x = _images(4, 32, 13)
    model = classify._BackboneClassifier(
        resnet.VGGFaceResNet50((1, 1, 1, 1), T32, trainable=True), OUT,
        dtype=T32)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = T.create_classifier_state(model)
    T.classifier_train_step(state, torch.from_numpy(x),
                            torch.tensor([0, 1, 2, 3]))
    after = model.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert set(moved) == set(before)


def test_create_classifier_state_refuses_a_frozen_backbone():
    frozen = classify._BackboneClassifier(
        resnet.VGGFaceResNet50((1, 1, 1, 1), T32), OUT, dtype=T32)
    with pytest.raises(ValueError, match="trains every tensor"):
        T.create_classifier_state(frozen)
    for model in (classify.ResNet50Classifier(OUT, T32),
                  classify.SENet50Classifier(OUT, T32),
                  classify.VGG16Classifier(OUT, 8, T32, (32, 32)),
                  classify.SmallResClassifier(OUT, T32, (16, 16))):
        state = T.create_classifier_state(model)
        assert sum(len(g["params"]) for g in state.optimizer.param_groups) \
            == len(list(model.parameters()))


def test_smallres_classifier_default_draws():
    """The classifier's own dropout keeps half its units (0.5 +/- 0.02),
    scaled by 2; a training forward without a generator raises; eval draws
    nothing and repeats itself."""
    model = classify.SmallResClassifier(3, T32, (16, 16),
                                        generator=torch.Generator()
                                        .manual_seed(0))
    seen = []
    base = model.draw

    def record(shape, g, dev):
        m = base(shape, g, dev)
        seen.append(m)
        return m

    model.draw = record
    x = torch.from_numpy(_pixels(64, 16, 14))
    with torch.no_grad():
        model.logits(x, train=True, generator=torch.Generator().manual_seed(1))
        a = model.logits(x)
        assert torch.equal(a, model.logits(x))
    assert len(seen) == 1 and seen[0].shape == (64, 512)
    assert abs(float(seen[0].float().mean()) - 0.5) < 0.02
    with pytest.raises(ValueError, match="Generator"):
        model.logits(x, train=True)


# -- losses ------------------------------------------------------------------

@pytest.mark.parametrize("weights", [None, "ones", "mixed", "zeros_some"])
def test_categorical_crossentropy_matches_jax(weights):
    rng = np.random.default_rng(15)
    logits = (3.0 * rng.normal(size=(9, 5))).astype(np.float32)
    targets = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 9)]
    sw = {None: None, "ones": np.ones(9, np.float32),
          "mixed": rng.uniform(0.1, 3.0, 9).astype(np.float32),
          "zeros_some": np.array([0, 1, 2, 0, 1, 0, 3, 1, 0], np.float32)
          }[weights]
    want = float(jclassifier.categorical_crossentropy(
        jnp.asarray(logits), jnp.asarray(targets),
        None if sw is None else jnp.asarray(sw)))
    got = float(T.categorical_crossentropy(
        torch.from_numpy(logits), torch.from_numpy(targets),
        None if sw is None else torch.from_numpy(sw)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_categorical_crossentropy_definition_and_uniform_weights():
    """The JAX test_classify cases."""
    logits = torch.tensor([[2.0, 0.0, -1.0]])
    targets = torch.tensor([[0.0, 1.0, 0.0]])
    got = float(T.categorical_crossentropy(logits, targets))
    assert abs(got + float(torch.log_softmax(logits, -1)[0, 1])) < 1e-6
    logits = torch.tensor([[2.0, 0.0], [0.0, 2.0]])
    uniform = T.categorical_crossentropy(logits, torch.eye(2),
                                         torch.ones(2))
    assert abs(float(uniform) - float(T.categorical_crossentropy(
        logits, torch.eye(2)))) < 1e-6


# -- fit_classifier ----------------------------------------------------------

def _fit_data(shift_val: bool, n: int = 20, hw: int = 32):
    """Class-separable images (the mean encodes the class); with
    ``shift_val`` the validation tail's labels are shifted by one class,
    so its loss rises while the model learns the train rows."""
    rng = np.random.default_rng(16)
    labels = rng.integers(0, 3, n).astype(np.int32)
    x = (labels[:, None, None, None] * 0.4 - 0.4
         + rng.normal(0, 0.3, (n, hw, hw, 3))).astype(np.float32)
    if shift_val:
        labels[int(n * 0.8):] = (labels[int(n * 0.8):] + 1) % 3
    return x, labels


@pytest.mark.parametrize("lr,shift_val,final_lr", [
    (1.0, False, 1.0), (0.2, True, 0.04)])
def test_fit_classifier_matches_jax(lr, shift_val, final_lr):
    """Every EpochLog field within 1e-4, the same early stop (fewer epochs
    than asked) and the same learning rate at the end.  With the
    validation labels shifted the val loss turns up after a few epochs,
    and the LR drops (0.2 -> 0.04) as the fit stops: both patiences are 5,
    so the drop shows in the returned state, not in a log."""
    x, labels = _fit_data(shift_val)
    jm, p, port = _pair(_senet_small, x, seed=17)
    jstate = jclassifier.create_classifier_state(
        jm, jax.random.PRNGKey(0), jnp.asarray(x[:1]), learning_rate=lr)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, p))
    jstate, jlogs = jclassifier.fit_classifier(
        jstate, jnp.asarray(x), jnp.asarray(labels), epochs=14,
        batch_size=16, key=jax.random.PRNGKey(2))
    tstate = T.create_classifier_state(port, learning_rate=lr)
    tstate, tlogs = T.fit_classifier(tstate, torch.from_numpy(x),
                                torch.from_numpy(labels), epochs=14,
                                batch_size=16,
                                generator=torch.Generator().manual_seed(3))
    assert len(tlogs) == len(jlogs) < 14
    # The drop comes with the stop (both patiences are 5), so it shows in
    # the returned state.
    assert tstate.learning_rate == pytest.approx(jstate.learning_rate)
    assert jstate.learning_rate == pytest.approx(final_lr)
    for a, b in zip(tlogs, jlogs):
        assert a.epoch == b.epoch
        for f in ("train_loss", "train_acc", "val_loss", "val_acc",
                  "learning_rate"):
            assert abs(getattr(a, f) - getattr(b, f)) <= 1e-4 * max(
                1.0, abs(getattr(b, f))), (a.epoch, f)


def test_fit_classifier_augment_hook_and_steps():
    """The JAX test_classify case: ``augment_fn`` sees every train batch
    (ceil(16 / 8) = 2 a epoch, the tail 4 rows validate) and what it
    returns is trained on."""
    model = classify.SmallResClassifier(2, T32, (16, 16))
    state = T.create_classifier_state(model)
    calls = []

    def augment(generator, batch):
        assert isinstance(generator, torch.Generator)
        calls.append(tuple(batch.shape))
        return torch.zeros_like(batch)

    x = torch.from_numpy(_pixels(20, 16, 18))
    y = torch.zeros(20, dtype=torch.int64)
    _, logs = T.fit_classifier(state, x, y, epochs=1, batch_size=8,
                               generator=torch.Generator().manual_seed(0),
                               augment_fn=augment,
                               dropout_generator=torch.Generator())
    assert calls == [(8, 16, 16, 3), (8, 16, 16, 3)]
    assert len(logs) == 1 and np.isfinite(logs[0].val_loss)
    with pytest.raises(ValueError, match="zero examples"):
        T.fit_classifier(state, x[:0], y[:0], epochs=1, batch_size=8)
