"""The port's featurizer, kernel K3's plain version and the training layer
against the JAX package, on the CPU.

Inputs come from ``np.random``; JAX parameters pass through
``alink_tpu_torch.convert``.  Tolerances, each with its reason:

- K3 (``bottleneck_chain`` on a CPU tensor, the plain version) against the
  Pallas kernel in interpret mode: at most 1 % of the outputs differ, by at
  most one bf16 step of the largest (2^-8 of it): the same rounding points,
  f32 sums in other orders may round a value the other way (0.02 is the JAX
  package's own bound for the fused block against flax; a rounding point
  moved or dropped changes most outputs);
- ``VGGFaceResNet50`` (bf16 stem and strided blocks, fused-block numerics)
  against flax in f32: relative max error 0.02, the JAX package's bound for
  its fused forward (``tests/test_resblock.py``);
- Adadelta steps, ``fit``, ``custom_train`` and the stacked committee with
  f32 heads: parameters within 1e-5 of the largest parameter, and their
  changes within 1e-3 of the largest change (one f32 ulp of a parameter is
  ~1e-4 of a first Adadelta step); bf16 heads: changes within 5e-2 (bf16
  hidden activations rounded at the same points from f32 sums in other
  orders).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu import train as JT
from alink_tpu.active.committee import Committee as JCommittee
from alink_tpu.models import SiameseHead as JSiameseHead
from alink_tpu.models import preprocess as jpreprocess
from alink_tpu.models.resnet import VGGFaceResNet50 as JVGG
from alink_tpu.models.resnet import _Bottleneck as JBottleneck
from alink_tpu.models.resnet import bottleneck_weights as jbottleneck_weights
from alink_tpu.ops.resblock import BottleneckWeights as JBottleneckWeights
from alink_tpu.ops.resblock import bottleneck_chain as jbottleneck_chain
from alink_tpu.train.ensemble import create_ensemble_state as jcreate_ens
from alink_tpu.train.ensemble import train_ensemble as jtrain_ensemble
from alink_tpu.train.trainer import _PlateauControl as JPlateau
from alink_tpu_torch import train as T
from alink_tpu_torch.active.committee import Committee, unstack_params
from alink_tpu_torch.convert import load_flax, state_dict_from_flax
from alink_tpu_torch.models import SiameseHead, VGGFaceResNet50, preprocess
from alink_tpu_torch.models.resnet import KERAS_BN_EPS, _FrozenBN
from alink_tpu_torch.ops import resblock
from alink_tpu_torch.train.ensemble import create_ensemble_state
from alink_tpu_torch.train.trainer import _PlateauControl

D = 24  # feature width of the small heads


def _rand_bn(tree, rng):
    """numpy copy of a flax tree with non-trivial BN statistics."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items") and "gamma" in v:
            c = np.asarray(v["gamma"]).shape[0]
            out[k] = {"gamma": rng.uniform(0.5, 1.5, c),
                      "beta": rng.uniform(-0.3, 0.3, c),
                      "mean": rng.uniform(-0.3, 0.3, c),
                      "var": rng.uniform(0.5, 1.5, c)}
            out[k] = {n: a.astype(np.float32) for n, a in out[k].items()}
        elif hasattr(v, "items"):
            out[k] = _rand_bn(v, rng)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def _bf16_close(got: torch.Tensor, want: np.ndarray) -> None:
    got = got.float().numpy()
    assert _rel(got, want) <= 2.0 ** -8
    assert np.mean(got != want) <= 0.01


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port_weights(jw) -> resblock.BottleneckWeights:
    return resblock.BottleneckWeights(
        *(None if a is None else torch.from_numpy(np.asarray(a, np.float32))
          for a in jw))


def _jax_block(project, cin, f, seed, x):
    blk = JBottleneck(f, stride=1, project=project, dtype=jnp.float32)
    p = blk.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    p = _rand_bn(jax.tree.map(np.asarray, dict(p["params"])),
                 np.random.default_rng(seed))
    return blk, p


# -- K3 ----------------------------------------------------------------------

@pytest.mark.parametrize("project,cin,f", [(True, 32, 16), (False, 64, 16),
                                           (True, 32, 8)])
def test_bottleneck_plain_matches_pallas_kernel(project, cin, f):
    """One stride-1 block, identity (Cout 64) or projected (Cout 64 / 32),
    on 1x8x8 and an odd 2x7x9 map."""
    rng = np.random.default_rng(cin + f)
    for shape in ((1, 8, 8, cin), (2, 7, 9, cin)):
        x = rng.normal(size=shape).astype(np.float32)
        _, p = _jax_block(project, cin, f, 1, x)
        jw = jbottleneck_weights(p)
        want = np.asarray(jbottleneck_chain(jnp.asarray(x), (jw,),
                                            interpret=True), np.float32)
        ref = resblock.bottleneck_s1_reference(torch.from_numpy(x),
                                               _port_weights(jw))
        got = resblock.bottleneck_chain(torch.from_numpy(x),
                                        (_port_weights(jw),))
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert torch.equal(got, ref)
        _bf16_close(got, want)


def _np_block(cin, cm, cout, proj, rng):
    """Folded-BN weights of one block at any widths (numpy f32)."""
    def mat(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2] * (
            9 if len(shape) == 4 else 1))).astype(np.float32)

    def bn(c):
        return (rng.uniform(0.5, 1.5, c).astype(np.float32),
                rng.uniform(-0.2, 0.2, c).astype(np.float32))

    ws = [mat(cin, cm), *bn(cm), mat(3, 3, cm, cm), *bn(cm), mat(cm, cout),
          *bn(cout)]
    if proj:
        ws += [mat(cin, cout), *bn(cout)]
    return JBottleneckWeights(*ws)


def test_bottleneck_chain_at_odd_widths_matches_pallas_kernel():
    """Widths K3 runs zero-padded (Cin 32 -> Cm 80 -> Cout 200 projected,
    then 200 -> 48 -> 200 identity): the plain chain against the JAX chain
    in interpret mode, which pads every width to 128 lanes."""
    rng = np.random.default_rng(11)
    x = np.abs(rng.normal(size=(2, 7, 9, 32))).astype(np.float32)
    jws = (_np_block(32, 80, 200, True, rng), _np_block(200, 48, 200, False,
                                                       rng))
    want = np.asarray(jbottleneck_chain(jnp.asarray(x), jws, interpret=True),
                      np.float32)
    got = resblock.bottleneck_chain(torch.from_numpy(x),
                                    tuple(_port_weights(w) for w in jws))
    assert got.shape == want.shape == (2, 7, 9, 200)
    _bf16_close(got, want)


def test_bottleneck_chain_of_two_matches_pallas_kernel():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    _, p0 = _jax_block(True, 32, 16, 4, x)
    y = np.zeros((2, 8, 8, 64), np.float32)
    _, p1 = _jax_block(False, 64, 16, 5, y)
    jws = (jbottleneck_weights(p0), jbottleneck_weights(p1))
    want = np.asarray(jbottleneck_chain(jnp.asarray(x), jws, interpret=True),
                      np.float32)
    got = resblock.bottleneck_chain(torch.from_numpy(x),
                                    tuple(_port_weights(w) for w in jws))
    _bf16_close(got, want)


def test_bottleneck_kernel_refuses_cpu_tensors_and_bad_shapes():
    x = torch.zeros(1, 4, 4, 32)
    wts = _port_weights(jbottleneck_weights(
        _jax_block(False, 32, 8, 0, np.zeros((1, 4, 4, 32), np.float32))[1]))
    with pytest.raises(ValueError, match="CUDA"):
        resblock.bottleneck_s1_kernel(x, wts)
    with pytest.raises(ValueError, match="no bottleneck"):
        resblock.bottleneck_chain(x.to("meta"), (wts,))


def test_kernel_weights_layout_and_plain_result():
    """``kernel_weights`` gives the layout the kernel checks for (bf16
    matrices, f32 scale/shift, contiguous), and the plain version gives the
    same bits on either form."""
    x = np.random.default_rng(7).normal(size=(1, 6, 6, 32)).astype(np.float32)
    wts = _port_weights(jbottleneck_weights(_jax_block(True, 32, 16, 2, x)[1]))
    kw = resblock.kernel_weights(wts, torch.device("cpu"))
    resblock._check_kernel_layout(kw, torch.device("cpu"))
    assert kw.w3.shape == (3, 3, 16, 16) and kw.w3.dtype == torch.bfloat16
    assert kw.s1.dtype == torch.float32 and kw.wp is not None
    with pytest.raises(ValueError, match="kernel_weights"):
        resblock._check_kernel_layout(wts, torch.device("cpu"))
    xt = torch.from_numpy(x)
    assert torch.equal(resblock.bottleneck_s1_reference(xt, kw),
                       resblock.bottleneck_s1_reference(xt, wts))


# -- VGGFace-ResNet50 --------------------------------------------------------

@pytest.mark.parametrize("size", [32, 64])
def test_vggface_resnet50_matches_flax(size):
    """Two blocks per stage, so every stage has a stride-1 block."""
    sizes = (2, 2, 2, 2)
    jm = JVGG(stage_sizes=sizes, dtype=jnp.float32)
    rng = np.random.default_rng(size)
    x = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = {"params": _rand_bn(jax.tree.map(np.asarray, dict(p["params"])),
                            rng)}
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    m = load_flax(VGGFaceResNet50(stage_sizes=sizes), p)
    got = m(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert _rel(got, want) < 0.02


def test_vggface_folded_weights_follow_loaded_parameters():
    """The cached stride-1 weights are dropped by ``load_state_dict`` and
    by ``refold``: a model that ran once and then loads other weights gives
    what a fresh model with those weights gives."""
    sizes = (2, 1, 1, 1)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (1, 32, 32, 3)).astype(np.float32))
    a = VGGFaceResNet50(sizes, generator=torch.Generator().manual_seed(0))
    b = VGGFaceResNet50(sizes, generator=torch.Generator().manual_seed(1))
    want = b(x)
    a(x)
    a.load_state_dict(b.state_dict())
    assert torch.equal(a(x), want)
    with torch.no_grad():
        a.blocks[1].bn[2].gamma.mul_(2.0)
    a.refold()
    assert not torch.equal(a(x), want)


def test_vggface_converter_round_trip_full_tree():
    """Every tensor of the full (3, 4, 6, 3) flax tree lands on a port
    tensor of the same name pattern and shape, values intact, eps 1e-3."""
    shapes = jax.eval_shape(JVGG().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    m = load_flax(VGGFaceResNet50(), tree)
    sd = m.state_dict()
    params = tree["params"]
    assert len(sd) == len(jax.tree.leaves(params))
    assert len(m.blocks) == 16
    np.testing.assert_array_equal(
        sd["conv.0.weight"].numpy(),
        params["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    for i in (0, 3, 15):
        for j in range(4 if i in (0, 3) else 3):
            k = params[f"_Bottleneck_{i}"][f"Conv_{j}"]["kernel"]
            np.testing.assert_array_equal(
                sd[f"blocks.{i}.conv.{j}.weight"].numpy(),
                k.transpose(3, 2, 0, 1))
            bn = params[f"_Bottleneck_{i}"][f"_FrozenBN_{j}"]
            np.testing.assert_array_equal(
                sd[f"blocks.{i}.bn.{j}.var"].numpy(), bn["var"])
    bns = [mod for mod in m.modules() if isinstance(mod, _FrozenBN)]
    assert len(bns) == 1 + 16 * 3 + 4
    assert all(bn.eps == KERAS_BN_EPS == 1e-3 for bn in bns)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_preprocess_vggface_matches_jax(version, dtype):
    x = np.random.default_rng(version).integers(0, 256, (2, 5, 5, 3)).astype(
        dtype)
    got = preprocess.vggface(torch.from_numpy(x), version)
    want = np.asarray(jpreprocess.vggface(jnp.asarray(x), version))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# -- losses ------------------------------------------------------------------

@pytest.mark.parametrize("labels", [[0, 1, 1, 0, 1, 1, 1, 0],
                                    [1, 1, 1, 1, 1, 1, 1, 1],
                                    [0, 0, 0, 0, 0, 0, 0, 0]])
def test_losses_match_jax(labels):
    y = np.asarray(labels, np.int32)
    logits = np.random.default_rng(len(labels)).normal(
        size=(8, 2)).astype(np.float32)
    jw = np.asarray(JT.class_weights_from_labels(jnp.asarray(y)))
    tw = T.class_weights_from_labels(torch.from_numpy(y))
    np.testing.assert_allclose(tw.numpy(), jw, rtol=1e-6)
    tgt = np.eye(2, dtype=np.float32)[y]
    for sw in (None, jw):
        want = JT.binary_crossentropy(jnp.asarray(logits), jnp.asarray(tgt),
                                      None if sw is None else jnp.asarray(sw))
        got = T.binary_crossentropy(
            torch.from_numpy(logits), T.one_hot(torch.from_numpy(y)),
            None if sw is None else torch.from_numpy(sw))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        float(T.accuracy(torch.from_numpy(logits), torch.from_numpy(tgt))),
        float(JT.accuracy(jnp.asarray(logits), jnp.asarray(tgt))))


# -- trainer -----------------------------------------------------------------

def _heads(f32: bool, seed: int = 0):
    """A JAX train state and the port's, same parameters."""
    jdt, tdt = (jnp.float32, torch.float32) if f32 else (jnp.bfloat16,
                                                         torch.bfloat16)
    jh = JSiameseHead(widths=(16, 8), dtype=jdt)
    ex = jnp.zeros((2, D))
    js = JT.create_train_state(jh, jax.random.PRNGKey(seed), ex, ex,
                               learning_rate=0.1)
    ts = T.TrainState(load_flax(SiameseHead(D, (16, 8), dtype=tdt),
                                jax.tree.map(np.asarray, js.params)), 0.1)
    return js, ts


def _batches(n_batches: int, b: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        left = rng.normal(size=(b, D)).astype(np.float32)
        right = (left + rng.normal(size=(b, D)) * rng.uniform(
            0.2, 2.0, (b, 1))).astype(np.float32)
        out.append(((left, right), rng.integers(0, 2, b).astype(np.int32)))
    return out


def _params_close(got, want, start, tol):
    """Parameter dicts agree within 1e-5 of the largest parameter (f32
    only), and their changes from ``start`` within ``tol`` of the largest
    change."""
    scale = max(float((want[k] - start[k]).abs().max()) for k in want)
    size = max(float(want[k].abs().max()) for k in want)
    assert scale > 0
    for k in want:
        err = float((got[k].float() - want[k]).abs().max())
        assert err <= tol * scale, (k, err, scale)
        assert tol > 1e-3 or err <= 1e-5 * size, (k, err, size)


def _delta_close(ts, js, js0, tol):
    _params_close(ts.module.state_dict(),
                  state_dict_from_flax(jax.tree.map(np.asarray, js.params)),
                  state_dict_from_flax(jax.tree.map(np.asarray, js0)), tol)


@pytest.mark.parametrize("f32,tol", [(True, 1e-3), (False, 5e-2)])
def test_adadelta_train_steps_match_jax(f32, tol):
    js, ts = _heads(f32)
    p0 = js.params
    for (l, r), y in _batches(5, 12, 1):
        js, jloss, jacc = JT.train_step(js, jnp.asarray(l), jnp.asarray(r),
                                        jnp.asarray(y), jax.random.PRNGKey(0))
        ts, loss, acc = T.train_step(ts, l, r, y)
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=1e-5 if f32 else 1e-2)
        assert float(acc) == pytest.approx(float(jacc))
    assert ts.step == int(js.step) == 5
    _delta_close(ts, js, p0, tol)


@pytest.mark.parametrize("losses", [
    [1.0, 0.95, 0.9, 0.85, 0.8, 0.79, 0.78, 0.77, 0.76, 0.75, 0.74],
    [1.0, 0.5, 0.45, 0.45, 0.45, 0.45, 0.45, 0.45, 0.3, 0.3, 0.3, 0.3, 0.3,
     0.3, 0.3, 0.3, 0.3, 0.3],
    [2.0, 1.0, 0.5, 0.2, 0.1, 0.05, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
def test_plateau_control_matches_jax(losses):
    js, ts = _heads(True)
    jc, tc = JPlateau(), _PlateauControl()
    for epoch, v in enumerate(losses):
        js, jstop = jc.update(js, v)
        ts, tstop = tc.update(ts, v)
        assert ts.learning_rate == pytest.approx(js.learning_rate)
        assert tstop == jstop, epoch
        if jstop:
            break


def test_fit_matches_jax_when_one_step_per_epoch():
    """20 rows, validation 0.2 from the tail: 16 train rows = one batch of
    16, so each epoch's shuffle only reorders one batch."""
    js, ts = _heads(True, 2)
    p0 = js.params
    (l, r), y = _batches(1, 20, 2)[0]
    js, jlogs = JT.fit(js, jnp.asarray(l), jnp.asarray(r), jnp.asarray(y),
                       epochs=4, batch_size=16, key=jax.random.PRNGKey(1))
    ts, tlogs = T.fit(ts, l, r, y, epochs=4, batch_size=16,
                      generator=torch.Generator().manual_seed(1))
    assert len(tlogs) == len(jlogs) == 4
    for a, b in zip(tlogs, jlogs):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    _delta_close(ts, js, p0, 1e-3)
    with pytest.raises(ValueError, match="zero examples"):
        T.fit(ts, l[:0], r[:0], y[:0], epochs=1, batch_size=16)


def test_custom_train_matches_jax_without_validation():
    js, ts = _heads(True, 3)
    p0 = js.params
    data = _batches(6, 8, 3)
    js, jlogs = JT.custom_train(js, iter(data), epochs=2, batch_size=8,
                                key=jax.random.PRNGKey(2), val_ratio=0.0,
                                n_steps=24)
    ts, tlogs = T.custom_train(ts, iter(data), epochs=2, batch_size=8,
                               val_ratio=0.0, n_steps=24)
    for a, b in zip(tlogs, jlogs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    _delta_close(ts, js, p0, 1e-3)


def test_test_accuracy_matches_jax():
    js, ts = _heads(True, 4)
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(12, D)).astype(np.float32)
    labels = np.repeat(np.arange(4), 3)
    assert T.test_accuracy(ts, feats, labels) == pytest.approx(
        JT.test_accuracy(js, jnp.asarray(feats), jnp.asarray(labels)),
        abs=1e-6)


def test_checkpoint_save_restore_and_missing(tmp_path):
    _, ts = _heads(True)
    sd = ts.module.state_dict()
    like = {k: torch.zeros_like(v) for k, v in sd.items()}
    path = str(tmp_path / "m")
    assert T.maybe_restore(path, like) == (like, False)
    T.save(path, sd)
    got, ok = T.maybe_restore(path, like)
    assert ok and all(torch.equal(got[k], sd[k]) for k in sd)
    bad = dict(like, extra=torch.zeros(1))
    assert T.maybe_restore(path, bad) == (bad, False)
    T.save(path, {"a": np.arange(3)})
    assert torch.equal(T.restore(path)["a"], torch.arange(3))


# -- the committee -----------------------------------------------------------

def _ensembles(e: int = 3):
    jh = JSiameseHead(widths=(16, 8), dtype=jnp.float32)
    ex = jnp.zeros((2, D))
    jst = jcreate_ens(jh, jax.random.PRNGKey(5), e, ex, ex, learning_rate=0.1)
    heads = [load_flax(SiameseHead(D, (16, 8), dtype=torch.float32),
                       jax.tree.map(lambda a, i=i: np.asarray(a[i]),
                                    jst.params)) for i in range(e)]
    return jh, jst, heads


def test_train_ensemble_matches_jax_and_single_heads():
    """Member i of the stacked trainer equals a single head trained on the
    batches member i draws (i, i + E, ...), and the port matches JAX."""
    e = 3
    jh, jst, heads = _ensembles(e)
    p0 = jst.params
    data = _batches(3 * e * 2, 8, 6)
    singles = [T.TrainState(copy.deepcopy(h), 0.1) for h in heads]
    ens = create_ensemble_state(heads, 0.1)
    ens, logs = T.train_ensemble(ens, iter(data), epochs=2, batch_size=8,
                                 n_steps=24)
    jst, jlogs = jtrain_ensemble(jst, iter(data), epochs=2, batch_size=8,
                                 n_steps=24)
    for a, b in zip(logs, jlogs):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    for i in range(e):
        for (l, r), y in data[i::e]:
            T.train_step(singles[i], l, r, y)
        member = unstack_params(ens.params, i)
        single = singles[i].module.state_dict()
        want = state_dict_from_flax(jax.tree.map(
            lambda a, i=i: np.asarray(a[i]), jst.params))
        start = state_dict_from_flax(jax.tree.map(
            lambda a, i=i: np.asarray(a[i]), p0))
        _params_close(member, want, start, 1e-3)
        _params_close(single, member, start, 1e-3)


def test_committee_predict_matches_jax():
    jh, jst, heads = _ensembles(3)
    jc = JCommittee(jh, jst.params)
    tc = Committee.from_param_list(heads[0], [h.state_dict() for h in heads])
    rng = np.random.default_rng(7)
    l, r = (rng.normal(size=(9, D)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tc.member_probs(torch.from_numpy(l), torch.from_numpy(r)).numpy(),
        np.asarray(jc.member_probs(jnp.asarray(l), jnp.asarray(r))),
        atol=1e-6)
    np.testing.assert_allclose(
        tc.predict(torch.from_numpy(l), torch.from_numpy(r)).numpy(),
        np.asarray(jc.predict(jnp.asarray(l), jnp.asarray(r))), atol=1e-6)
    assert tc.num_members == jc.num_members == 3


def test_train_or_load_keeps_restored_checkpoints(tmp_path):
    """A restored head is not retrained; a committee keeps every member that
    restores and trains the rest (the JAX package's staging contract)."""
    from alink_tpu_torch.data import PersonStacks, balanced_pair_batches
    from alink_tpu_torch.drivers import common

    rng = np.random.default_rng(12)
    stacks = PersonStacks(rng.normal(size=(4, 3, D)).astype(np.float32),
                          np.full(4, 3, np.int32))
    gen = balanced_pair_batches(0, stacks, None, 8)
    g = torch.Generator().manual_seed(0)
    kw = dict(epochs=1, batch_size=8, n_steps=16)
    head = common.new_head_state(g, D)
    common.train_or_load_head(head, str(tmp_path / "m2"), gen, **kw)
    saved = T.restore(str(tmp_path / "m2"))
    again = common.train_or_load_head(common.new_head_state(g, D),
                                      str(tmp_path / "m2"), gen, **kw)
    assert all(torch.equal(again.module.state_dict()[k], v)
               for k, v in saved.items())

    base = str(tmp_path / "ens")
    common.train_or_load_committee(g, D, ("plain",), 2, base, gen, **kw)
    first = T.restore(f"{base}1")
    second = T.restore(f"{base}2")
    os.remove(os.path.join(f"{base}2", "tree.pt"))
    com, _ = common.train_or_load_committee(g, D, ("plain",), 2, base, gen,
                                            **kw)
    m1, m2 = (unstack_params(com.params, i) for i in (0, 1))
    assert all(torch.equal(m1[k], first[k]) for k in first)
    assert not all(torch.equal(m2[k], second[k]) for k in second)
    assert all(torch.equal(T.restore(f"{base}2")[k], m2[k]) for k in m2)
