"""The port's Multi-PIE path against the JAX package, on the CPU: the
configurations, ``preprocess.smallres``, the SmallRes student (with its
dropout), the Multi-PIE scanner, pair builders and synthetic writer, the
loop's raw-pixel student, ``build_committee``, and ``run_alink_mtp`` with
its top-1 tail.

``jax.random`` and ``torch.Generator`` cannot give the same numbers, so
where a comparison runs through randomness the JAX side's draws are made
here and fed to the port: dropout masks through the tower's ``draw`` hook,
noise and DE draws and finetune permutations through the loop
(``test_torch_port_arc._JaxSchedule``).  Tolerances, each with its reason:

- configurations, ``smallres``, the scanner, pair builders and synthetic
  files: equal (bit-equal arrays, byte-identical files);
- SmallRes in f32: embeddings and logits within 2e-4 (the bound of
  ``tests/test_torch_parity.py``'s independent tower: f32 convolutions
  summed in other orders); in bf16 (the default) within 2e-2 on the
  logits, the siamese head's bf16 tolerance (bf16 activations rounded at
  the same points, f32 sums in other orders, a few values round the other
  way);
- one ``train_step`` with the same dropout masks on both sides, f32: loss
  within a relative 1e-4, every updated parameter within a relative 1e-4
  of its largest value (the forward's f32 differences carried through one
  Adadelta step);
- ``smallres_score_fn``: within 2e-2 of the JAX driver's repeated-pair
  scorer (kernel K1's tolerance: the port scores the head on bf16-rounded
  operands with f32 hidden activations, the JAX head rounds them to bf16),
  and the same top-1 where each probe's margin exceeds the measured
  difference;
- the loop and ``run_alink_mtp``: every slab's log equal; the final M2
  within 1e-3 of its update's largest change (as ``test_torch_port_arc``
  holds its driver: one finetune's batches summed in another order); the
  same top-1.
"""

import dataclasses
import filecmp
import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu import train as JT
from alink_tpu.config import ExistingALConfig as JExistingALConfig
from alink_tpu.config import MTPConfig as JMTPConfig
from alink_tpu.data import manifest as jmanifest
from alink_tpu.data import pairs as jpairs
from alink_tpu.data import synth as jsynth
from alink_tpu.data.loader import load_person_stacks as jload
from alink_tpu.drivers import alink as jalink
from alink_tpu.models import SmallRes as JSmallRes
from alink_tpu.models import preprocess as jpreprocess
from alink_tpu_torch import config as tconfig
from alink_tpu_torch import train as T
from alink_tpu_torch.convert import load_flax, state_dict_from_flax
from alink_tpu_torch.data import load_person_stacks, manifest, pairs, synth
from alink_tpu_torch.drivers import alink as talink
from alink_tpu_torch.models import SmallRes, SmallResTower, preprocess

from test_torch_port_a2 import pil_only  # noqa: F401

FD = 32          # the toy student's feature width


# -- configurations ----------------------------------------------------------

@pytest.mark.parametrize("jcls,tcls", [
    (JMTPConfig, tconfig.MTPConfig),
    (JExistingALConfig, tconfig.ExistingALConfig)])
def test_configs_match_jax_field_by_field(jcls, tcls):
    jf = {f.name: f for f in dataclasses.fields(jcls)}
    tf = {f.name: f for f in dataclasses.fields(tcls)}
    assert list(jf) == list(tf)
    for name in jf:
        assert tf[name].default == jf[name].default, name
        assert str(tf[name].type) == str(jf[name].type), name
    assert talink.parse_config([], config_cls=tcls) == tcls()
    argv = ["--seed", "7", "--split_ratio", "0.25"]
    assert (dataclasses.asdict(talink.parse_config(argv, config_cls=tcls))
            == dataclasses.asdict(jalink.parse_config(argv, config_cls=jcls)))


@pytest.mark.parametrize("kw", [
    {"low_res": 151}, {"eps": 0.5}, {"eps": -0.1}, {"split_ratio": 1.5},
    {"disparity_ratio": -0.1}, {"device_batch": 0}, {"device_batch": "x"},
    {"device_batch": "auto"}, {"low_res": 150}, {"noise": ("gaussian",)}])
def test_mtp_config_validation_matches_jax(kw):
    def outcome(cls):
        try:
            cls(**kw)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(tconfig.MTPConfig) == outcome(JMTPConfig)


# -- preprocess.smallres -----------------------------------------------------

@pytest.mark.parametrize("dtype", ["uint8", "float32", "bfloat16"])
def test_smallres_preprocess_matches_jax(dtype):
    """Exact on every dtype; uint8 promotes to f32 before the subtraction
    (uint8 - 128 would wrap)."""
    x = np.random.default_rng(0).integers(0, 256, (2, 5, 4, 3))
    if dtype == "uint8":
        jx, tx = jnp.asarray(x, jnp.uint8), torch.as_tensor(
            x.astype(np.uint8))
        want = (x.astype(np.float32) - 128.0) / 128.0
    else:
        jx = jnp.asarray(x, getattr(jnp, dtype))
        tx = torch.as_tensor(x.astype(np.float32)).to(getattr(torch, dtype))
        want = np.asarray(jpreprocess.smallres(jx).astype(jnp.float32))
    got = preprocess.smallres(tx)
    assert got.dtype == (torch.float32 if dtype == "uint8"
                         else getattr(torch, dtype))
    np.testing.assert_array_equal(got.float().numpy(), want)
    if dtype == "uint8":
        assert float(got.min()) == -1.0 and float(got.max()) < 1.0


# -- SmallRes ----------------------------------------------------------------

def _jax_smallres(hw, dtype=jnp.float32, seed=0):
    model = JSmallRes(feature_dim=FD, dtype=dtype)
    z = jnp.zeros((1, hw, hw, 3))
    return model, jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), z, z))


def _port_smallres(hw, params, dtype=torch.float32):
    return load_flax(SmallRes(FD, dtype=dtype, input_size=(hw, hw)), params)


def _pixels(n, hw, seed):
    x = np.random.default_rng(seed).integers(0, 256, (n, hw, hw, 3))
    return jpreprocess.smallres(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("hw", [12, 16, 20])
def test_smallres_matches_jax_in_f32(hw):
    model, p = _jax_smallres(hw)
    port = _port_smallres(hw, p)
    flat = (((hw - 2) // 2 - 2) // 2) ** 2 * 64
    assert port.tower.dense[0].in_features == flat
    left, right = _pixels(5, hw, 1), _pixels(5, hw, 2)
    tl, tr = (torch.tensor(np.asarray(v)) for v in (left, right))
    with torch.no_grad():
        np.testing.assert_allclose(
            port.embed(tl).numpy(),
            np.asarray(model.apply(p, left, method="embed")), atol=2e-4)
        np.testing.assert_allclose(
            port.logits(tl, tr).numpy(),
            np.asarray(model.apply(p, left, right, method="logits")),
            atol=2e-4)
        np.testing.assert_allclose(
            port(tl, tr).numpy(), np.asarray(model.apply(p, left, right)),
            atol=2e-4)


def test_smallres_bf16_default_matches_jax():
    hw = 16
    model, p = _jax_smallres(hw, jnp.bfloat16)
    port = _port_smallres(hw, p, torch.bfloat16)
    assert port.tower.dtype == port.verify_head.dtype == torch.bfloat16
    left, right = _pixels(8, hw, 3), _pixels(8, hw, 4)
    with torch.no_grad():
        got = port.logits(*(torch.tensor(np.asarray(v))
                            for v in (left, right)))
        emb = port.embed(torch.tensor(np.asarray(left)))
    assert got.dtype == emb.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(model.apply(p, left, right, method="logits")),
        atol=2e-2)


def test_smallres_tower_needs_ten_pixels():
    assert SmallResTower(8, input_size=(10, 10)).dense[0].in_features == 64
    with pytest.raises(ValueError, match="10"):
        SmallResTower(8, input_size=(9, 10))


def test_smallres_at_48_flattens_6400_wide():
    tower = SmallResTower(2048)
    assert tower.dense[0].in_features == 10 * 10 * 64 == 6400


# -- dropout -----------------------------------------------------------------

class _Masks:
    """Dropout keep masks for the JAX side (``flax.linen.intercept_methods``
    replaces each ``nn.Dropout`` call with ``x * mask / 0.75``) and the
    same masks for the port's ``draw`` hook, in call order."""

    def __init__(self, masks):
        self.jax = list(masks)
        self.port = list(masks)
        self.shapes = []

    def interceptor(self, next_fun, args, kwargs, context):
        if (isinstance(context.module, fnn.Dropout)
                and context.method_name == "__call__"):
            x = args[0]
            if kwargs.get("deterministic", context.module.deterministic):
                return x
            m = jnp.asarray(self.jax.pop(0))
            assert m.shape == x.shape
            return jnp.where(m, x / 0.75, jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    def draw(self, shape, generator, device):
        self.shapes.append(tuple(shape))
        m = self.port.pop(0)
        assert m.shape == tuple(shape)
        return torch.from_numpy(m)


def _mask_set(n, hw, seed):
    rng = np.random.default_rng(seed)
    s1 = (hw - 2) // 2
    s2 = (s1 - 2) // 2
    shapes = [(n, s1, s1, 32), (n, s2, s2, 64)] * 2   # left, then right
    return [rng.random(s) < 0.75 for s in shapes]


def test_train_step_with_injected_dropout_matches_jax():
    hw, n = 16, 6
    model, p = _jax_smallres(hw)
    port = _port_smallres(hw, p)
    left, right = _pixels(n, hw, 5), _pixels(n, hw, 6)
    y = np.array([0, 1, 1, 0, 1, 0], np.int32)
    masks = _Masks(_mask_set(n, hw, 7))

    jstate = JT.create_train_state(model, jax.random.PRNGKey(0), left, right,
                                   learning_rate=0.1)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, p))
    step = JT.train_step.__wrapped__       # eagerly: fresh masks per call
    with fnn.intercept_methods(masks.interceptor):
        jnew, jloss, jacc = step(jstate, left, right, jnp.asarray(y),
                                 jax.random.PRNGKey(1), weighted=True)
    assert not masks.jax

    port.tower.draw = masks.draw
    tstate = T.TrainState(port, learning_rate=0.1)
    tstate, tloss, tacc = T.train_step(
        tstate, torch.tensor(np.asarray(left)),
        torch.tensor(np.asarray(right)), torch.from_numpy(y),
        weighted=True, dropout_generator=torch.Generator())
    assert not masks.port and masks.shapes == [
        m.shape for m in _mask_set(n, hw, 7)]
    assert float(tacc) == float(jacc)
    assert abs(float(tloss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    want = state_dict_from_flax(jax.tree.map(np.asarray, jnew.params))
    got = tstate.module.state_dict()
    for k, w in want.items():
        assert float((got[k] - w).abs().max()) <= 1e-4 * float(
            w.abs().max()), k
    # Dropout mattered: the same step without masks moves M2 elsewhere.
    ref = _port_smallres(hw, p)
    T.train_step(T.TrainState(ref, learning_rate=0.1),
                 torch.tensor(np.asarray(left)),
                 torch.tensor(np.asarray(right)), torch.from_numpy(y),
                 dropout_generator=torch.Generator().manual_seed(3))
    assert not torch.equal(ref.tower.dense[0].weight,
                           got["tower.dense.0.weight"])


def test_default_dropout_draws_and_eval_is_deterministic():
    hw, n = 48, 64
    model = SmallRes(64, dtype=torch.float32,
                     generator=torch.Generator().manual_seed(0))
    x = preprocess.smallres(torch.randint(
        0, 256, (n, hw, hw, 3), generator=torch.Generator().manual_seed(1)))
    seen = []
    base = model.tower.draw

    def record(shape, g, dev):
        m = base(shape, g, dev)
        seen.append(m)
        return m

    model.tower.draw = record
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        model.embed(x, train=True, generator=g)
        a = model.embed(x)
        b = model.logits(x, x)
    assert len(seen) == 2 and seen[0].shape == (n, 23, 23, 32)
    for m in seen:
        assert m.dtype == torch.bool
        assert abs(float(m.float().mean()) - 0.75) < 0.02
    # Eval draws nothing and repeats itself.
    assert len(seen) == 2
    assert torch.equal(a, model.embed(x)) and torch.equal(
        b, model.logits(x, x))
    # Kept units scale by exactly 1/0.75, dropped ones are 0.
    t = model.tower
    v = torch.rand(4, 6, 6, 8, generator=torch.Generator().manual_seed(4))
    out = t._dropout(v.permute(0, 3, 1, 2), True,
                     torch.Generator().manual_seed(5)).permute(0, 2, 3, 1)
    ratio = out[out != 0] / v[out != 0]
    assert torch.allclose(ratio, torch.full_like(ratio, 1 / 0.75))
    with pytest.raises(ValueError, match="Generator"):
        model.logits(x[:2], x[:2], train=True)


def test_siamese_head_steps_are_unchanged_by_the_dropout_plumbing():
    """A module without dropout: ``train_step`` (with or without a dropout
    generator) and ``fit`` are bit-equal to the plain step they were
    before: logits, loss, one Adadelta step."""
    from alink_tpu_torch.models import SiameseHead
    from alink_tpu_torch.train.losses import (binary_crossentropy,
                                              class_weights_from_labels,
                                              one_hot)

    rng = np.random.default_rng(0)
    left = torch.from_numpy(rng.random((8, 24)).astype(np.float32))
    right = torch.from_numpy(rng.random((8, 24)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 2, 8))

    def head():
        return SiameseHead(24, (16, 8), generator=torch.Generator()
                           .manual_seed(1))

    plain = T.TrainState(head(), 0.1)
    logits = plain.module.logits(left, right)
    loss = binary_crossentropy(logits, one_hot(y),
                               class_weights_from_labels(y))
    plain.optimizer.zero_grad()
    loss.backward()
    plain.optimizer.step()
    for dg in (None, torch.Generator().manual_seed(9)):
        s = T.TrainState(head(), 0.1)
        s, got_loss, _ = T.train_step(s, left, right, y,
                                      dropout_generator=dg)
        assert torch.equal(got_loss, loss.detach())
        for k, v in plain.module.state_dict().items():
            assert torch.equal(s.module.state_dict()[k], v), k
    assert torch.equal(s.logits(left, right, train=True),
                       s.module.logits(left, right))


# -- scanner, pair builders, synthetic tree -----------------------------------

def test_synthetic_mtp_and_scanner_match_jax(tmp_path):
    jr, tr = str(tmp_path / "j"), str(tmp_path / "t")
    jsynth.make_synthetic_mtp(jr, num_subjects=4, image_size=16, seed=3)
    synth.make_synthetic_mtp(tr, num_subjects=4, image_size=16, seed=3)
    names = sorted(os.listdir(jr))
    assert names == sorted(os.listdir(tr)) and len(names) == 20
    _, mismatch, errors = filecmp.cmpfiles(jr, tr, names, shallow=False)
    assert not mismatch and not errors
    jg, tg = jmanifest.scan_mtp(jr), manifest.scan_mtp(tr)
    assert list(jg) == list(tg) == [1, 2, 3, 4]
    assert [[os.path.basename(p) for p in v] for v in jg.values()] == [
        [os.path.basename(p) for p in v] for v in tg.values()]
    assert all(len(v) == 4 for v in tg.values())
    for name in names + ["x_01_01_051_06.jpg", "7_02_01_051_08.png"]:
        assert manifest.mtp_qualifies(name) == jmanifest.mtp_qualifies(name)
    assert manifest._MTP_SUFFIXES == jmanifest._MTP_SUFFIXES


def _stacks(counts, seed=0):
    rng = np.random.default_rng(seed)
    from alink_tpu.data.loader import PersonStacks as JStacks
    from alink_tpu_torch.data import PersonStacks

    s = max(counts)
    imgs = rng.random((len(counts), s, 3, 2, 1)).astype(np.float32)
    c = np.asarray(counts, np.int32)
    return JStacks(imgs, c), PersonStacks(imgs, c)


@pytest.mark.parametrize("builder", ["gather_pairs", "all_pairs_minibatch",
                                     "mtp_all_pairs_minibatch",
                                     "mtp_all_pairs_index"])
def test_mtp_pair_builders_match_jax(builder):
    (ja, ta), (jb, tb) = _stacks([2, 0, 3, 1]), _stacks([1, 2, 2, 1], 1)
    if builder == "gather_pairs":
        idx = jpairs._grid_indices(ja.counts, jb.counts)
        want = jpairs.gather_pairs(ja, jb, idx)
        got = pairs.gather_pairs(ta, tb, pairs._grid_indices(ta.counts,
                                                            tb.counts))
    elif builder == "all_pairs_minibatch":
        want, got = (jpairs.all_pairs_minibatch(ja, jb),
                     pairs.all_pairs_minibatch(ta, tb))
    else:
        want, got = (getattr(jpairs, builder)(ja),
                     getattr(pairs, builder)(ta))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(w, g)
    if builder == "mtp_all_pairs_index":
        flat, li, ri, y = got
        assert len(y) == 6 * 6 and y.sum() == 2 * 2 + 3 * 3 + 1
        np.testing.assert_array_equal(
            flat[li], pairs.mtp_all_pairs_minibatch(ta)[0])


def test_person_stacks_of_a_synthetic_tree_match_jax(tmp_path, pil_only):
    root = synth.make_synthetic_mtp(str(tmp_path), num_subjects=3,
                                    image_size=20, seed=1)
    groups = list(manifest.scan_mtp(root).values())
    for res in ((20, 20), (12, 12)):
        want, got = jload(groups, res), load_person_stacks(groups, res)
        np.testing.assert_array_equal(want.images, got.images)
        np.testing.assert_array_equal(want.counts, got.counts)


# -- the JAX side's dropout masks, for the port's draw hook -------------------

@functools.lru_cache(maxsize=None)
def _mask_model(hw):
    model = JSmallRes(feature_dim=8, dtype=jnp.float32)
    z = jnp.zeros((1, hw, hw, 3))
    return model, model.init(jax.random.PRNGKey(0), z, z)


def jax_dropout_masks(kd, n, hw):
    """The keep masks flax's ``nn.Dropout`` draws in a SmallRes training
    forward on ``n`` pairs at ``hw`` under ``rngs={"dropout": kd}`` (the
    JAX trainer's ``train_step``), in call order: left tower, then right.
    They depend only on the key, the module paths and the shapes."""
    model, p = _mask_model(hw)
    masks = []

    def record(next_fun, args, kwargs, context):
        if (isinstance(context.module, fnn.Dropout)
                and context.method_name == "__call__"):
            rng = context.module.make_rng("dropout")
            masks.append(np.asarray(jax.random.bernoulli(
                rng, 0.75, args[0].shape)))
            return next_fun(*args, rng=rng, **kwargs)
        return next_fun(*args, **kwargs)

    z = jnp.zeros((n, hw, hw, 3))
    with fnn.intercept_methods(record):
        model.apply(p, z, z, train=True, rngs={"dropout": kd},
                    method="logits")
    return masks


def test_recorded_masks_are_the_ones_flax_draws():
    hw, n = 14, 3
    model, p = _jax_smallres(hw)
    left, right = _pixels(n, hw, 8), _pixels(n, hw, 9)
    kd = jax.random.PRNGKey(11)
    want = model.apply(p, left, right, train=True, rngs={"dropout": kd},
                       method="logits")
    masks = _Masks(jax_dropout_masks(kd, n, hw))
    with fnn.intercept_methods(masks.interceptor):
        got = model.apply(p, left, right, train=True, method="logits")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert not masks.jax


# -- smallres_score_fn and the top-1 tail ------------------------------------

def test_smallres_score_fn_matches_jax(tmp_path, pil_only):
    from alink_tpu.drivers import alink_mtp as jmtp
    from alink_tpu.evaluation import gallery_top1 as jtop1
    from alink_tpu_torch.drivers import alink_mtp as tmtp
    from alink_tpu_torch.evaluation.identification import gallery_top1

    hw = 16
    cfg = tconfig.MTPConfig(low_res=hw, feature_res=FD)
    jstate = jmtp.make_smallres_state(jax.random.PRNGKey(2), JMTPConfig(
        low_res=hw, feature_res=FD))
    port = load_flax(SmallRes(FD, input_size=(hw, hw)),
                     jax.tree.map(np.asarray, jstate.params))
    tstate = T.TrainState(port, 0.1)
    assert isinstance(tmtp.make_smallres_state(None, cfg, "cpu").module,
                      SmallRes)
    rng = np.random.default_rng(4)
    probes = rng.integers(0, 256, (40, hw, hw, 3)).astype(np.float32)
    gallery = rng.integers(0, 256, (7, hw, hw, 3)).astype(np.float32)
    want = np.asarray(jmtp.smallres_score_fn(jstate, hw, probe_chunk=16)(
        probes, gallery))
    got = tmtp.smallres_score_fn(tstate, batch=16)(probes, gallery).numpy()
    assert got.shape == want.shape == (40, 7)
    diff = float(np.abs(got - want).max())
    assert diff <= 2e-2, diff
    top = np.sort(want, axis=1)
    clear = top[:, -1] - top[:, -2] > 2 * diff
    assert clear.sum() >= 20
    np.testing.assert_array_equal(got.argmax(1)[clear],
                                  want.argmax(1)[clear])

    root = synth.make_synthetic_mtp(str(tmp_path), num_subjects=5,
                                    image_size=24, seed=6)
    groups = list(manifest.scan_mtp(root).values())
    subjects = load_person_stacks(groups, (hw, hw))
    assert gallery_top1(tmtp.smallres_score_fn(tstate), subjects) == jtop1(
        jmtp.smallres_score_fn(jstate, hw), jload(groups, (hw, hw)))


# -- the loop's raw-pixel student and run_alink_mtp against JAX's -------------

class _MtpSchedule:
    """``test_torch_port_arc._JaxSchedule`` for the Multi-PIE loop: the JAX
    loop's keys replayed into the port's (noise and DE draws per chunk,
    finetune permutations), and each finetune step's dropout masks fed to
    the port's tower through its ``draw`` hook.  An adversarial-only bank
    splits no key for the plain channels."""

    def __init__(self, low_res):
        from test_torch_port_arc import _JaxSchedule

        self.base = _JaxSchedule()
        self.low_res = low_res
        self.step_keys, self.masks = [], []
        self.base.start_chunk = self.start_chunk

    def start_chunk(self, names, n):
        from test_torch_port_a2 import CPU_DE, jax_draws

        b = self.base
        key, b.width = b._pop(chunk=True)
        plain = [nm for nm in names if nm not in ("adversarial", "fgsm")]
        if plain:
            kb, key = jax.random.split(key)
            b.noise_keys = {nm: list(jax.random.split(k)) for nm, k in
                            zip(plain, jax.random.split(kb, len(plain)))}
        if "adversarial" in names:
            ka = jax.random.split(key)[0]
            k = 5 * CPU_DE["pixel_count"]
            m = max(5, max(1, CPU_DE["popsize"] // k) * k)
            b.de = jax_draws(jax.random.split(ka, b.width)[:n], m, k,
                             CPU_DE["maxiter"])

    def fit(self, real_fit, monkeypatch):
        """The port's ``fit`` with JAX ``fit``'s permutations; each step's
        dropout key is kept for ``draw``."""
        def fit(state, left, right, labels, *, epochs, batch_size,
                generator=None, **kw):
            key, _ = self.base._pop(chunk=False)
            n_train = int(len(labels) * 0.8) or len(labels)
            perms = []
            for _ in range(epochs):
                key, kp = jax.random.split(key)
                perms.append(torch.from_numpy(np.asarray(
                    jax.random.permutation(kp, n_train))).long())
                for _ in range(max(1, -(-n_train // batch_size))):
                    key, kd = jax.random.split(key)
                    self.step_keys.append(kd)
            with monkeypatch.context() as m:
                m.setattr(torch, "randperm",
                          lambda n, generator=None: perms.pop(0))
                return real_fit(state, left, right, labels, epochs=epochs,
                                batch_size=batch_size, **kw)
        return fit

    def draw(self, shape, generator, device):
        if not self.masks:
            self.masks = jax_dropout_masks(self.step_keys.pop(0), shape[0],
                                           self.low_res)
        m = self.masks.pop(0)
        assert m.shape == tuple(shape)
        return torch.from_numpy(m)

    def install(self, monkeypatch, tloop):
        from alink_tpu_torch.ops import noise

        monkeypatch.setattr(noise, "get_relevant_noise", self.base.noise_fn)
        monkeypatch.setattr(tloop, "fit", self.fit(tloop.fit, monkeypatch))

    def done(self):
        return not (self.base.records or self.step_keys or self.masks)


HI, LO = 16, 12                 # the toy teacher's and student's resolution
DHI = HI * HI * 3


def _flat(images):
    """The toy teacher for both packages: pixels / 256, exact in f32."""
    return images.reshape(images.shape[0], -1) * 0.00390625


def _mtp_kw(tmp_path, side, **kw):
    out = dict(data_dir_prefix=str(tmp_path / "train"),
               test_dir=str(tmp_path / "test"),
               out_model=str(tmp_path / side / "post"),
               ensemble_basepath=str(tmp_path / side / "ens"),
               lowres_basemodel=str(tmp_path / side / "low"),
               noise=("gaussian",), image_res=(HI, HI), normal_res=(HI, HI),
               feature_res=DHI, low_res=LO, lowres_epochs=1,
               highres_epochs=1, ft_epochs=2, alink_bs=2, batch_send=4,
               batch_size=8, disparity_ratio=0.5, eps=0.0, seed=1)
    out.update(kw)
    return out


@pytest.fixture
def mtp_trees(tmp_path):
    synth.make_synthetic_mtp(str(tmp_path / "train"), num_subjects=4,
                             image_size=HI, seed=0)
    synth.make_synthetic_mtp(str(tmp_path / "test"), num_subjects=3,
                             image_size=HI, seed=9)
    return tmp_path


def _f32_models(monkeypatch, sched):
    """f32 students and committee heads on both sides; the port's student
    takes its dropout masks from ``sched``."""
    from alink_tpu.drivers import alink_mtp as jmtp
    from alink_tpu.drivers import common as jcommon
    from alink_tpu.models import SiameseHead as JSiameseHead
    from alink_tpu_torch.drivers import alink_mtp as tmtp
    from alink_tpu_torch.drivers import common as tcommon
    from alink_tpu_torch.models import SiameseHead

    monkeypatch.setattr(jmtp, "SmallRes", functools.partial(
        JSmallRes, dtype=jnp.float32))

    def student(**kw):
        m = SmallRes(dtype=torch.float32, **kw)
        m.tower.draw = sched.draw
        return m

    monkeypatch.setattr(tmtp, "SmallRes", student)
    monkeypatch.setattr(jcommon, "SiameseHead", functools.partial(
        JSiameseHead, dtype=jnp.float32))
    monkeypatch.setattr(tcommon, "SiameseHead", functools.partial(
        SiameseHead, dtype=torch.float32))


def _carry_checkpoints(tmp_path, names):
    """The JAX run's pretrained checkpoints, converted for the port."""
    for name in names:
        T.save(str(tmp_path / "t" / name), state_dict_from_flax(
            jax.tree.map(np.asarray, JT.restore(str(tmp_path / "j" / name)))))


@pytest.mark.parametrize("bank", ["gaussian", "adversarial"])
def test_run_alink_mtp_matches_jax(mtp_trees, monkeypatch, pil_only, bank):
    """The whole driver on the CPU against the JAX driver: the same
    pretrained SmallRes and committee (the JAX run's checkpoints), the JAX
    loop's draws replayed; every slab's log, the final M2 (within 1e-3 of
    its update's largest change) and the top-1 equal."""
    from alink_tpu.drivers import alink_mtp as jmtp
    from alink_tpu_torch.active import loop as tloop
    from alink_tpu_torch.drivers import alink_mtp as tmtp
    from test_torch_port_a2 import CPU_DE, _cut_de

    tmp = mtp_trees
    sched = _MtpSchedule(LO)
    _f32_models(monkeypatch, sched)
    jloops, tloops = [], []
    _cut_de(jmtp, monkeypatch)
    monkeypatch.setattr(jmtp, "ALinkLoop",
                        sched.base.jax_loop(jmtp.ALinkLoop, jloops))
    monkeypatch.setattr(tmtp, "ALinkLoop",
                        sched.base.port_loop(tmtp.ALinkLoop, tloops))
    sched.install(monkeypatch, tloop)

    kw = dict(noise=(bank,))
    jmtp.run_alink_mtp(JMTPConfig(**_mtp_kw(tmp, "j", active_ratio=0.0,
                                            **kw)),
                       featurize=_flat, n_steps=16)
    _carry_checkpoints(tmp, ["low", "ens1"])
    start = T.restore(str(tmp / "t" / "low"))
    del sched.base.records[:]
    sched.step_keys.clear()
    jstate, jtop1 = jmtp.run_alink_mtp(JMTPConfig(**_mtp_kw(tmp, "j", **kw)),
                                       featurize=_flat, n_steps=16)
    tstate, ttop1 = tmtp.run_alink_mtp(
        tconfig.MTPConfig(**_mtp_kw(tmp, "t", **kw)), featurize=_flat,
        n_steps=16, device="cpu")
    assert sched.done(), "the port drew fewer keys or masks than JAX"

    jl, tl = jloops[-1], tloops[0]
    assert tl.student_res == (LO, LO) and not tl.student_is_head
    if bank == "adversarial":
        assert {k: v for k, v in tl.adversarial_kwargs.items()
                if k != "draw"} == CPU_DE
    assert len(tl.logs) == 2 and tl.logs == jl.logs, (tl.logs, jl.logs)
    assert tstate.active_count > 0 and any(lg.finetuned for lg in tl.logs)
    assert tstate.buffer_size() == jstate.buffer_size()
    want = state_dict_from_flax(jax.tree.map(
        np.asarray, JT.restore(str(tmp / "j" / "post"))))
    got = T.restore(str(tmp / "t" / "post"))
    scale = max(float((want[k] - start[k]).abs().max()) for k in want)
    assert scale > 0
    for k in want:
        assert float((got[k] - want[k]).abs().max()) <= 1e-3 * scale, k
    assert ttop1 == jtop1 and jtop1 is not None


def _mtp_pool(p=6, seed=8):
    """``p`` subjects of 3 raw HIxHI images (the loop's pool, one group)."""
    from alink_tpu_torch.data import PersonStacks

    rng = np.random.default_rng(seed)
    return PersonStacks(rng.integers(0, 256, (p, 3, HI, HI, 3)).astype(
        np.float32), np.full(p, 3, np.int32))


def _replay(seed=3):
    """Clean SmallRes-scaled pairs at LO (numpy, the same on both sides)."""
    rng = np.random.default_rng(seed)
    while True:
        x = rng.integers(0, 256, (2, 8, LO, LO, 3)).astype(np.float32)
        yield ((x[0] - 128.0) / 128.0, (x[1] - 128.0) / 128.0), (
            rng.random(8) > 0.5).astype(np.int32)


def _loop_cfg(**kw):
    out = dict(noise=("gaussian",), image_res=(HI, HI), feature_res=DHI,
               alink_bs=2, batch_send=4, ft_epochs=2, mixture_ratio=1,
               disparity_ratio=0.5, eps=0.0, seed=3)
    out.update(kw)
    return out


def _raw_pixel_loops(monkeypatch, replay=True, **cfg_kw):
    """A JAX and a port ``ALinkLoop`` with SmallRes on raw pixels
    (``student_featurize=smallres``, ``student_is_head=False``,
    ``student_res`` 12^2, ``pair_builder=mtp_all_pairs_index``) on the same
    f32 models, the JAX loop's draws replayed into the port's; returns
    (JAX loop, port loop, the student's starting parameters)."""
    from alink_tpu.active import loop as jloop
    from alink_tpu.active.committee import Committee as JCommittee
    from alink_tpu.config import ALinkConfig as JALinkConfig
    from alink_tpu.data.pairs import mtp_all_pairs_index as jmtp_index
    from alink_tpu.models import SiameseHead as JSiameseHead
    from alink_tpu_torch.active import loop as tloop
    from alink_tpu_torch.active.committee import Committee
    from alink_tpu_torch.config import ALinkConfig
    from alink_tpu_torch.models import SiameseHead

    sched = _MtpSchedule(LO)
    sched.install(monkeypatch, tloop)
    jhead = JSiameseHead(dtype=jnp.float32)
    z = jnp.zeros((1, DHI))
    hp = jax.tree.map(np.asarray, jhead.init(jax.random.PRNGKey(5), z, z))
    model, sp = _jax_smallres(LO, seed=6)
    jm2 = JT.create_train_state(model, jax.random.PRNGKey(0),
                                jnp.zeros((1, LO, LO, 3)),
                                jnp.zeros((1, LO, LO, 3)), learning_rate=0.1)
    jm2 = jm2.replace(params=jax.tree.map(jnp.asarray, sp))
    port = _port_smallres(LO, sp)
    port.tower.draw = sched.draw
    thead = load_flax(SiameseHead(DHI, dtype=torch.float32), hp)
    common = dict(featurize=_flat, student_is_head=False,
                  student_res=(LO, LO), pool_uint8=True)
    jl = sched.base.jax_loop(jloop.ALinkLoop, [])(
        JALinkConfig(**_loop_cfg(**cfg_kw)),
        committee=JCommittee.from_param_list(jhead, [hp], ("gaussian",)),
        m2_state=jm2, student_featurize=jpreprocess.smallres,
        pair_builder=lambda p, _d: jmtp_index(p),
        replay_gen=_replay() if replay else None,
        key=jax.random.PRNGKey(4), **common)
    tl = sched.base.port_loop(tloop.ALinkLoop, [])(
        ALinkConfig(**_loop_cfg(**cfg_kw)),
        committee=Committee.from_param_list(thead, [thead.state_dict()],
                                            ("gaussian",)),
        m2_state=T.TrainState(port, 0.1),
        student_featurize=preprocess.smallres,
        pair_builder=lambda p, _d: pairs.mtp_all_pairs_index(p),
        replay_gen=_replay() if replay else None, **common)
    return jl, tl, sp, sched


def _assert_student_close(tl, jl, start):
    want = state_dict_from_flax(start)
    new = state_dict_from_flax(jax.tree.map(np.asarray,
                                            jl.state.m2_state.params))
    got = tl.state.m2_state.module.state_dict()
    scale = max(float((new[k] - want[k]).abs().max()) for k in want)
    assert scale > 0
    for k in want:
        assert float((got[k] - new[k]).abs().max()) <= 1e-3 * scale, k


def test_raw_pixel_student_loop_matches_jax(monkeypatch):
    """One slab with SmallRes on raw pixels against the JAX loop on the
    same models and draws: the log equal, M2 within 1e-3 of its update;
    with the queue left over, its image-shaped student inputs within 1e-4
    (bilinear resizes of the same noisy pixels)."""
    from test_torch_port_loop import _jax_stacks

    jl, tl, sp, sched = _raw_pixel_loops(monkeypatch)
    pool = _mtp_pool(p=2)
    jlog = jl.run_iteration(_jax_stacks(pool), _jax_stacks(pool))
    tlog = tl.run_iteration(pool, pool)
    assert sched.done()
    assert tlog == jlog and tlog.pairs == 36 and tlog.queried > 0, tlog
    assert tlog.finetuned
    _assert_student_close(tl, jl, sp)

    jl2, tl2, _, sched2 = _raw_pixel_loops(monkeypatch, replay=False,
                                           batch_send=1000)
    jlog2 = jl2.run_iteration(_jax_stacks(pool), _jax_stacks(pool))
    assert tl2.run_iteration(pool, pool) == jlog2 and not jlog2.finetuned
    assert sched2.done()
    js, ts = jl2.state, tl2.state
    assert ts.buffer_left.shape == js.buffer_left.shape == (
        ts.buffer_size(), LO, LO, 3)
    np.testing.assert_array_equal(ts.buffer_y, js.buffer_y)
    for a, b in ((ts.buffer_left, js.buffer_left),
                 (ts.buffer_right, js.buffer_right)):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_raw_pixel_student_augmented_finetune_matches_jax(monkeypatch):
    """``augment=True`` with the raw-pixel student: the queried pairs'
    variant blocks (the same matrices on both sides) are resized to
    ``student_res`` and scaled before the finetune; fit's inputs within
    1e-4 of JAX's (bilinear resizes), labels equal, M2 within 1e-3 of its
    update."""
    from alink_tpu.active import loop as jloop
    from alink_tpu.ops import augment as jaug
    from alink_tpu_torch.active import loop as tloop
    from alink_tpu_torch.ops import augment as taug
    from test_torch_port_loop import _draw_from, _jax_matrices, _jax_stacks

    jl, tl, sp, sched = _raw_pixel_loops(monkeypatch, augment=True,
                                         batch_send=1, mixture_ratio=0)
    mats = _jax_matrices(jax.random.PRNGKey(11), 64, HI, HI)

    def jax_augment(key, left, right, labels):
        n = left.shape[0]
        outs = [[left], [right]]
        for block, name in enumerate(("rotation", "shear", "shift")):
            for side, x in enumerate((left, right)):
                A, t = mats[block, side]
                outs[side].append(jaug._warp_batch(
                    x, jnp.asarray(A[:n]), jnp.asarray(t[:n]),
                    name != "shift"))
        return (jnp.concatenate(outs[0]), jnp.concatenate(outs[1]),
                jnp.tile(labels, (4, 1)))

    def port_augment(g, left, right, labels):
        sched.base._pop(chunk=False)        # the JAX loop's augment key
        return taug.augment_pairs(g, left, right, labels,
                                  draw=_draw_from(mats))

    fits = {"j": [], "t": []}
    real_jfit = JT.fit
    monkeypatch.setattr(jloop, "augment_pairs", jax_augment)
    monkeypatch.setattr(tloop, "augment_pairs", port_augment)
    monkeypatch.setattr(JT, "fit", lambda st, l, r, y, **k: (
        fits["j"].append((np.asarray(l), np.asarray(r), np.asarray(y))),
        real_jfit(st, l, r, y, **k))[1])
    real_tfit = tloop.fit
    monkeypatch.setattr(tloop, "fit", lambda st, l, r, y, **k: (
        fits["t"].append((l, r, y)), real_tfit(st, l, r, y, **k))[1])
    pool = _mtp_pool(p=2)
    jlog = jl.run_iteration(_jax_stacks(pool), _jax_stacks(pool))
    tlog = tl.run_iteration(pool, pool)
    assert sched.done()
    assert tlog == jlog and tlog.finetuned and tlog.queried > 0, tlog
    (jlft, jrft, jyft), = fits["j"]
    (tlft, trft, tyft), = fits["t"]
    assert tlft.shape == jlft.shape == (5 * tlog.queried, LO, LO, 3)
    np.testing.assert_array_equal(tyft, jyft)
    np.testing.assert_allclose(tlft, jlft, atol=1e-4)
    np.testing.assert_allclose(trft, jrft, atol=1e-4)
    assert float(np.abs(tlft).max()) <= 1.0
    _assert_student_close(tl, jl, sp)


def _resume_loop():
    from alink_tpu_torch.active import loop as tloop
    from alink_tpu_torch.active.committee import Committee
    from alink_tpu_torch.config import ALinkConfig
    from alink_tpu_torch.models import SiameseHead

    g = torch.Generator().manual_seed(0)
    head = SiameseHead(DHI, (16, 8), dtype=torch.float32, generator=g)
    m2 = SmallRes(FD, dtype=torch.float32, input_size=(LO, LO), generator=g)
    return tloop.ALinkLoop(
        ALinkConfig(**_loop_cfg(batch_send=20, disparity_ratio=0.9)),
        featurize=_flat,
        committee=Committee.from_param_list(head, [head.state_dict()],
                                            ("gaussian",)),
        m2_state=T.TrainState(m2, 0.1), student_featurize=preprocess.smallres,
        student_is_head=False, student_res=(LO, LO),
        pair_builder=lambda p, _d: pairs.mtp_all_pairs_index(p),
        replay_gen=_replay(), pool_uint8=True)


def test_raw_pixel_student_resume_is_exact(tmp_path):
    """Kill after slab 1 (its queue of 12^2 student inputs not yet sent),
    resume: counters, logs, M2 and its optimizer, both generators equal to
    the uninterrupted run's, bit for bit."""
    from test_torch_port_loop import _assert_same_end

    pool = _mtp_pool()
    gt = _resume_loop()
    gt.run(pool, pool, checkpoint_path=str(tmp_path / "gt"))
    assert len(gt.logs) == 3 and any(lg.finetuned for lg in gt.logs)
    path = str(tmp_path / "run")
    first = _resume_loop()
    real = first.run_iteration

    def killed(*a, **k):
        if first.logs:
            raise RuntimeError("killed")
        return real(*a, **k)

    first.run_iteration = killed
    with pytest.raises(RuntimeError, match="killed"):
        first.run(pool, pool, checkpoint_path=path)
    assert not first.logs[0].finetuned
    queued = first.state.buffer_left
    assert queued.shape[1:] == (LO, LO, 3) and len(queued) > 0
    resumed = _resume_loop()
    assert resumed.restore(path)
    np.testing.assert_array_equal(resumed.state.buffer_left, queued)
    np.testing.assert_array_equal(resumed.state.buffer_right,
                                  first.state.buffer_right)
    resumed.run(pool, pool, checkpoint_path=path)
    assert [lg.iteration for lg in resumed.logs] == [1, 2]
    _assert_same_end(gt, resumed)


def test_run_alink_mtp_resumes_from_its_loop_checkpoint(mtp_trees):
    """``loop_checkpoint`` reaches the loop: a second run restores the
    finished loop (counters, M2, generators), runs no slab and saves the
    same student."""
    from alink_tpu_torch.drivers import alink_mtp as tmtp

    tmp = mtp_trees
    cfg = tconfig.MTPConfig(**_mtp_kw(tmp, "t", loop_checkpoint=str(
        tmp / "ck")))
    first, top1 = tmtp.run_alink_mtp(cfg, featurize=_flat, n_steps=16,
                                     device="cpu")
    assert len(first.logs) == 2 and first.active_count > 0
    saved = T.restore(str(tmp / "t" / "post"))
    again, top1b = tmtp.run_alink_mtp(cfg, featurize=_flat, n_steps=16,
                                      device="cpu")
    assert again.logs == [] and top1b == top1
    assert (again.active_count, again.un_size, again.pool_cursor) == (
        first.active_count, first.un_size, first.pool_cursor)
    for k, v in T.restore(str(tmp / "t" / "post")).items():
        assert torch.equal(v, saved[k]), k
