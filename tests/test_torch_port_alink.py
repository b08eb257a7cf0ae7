"""The port's A-LINK path against the JAX package, on the CPU: data, noise,
selection, one loop iteration and ``run_alink`` end to end.

Tolerances, each with its reason:

- data (synthetic trees, manifests, decoded stacks, pair indices, balanced
  pair batches): bit-equal, the same numpy draws in the same order; the
  JAX package's native loader is switched off so both decode with PIL;
- noise: the JAX draws are fed to the port's arithmetic; f32 results
  within 1 f32 ulp of the operands' scale (XLA may contract a multiply and
  an add into one FMA), uint8 salt and pepper bit-equal;
- selection: bit-equal masks and counts (the same stable sort order);
- one loop iteration with ``noise=("plain",)`` (identity) and f32 heads:
  logs, masks and queue bit-equal; the finetune's parameters as in
  ``test_torch_port_train.py`` (changes within 1e-3 of the largest);
- ``run_alink`` with a small VGGFace-ResNet50 featurizer: the featurized
  stacks to a relative max error of 0.02 (the fused-block numerics against
  flax f32), pair counts equal.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu import train as JT
from alink_tpu.active import loop as jloop_mod
from alink_tpu.active.committee import Committee as JCommittee
from alink_tpu.active.selection import select_queries as jselect
from alink_tpu.config import ALinkConfig
from alink_tpu.data import loader as jloader
from alink_tpu.data import native_loader
from alink_tpu.data import pairs as jpairs
from alink_tpu.data.manifest import scan_dfw as jscan_dfw
from alink_tpu.data.synth import make_synthetic_dfw as jmake_dfw
from alink_tpu.drivers import alink as jalink
from alink_tpu.drivers import common as jcommon
from alink_tpu.models import SiameseHead as JSiameseHead
from alink_tpu.models import preprocess as jpreprocess
from alink_tpu.models.resnet import VGGFaceResNet50 as JVGG
from alink_tpu.ops import noise as jnoise
from alink_tpu_torch import train as T
from alink_tpu_torch.active import loop as tloop_mod
from alink_tpu_torch.active.committee import Committee
from alink_tpu_torch.active.selection import select_queries
from alink_tpu_torch.convert import load_flax, state_dict_from_flax
from alink_tpu_torch.data import (PersonStacks, all_pairs_index,
                                  balanced_pair_batches, load_person_stacks,
                                  make_synthetic_dfw, scan_dfw,
                                  split_disguise_data)
from alink_tpu_torch.drivers import alink as talink
from alink_tpu_torch.drivers import common
from alink_tpu_torch.models import SiameseHead, VGGFaceResNet50
from alink_tpu_torch.ops import noise

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def pil_only(monkeypatch):
    """Decode with PIL in the JAX package too (the port has no native
    loader)."""
    monkeypatch.setattr(native_loader, "available", lambda: False)


# -- data --------------------------------------------------------------------

def _tree(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_synthetic_tree_and_manifest_match_jax(tmp_path):
    kw = dict(num_people=4, image_size=16, seed=3)
    jmake_dfw(str(tmp_path / "j"), **kw)
    make_synthetic_dfw(str(tmp_path / "t"), **kw)
    jt, tt = _tree(tmp_path / "j"), _tree(tmp_path / "t")
    assert len(tt) == 4 * 9 and jt == tt
    jp = jscan_dfw(str(tmp_path / "j"), "Training_data")
    tp = scan_dfw(str(tmp_path / "t"), "Training_data")

    def rel(people, root):
        return [(p.name, *(tuple(os.path.relpath(f, root) for f in g)
                           for g in (p.plain, p.disguised, p.impostor)))
                for p in people]

    assert rel(jp, tmp_path / "j") == rel(tp, tmp_path / "t")


def test_stacks_split_and_pairs_match_jax(tmp_path, pil_only):
    make_synthetic_dfw(str(tmp_path), num_people=4, image_size=16, seed=5)
    people = scan_dfw(str(tmp_path), "Training_data")
    for group in ("plain", "disguised", "impostor"):
        paths = [getattr(p, group) for p in people]
        js = jloader.load_person_stacks(paths, (12, 10))
        ts = load_person_stacks(paths, (12, 10))
        np.testing.assert_array_equal(ts.images, js.images)
        np.testing.assert_array_equal(ts.counts, js.counts)
    plain = load_person_stacks([p.plain for p in people], (8, 8))
    dig = load_person_stacks([p.disguised for p in people], (8, 8))
    jst = jpairs.PersonStacks(dig.images, dig.counts)
    for a, b in zip(split_disguise_data(dig, 0.5),
                    jpairs.split_disguise_data(jst, 0.5)):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.counts, b.counts)
    jplain = jpairs.PersonStacks(plain.images, plain.counts)
    for a, b in zip(all_pairs_index(plain, dig),
                    jpairs.all_pairs_index(jplain, jst)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_imp", [True, False])
def test_balanced_pair_batches_match_jax(with_imp):
    rng = np.random.default_rng(6)
    normal = PersonStacks(rng.normal(size=(5, 3, 4)).astype(np.float32),
                          np.array([3, 2, 3, 1, 3], np.int32))
    imp = PersonStacks(rng.normal(size=(5, 2, 4)).astype(np.float32),
                       np.array([2, 2, 1, 2, 0], np.int32))
    jn = jpairs.PersonStacks(normal.images, normal.counts)
    ji = jpairs.PersonStacks(imp.images, imp.counts) if with_imp else None
    tg = balanced_pair_batches(11, normal, imp if with_imp else None, 16)
    jg = jpairs.balanced_pair_batches(11, jn, ji, 16)
    for _ in range(4):
        (tl, tr), ty = next(tg)
        (jl, jr), jy = next(jg)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(ty, jy)


# -- noise -------------------------------------------------------------------

def _images(dtype=np.float32, n=3, size=56):
    x = np.random.default_rng(8).integers(0, 256, (n, size, size, 3))
    return x.astype(dtype)


def _close_f32(got, want, x):
    """Within one f32 ulp of the operands' scale (an FMA contraction)."""
    scale = float(np.abs(want).max()) + float(np.abs(x).max())
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=scale * 2.0 ** -23)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_gaussian_and_speckle_match_jax_draws(dtype):
    x = _images(dtype)
    key = jax.random.PRNGKey(1)
    z = np.asarray(jax.random.normal(key, x.shape, dtype=jnp.float32))
    xt, zt = torch.from_numpy(x), torch.from_numpy(z)
    _close_f32(noise.gaussian_from(xt, zt).numpy(),
               jnoise.gaussian(key, jnp.asarray(x)), x)
    _close_f32(noise.speckle_from(xt, zt).numpy(),
               jnoise.speckle(key, jnp.asarray(x)), x)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_salt_pepper_matches_jax_draws(dtype):
    x = _images(dtype)
    key = jax.random.PRNGKey(2)
    n, h, w, c = x.shape
    counts = noise.salt_pepper_counts(x.shape)

    def draws(k):
        ks, kp = jax.random.split(k)

        def coords(kk, count):
            k1, k2, k3 = jax.random.split(kk, 3)
            return jnp.stack([jax.random.randint(k1, (count,), 0, h - 1),
                              jax.random.randint(k2, (count,), 0, w - 1),
                              jax.random.randint(k3, (count,), 0, c - 1)])

        return coords(ks, counts[0]), coords(kp, counts[1])

    salt, pepper = jax.vmap(draws)(jax.random.split(key, n))
    got = noise.salt_pepper_from(
        torch.from_numpy(x), torch.from_numpy(np.asarray(salt)).permute(
            1, 0, 2), torch.from_numpy(np.asarray(pepper)).permute(1, 0, 2))
    want = np.asarray(jnoise.salt_pepper(key, jnp.asarray(x)))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_poisson_matches_jax_draws(dtype):
    x = _images(dtype)
    x[0] = x[0] // 64 * 64          # 4 levels: a different vals per image
    key = jax.random.PRNGKey(3)
    z = np.stack([np.asarray(jax.random.normal(k, x.shape[1:],
                                               dtype=jnp.float32))
                  for k in jax.random.split(key, x.shape[0])])
    got = noise.poisson_from(torch.from_numpy(x), torch.from_numpy(z))
    want = np.asarray(jnoise.poisson(key, jnp.asarray(x)))
    _close_f32(got.numpy(), want, x)


@pytest.mark.parametrize("size", [56, 50])
def test_perlin_matches_jax_draws(size):
    x = _images(np.float32, n=2, size=size)
    key = jax.random.PRNGKey(4)
    phis = [[], [], []]
    for k in jax.random.split(key, x.shape[0]):
        for j, (kk, ns) in enumerate(zip(jax.random.split(k, 3),
                                         noise.perlin_octaves(size))):
            nc = -(-size // ns)
            phis[j].append(np.asarray(jax.random.uniform(
                kk, (nc + 1, nc + 1), minval=0.0, maxval=2 * jnp.pi)))
    got = noise.perlin_from(torch.from_numpy(x),
                            [torch.from_numpy(np.stack(p)) for p in phis])
    want = np.asarray(jnoise.perlin(key, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_port_noise_draws_have_the_reference_statistics():
    g = torch.Generator().manual_seed(0)
    x = torch.from_numpy(_images(np.float32, n=4, size=64))
    d = noise.gaussian(g, x) - x
    assert abs(float(d.mean()) - 10.0) < 0.05
    assert abs(float(d.std()) - 10 ** 0.5) < 0.05
    r = noise.speckle(g, x + 1.0) / (x + 1.0) - 1.0
    assert abs(float(r.std()) - 1 / 15) < 2e-3 and abs(float(r.mean())) < 2e-3
    sp = noise.salt_pepper(g, x + 2.0)
    changed = sp != x + 2.0
    n_salt, n_pepper = noise.salt_pepper_counts(x.shape)
    assert int(changed.sum()) <= 4 * (n_salt + n_pepper)
    assert int(changed.sum()) > 3 * (n_salt + n_pepper)
    assert set(sp[changed].unique().tolist()) <= {0.0, 1.0}
    assert not changed[:, -1].any() and not changed[:, :, -1].any() \
        and not changed[..., -1].any()
    p = noise.poisson(g, x)
    assert abs(float(p.mean() / x.mean()) - 1.0) < 2e-3
    f = noise.perlin(g, torch.zeros_like(x))
    assert torch.isfinite(f).all() and torch.equal(f[..., 0], f[..., 2])
    assert float(f.abs().max()) > 1.0


# -- selection ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "valid", "valid_f32", "blind"])
def test_select_queries_matches_jax(case):
    rng = np.random.default_rng(9)
    k, n = 3, 37
    student = np.round(rng.uniform(0, 1, (k, n)) * 8) / 8   # many ties
    committee = np.round(rng.uniform(0, 1, n) * 8) / 8
    oracle = rng.integers(0, 2, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    kw = dict(disparity_ratio=0.4, blind_strategy=case == "blind", eps=0.1)
    vkw, tkw = {}, {}
    if case in ("valid", "valid_f32", "blind"):
        vkw = dict(valid=jnp.asarray(valid))
        tkw = dict(valid=torch.from_numpy(valid))
    if case == "valid":
        take = int(valid.sum() * 0.4)
        vkw["k_take"] = jnp.asarray(take, jnp.int32)
        tkw["k_take"] = take
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    want = jselect(jnp.asarray(f32(student)), jnp.asarray(f32(committee)),
                   jnp.asarray(oracle), **kw, **vkw)
    got = select_queries(torch.from_numpy(f32(student)),
                         torch.from_numpy(f32(committee)),
                         torch.from_numpy(oracle), **kw, **tkw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got.selected.sum()) > 0


# -- one loop iteration ------------------------------------------------------

SIZE = 4
DF = SIZE * SIZE * 3


def _flat(images):
    """A featurizer for both packages: pixels / 256, exact in f32 (XLA
    turns a division by 255 into a multiply by its rounded reciprocal)."""
    return images.reshape(images.shape[0], -1) * 0.00390625


def _loops(**cfg_kw):
    cfg = ALinkConfig(noise=("plain",), image_res=(SIZE, SIZE),
                      feature_res=DF, alink_bs=2, batch_send=1000,
                      ft_epochs=2, mixture_ratio=0, disparity_ratio=0.2,
                      eps=0.01, **cfg_kw)
    jh = JSiameseHead(widths=(16, 8), dtype=jnp.float32)
    ex = jnp.zeros((2, DF))
    m2 = JT.create_train_state(jh, jax.random.PRNGKey(0), ex, ex)
    members = [jh.init(jax.random.PRNGKey(i), ex, ex) for i in (1, 2)]
    jl = jloop_mod.ALinkLoop(
        cfg, featurize=_flat, committee=JCommittee.from_param_list(
            jh, members, cfg.noise), m2_state=m2, pool_uint8=True,
        key=jax.random.PRNGKey(4))
    head = lambda p: load_flax(  # noqa: E731
        SiameseHead(DF, (16, 8), dtype=torch.float32),
        jax.tree.map(np.asarray, p))
    tl = tloop_mod.ALinkLoop(
        cfg, featurize=_flat, committee=Committee.from_param_list(
            head(members[0]), [head(p).state_dict() for p in members],
            cfg.noise), m2_state=T.TrainState(head(m2.params)),
        pool_uint8=True)
    return cfg, jl, tl, m2.params


def _slabs(p=4):
    rng = np.random.default_rng(5)
    mk = lambda: PersonStacks(  # noqa: E731
        rng.integers(0, 256, (p, 2, SIZE, SIZE, 3)).astype(np.float32),
        np.full(p, 2, np.int32))
    return mk(), mk()


def test_one_iteration_and_finetune_match_jax(monkeypatch):
    cfg, jl, tl, p0 = _loops()
    jsel, tsel = [], []
    monkeypatch.setattr(jloop_mod, "select_queries",
                        lambda *a, **k: jsel.append(jselect(*a, **k))
                        or jsel[-1])
    monkeypatch.setattr(tloop_mod, "select_queries",
                        lambda *a, **k: tsel.append(select_queries(*a, **k))
                        or tsel[-1])
    plain, dig = _slabs()
    jplain = jpairs.PersonStacks(plain.images, plain.counts)
    jdig = jpairs.PersonStacks(dig.images, dig.counts)

    # Slab 1: queue only (batch_send not reached).
    jlog = jl.run_iteration(jplain.take_people([0, 1]),
                            jdig.take_people([0, 1]))
    tlog = tl.run_iteration(plain.take_people([0, 1]),
                            dig.take_people([0, 1]))
    assert tlog == jlog and not tlog.finetuned and tlog.queried > 0
    n = tlog.pairs
    for field in ("selected", "queried", "pseudo_labels"):
        np.testing.assert_array_equal(
            getattr(tsel[0], field).numpy(),
            np.asarray(getattr(jsel[0], field))[:n])
    assert int(tsel[0].oracle_charges) == int(jsel[0].oracle_charges)
    for b in ("buffer_left", "buffer_right", "buffer_y"):
        np.testing.assert_array_equal(getattr(tl.state, b),
                                      getattr(jl.state, b))

    # Slab 2: the queue reaches batch_send and M2 is finetuned on at most
    # 20 rows, so fit's 80 % train part is one batch of <= 16.
    jl.config = tl.config = dataclasses.replace(cfg, batch_send=1)
    jlog = jl.run_iteration(jplain.take_people([2, 3]),
                            jdig.take_people([2, 3]))
    tlog = tl.run_iteration(plain.take_people([2, 3]),
                            dig.take_people([2, 3]))
    assert tlog == jlog and tlog.finetuned
    assert int(tsel[0].queried.sum()) + 2 * tlog.queried <= 20
    assert tl.state.buffer_size() == jl.state.buffer_size() == 0
    want = state_dict_from_flax(jax.tree.map(np.asarray,
                                             jl.state.m2_state.params))
    start = state_dict_from_flax(jax.tree.map(np.asarray, p0))
    got = tl.state.m2_state.module.state_dict()
    scale = max(float((want[k] - start[k]).abs().max()) for k in want)
    assert scale > 0
    for k in want:
        assert float((got[k] - want[k]).abs().max()) <= 1e-3 * scale


def test_loop_run_stops_and_counts():
    cfg, _, tl, _ = _loops(active_ratio=0.0)
    plain, dig = _slabs(6)
    state = tl.run(plain, dig)
    assert len(state.logs) == 1 and state.logs[0].pairs == 32
    assert state.un_size == 32 and set(state.timings.totals) >= {
        "pairs", "chunk", "select"}


# -- run_alink ---------------------------------------------------------------

def _tiny_featurizers():
    sizes = (1, 1, 1, 1)
    jm = JVGG(stage_sizes=sizes, dtype=jnp.float32)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(1)

    def bn(tree):
        return {k: ({n: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32)
                     if n in ("gamma", "var") else
                     rng.uniform(-0.3, 0.3, np.shape(a)).astype(np.float32)
                     for n, a in v.items()} if "gamma" in v else bn(v))
                if hasattr(v, "items") else np.asarray(v, np.float32)
                for k, v in tree.items()}

    p = {"params": bn(jax.tree.map(np.asarray, dict(p["params"])))}
    jfeat = jax.jit(lambda x: jm.apply(p, jpreprocess.vggface(x, 2)))
    tfeat, _ = common.make_resnet50_featurizer(
        model=load_flax(VGGFaceResNet50(stage_sizes=sizes), p))
    return jfeat, tfeat


def _cfg(tmp_path, side, **kw):
    base = dict(synthetic_people=4, image_res=(32, 32), noise=("plain",),
                dig_epochs=1, undig_epochs=1, ft_epochs=1, alink_bs=2,
                batch_send=4, batch_size=8, train_steps=32,
                num_ensemble_models=2,
                out_model=str(tmp_path / side / "post"),
                ensemble_basepath=str(tmp_path / side / "ens"),
                disguised_basemodel=str(tmp_path / side / "dig"))
    base.update(kw)
    return ALinkConfig(**base)


def test_run_alink_slice_matches_jax(tmp_path, monkeypatch, pil_only):
    jfeat, tfeat = _tiny_featurizers()
    jloops = []

    class Recorded(jloop_mod.ALinkLoop):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            jloops.append(self)

    monkeypatch.setattr(jalink, "ALinkLoop", Recorded)
    jstate = jalink.run_alink(_cfg(tmp_path, "j"), featurize=jfeat)
    tstate = talink.run_alink(_cfg(tmp_path, "t"), featurize=tfeat,
                              device="cpu")
    assert tstate.un_size == jstate.un_size > 0
    assert [lg.pairs for lg in tstate.logs] == [
        lg.pairs for lg in jloops[0].logs]
    head = SiameseHead(2048)
    head.load_state_dict(T.restore(str(tmp_path / "t" / "post")))
    assert os.path.isdir(tmp_path / "j" / "post")

    # The featurized stacks of one tree, through both packages.
    root = make_synthetic_dfw(str(tmp_path / "tree"), num_people=4,
                              image_size=32, seed=42)
    cfg = _cfg(tmp_path, "t", data_dir_prefix=root)
    jd = jcommon.load_dfw(cfg, jfeat)
    td = common.load_dfw(cfg, tfeat)
    for f in ("plain_feats", "dig_feats", "imp_feats"):
        a, b = getattr(td, f), getattr(jd, f)
        np.testing.assert_array_equal(a.counts, b.counts)
        assert a.images.shape == b.images.shape
        m = b.mask()
        err = np.abs(a.images[m] - b.images[m]).max() / np.abs(
            b.images[m]).max()
        assert err < 0.02
    np.testing.assert_array_equal(td.plain_raw.images, jd.plain_raw.images)
    with torch.no_grad():
        p = head(torch.from_numpy(td.plain_feats.images[0]),
                 torch.from_numpy(td.plain_feats.images[1]))
    assert torch.isfinite(p).all() and torch.allclose(p.sum(-1),
                                                      torch.ones(3))


def test_run_alink_with_the_plain_noise_bank(tmp_path):
    _, tfeat = _tiny_featurizers()
    cfg = _cfg(tmp_path, "t", synthetic_people=6, alink_bs=3,
               noise=("gaussian", "saltpepper", "poisson", "speckle"),
               disparity_ratio=0.9)
    state = talink.run_alink(cfg, featurize=tfeat, device="cpu")
    # 3 people x (3 plain x 2 disguised + 2 x 2) per slab: 90 pairs each.
    assert [lg.pairs for lg in state.logs] == [90, 90]
    assert state.un_size == 180
    counts = [lg.active_count for lg in state.logs]
    assert counts == sorted(counts) and counts[-1] <= state.un_size
    assert all(lg.queried <= lg.selected for lg in state.logs)
    assert os.path.isfile(tmp_path / "t" / "post" / "tree.pt")
    assert os.path.isfile(tmp_path / "t" / "ens2" / "tree.pt")


# -- imports -----------------------------------------------------------------

def test_training_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
            "import alink_tpu_torch.drivers.alink, alink_tpu_torch.train, "
            "alink_tpu_torch.active, alink_tpu_torch.data, "
            "alink_tpu_torch.ops.noise, alink_tpu_torch.ops.resblock\n"
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_profile_alink_chunk_breakdown_runs_on_cpu():
    from alink_tpu_torch.tools.profile_alink import chunk_breakdown

    _, tfeat = _tiny_featurizers()
    g = torch.Generator().manual_seed(0)
    heads = [SiameseHead(2048, generator=g) for _ in range(2)]
    committee = Committee.from_param_list(
        heads[0], [h.state_dict() for h in heads], ("gaussian", "speckle"))
    x = torch.rand((4, 32, 32, 3), generator=g) * 255
    ms = chunk_breakdown(tfeat, committee, heads[1], x, x.flip(0), g,
                         n_windows=1, iters=1)
    assert set(ms) == {"committee_features", "noise_bank",
                       "student_features", "student_scores"}
    assert all(v > 0 for v in ms.values())
