"""The port's classical active-learning drivers, ``visualize_noise``, the
Multi-PIE staging CLI, ``build_committee`` and the CUDA default of the new
entry points, against the JAX package on the CPU.

- ``run_existing_al`` (DFW, a ``SiameseHead`` on teacher features) and
  ``run_existing_al_mtp`` (SmallRes on Multi-PIE pixels, dropout on):
  both sides start from the same pretrained student (the JAX run's
  checkpoint, converted), draw the same pool batches (numpy, the same
  seed), and the port's refits replay the JAX learner's permutations and,
  for SmallRes, its dropout masks.  The queried indices of every round
  are equal, and so is the number of rounds (the DFW driver's budget
  break).  Students in f32 on both sides, so that an f32 difference of
  about 1e-6 is all that separates two candidates' scores;
- ``visualize_noise``: the same PNG as the JAX driver's for the same
  perlin draws, within 1 LSB (f32 noise arithmetic in another order can
  round a pixel the other way at .5);
- ``mtp_staging``: the same trees and list files, byte for byte;
- ``build_committee``: the JAX committee's structure, and its members'
  weights carried over predict within 2e-2 (bf16 heads);
- the new entry points raise without CUDA unless asked for the CPU.
"""

import filecmp
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from alink_tpu import train as JT
from alink_tpu.config import ExistingALConfig as JExistingALConfig
from alink_tpu.config import MTPConfig as JMTPConfig
from alink_tpu_torch import config as tconfig
from alink_tpu_torch import train as T
from alink_tpu_torch.convert import state_dict_from_flax
from alink_tpu_torch.data import synth

from test_torch_port_a2 import pil_only  # noqa: F401

SIZE = 12


def _flat(images):
    """The toy teacher for both packages: pixels / 256, exact in f32."""
    return images.reshape(images.shape[0], -1) * 0.00390625


class _Learners:
    """Record each learner's queried indices per round, and replay the
    JAX learner's refit keys into the port's ``fit``."""

    def __init__(self):
        self.queries = {"j": [], "t": []}
        self.fit_keys = []

    def subclass(self, base, side):
        rec = self.queries[side]

        class Recorded(base):
            def query(self, *a, **k):
                idx = super().query(*a, **k)
                rec.append(np.asarray(idx).copy())
                return idx

        return Recorded

    def jax_fit(self, real_fit):
        def fit(state, left, right, labels, *, key, **kw):
            self.fit_keys.append((key, None))
            return real_fit(state, left, right, labels, key=key, **kw)
        return fit


def _carry(tmp_path, name):
    T.save(str(tmp_path / "t" / name), state_dict_from_flax(
        jax.tree.map(np.asarray, JT.restore(str(tmp_path / "j" / name)))))


@pytest.mark.parametrize("strategy,active_ratio,rounds", [
    ("uncertainty_sampling", 1.0, 4), ("margin_sampling", 0.5, 3),
    ("entropy_sampling", 1.0, 4)])
def test_run_existing_al_matches_jax(tmp_path, monkeypatch, pil_only,
                                     strategy, active_ratio, rounds):
    from alink_tpu import train as jtrain
    from alink_tpu.drivers import common as jcommon
    from alink_tpu.drivers import existing_al as jdriver
    from alink_tpu.models import SiameseHead as JSiameseHead
    from alink_tpu_torch.drivers import common as tcommon
    from alink_tpu_torch.drivers import existing_al as tdriver
    from alink_tpu_torch.models import SiameseHead
    from test_torch_port_mtp import _MtpSchedule

    root = synth.make_synthetic_dfw(str(tmp_path / "dfw"), num_people=4,
                                    plain_per_person=2,
                                    disguised_per_person=2,
                                    impostors_per_person=2, image_size=SIZE)
    rec = _Learners()
    sched = _MtpSchedule(SIZE)
    monkeypatch.setattr(jcommon, "SiameseHead", functools.partial(
        JSiameseHead, dtype=jnp.float32))
    monkeypatch.setattr(tcommon, "SiameseHead", functools.partial(
        SiameseHead, dtype=torch.float32))
    monkeypatch.setattr(jdriver, "ActiveLearner",
                        rec.subclass(jdriver.ActiveLearner, "j"))
    monkeypatch.setattr(tdriver, "ActiveLearner",
                        rec.subclass(tdriver.ActiveLearner, "t"))
    monkeypatch.setattr(jtrain, "fit", rec.jax_fit(jtrain.fit))
    monkeypatch.setattr(T, "fit", sched.fit(T.fit, monkeypatch))

    def kw(side):
        return dict(data_dir_prefix=root, image_res=(SIZE, SIZE),
                    feature_res=SIZE * SIZE * 3, epochs=2, batch_size=16,
                    query_strategy=strategy, active_ratio=active_ratio,
                    model_path=str(tmp_path / side / "active"),
                    out_model=str(tmp_path / side / "post"))

    jdriver.run_existing_al(JExistingALConfig(**kw("j")), featurize=_flat,
                            n_rounds=4, n_steps=32)
    _carry(tmp_path, "active")
    rec.queries["j"].clear()
    rec.fit_keys.clear()
    jl = jdriver.run_existing_al(JExistingALConfig(**kw("j")),
                                 featurize=_flat, n_rounds=4, n_steps=32)
    sched.base.records[:] = rec.fit_keys
    tl = tdriver.run_existing_al(tconfig.ExistingALConfig(**kw("t")),
                                 featurize=_flat, n_rounds=4, n_steps=32,
                                 device="cpu")
    assert not sched.base.records
    assert len(rec.queries["t"]) == len(rec.queries["j"]) == rounds
    for got, want in zip(rec.queries["t"], rec.queries["j"]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tl._y, np.asarray(jl._y))
    assert os.path.isdir(tmp_path / "t" / "post")


@pytest.mark.parametrize("strategy", ["uncertainty_sampling",
                                      "margin_sampling"])
def test_run_existing_al_mtp_matches_jax(tmp_path, monkeypatch, pil_only,
                                         strategy):
    from alink_tpu import train as jtrain
    from alink_tpu.drivers import alink_mtp as jmtp
    from alink_tpu.drivers import existing_al_mtp as jdriver
    from alink_tpu.models import SmallRes as JSmallRes
    from alink_tpu_torch.drivers import alink_mtp as tmtp
    from alink_tpu_torch.drivers import existing_al_mtp as tdriver
    from alink_tpu_torch.models import SmallRes
    from test_torch_port_mtp import _MtpSchedule

    root = synth.make_synthetic_mtp(str(tmp_path / "mtp"), num_subjects=5,
                                    image_size=16)
    rec = _Learners()
    sched = _MtpSchedule(SIZE)
    monkeypatch.setattr(jmtp, "SmallRes", functools.partial(
        JSmallRes, dtype=jnp.float32))

    def student(**kw):
        m = SmallRes(dtype=torch.float32, **kw)
        m.tower.draw = sched.draw
        return m

    monkeypatch.setattr(tmtp, "SmallRes", student)
    monkeypatch.setattr(jdriver, "ActiveLearner",
                        rec.subclass(jdriver.ActiveLearner, "j"))
    monkeypatch.setattr(tdriver, "ActiveLearner",
                        rec.subclass(tdriver.ActiveLearner, "t"))
    monkeypatch.setattr(jtrain, "fit", rec.jax_fit(jtrain.fit))
    monkeypatch.setattr(T, "fit", sched.fit(T.fit, monkeypatch))

    def kw(side):
        return dict(data_dir_prefix=root, low_res=SIZE, feature_res=32,
                    lowres_epochs=1, ft_epochs=2, batch_size=20,
                    lowres_basemodel=str(tmp_path / side / "low"),
                    out_model=str(tmp_path / side / "post"))

    jdriver.run_existing_al_mtp(JMTPConfig(**kw("j")), n_rounds=3,
                                n_steps=40, query_strategy=strategy)
    _carry(tmp_path, "low")
    rec.queries["j"].clear()
    rec.fit_keys.clear()
    jl = jdriver.run_existing_al_mtp(JMTPConfig(**kw("j")), n_rounds=3,
                                     n_steps=40, query_strategy=strategy)
    sched.base.records[:] = rec.fit_keys
    tl = tdriver.run_existing_al_mtp(tconfig.MTPConfig(**kw("t")),
                                     n_rounds=3, n_steps=40,
                                     query_strategy=strategy, device="cpu")
    assert sched.done()
    assert len(rec.queries["t"]) == len(rec.queries["j"]) == 3
    for got, want in zip(rec.queries["t"], rec.queries["j"]):
        assert len(got) == 2
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tl._y, np.asarray(jl._y))
    assert tl._left.shape == (6, SIZE, SIZE, 3)


def test_existing_al_mtp_pretrains_with_dropout(tmp_path):
    """Without a checkpoint the baseline pretrains SmallRes (dropout masks
    from a generator on the device) and saves it; a second run loads it."""
    from alink_tpu_torch.drivers import existing_al_mtp as tdriver

    root = synth.make_synthetic_mtp(str(tmp_path / "mtp"), num_subjects=4,
                                    image_size=16)
    cfg = tconfig.MTPConfig(data_dir_prefix=root, low_res=SIZE,
                            feature_res=16, lowres_epochs=1, ft_epochs=1,
                            batch_size=8,
                            lowres_basemodel=str(tmp_path / "low"),
                            out_model=str(tmp_path / "post"))
    a = tdriver.run_existing_al_mtp(cfg, n_rounds=1, n_steps=16,
                                    device="cpu")
    saved = T.restore(str(tmp_path / "low"))
    b = tdriver.run_existing_al_mtp(cfg, n_rounds=0, n_steps=16,
                                    device="cpu")
    for k, v in b.state.module.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert a._y is not None and b._y is None


# -- visualize_noise ---------------------------------------------------------

def test_visualize_noise_matches_jax(tmp_path, monkeypatch):
    from alink_tpu.drivers import visualize_noise as jviz
    from alink_tpu_torch.drivers import visualize_noise as tviz
    from alink_tpu_torch.ops import noise
    from test_torch_port_arc import _port_noise

    src = str(tmp_path / "in.png")
    Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (56, 56, 3), dtype=np.uint8)).save(src)
    jviz.main(["--image", src, "--noise", "perlin", "--seed", "3",
               "--out", str(tmp_path / "j.png")])
    calls = []

    def channel(name):
        def fn(g, x):
            calls.append((name, g.initial_seed(), g.device.type))
            return _port_noise(name, jax.random.PRNGKey(3), 1, x)
        return fn

    monkeypatch.setattr(noise, "get_relevant_noise", channel)
    tviz.main(["--image", src, "--noise", "perlin", "--seed", "3",
               "--out", str(tmp_path / "t.png"), "--device", "cpu"])
    assert calls == [("perlin", 3, "cpu")]
    want, got = (np.asarray(Image.open(tmp_path / f"{s}.png")).astype(int)
                 for s in "jt")
    assert want.shape == got.shape == (56, 56, 3)
    assert np.abs(got - want).max() <= 1
    assert (got != np.asarray(Image.open(src))).any()


@pytest.mark.parametrize("name", ["gaussian", "saltpepper", "poisson",
                                  "speckle", "perlin", "plain"])
def test_visualize_noise_renders_every_channel(tmp_path, name):
    from alink_tpu_torch.drivers import visualize_noise as tviz

    src = str(tmp_path / "in.png")
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (50, 50, 3), dtype=np.uint8)).save(src)
    out = str(tmp_path / "out.png")
    tviz.main(["--image", src, "--noise", name, "--out", out,
               "--device", "cpu"])
    img = np.asarray(Image.open(out))
    assert img.shape == (50, 50, 3) and img.dtype == np.uint8
    if name == "plain":
        np.testing.assert_array_equal(img, np.asarray(Image.open(src)))


# -- mtp_staging -------------------------------------------------------------

def _flat_tree(root, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    for person in range(1, 7):
        for k in range(int(rng.integers(5, 12))):
            with open(os.path.join(root, f"{person:03d}_{k:02d}_x.png"),
                      "wb") as f:
                f.write(rng.bytes(16))
    return root


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not (cmp.left_only or cmp.right_only or cmp.funny_files), (
        cmp.left_only, cmp.right_only)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files,
                                           shallow=False)
    assert not mismatch and not errors
    for d in cmp.common_dirs:
        _same_tree(os.path.join(a, d), os.path.join(b, d))


@pytest.mark.parametrize("cmd", ["group", "bisect", "dirs", "ready"])
def test_mtp_staging_matches_jax(tmp_path, cmd):
    from alink_tpu.tools import mtp_staging as jstage
    from alink_tpu_torch.tools import mtp_staging as tstage

    assert tstage.SPLIT_RATIOS == jstage.SPLIT_RATIOS
    assert tstage.LIST_NAMES == jstage.LIST_NAMES
    src = _flat_tree(str(tmp_path / "src"))
    for side, mod in (("j", jstage), ("t", tstage)):
        work = tmp_path / side
        flat = shutil.copytree(src, work / "flat")
        if cmd == "group":
            mod.main(["group", str(flat), str(work / "out")])
        elif cmd == "ready":
            mod.main(["ready", str(flat), str(work / "out")])
        else:
            grouped = work / "grouped"
            mod.group_by_person(str(flat), str(grouped), move=False)
            mod.main(["bisect", str(grouped), str(work / "lists")])
            if cmd == "dirs":
                pool = shutil.copytree(src, work / "pool")
                mod.main(["dirs", str(work / "out"), str(pool),
                          str(work / "lists" / "highResData.txt")])
    _same_tree(str(tmp_path / "j"), str(tmp_path / "t"))
    if cmd == "ready":
        out = tmp_path / "t" / "out"
        assert sorted(os.listdir(out)) == ["fileLists", "highres", "lowres"]
        assert sorted(os.listdir(out / "highres")) == ["train", "val"]


# -- build_committee ---------------------------------------------------------

def test_build_committee_matches_jax():
    from alink_tpu.drivers import common as jcommon
    from alink_tpu_torch.active.committee import Committee
    from alink_tpu_torch.drivers import common as tcommon

    names = ("gaussian", "adversarial")
    jc, _ = jcommon.build_committee(jax.random.PRNGKey(0), 24, names, 3)
    tc, head = tcommon.build_committee(torch.Generator().manual_seed(0), 24,
                                       names, 3, device="cpu")
    assert tc.noise_names == jc.noise_names == names
    assert tc.num_members == jc.num_members == 3
    members = [state_dict_from_flax(jax.tree.map(
        np.asarray, jax.tree.map(lambda v: v[i], jc.params)))
        for i in range(3)]
    assert {k: tuple(v.shape) for k, v in tc.params.items()} == {
        k: (3,) + tuple(v.shape) for k, v in members[0].items()}
    assert not torch.equal(tc.params["out.weight"][0],
                           tc.params["out.weight"][1])
    rng = np.random.default_rng(1)
    left, right = (rng.random((5, 24)).astype(np.float32) for _ in "lr")
    carried = Committee.from_param_list(head, members, names)
    np.testing.assert_allclose(
        carried.predict(torch.from_numpy(left), torch.from_numpy(right)),
        np.asarray(jc.predict(jnp.asarray(left), jnp.asarray(right))),
        atol=2e-2)


# -- the CUDA default ----------------------------------------------------------

def test_new_entry_points_run_on_cuda_unless_asked_for_the_cpu(
        monkeypatch, tmp_path):
    from alink_tpu_torch.drivers import alink_mtp, existing_al
    from alink_tpu_torch.drivers import existing_al_mtp, visualize_noise

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: alink_mtp.run_alink_mtp(tconfig.MTPConfig()),
            lambda: alink_mtp.main([]),
            lambda: existing_al.run_existing_al(tconfig.ExistingALConfig()),
            lambda: existing_al_mtp.run_existing_al_mtp(tconfig.MTPConfig()),
            lambda: visualize_noise.main(["--image", "x.png"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
