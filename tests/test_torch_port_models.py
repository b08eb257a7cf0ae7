"""The port's models against the JAX package's, on the CPU.

JAX parameters come from ``init`` (BN statistics and PReLU slopes then
randomised with numpy so they matter), are turned to numpy and pass
through ``alink_tpu_torch.convert``.  Inputs come from
``np.random.default_rng``.  Tolerances, with both sides in f32:

- ArcFace (tiny: one unit per stage, narrow widths): 1e-4, f32
  convolutions summed in another order;
- P/R/O-Net: 1e-5, as the existing torch mirrors of the JAX towers;
- SiameseHead: 1e-5 in f32; the bf16 default is held to 1e-2 (bf16 hidden
  layers rounded at the same places, different summation order).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu.models import ArcFaceResNet100 as JArcFace
from alink_tpu.models import SiameseHead as JSiameseHead
from alink_tpu.models import mtcnn as jmtcnn
from alink_tpu.models import preprocess as jpreprocess
from alink_tpu_torch.convert import load_flax, state_dict_from_flax
from alink_tpu_torch.models import (ArcFaceResNet34, ArcFaceResNet50,
                                    ArcFaceResNet100, ONet, PNet, RNet,
                                    SiameseHead, preprocess)

REPO = Path(__file__).resolve().parent.parent


def _randomise(tree, rng):
    """numpy copy of a flax tree with non-trivial BN stats and PReLUs."""
    def walk(node, name=""):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if name in ("mean", "beta"):
            return rng.normal(0, 0.3, a.shape).astype(np.float32)
        if name in ("var",):
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name in ("gamma", "fc1_gamma"):
            return rng.normal(1.0, 0.2, a.shape).astype(np.float32)
        if name in ("alpha",):
            return rng.uniform(0.05, 0.5, a.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a
    return walk(tree)


@pytest.mark.parametrize("size", [112, 64])
def test_arcface_tiny_matches_jax(size):
    widths = (16, 16, 32, 32)
    jm = JArcFace(stage_sizes=(1, 1, 1, 1), stage_widths=widths,
                  embedding_dim=24, dtype=jnp.float32)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    p = _randomise(jax.tree.map(np.asarray, p), np.random.default_rng(1))
    m = load_flax(ArcFaceResNet100(stage_sizes=(1, 1, 1, 1),
                                   stage_widths=widths, embedding_dim=24,
                                   dtype=torch.float32,
                                   input_size=(size, size)), p)
    x = np.random.default_rng(2).uniform(
        0, 255, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_arcface_identity_shortcuts_and_raw_output_match_jax():
    """Two units per stage (stride-1 identity shortcuts) and
    ``normalize=False`` (the raw fc1 output)."""
    widths = (16, 16, 24, 24)
    jm = JArcFace(stage_sizes=(2, 2, 1, 1), stage_widths=widths,
                  embedding_dim=8, dtype=jnp.float32, normalize=False)
    p = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))
    p = _randomise(jax.tree.map(np.asarray, p), np.random.default_rng(4))
    m = load_flax(ArcFaceResNet100(stage_sizes=(2, 2, 1, 1),
                                   stage_widths=widths, embedding_dim=8,
                                   dtype=torch.float32, normalize=False,
                                   input_size=(32, 32)), p)
    x = np.random.default_rng(5).uniform(0, 255, (2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_arcface_zoo_depths_and_params():
    assert ArcFaceResNet100(device="meta").stage_sizes == (3, 13, 30, 3)
    assert ArcFaceResNet50(device="meta").stage_sizes == (3, 4, 14, 3)
    r34 = ArcFaceResNet34(device="meta")
    assert r34.stage_sizes == (3, 4, 6, 3) and len(r34.units) == 16
    r100 = ArcFaceResNet100(device="meta")
    assert r100.dense[0].in_features == 512 * 7 * 7
    assert r100.embedding_dim == 512 and r100.normalize


def test_converter_covers_the_full_r100_tree():
    """Every tensor of the full-width JAX r100 tree has a port counterpart
    of the same shape (shapes only: no weights are drawn)."""
    shapes = jax.eval_shape(JArcFace().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 112, 112, 3)))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_flax(tree)
    own = ArcFaceResNet100(device="meta").state_dict()
    assert set(sd) == set(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in own)


@pytest.mark.parametrize("name,size,cin", [("PNet", 12, 3), ("PNet", 37, 3),
                                           ("RNet", 24, 3), ("ONet", 48, 3)])
def test_mtcnn_towers_match_jax(name, size, cin):
    jm = getattr(jmtcnn, name)(dtype=jnp.float32)
    p = jm.init(jax.random.PRNGKey(size), jnp.zeros((1, size, size, cin)))
    p = _randomise(jax.tree.map(np.asarray, p), np.random.default_rng(size))
    m = load_flax({"PNet": PNet, "RNet": RNet, "ONet": ONet}[name](
        torch.float32), p)
    x = np.random.default_rng(size + 1).uniform(
        -1, 1, (3, size, size, cin)).astype(np.float32)
    want = jm.apply(p, jnp.asarray(x))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)


def test_pnet_bf16_tower_runs_in_bf16():
    m = PNet(generator=torch.Generator().manual_seed(0))
    prob, reg = m(torch.zeros(1, 20, 20, 3))
    assert prob.dtype == reg.dtype == torch.float32
    assert prob.shape == (1, 5, 5, 2)
    np.testing.assert_allclose(prob.sum(-1).detach().numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("kind", ["softmax", "sigmoid"])
@pytest.mark.parametrize("f32", [True, False])
def test_siamese_head_matches_jax(kind, f32):
    jdt, tdt = (jnp.float32, torch.float32) if f32 else (jnp.bfloat16,
                                                         torch.bfloat16)
    jm = JSiameseHead(head=kind, dtype=jdt)
    p = jm.init(jax.random.PRNGKey(7), jnp.zeros((1, 40)), jnp.zeros((1, 40)))
    p = _randomise(jax.tree.map(np.asarray, p), np.random.default_rng(8))
    m = load_flax(SiameseHead(40, head=kind, dtype=tdt), p)
    rng = np.random.default_rng(9)
    left = rng.normal(size=(6, 40)).astype(np.float32)
    right = rng.normal(size=(6, 40)).astype(np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(left), torch.from_numpy(right)).numpy()
        logits = m.logits(torch.from_numpy(left), torch.from_numpy(right))
    want = np.asarray(jm.apply(p, jnp.asarray(left), jnp.asarray(right)))
    np.testing.assert_allclose(got, want, atol=1e-5 if f32 else 1e-2)
    if kind == "sigmoid":
        assert torch.all(logits[:, 0] == 0)


def test_preprocess_matches_jax():
    x = np.random.default_rng(10).integers(0, 256, (2, 5, 5, 3)).astype(
        np.uint8)
    got = preprocess.mtcnn(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jpreprocess.mtcnn(jnp.asarray(x, jnp.float32))),
        atol=1e-7)
    t = torch.ones(2)
    assert preprocess.identity(t) is t


def test_converter_rejects_unknown_and_misshapen():
    m = SiameseHead(8, (4, 2), dtype=torch.float32)
    good = {"params": {
        "hidden_0": {"kernel": np.zeros((8, 4)), "bias": np.zeros(4)},
        "hidden_1": {"kernel": np.zeros((4, 2)), "bias": np.zeros(2)},
        "out": {"kernel": np.ones((2, 2)), "bias": np.zeros(2)}}}
    load_flax(m, good)
    assert torch.all(m.out.weight == 1)
    bad = {"params": dict(good["params"], hidden_0={
        "kernel": np.zeros((9, 4)), "bias": np.zeros(4)})}
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_flax(m, bad)
    with pytest.raises(KeyError):
        load_flax(m, {"params": dict(good["params"], Foo_0={"kernel": 0})})


def test_package_imports_without_jax():
    """The port must import with jax and flax unavailable."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
            "import alink_tpu_torch, alink_tpu_torch.serving, "
            "alink_tpu_torch.convert, alink_tpu_torch.detect, "
            "alink_tpu_torch.models, alink_tpu_torch.ops.pairwise, "
            "alink_tpu_torch.ops.image, alink_tpu_torch._build\n"
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
