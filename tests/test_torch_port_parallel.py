"""The port's parallel layer in one process, against the JAX package on the
CPU, and the six API repairs that came with it.

The JAX side runs on conftest's virtual 8-device CPU mesh; the port's
process is a world of one rank (``create_mesh`` makes it a group of its
own from a ``HashStore``).  Multi-rank worlds are in
``test_torch_port_parallel_mp.py``.  Tolerances, each with its reason:

- mesh shapes, padding, ``process_shard``, ``boundary_shape``,
  ``_default_splits``, ``tp_param_specs``, ``_pad_unit_params`` and every
  error: equal, case by case (the same integer arithmetic);
- world-1 sharded paths against the unsharded port: bit-equal (one block
  is the whole batch, and a one-rank axis has no collective);
- against JAX's sharded functions: the featurizer and the committee 1e-5
  (f32 sums in another order; ``tests/test_parallel.py``'s bound), the
  score grid 2e-2 (bf16 operands; ``tests/test_pairwise.py``);
- ``poisson(assume_uint8=False)`` bit-equal on JAX's own draws;
  ``exact=True`` on statistics (the draws cannot match), as
  ``tests/test_noise.py`` holds JAX's.
"""

import copy
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from alink_tpu import parallel as jpar
from alink_tpu import train as JT
from alink_tpu.active.committee import Committee as JCommittee
from alink_tpu.data import loader as jloader
from alink_tpu.data import native_loader
from alink_tpu.data import prefetch as jprefetch
from alink_tpu.data.synth import make_synthetic_dfw as jmake_dfw
from alink_tpu.data.manifest import scan_dfw as jscan_dfw
from alink_tpu.models import SiameseHead as JSiameseHead
from alink_tpu.ops import noise as jnoise
from alink_tpu.ops.pairwise import score_matrix_sharded as jgrid_sharded
from alink_tpu.parallel import distributed as jdist
from alink_tpu.parallel import pp as jpp
from alink_tpu.parallel import tp as jtp
from alink_tpu.serving import Verifier as JVerifier
from alink_tpu.utils.profiling import Timings as JTimings
from alink_tpu_torch import parallel as P
from alink_tpu_torch import train as T
from alink_tpu_torch.active.committee import Committee
from alink_tpu_torch.convert import load_flax, state_dict_from_flax
from alink_tpu_torch.data import load_person_stacks
from alink_tpu_torch.data import native_loader as tnative_loader
from alink_tpu_torch.data import prefetch as tprefetch
from alink_tpu_torch.detect import (CascadeConfig, FaceModel,
                                    init_cascade_params)
from alink_tpu_torch.drivers import alink as talink
from alink_tpu_torch.models import ArcFaceResNet100, SiameseHead
from alink_tpu_torch.ops import noise
from alink_tpu_torch.ops.pairwise import score_matrix, score_matrix_sharded
from alink_tpu_torch.parallel import distributed as tdist
from alink_tpu_torch.parallel import mesh as tmesh
from alink_tpu_torch.parallel import pp as tpp
from alink_tpu_torch.parallel import tp as ttp
from alink_tpu_torch.serving import Verifier
from alink_tpu_torch.tools import generate_matrix
from alink_tpu_torch.utils.profiling import Timings

FULL_DEPTH = (3, 13, 30, 3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def mesh1():
    """The port's world-1 mesh on the CPU."""
    return P.create_mesh(device_type="cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jpar.create_mesh((4, 2))


def _jax_head(seed=0, d=16, widths=(8, 4)):
    head = JSiameseHead(widths=widths, dtype=jnp.float32)
    params = head.init(jax.random.PRNGKey(seed), jnp.zeros((1, d)),
                       jnp.zeros((1, d)))
    port = load_flax(SiameseHead(d, widths, dtype=torch.float32),
                     _np(params))
    return head, params, port


# -- the six repairs ----------------------------------------------------------

def _jax_z(key, x):
    return np.stack([np.asarray(jax.random.normal(k, x.shape[1:],
                                                  dtype=jnp.float32))
                     for k in jax.random.split(key, x.shape[0])])


@pytest.mark.parametrize("integer", [False, True])
def test_poisson_sort_count_matches_jax_draws(integer):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 255, (3, 12, 12, 3)).astype(np.float32)
    if integer:
        x = np.round(x)
    x[0] = np.round(x[0] / 64) * 63 + (0 if integer else 0.5)  # 5 values
    key = jax.random.PRNGKey(3)
    got = noise.poisson_from(torch.from_numpy(x),
                             torch.from_numpy(_jax_z(key, x)),
                             assume_uint8=False).numpy()
    want = np.asarray(jnoise.poisson(key, jnp.asarray(x),
                                     assume_uint8=False))
    np.testing.assert_array_equal(got, want)
    # Not integer-valued: the sort count sees more levels than 256 rounds.
    counted = noise.poisson_from(torch.from_numpy(x),
                                 torch.from_numpy(_jax_z(key, x))).numpy()
    assert integer == np.array_equal(counted, got)


def test_poisson_exact_has_the_approximation_statistics():
    """As ``tests/test_noise.py`` holds JAX's: the Gaussian limit against
    the exact draw on one integer image, and the port's exact draw against
    JAX's (mean, std)."""
    rng = np.random.default_rng(1)
    img = np.round(rng.uniform(0, 1, (1, 16, 16, 3)) * 200.0).astype(
        np.float32)
    batch = torch.from_numpy(np.tile(img, (64, 1, 1, 1)))
    g = torch.Generator().manual_seed(0)
    approx = noise.poisson(g, batch).numpy()
    exact = noise.poisson(g, batch, exact=True).numpy()
    np.testing.assert_allclose(approx.mean(), exact.mean(), rtol=0.02)
    np.testing.assert_allclose(approx.std(), exact.std(), rtol=0.05)
    jexact = np.asarray(jnoise.poisson(jax.random.PRNGKey(2),
                                       jnp.asarray(batch.numpy()),
                                       exact=True))
    np.testing.assert_allclose(exact.mean(), jexact.mean(), rtol=0.02)
    np.testing.assert_allclose(exact.std(), jexact.std(), rtol=0.05)
    assert exact.min() >= 0 and exact.dtype == np.float32
    # Integer images: the sort count equals the 256-level count.
    a = noise.poisson(torch.Generator().manual_seed(3), batch).numpy()
    b = noise.poisson(torch.Generator().manual_seed(3), batch,
                      assume_uint8=False).numpy()
    np.testing.assert_array_equal(a, b)


def test_committee_member_params_round_trip_like_jax():
    jhead, p0, h0 = _jax_head(0)
    _, p1, h1 = _jax_head(1)
    jcom = JCommittee.from_param_list(jhead, [p0, p1])
    com = Committee.from_param_list(h0, [h0.state_dict(), h1.state_dict()])
    back = com.member_params(1)
    want = state_dict_from_flax(_np(jcom.member_params(1)))
    assert back.keys() == want.keys() == h1.state_dict().keys()
    for k in back:
        torch.testing.assert_close(back[k], want[k], rtol=0, atol=0)
        torch.testing.assert_close(back[k], h1.state_dict()[k], rtol=0,
                                   atol=0)


def test_load_person_stacks_pad_to_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(tnative_loader, "available", lambda: False)
    jmake_dfw(str(tmp_path), num_people=3, image_size=16, seed=5)
    people = jscan_dfw(str(tmp_path), "Training_data")
    paths = [p.plain for p in people]
    most = max(len(g) for g in paths)
    for pad in (None, most + 2):
        js = jloader.load_person_stacks(paths, (12, 10), pad_to=pad)
        ts = load_person_stacks(paths, (12, 10), pad_to=pad)
        assert ts.images.shape == js.images.shape
        assert ts.max_stack == (most if pad is None else pad)
        np.testing.assert_array_equal(ts.images, js.images)
        np.testing.assert_array_equal(ts.counts, js.counts)


def test_test_accuracy_takes_and_ignores_batch_size():
    jhead, params, head = _jax_head(2, d=8)
    jstate = JT.create_train_state(jhead, jax.random.PRNGKey(0),
                                   jnp.zeros((2, 8)), jnp.zeros((2, 8)))
    jstate = jstate.replace(params=params)
    state = T.TrainState(head)
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(12, 8)).astype(np.float32)
    labels = rng.integers(0, 3, 12).astype(np.int32)
    want = JT.test_accuracy(jstate, jnp.asarray(feats), jnp.asarray(labels),
                            batch_size=5)
    assert T.test_accuracy(state, feats, labels, batch_size=5) == \
        T.test_accuracy(state, feats, labels) == pytest.approx(want)


def test_timings_timed_charges_the_call_like_jax():
    jt, t = JTimings(), Timings()
    assert float(jt.timed("mul", lambda: jnp.ones(4) * 2)[0]) == 2.0
    out = t.timed("mul", lambda x, k=1: x * k, torch.ones(4), k=2)
    assert float(out[0]) == 2.0
    assert t.counts["mul"] == jt.counts["mul"] == 1
    assert t.totals["mul"] > 0 and "mul" in t.report()


def test_smallres_score_fn_takes_the_jax_positions():
    """``smallres_score_fn(state, low_res, probe_chunk)`` as the JAX driver
    is called: its parameters in JAX's positions, the same grid as the
    keyword call, and ``batch`` keyword-only."""
    from alink_tpu.drivers import alink_mtp as jmtp
    from alink_tpu_torch.drivers import alink_mtp as tmtp
    from alink_tpu_torch.models import SmallRes

    jparams = list(inspect.signature(jmtp.smallres_score_fn).parameters)
    tparams = inspect.signature(tmtp.smallres_score_fn).parameters
    assert list(tparams)[:3] == jparams == ["state", "low_res",
                                             "probe_chunk"]
    assert tparams["batch"].kind is inspect.Parameter.KEYWORD_ONLY
    hw = 16
    tstate = T.TrainState(SmallRes(32, input_size=(hw, hw),
                                   generator=torch.Generator().manual_seed(2)))
    rng = np.random.default_rng(4)
    probes = rng.integers(0, 256, (9, hw, hw, 3)).astype(np.float32)
    gallery = rng.integers(0, 256, (5, hw, hw, 3)).astype(np.float32)
    plain = tmtp.smallres_score_fn(tstate)(probes, gallery)
    assert plain.shape == (9, 5)
    for fn in (tmtp.smallres_score_fn(tstate, hw),
               tmtp.smallres_score_fn(tstate, hw, 4),
               tmtp.smallres_score_fn(tstate, hw, probe_chunk=4, batch=3)):
        torch.testing.assert_close(fn(probes, gallery), plain, rtol=0,
                                   atol=0)
    with pytest.raises(TypeError):
        tmtp.smallres_score_fn(tstate, hw, 4, 3)


# -- the mesh -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(-1,), (8,), (4, 2), (-1, 2), (2, -1),
                                   (1, 8), (-1, 8), (3, 2), (-1, 3),
                                   (2, 2, 2), (16,)])
def test_mesh_shape_inference_matches_jax(shape):
    try:
        want = jpar.create_mesh(shape).shape
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tmesh.infer_shape(shape, 8)
        return
    assert tmesh.infer_shape(shape, 8) == (want["data"], want["model"])


def test_create_mesh_in_one_process(mesh1):
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert mesh1.mesh_dim_names == (P.DATA_AXIS, P.MODEL_AXIS)
    assert tuple(mesh1.shape) == (1, 1)
    assert tmesh.coordinate(mesh1) == (0, 0)
    assert tuple(P.create_mesh((1, -1), devices=[0],
                               device_type="cpu").shape) == (1, 1)
    with pytest.raises(ValueError, match="does not cover"):
        P.create_mesh((2,), device_type="cpu")
    with pytest.raises(ValueError, match="1 or 2 dims"):
        P.create_mesh((1, 1, 1), device_type="cpu")
    with pytest.raises(RuntimeError, match="NCCL"):
        tmesh.backend_for("cuda")   # this PyTorch has no NCCL: no fallback


@pytest.mark.parametrize("n,multiple", [(5, 4), (8, 4), (0, 3), (7, 1)])
def test_pad_axis0_matches_jax(n, multiple):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3) + 1
    want = np.asarray(jpar.mesh.pad_axis0(jnp.asarray(x), multiple))
    np.testing.assert_array_equal(
        P.mesh.pad_axis0(torch.from_numpy(x), multiple).numpy(), want)


def test_shard_batch_lengths_match_jax(mesh1, jmesh):
    tree = {"x": np.arange(15, dtype=np.float32).reshape(5, 3),
            "y": (np.ones((3, 2, 2), np.float32),)}
    jsh, jlen = jpar.shard_batch(jmesh, tree)
    sh, lengths = P.shard_batch(mesh1, tree)
    assert lengths == jax.tree.map(int, jlen)
    assert jsh["x"].shape == (8, 3)           # padded to the data axis 4
    assert tuple(sh["x"].shape) == (5, 3)     # data axis 1: no padding
    np.testing.assert_array_equal(sh["x"].full_tensor().numpy(), tree["x"])
    np.testing.assert_array_equal(sh["y"][0].to_local().numpy(),
                                  tree["y"][0])
    assert P.batch_sharding(mesh1, 3).placements == sh["x"].placements
    assert all(p.is_replicate()
               for p in P.replicated_sharding(mesh1).placements)


# -- the multi-host layer -----------------------------------------------------

def test_initialize_is_a_noop_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    before = dist.is_initialized()
    jdist.initialize()
    jdist.initialize(num_processes=1)
    P.initialize()
    P.initialize(num_processes=1)
    P.initialize("localhost:1", num_processes=1, process_id=0)
    monkeypatch.setenv("WORLD_SIZE", "1")
    P.initialize()
    assert dist.is_initialized() == before


@pytest.mark.parametrize("count", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("n", [9, 10, 103])
def test_process_shard_matches_jax(monkeypatch, count, n):
    for p in range(count):
        monkeypatch.setattr(jax, "process_index", lambda p=p: p)
        monkeypatch.setattr(jax, "process_count", lambda: count)
        monkeypatch.setattr(tdist, "_rank_and_world", lambda p=p: (p, count))
        got = P.process_shard(n)
        np.testing.assert_array_equal(got, jdist.process_shard(n))
        assert len(got) == -(-n // count)


@pytest.mark.parametrize("model", [1, 2, 3, 4, 5, 8, 16])
def test_multihost_mesh_rule_matches_jax(monkeypatch, model):
    """8 devices, 4 per process (two hosts): the shape, or the error."""
    monkeypatch.setattr(jax, "local_device_count", lambda: 4)
    try:
        want = jpar.create_multihost_mesh(model=model).shape
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tdist.multihost_shape(8, 4, model)
        return
    assert tdist.multihost_shape(8, 4, model) == (want["data"],
                                                  want["model"])


def test_multihost_mesh_and_global_batch_in_one_process(mesh1):
    mh = P.create_multihost_mesh(device_type="cpu")
    assert tuple(mh.shape) == (1, 1)
    with pytest.raises(ValueError):
        P.create_multihost_mesh(model=2, device_type="cpu")
    local = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    arr = P.global_batch_from_local(mh, local)
    want = jpar.global_batch_from_local(jpar.create_multihost_mesh(), local)
    assert tuple(arr.shape) == want.shape == (16, 3)
    np.testing.assert_array_equal(arr.full_tensor().numpy(),
                                  np.asarray(want))
    assert arr.placements[0].is_shard() and arr.placements[1].is_replicate()


# -- tensor and pipeline parallelism: the bookkeeping -------------------------

@pytest.mark.parametrize("case", [
    (1, 112, (1, 1, 1, 1), (32, 64, 128, 256)),
    (0, 112, FULL_DEPTH, (64, 128, 256, 512)),
    (16, 112, FULL_DEPTH, (64, 128, 256, 512)),
    (48, 112, FULL_DEPTH, (64, 128, 256, 512)),
    (3, 64, (1, 2, 2, 1), (16, 32, 64, 128))])
def test_boundary_shape_matches_jax(case):
    assert tpp.boundary_shape(*case) == jpp.boundary_shape(*case)


@pytest.mark.parametrize("ranks", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("sizes", [FULL_DEPTH, (1, 2, 2, 1)])
def test_default_splits_match_jax(ranks, sizes):
    strides = jtp._unit_strides(sizes)
    assert ttp._unit_strides(sizes) == strides
    if len(strides) < ranks:
        return
    widths = [w for b, w in zip(sizes, (64, 128, 256, 512))
              for _ in range(b)]
    splits = tpp._default_splits(ranks, strides, widths, 112)
    assert splits == jpp._default_splits(ranks, strides, widths, 112)
    assert len(splits) == ranks - 1 and list(splits) == sorted(set(splits))


_FLAX_NAMES = {"conv": "Conv", "dense": "Dense", "bn": "_FrozenBN",
               "prelu": "_PReLU", "units": "_IRUnit"}


def _flax_tree(state_dict) -> dict:
    """The JAX package's parameter tree of a port ArcFace state dict (the
    inverse of ``convert.state_dict_from_flax``)."""
    tree = {}
    for key, t in state_dict.items():
        *mods, leaf = key.split(".")
        node = tree
        for name, idx in zip(mods[::2], mods[1::2]):
            node = node.setdefault(f"{_FLAX_NAMES[name]}_{idx}", {})
        v = t.numpy()
        if leaf == "weight":
            leaf, v = "kernel", (v.transpose(2, 3, 1, 0) if v.ndim == 4
                                 else v.T)
        node[leaf] = v
    return {"params": tree}


def _tiny_arcface(widths, sizes=(1, 1, 1, 1), hw=56, embed=16):
    """(the JAX parameter tree, the port module) of one random ArcFace."""
    port = ArcFaceResNet100(sizes, widths, embed, torch.float32,
                            input_size=(hw, hw),
                            generator=torch.Generator().manual_seed(0))
    params = _flax_tree(port.state_dict())
    back = state_dict_from_flax(params)
    assert all(torch.equal(back[k], v) for k, v in port.state_dict().items())
    return params, port


@pytest.fixture(scope="module")
def odd_arcface():
    """A tiny ArcFace whose unit widths divide no rank count above 1."""
    return _tiny_arcface(widths=(15, 31, 63, 127))


def test_tp_param_specs_match_jax(odd_arcface):
    params, port = odd_arcface
    specs = ttp.tp_param_specs(port)
    assert specs == ttp.tp_param_specs(port.state_dict())
    # The JAX spec of each leaf, at its torch name and in torch's layout:
    # HWIO's output dim (3) is torch's dim 0, its input dim (2) dim 1.
    flat = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = v

    walk(jtp.tp_param_specs(params)["params"], ())
    torch_dim = {(None, None, None, "model"): 0,
                 (None, None, "model", None): 1, ("model",): 0, (): None}
    assert len(flat) == len(specs)
    for path, spec in flat.items():
        key, = state_dict_from_flax(_nest(path, np.zeros(1)))
        assert specs[key] == torch_dim[tuple(spec)], key
    assert sum(d is not None for d in specs.values()) == 4 * 7


def _nest(path, leaf):
    tree = leaf
    for k in reversed(path):
        tree = {k: tree}
    return tree


def test_pad_unit_params_match_jax_and_are_exact(odd_arcface):
    params, port = odd_arcface
    port = copy.deepcopy(port)
    for ranks in (1, 4):
        want = state_dict_from_flax(_np(jtp._pad_unit_params(params, ranks)))
        got = ttp._pad_unit_params(port.state_dict(), ranks)
        assert got.keys() == want.keys()
        for k in got:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    # Exact on data whose every product and sum is exact in f32: the unit
    # on the padded tensors gives the unpadded output and zero pad lanes.
    g = torch.Generator().manual_seed(0)
    unit = port.units[1]
    with torch.no_grad():
        for t in unit.parameters():
            t.copy_(torch.randint(-2, 3, t.shape, generator=g) / 4.0)
        for name in ("gamma", "beta", "mean"):
            for bn in unit.bn:
                getattr(bn, name).copy_(torch.randint(
                    -2, 3, getattr(bn, name).shape, generator=g) / 2.0)
    sd = {k[len("units.1."):]: v for k, v in ttp._pad_unit_params(
        port.state_dict(), 4).items() if k.startswith("units.1.")}
    x = torch.randint(-3, 4, (2, 15, 8, 8), generator=g).float()
    lanes = []
    with torch.no_grad():
        want = unit(x)
        got = torch.func.functional_call(
            unit, sd, (x,), {"reduce": lambda y: lanes.append(y) or y})
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert sd["conv.0.weight"].shape[0] == 32 and len(lanes) == 1


def _pp_case(case):
    """(JAX mesh shape, port pp_splits kwargs) of one validation case."""
    kw = dict(stage_sizes=(1, 1, 1, 1), stage_widths=(64, 128, 256, 512),
              microbatches=2)
    shape, extra = case
    kw.update(extra)
    return shape, kw


@pytest.mark.parametrize("case", [
    ((8, 1), {}),                                         # < 2 ranks
    ((1, 8), {}),                                         # 4 units, 8 ranks
    ((2, 4), {"split_after_unit": 1}),                    # 2-rank spelling
    ((4, 2), {"split_after_unit": 3}),                    # empty last rank
    ((2, 4), {"splits": (0, 0, 2)}),                      # not ascending
    ((2, 4), {"splits": (0, 1)}),                         # too few
    ((4, 2), {"microbatches": 3}),                        # batch 8 / (4 x 3)
    ((4, 2), {"splits": (2,)}),                           # valid
    ((2, 4), {}),                                         # valid, default
])
def test_pp_validation_matches_jax(case):
    shape, kw = _pp_case(case)
    mesh = jpar.create_mesh(shape)
    x = jnp.zeros((8, 112, 112, 3), jnp.float32)
    params = {"params": {}}
    args = dict(n_ranks=shape[1], n_data=shape[0], batch=8, in_hw=112)
    try:
        # Every check comes before any compute in JAX; with an empty
        # parameter tree a valid case fails only on its first lookup.
        jpp.arcface_pp_apply(mesh, params, x, dtype=jnp.float32, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tpp.pp_splits(**args, **kw)
        return
    except KeyError:
        pass
    splits = tpp.pp_splits(**args, **kw)
    assert len(splits) == shape[1] - 1


def test_pp_needs_two_ranks_in_one_process(mesh1, odd_arcface):
    with pytest.raises(ValueError, match="2 ranks"):
        P.arcface_pp_apply(mesh1, odd_arcface[1], torch.zeros(2, 56, 56, 3))


# -- the world-1 paths against the unsharded port -----------------------------

def test_sharded_featurize_matches_local_and_jax(mesh1, jmesh):
    w = np.random.default_rng(0).normal(size=(48, 8)).astype(np.float32)
    x = np.random.default_rng(1).uniform(size=(13, 4, 4, 3)).astype(
        np.float32)

    def tfeat(v):
        return torch.tanh(v.reshape(v.shape[0], -1) @ torch.from_numpy(w))

    got = P.sharded_featurize(mesh1, tfeat, torch.from_numpy(x))
    torch.testing.assert_close(got, tfeat(torch.from_numpy(x)), rtol=0,
                               atol=0)
    want = jpar.sharded_featurize(
        jmesh, lambda v: jnp.tanh(v.reshape(v.shape[0], -1) @ w), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_sharded_face_pipeline_matches_local(mesh1):
    g = torch.Generator().manual_seed(0)
    fm = FaceModel(ArcFaceResNet100((1, 1, 1, 1), (16, 16, 32, 32), 8,
                                    torch.float32, generator=g),
                   init_cascade_params(g, torch.float32, with_lnet=False),
                   CascadeConfig.typical(thresholds=(0.0, 0.0, 0.0)))
    x = np.random.default_rng(2).uniform(0, 255, (3, 48, 48, 3)).astype(
        np.float32)
    torch.testing.assert_close(P.sharded_face_pipeline(mesh1, fm, x),
                               fm.pipeline(x), rtol=0, atol=0)


def test_sharded_committee_matches_predict_and_jax(mesh1, jmesh):
    jhead, p0, h0 = _jax_head(0)
    heads = [_jax_head(i) for i in range(4)]
    com = Committee.from_param_list(h0, [h[2].state_dict() for h in heads])
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[h[1] for h in heads])
    rng = np.random.default_rng(5)
    left = rng.normal(size=(9, 16)).astype(np.float32)
    right = rng.normal(size=(9, 16)).astype(np.float32)
    tl, tr = torch.from_numpy(left), torch.from_numpy(right)
    got = P.sharded_committee_probs(mesh1, h0, com.params, tl, tr)
    torch.testing.assert_close(got, com.predict(tl, tr), rtol=0, atol=1e-6)
    want = jpar.sharded_committee_probs(jmesh, jhead, stacked, left, right)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_score_matrix_sharded_matches_local_and_jax(mesh1, jmesh):
    jhead, params, head = _jax_head(3, d=16, widths=(512, 64))
    rng = np.random.default_rng(6)
    rows = rng.normal(size=(9, 16)).astype(np.float32)
    cols = rng.normal(size=(7, 16)).astype(np.float32)
    tr, tc = torch.from_numpy(rows), torch.from_numpy(cols)
    got = score_matrix_sharded(mesh1, head, tr, tc, row_block=4, col_block=4)
    torch.testing.assert_close(got, score_matrix(head, tr, tc), rtol=0,
                               atol=0)
    want = jgrid_sharded(jmesh, params, rows, cols)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)
    with pytest.raises(TypeError, match="rowblock"):
        score_matrix_sharded(mesh1, head, tr, tc, rowblock=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_arcface_tp_at_model_1_is_bit_equal(mesh1, dtype):
    g = torch.Generator().manual_seed(1)
    model = ArcFaceResNet100((1, 2, 1, 1), (16, 32, 32, 64), 8, dtype,
                             input_size=(32, 32), generator=g)
    x = torch.rand((3, 32, 32, 3), generator=g) * 255
    with torch.no_grad():
        want = model(x)
    got = P.arcface_tp_apply(mesh1, model, x, stage_sizes=(1, 2, 1, 1),
                             dtype=dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="stage_sizes"):
        P.arcface_tp_apply(mesh1, model, x, stage_sizes=(3, 13, 30, 3))
    with pytest.raises(ValueError, match="dtype"):
        P.arcface_tp_apply(mesh1, model, x, dtype=torch.float16)


def test_verifier_with_a_mesh_matches_jax(mesh1, jmesh):
    jhead, params, head = _jax_head(4, d=16, widths=(512, 64))
    feats = np.random.default_rng(7).normal(size=(6, 16)).astype(np.float32)
    got = Verifier(lambda x: x, head, mesh=mesh1).score_matrix(
        feats, precomputed=True)
    torch.testing.assert_close(got, Verifier(lambda x: x, head).score_matrix(
        feats, precomputed=True), rtol=0, atol=0)
    want = JVerifier(lambda x: x, params, mesh=jmesh).score_matrix(
        feats, precomputed=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)


def test_generate_matrix_scores_unsharded_in_one_process(tmp_path):
    head = SiameseHead(16, generator=torch.Generator().manual_seed(5))
    T.save(str(tmp_path / "head"), head.state_dict())
    feats = np.random.default_rng(8).normal(size=(5, 16)).astype(np.float32)
    got = generate_matrix.restore_head_and_score(str(tmp_path / "head"),
                                                 feats, device="cpu")
    torch.testing.assert_close(got, score_matrix(
        head, torch.from_numpy(feats), torch.from_numpy(feats)), rtol=0,
        atol=0)


def test_alink_main_initializes_before_parsing(monkeypatch):
    order = []
    monkeypatch.setattr(P, "initialize", lambda: order.append("initialize"))
    monkeypatch.setattr(talink, "parse_config",
                        lambda argv: order.append("parse") or argv)
    monkeypatch.setattr(talink, "run_alink",
                        lambda cfg, device: order.append((cfg, device)))
    talink.main(["--device", "cpu", "--eps", "0.1"])
    assert order == ["initialize", "parse", (["--eps", "0.1"], "cpu")]


# -- the prefetcher's sharding and transfer -----------------------------------

def test_prefetch_sharding_lands_this_ranks_rows(mesh1, jmesh):
    src = [{"x": np.arange(8 * 3, dtype=np.float32).reshape(8, 3) + i,
            "y": (np.full((8,), i, np.int32), "tag")} for i in range(3)]
    got = list(tprefetch.DevicePrefetcher(
        iter(src), sharding=P.batch_sharding(mesh1, 2)))
    want = list(jprefetch.DevicePrefetcher(
        iter([{"x": s["x"]} for s in src]),
        sharding=jpar.batch_sharding(jmesh, 2)))
    assert len(got) == len(want) == 3
    for g, w, s in zip(got, want, src):
        assert g["y"][1] == "tag"
        assert g["x"].placements == P.batch_sharding(mesh1).placements
        assert g["x"].to_local().device.type == "cpu"
        np.testing.assert_array_equal(g["x"].full_tensor().numpy(),
                                      np.asarray(w["x"]))
        np.testing.assert_array_equal(g["y"][0].to_local().numpy(), s["y"][0])
    with pytest.raises(ValueError, match="cpu mesh"):
        tprefetch.DevicePrefetcher([], device="cuda",
                                   sharding=P.batch_sharding(mesh1))


def test_prefetch_transfer_options_match_jax(mesh1):
    src = [np.full((2,), i, np.float32) for i in range(4)]
    for mod, kw in ((jprefetch, {}), (tprefetch, {})):
        raw = list(mod.DevicePrefetcher(iter(src), transfer=None, **kw))
        assert all(a is b for a, b in zip(raw, src))
        doubled = list(mod.DevicePrefetcher(iter(src),
                                            transfer=lambda b: b * 2))
        np.testing.assert_array_equal(np.stack(doubled), np.stack(src) * 2)
    with pytest.raises(ValueError, match="not both"):
        jprefetch.DevicePrefetcher([], sharding=jpar.batch_sharding(
            jpar.create_mesh((4, 2))), transfer=None)
    with pytest.raises(ValueError, match="not both"):
        tprefetch.DevicePrefetcher([], sharding=P.batch_sharding(mesh1),
                                   transfer=lambda b: b)
    with tprefetch.prefetch_to_device(iter(src), transfer=None) as it:
        assert next(it) is src[0]
