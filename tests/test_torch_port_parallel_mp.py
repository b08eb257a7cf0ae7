"""The port's parallel layer in real multi-rank worlds, against the JAX
package on conftest's 8-device CPU mesh.

Two gloo worlds are spawned once each (``tests/torch_parallel_worker.py``,
one OS process per rank, a ``file://`` rendezvous under the test's
directory, a hard timeout, every child killed in ``finally``) and run many
cases per spawn; each test below reads one case from the ranks' result
files.  The two worlds and ``dryrun_multichip --ranks 2`` run while the
parent computes the JAX package's answers; the 2-rank world resumes a loop
once the 4-rank one has saved it.  ``world4`` is 4 ranks on (2, 2), (1, 4) and (4, 1) meshes, two
"hosts" of two ranks (``LOCAL_WORLD_SIZE=2``); ``world2`` is 2 ranks: the
resume of a loop saved by ``world4``, ``generate_matrix``'s sharded
branch, a collective across the two processes and a heartbeat that finds
its killed partner (``tests/test_distributed_mp.py``'s two tests).

Tolerances, each with its reason:

- the sharded featurizer and committee against JAX's sharded functions
  1e-5 (``tests/test_parallel.py``'s bound); the score grid 2e-2 (bf16
  operands, ``tests/test_pairwise.py``);
- TP and PP at tiny depth in f32 within 1e-3 of JAX's local forward (the
  JAX dry run's bound; JAX's own TP compile takes ~25 s on this CPU, so
  the reference is its local forward, which JAX's tests hold its sharded
  forwards to within 2e-5), and within 2e-5 of the port's local forward;
- sharded against unsharded within one package: 1e-6 on the CPU (each
  rank's block is a smaller matmul or convolution, whose blocking and so
  whose f32 summation order can differ from the whole batch's; on the card
  the K1 grid is computed pair by pair, and phase (n) of ``chip_smoke.py``
  holds the world-1 paths bit-equal);
- meshes, shards, errors, counters and the elastic resume: equal (the
  resume 1e-6, as the JAX test).
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu import parallel as jpar
from alink_tpu.models import ArcFaceResNet100 as JArcFace
from alink_tpu.models import SiameseHead as JSiameseHead
from alink_tpu.ops.pairwise import score_matrix_sharded as jgrid_sharded
from alink_tpu.parallel import distributed as jdist
from alink_tpu_torch import train as T
from alink_tpu_torch.active.committee import stack_params
from alink_tpu_torch.convert import state_dict_from_flax
from alink_tpu_torch.data import PersonStacks
from alink_tpu_torch.models import ArcFaceResNet100
from alink_tpu_torch.parallel import distributed as tdist
from test_torch_port_parallel import _flax_tree

WORKER = Path(__file__).resolve().with_name("torch_parallel_worker.py")
REPO = WORKER.parent.parent
# (stage_sizes, stage_widths, input side, embedding) of the TP/PP model:
# at model 2 every width divides; at model 4, 30 and 126 do not (the TP
# split zero-pads them) while 16 and 64 do; 5 units fill 4 PP ranks.
ARCFACES = {"mixed": ((1, 2, 1, 1), (16, 30, 64, 126), 64, 16)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_heads(n, d=16, widths=(8, 4), seed=0):
    head = JSiameseHead(widths=widths, dtype=jnp.float32)
    params = [head.init(jax.random.PRNGKey(seed + i), jnp.zeros((1, d)),
                        jnp.zeros((1, d))) for i in range(n)]
    return head, params


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs both packages see, written for the workers; the 4-rank
    world and the dry run's CLI started on them; and, while they run, the
    JAX package's answers."""
    work = tmp_path_factory.mktemp("parallel_mp")
    rng = np.random.default_rng(0)
    inputs = {"feat_w": rng.normal(size=(48, 8)).astype(np.float32),
              "feat_x": rng.uniform(size=(13, 4, 4, 3)).astype(np.float32),
              "vgg_x": rng.uniform(0, 255, (6, 32, 32, 3)).astype(np.float32),
              "pipe_x": rng.uniform(0, 255, (6, 48, 48, 3)).astype(
                  np.float32),
              "com_left": rng.normal(size=(9, 16)).astype(np.float32),
              "com_right": rng.normal(size=(9, 16)).astype(np.float32),
              "grid_rows": rng.normal(size=(9, 16)).astype(np.float32),
              "grid_cols": rng.normal(size=(7, 16)).astype(np.float32),
              "tp_x": rng.uniform(0, 255, (8, 64, 64, 3)).astype(np.float32),
              "arcfaces": ARCFACES}
    jhead, jparams = _jax_heads(4)
    port_heads = [state_dict_from_flax(_np(p)) for p in jparams]
    inputs["com_params"] = stack_params(port_heads)
    inputs["com3_params"] = stack_params(port_heads[:3])
    _, (gparams,) = _jax_heads(1, widths=(512, 64), seed=9)
    inputs["grid_head"] = state_dict_from_flax(_np(gparams))
    T.save(str(work / "grid_head"), inputs["grid_head"])
    people, size = 6, 4
    inputs["elastic_plain"], inputs["elastic_dig"] = (
        PersonStacks(rng.random((people, 2, size, size, 3)).astype(
            np.float32) * 255, np.full(people, 2, np.int32))
        for _ in range(2))

    for name, (sizes, widths, hw, embed) in ARCFACES.items():
        port = ArcFaceResNet100(sizes, widths, embed, torch.float32,
                                input_size=(hw, hw),
                                generator=torch.Generator().manual_seed(3))
        inputs[f"{name}_sd"] = port.state_dict()
    torch.save(inputs, work / "inputs.pt")
    world4 = _World(work, "world4", 4, timeout=150.0)
    world2 = _World(work, "world2", 2, timeout=180.0)
    with open(work / "cli.log", "w") as log:
        cli = subprocess.Popen(
            [sys.executable, "-m", "alink_tpu_torch.tools.dryrun_multichip",
             "--ranks", "2"], cwd=str(REPO), stdout=log,
            stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": str(REPO)})
    try:
        yield work, inputs, _jax_answers(inputs, jhead, jparams, gparams), \
            world4, cli, world2
    finally:
        world4.kill()
        world2.kill()
        if cli.poll() is None:
            cli.kill()
            cli.wait()


def _jax_answers(inputs, jhead, jparams, gparams) -> dict:
    want = {}
    mesh22 = jpar.create_mesh((2, 2), devices=jax.devices()[:4])
    w = inputs["feat_w"]
    want["featurize"] = np.asarray(jpar.sharded_featurize(
        mesh22, lambda v: jnp.tanh(v.reshape(v.shape[0], -1) @ w),
        inputs["feat_x"]))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jparams)
    want["committee"] = np.asarray(jpar.sharded_committee_probs(
        mesh22, jhead, stacked, inputs["com_left"], inputs["com_right"]))
    with pytest.raises(ValueError) as err:
        jpar.sharded_committee_probs(
            mesh22, jhead, jax.tree.map(lambda x: x[:3], stacked),
            inputs["com_left"], inputs["com_right"])
    want["committee3"] = str(err.value)
    want["grid"] = np.asarray(jgrid_sharded(mesh22, gparams,
                                            inputs["grid_rows"],
                                            inputs["grid_cols"]))
    for name, (sizes, widths, hw, embed) in ARCFACES.items():
        port = ArcFaceResNet100(sizes, widths, embed, torch.float32,
                                input_size=(hw, hw))
        port.load_state_dict(inputs[f"{name}_sd"])
        model = JArcFace(stage_sizes=sizes, stage_widths=widths,
                         embedding_dim=embed, dtype=jnp.float32)
        want[f"{name}_jax"] = np.asarray(model.apply(
            _flax_tree(port.state_dict()), jnp.asarray(inputs["tp_x"])))
        with torch.no_grad():
            want[f"{name}_local"] = port(torch.from_numpy(
                inputs["tp_x"])).numpy()
    return want


class _World:
    """``world`` ranks of ``scenario``, started at once; ``wait`` fails a
    world that outlives ``timeout`` seconds from its start, and every
    child still running is killed (``wait``'s ``finally``, ``kill``)."""

    def __init__(self, work: Path, scenario: str, world: int,
                 timeout: float):
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH",
                                                             "")
        env["LOCAL_WORLD_SIZE"] = "2"
        for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                    "MASTER_PORT"):
            env.pop(var, None)
        self.work, self.scenario, self.world = work, scenario, world
        self.deadline = time.monotonic() + timeout
        self.logs = [work / f"{scenario}_r{r}.log" for r in range(world)]
        self.procs = []
        try:
            for r in range(world):
                with open(self.logs[r], "w") as log:
                    self.procs.append(subprocess.Popen(
                        [sys.executable, str(WORKER), scenario, str(r),
                         str(world), str(work)], stdout=log,
                        stderr=subprocess.STDOUT, env=env, cwd=str(REPO)))
        except BaseException:
            self.kill()
            raise

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self):
        """(return codes, logs, each rank's results or None)."""
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        finally:
            self.kill()
        files = [self.work / f"{self.scenario}_r{r}.pt"
                 for r in range(self.world)]
        return ([p.returncode for p in self.procs],
                [log.read_text() for log in self.logs],
                [torch.load(f, weights_only=False) if f.exists() else None
                 for f in files])


@pytest.fixture(scope="module")
def world4(setup):
    rcs, logs, results = setup[3].wait()
    assert rcs == [0] * 4, logs
    return results


@pytest.fixture(scope="module")
def world2(setup):
    return setup[5].wait()


def _case(results, name):
    """Every rank's result of one case (a worker error fails here)."""
    outs = [r[name] for r in results]
    for r, out in enumerate(outs):
        if isinstance(out, dict) and "error" in out:
            pytest.fail(f"rank {r}, case {name}:\n{out['error']}")
    return outs


def _same_on_every_rank(outs, key=None):
    first = outs[0] if key is None else outs[0][key]
    for out in outs[1:]:
        np.testing.assert_array_equal(out if key is None else out[key],
                                      first)
    return first


# -- world4: the sharded ops --------------------------------------------------

def test_meshes_and_coordinates(world4):
    for r, out in enumerate(_case(world4, "mesh")):
        assert out[(2, 2)] == ((2, 2), divmod(r, 2))
        assert out[(1, 4)] == ((1, 4), (0, r))
        assert out[(4, 1)] == ((4, 1), (r, 0))


def test_sharded_featurize_matches_jax(world4, setup):
    got = _same_on_every_rank(_case(world4, "featurize"))
    assert got.shape == (13, 8)
    np.testing.assert_allclose(got, setup[2]["featurize"], atol=1e-5)


def test_sharded_vgg_featurizer_matches_unsharded(world4):
    outs = _case(world4, "vgg")
    got = _same_on_every_rank(outs, "sharded")
    assert got.shape == (6, 2048)
    np.testing.assert_allclose(got, outs[0]["local"], rtol=0,
                               atol=1e-6 * float(np.abs(got).max()))


def test_sharded_face_pipeline_matches_unsharded(world4):
    outs = _case(world4, "pipeline")
    got = _same_on_every_rank(outs, "sharded")
    assert got.shape == (6, 8) and np.isfinite(got).all()
    np.testing.assert_allclose(got, outs[0]["local"], rtol=0, atol=1e-6)


def test_sharded_committee_matches_jax(world4, setup):
    outs = _case(world4, "committee")
    got = _same_on_every_rank(outs, "sharded")
    np.testing.assert_allclose(got, setup[2]["committee"], atol=1e-5)
    np.testing.assert_allclose(got, outs[0]["local"], rtol=0, atol=1e-6)


def test_indivisible_committee_raises_like_jax(world4, setup):
    for out in world4:
        err = out["committee3"]["error"]
        assert "ValueError: " + setup[2]["committee3"] in err


def test_sharded_score_grid_matches_jax_and_the_local_grid(world4, setup):
    outs = _case(world4, "grid")
    got = _same_on_every_rank(outs, "sharded")
    assert got.shape == (9, 7)
    np.testing.assert_allclose(got, setup[2]["grid"], atol=2e-2)
    np.testing.assert_allclose(got, outs[0]["local"], rtol=0, atol=1e-6)


# -- world4: tensor and pipeline parallelism ----------------------------------

@pytest.mark.parametrize("name", sorted(ARCFACES))
@pytest.mark.parametrize("shape", ["2x2", "1x4"])
def test_tensor_parallel_matches_jax(world4, setup, name, shape):
    outs = _case(world4, f"tp_{name}_{shape}")
    got = _same_on_every_rank(outs, "out")
    np.testing.assert_allclose(got, setup[2][f"{name}_jax"], atol=1e-3)
    np.testing.assert_allclose(got, setup[2][f"{name}_local"], atol=2e-5)
    # Exactly one model all-reduce per unit.
    assert {o["all_reduce"] for o in outs} == {sum(ARCFACES[name][0])}


@pytest.mark.parametrize("case", ["mixed_2x2_None", "mixed_1x4_None",
                                  "mixed_1x4_(0, 2, 3)"])
def test_pipeline_parallel_matches_jax(world4, setup, case):
    got = _same_on_every_rank(_case(world4, f"pp_{case}"))
    name = case.split("_")[0]
    np.testing.assert_allclose(got, setup[2][f"{name}_jax"], atol=1e-3)
    np.testing.assert_allclose(got, setup[2][f"{name}_local"], atol=2e-5)


# -- world4: the multi-host layer, the dry run --------------------------------

def test_multihost_mesh_over_two_hosts(world4, monkeypatch):
    """4 ranks as 2 hosts x 2: model 1 and 2 give meshes, 3 and 4 raise
    with the rule's message; JAX (8 devices, 2 per process) raises for the
    same models."""
    monkeypatch.setattr(jax, "local_device_count", lambda: 2)
    outs = _case(world4, "multihost")
    for model in (3, 4):
        with pytest.raises(ValueError) as err:
            tdist.multihost_shape(4, 2, model)
        assert {o[model] for o in outs} == {str(err.value)}
        with pytest.raises(ValueError):
            jpar.create_multihost_mesh(model=model)
    for model, shape in ((1, (4, 1)), (2, (2, 2))):
        assert jpar.create_multihost_mesh(model=model).shape["model"] == model
        for r, o in enumerate(outs):
            o = o[model]
            assert o["shape"] == shape
            assert o["coord"] == divmod(r, model)
            assert o["global"] == (3 * shape[0], 2)
            np.testing.assert_array_equal(o["local"], 10.0 * o["coord"][0])
            # The full batch: every data coordinate's rows, in order.
            want = np.repeat(10.0 * np.arange(shape[0]), 3)[:, None]
            np.testing.assert_array_equal(o["full"][:, :1], want)


def test_process_shard_per_rank_matches_jax(world4, monkeypatch):
    outs = _case(world4, "process_shard")
    for r, out in enumerate(outs):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: 4)
        for n, got in out.items():
            np.testing.assert_array_equal(got, jdist.process_shard(n))
    for n in (9, 10, 103):
        rows = np.concatenate([o[n] for o in outs])
        assert set(rows) == set(range(n))


def test_dryrun_multichip_at_4_ranks(world4):
    for out in _case(world4, "dryrun"):
        assert out["mesh"] == (2, 2) and out["loop_pairs"] > 0
        assert out["tp_diff"] < 1e-3 and out["pp_diff"] < 1e-3
        assert max(out["grid_diff"], out["committee_diff"]) <= 1e-5
        assert np.isfinite(out["train_loss"])


def test_dryrun_multichip_cli_spawns_a_world(setup):
    cli = setup[4]
    try:
        cli.wait(timeout=120)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    out = (setup[0] / "cli.log").read_text()
    assert cli.returncode == 0, out
    assert "'mesh': (2, 1)" in out
    assert out.strip().endswith("dryrun_multichip OK")


# -- the elastic restart: save at 4 ranks, resume at 2 ------------------------

def test_checkpoint_resumes_under_a_smaller_world(world4, world2):
    _, logs, results = world2
    truth = _case(world4, "elastic")[0]
    for r, res in enumerate(results):
        assert res is not None, logs[r]
        got = _case([res], "elastic")[0]
        assert got["counters"] == truth["counters"]
        for k, v in truth["m2"].items():
            np.testing.assert_allclose(got["m2"][k], v, rtol=0, atol=1e-6)


def test_generate_matrix_shards_over_a_world_of_two(world2):
    _, logs, results = world2
    outs = _case([r for r in results if r is not None], "generate_matrix")
    assert len(outs) == 2, logs
    got = _same_on_every_rank(outs, "sharded")
    assert got.shape == (9, 9)
    np.testing.assert_allclose(got, outs[0]["local"], rtol=0, atol=1e-6)


def test_two_process_collective(world2):
    _, logs, results = world2
    for r in range(2):
        assert f"WORKER{r}_OK" in logs[r], logs[r]
        out = _case([results[r]], "collective")[0]
        assert out["shape"] == (2, 1) and out["coord"] == (r, 0)
        assert out["global"] == (8, 3)
        assert out["total"] == sum(4 * 3 * (p + 1) for p in range(2))
        assert out["shard10"] == 5 and out["shard9"] == 5


def test_heartbeat_detects_killed_partner(world2):
    rcs, logs, results = world2
    assert rcs[1] == 0 and "WORKER1_ABRUPT_EXIT" in logs[1], logs[1]
    assert rcs[0] == 0 and "PEER_FAILURE_DETECTED" in logs[0], logs[0]
    assert "missed the 1s heartbeat" in results[0]["peer_failure"]
