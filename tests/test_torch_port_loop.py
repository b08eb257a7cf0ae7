"""The port's loop resume and supervision, augmentation, NaN guard, metrics,
utilities and prefetcher, on the CPU: each module held to its JAX
counterpart on the same inputs, and the port's resume held to its own
uninterrupted run.

Tolerances, each with its reason:

- utilities (``helpers``, ``MetricsLogger``, ``check_finite``,
  ``resilience``) and the prefetcher: the same outputs and the same
  exceptions, case for case with the JAX package's tests;
- augment warps: bit-equal to the ``scipy.ndimage.affine_transform(order=0,
  mode="nearest")`` oracle and to JAX's ``_warp_batch`` on the same
  numpy-drawn matrices (nearest sampling: every output is an input pixel);
- the augmented finetune and the carried JAX loop state: M2's parameters
  within 1e-3 of the largest change, as ``test_torch_port_alink.py`` holds
  one finetune (fit's one batch is summed in another order);
- resume and supervised restarts within the port: bit-equal counters, logs,
  M2 and optimizer state (the same arithmetic in the same order).
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from alink_tpu import train as JT
from alink_tpu import utils as jutils
from alink_tpu.active import loop as jloop_mod
from alink_tpu.active.committee import Committee as JCommittee
from alink_tpu.data import pairs as jpairs
from alink_tpu.data import prefetch as jprefetch
from alink_tpu.models import SiameseHead as JSiameseHead
from alink_tpu.ops import augment as jaug
from alink_tpu.utils import debug as jdebug
from alink_tpu.utils import resilience as jres
from alink_tpu.utils.dispatch import resolve_device_batch
from alink_tpu_torch import train as T
from alink_tpu_torch import utils as tutils
from alink_tpu_torch.active import loop as tloop_mod
from alink_tpu_torch.active.committee import Committee
from alink_tpu_torch.config import ALinkConfig
from alink_tpu_torch.convert import (load_flax, loop_state_from_jax,
                                     state_dict_from_flax)
from alink_tpu_torch.data import PersonStacks
from alink_tpu_torch.data import prefetch as tprefetch
from alink_tpu_torch.drivers import alink as talink
from alink_tpu_torch.models import SiameseHead
from alink_tpu_torch.ops import augment as taug
from alink_tpu_torch.utils import debug as tdebug
from alink_tpu_torch.utils import resilience as tres

REPO = Path(__file__).resolve().parent.parent

SIZE = 8
DF = SIZE * SIZE * 3


def _flat(images):
    """A featurizer for both packages: pixels / 256, exact in f32."""
    return images.reshape(images.shape[0], -1) * 0.00390625


# -- helpers and metrics -----------------------------------------------------

HELPER_CASES = {
    "roundoff": lambda h: h.roundoff(np.array([0.1, 0.5, 0.9, 0.49])),
    "one_hot": lambda h: h.one_hot(np.array([0, 1, 1]), 3),
    "unison_split": lambda h: np.concatenate([np.concatenate(p) for p in
                                              h.unison_split(
                                                  np.arange(10),
                                                  np.arange(10) * 2, 0.4,
                                                  seed=0)]),
    "calculate_accuracy": lambda h: h.calculate_accuracy(
        np.array([[0.9, 0.1], [0.2, 0.8], [0.9, 0.1]]),
        h.one_hot(np.array([0, 1, 1]))),
    "confusion_counts": lambda h: h.confusion_counts([0, 0, 1, 1, 2],
                                                     [0, 1, 1, 1, 0]),
}


@pytest.mark.parametrize("name", sorted(HELPER_CASES))
def test_helpers_match_jax(name):
    got = HELPER_CASES[name](tutils)
    want = HELPER_CASES[name](jutils)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.asarray(want).dtype


def test_metrics_logger_matches_jax(tmp_path, capsys):
    records, echoes = [], []
    for side, cls in (("j", jutils.MetricsLogger), ("t", tutils.MetricsLogger)):
        path = tmp_path / side / "m.jsonl"
        with cls(str(path)) as logger:
            logger.log("alink_iteration", active_count=3, queried=2)
            logger.log("done", ok=True)
        assert logger._fh is None
        recs = [json.loads(x) for x in path.read_text().splitlines()]
        records.append([{k: v for k, v in r.items() if k != "t"}
                        for r in recs])
        echoes.append([line.split("] ", 1)[1] for line in
                       capsys.readouterr().out.splitlines()])
    assert records[0] == records[1] and records[0][0] == {
        "event": "alink_iteration", "active_count": 3, "queried": 2}
    assert echoes[0] == echoes[1] == ["alink_iteration: active_count=3 "
                                      "queried=2", "done: ok=True"]


def test_timings_and_trace(tmp_path):
    t = tutils.Timings()
    for name in ("a", "a", "b"):
        with t.phase(name):
            pass
    assert t.counts == {"a": 2, "b": 1} and "ms/call" in t.report()
    with tutils.trace(str(tmp_path / "tr")):
        torch.ones(64).sum()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]


# -- check_finite ------------------------------------------------------------

NAN_CASES = {
    "finite_dict": ({"a": np.ones(3, np.float32),
                     "b": np.array([1.0, 2.0], np.float32)}, None),
    "inf_in_dict": ({"a": np.ones(3, np.float32),
                     "b": np.array([1.0, np.inf], np.float32)}, "leaf[1]"),
    "nan_in_tuple": ((np.zeros(2, np.float32),
                      [np.array([np.nan], np.float32)]), "leaf[1]"),
    "int_leaves": (np.arange(4), None),
}


@pytest.mark.parametrize("case", sorted(NAN_CASES))
def test_check_finite_forced_matches_jax(case):
    tree, bad = NAN_CASES[case]
    as_jax = jax.tree.map(jnp.asarray, tree)
    as_torch = jax.tree.map(torch.from_numpy, tree)
    outcomes = []
    for mod, t in ((jdebug, as_jax), (tdebug, as_torch)):
        try:
            mod.check_finite(t, "selection", force=True)
            outcomes.append(None)
        except FloatingPointError as exc:
            msg = str(exc)
            assert "phase 'selection'" in msg
            outcomes.append(msg.split(": ", 2)[2].split(" ")[0])
    assert outcomes == [bad, bad]


def test_check_finite_switch_and_modules_match_jax():
    nan = np.array([np.nan], np.float32)
    for mod, arr in ((jdebug, jnp.asarray), (tdebug, torch.from_numpy)):
        mod.enable_nan_guard(False)
        assert not mod.nan_guard_enabled()
        mod.check_finite(arr(nan), "x")  # off: no raise
        mod.enable_nan_guard(True)
        try:
            with pytest.raises(FloatingPointError):
                mod.check_finite(arr(nan), "x")
            mod.check_finite(arr(np.ones(4, np.float32)), "x")
        finally:
            mod.enable_nan_guard(False)
    head = SiameseHead(DF, (16, 8), dtype=torch.float32)
    tdebug.check_finite(head, "m2", force=True)
    with torch.no_grad():
        head.out.bias[0] = float("nan")
    with pytest.raises(FloatingPointError, match="'m2'.*shape=\\(2,\\)"):
        tdebug.check_finite(head, "m2", force=True)


# -- resilience --------------------------------------------------------------

def _retry_scenario(mod, case):
    """One supervision scenario on ``mod``'s run_with_retries: (outcome,
    calls, sleeps, attempts, failures, hook calls)."""
    calls, sleeps, seen = [], [], []

    def step(attempt):
        calls.append(attempt)
        if case == "success":
            return attempt + 41
        if case == "retry_then_success":
            if attempt < 2:
                raise RuntimeError(f"device halt {attempt}")
            return "ok"
        if case == "budget":
            raise RuntimeError("always down")
        if case == "bug":
            raise ValueError("programming error")
        if case == "fatal_subclass":
            raise NotImplementedError("missing piece")
        if case == "peer_failure":
            raise mod.PeerFailure("process(es) [1] missed the deadline")
        if case == "oom":
            if attempt == 0:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return "ok"
        if attempt == 0:   # "hook"
            raise OSError("shared fs hiccup")
        return attempt

    report = mod.RetryReport()
    try:
        out = mod.run_with_retries(
            step, max_restarts=2, backoff_s=1.0, backoff_factor=2.0,
            report=report, _sleep=sleeps.append,
            on_restart=lambda a, e: seen.append((a, str(e))))
    except BaseException as exc:  # noqa: BLE001 — compared below
        out = (type(exc).__name__, str(exc))
    return out, calls, sleeps, report.attempts, report.failures, seen


@pytest.mark.parametrize("case", ["success", "retry_then_success", "budget",
                                  "bug", "fatal_subclass", "peer_failure",
                                  "oom", "hook"])
def test_run_with_retries_matches_jax(case):
    got = _retry_scenario(tres, case)
    want = _retry_scenario(jres, case)
    assert got == want
    assert tres.RETRYABLE == jres.RETRYABLE
    assert [c.__name__ for c in tres.FATAL] == [c.__name__ for c in jres.FATAL]
    if case == "retry_then_success":
        assert got[0] == "ok" and got[2] == [1.0, 2.0] and got[3] == 3


def _age(path, seconds):
    stale = time.time() - seconds
    os.utime(path, (stale, stale))


def test_heartbeat_protocol(tmp_path):
    """tests/test_resilience.py's cases on the port's objects."""
    mod = tres
    d = str(tmp_path)
    hs = [mod.Heartbeat(d, p, 3) for p in range(3)]
    assert hs[0].check_peers(timeout_s=60.0) == []   # before any beat
    for h in hs:
        h.beat()
    assert hs[0].check_peers(timeout_s=60.0) == []
    assert hs[0].last_seen(1) < 5.0
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    with open(os.path.join(d, "heartbeat_1")) as f:
        assert f.read() == hs[1].session
    _age(os.path.join(d, "heartbeat_2"), 120.0)
    assert hs[0].check_peers(timeout_s=60.0) == [2]
    with pytest.raises(mod.PeerFailure, match=r"\[2\]"):
        hs[0].ensure_peers_alive(timeout_s=60.0)
    # Start-up grace anchors to the first beat, not the freshest one.
    solo = mod.Heartbeat(str(tmp_path / "g"), 0, 2)
    solo.beat()
    assert solo.check_peers(timeout_s=60.0) == []
    solo._first_beat = time.time() - 120.0
    solo.beat()
    assert solo.check_peers(timeout_s=60.0) == [1]


def test_barrier_protocol(tmp_path):
    """tests/test_resilience.py's cases on the port's objects."""
    mod = tres
    d = str(tmp_path)
    hs = [mod.Heartbeat(d, p, 3) for p in range(3)]
    for h in hs[1:]:
        h.beat()
        mod._drop_marker(h, "sync0")
    mod.barrier(hs[0], "sync0", timeout_s=5.0, _sleep=lambda s: None)
    clock = iter(range(100))
    with pytest.raises(mod.PeerFailure, match=r"missing process\(es\) \[1, 2\]"):
        mod.barrier(hs[0], "sync1", timeout_s=3.0, _sleep=lambda s: None,
                    _clock=lambda: float(next(clock)))
    arrivals = {"n": 0}

    def late_sleep(_):
        arrivals["n"] += 1
        if arrivals["n"] == 2:
            for h in hs[1:]:
                h.beat()
                mod._drop_marker(h, "sync2")

    mod.barrier(hs[0], "sync2", timeout_s=60.0, _sleep=late_sleep)
    assert arrivals["n"] == 2
    # A restarted peer's stale marker does not release the barrier.
    mod._drop_marker(hs[1], "iter_3")    # the pre-crash incarnation's
    mod._drop_marker(hs[2], "iter_3")
    new_h1 = mod.Heartbeat(d, 1, 3)
    new_h1.beat()
    clock = iter(range(100))
    with pytest.raises(mod.PeerFailure, match=r"\[1\]"):
        mod.barrier(hs[0], "iter_3", timeout_s=3.0, _sleep=lambda s: None,
                    _clock=lambda: float(next(clock)))
    mod._drop_marker(new_h1, "iter_3")
    mod.barrier(hs[0], "iter_3", timeout_s=3.0, _sleep=lambda s: None)


# -- augment -----------------------------------------------------------------

def _pairs(n=4, size=24, seed=0):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (n, size, size, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (n, size, size, 3)).astype(np.float32)
    return torch.from_numpy(left), torch.from_numpy(right)


@pytest.mark.parametrize("kw,blocks", [
    ({}, 4), ({"use_shear": False, "use_shift": False}, 2),
    ({"use_rotation": False, "use_shift": False}, 2),
    ({"use_rotation": False, "use_shear": False}, 2),
    ({"factor": 2}, 8)])
def test_augment_layout(kw, blocks):
    left, right = _pairs()
    labels = torch.arange(4) % 2
    g = torch.Generator().manual_seed(1)
    al, ar, ay = taug.augment_pairs(g, left, right, labels, **kw)
    assert al.shape == ar.shape == (4 * blocks, 24, 24, 3)
    assert torch.equal(al[:4], left) and torch.equal(ar[:4], right)
    assert torch.equal(ay, labels.repeat(blocks))
    if kw.get("factor") == 2:
        assert torch.equal(al[16:20], left)
    moved = al[4:8]
    assert not torch.equal(moved, left)
    assert float(al.min()) >= float(left.min()) and float(
        al.max()) <= float(max(left.max(), right.max()))


def _keras_cases(h, w):
    theta, shear = 0.31, 0.2
    return {
        "rotation": (np.array([[np.cos(theta), -np.sin(theta)],
                               [np.sin(theta), np.cos(theta)]]),
                     np.zeros(2), True),
        "shear": (np.array([[1.0, -np.sin(shear)], [0.0, np.cos(shear)]]),
                  np.zeros(2), True),
        "shift": (np.eye(2), np.array([3.2, -2.6]), False),
    }


@pytest.mark.parametrize("variant", ["rotation", "shear", "shift"])
def test_augment_warp_matches_ndimage_oracle(variant):
    rng = np.random.default_rng(0)
    h, w = 20, 16
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    A_rc, t_rc, center = _keras_cases(h, w)[variant]
    A_full, t_full = A_rc, t_rc
    if center:
        o = np.array([h / 2.0 + 0.5, w / 2.0 + 0.5])
        t_full = o - A_rc @ o + t_rc
    want = np.stack([ndi.affine_transform(img[..., c], A_full, offset=t_full,
                                          order=0, mode="nearest")
                     for c in range(3)], axis=-1)
    got = taug.warp_pullback(
        torch.from_numpy(img)[None],
        torch.from_numpy(A_rc.astype(np.float32))[None],
        torch.from_numpy(t_rc.astype(np.float32))[None], center)[0].numpy()
    assert np.array_equal(got, want), (got != want).mean()


def _jax_matrices(key, n, h, w, names=("rotation", "shear", "shift"),
                  factor=1):
    """The JAX augment_pairs' per-block matrices, {(block, side): (A, t)} as
    numpy, drawn with its key schedule."""
    out = {}
    for rep in range(factor):
        for vi, name in enumerate(names):
            block = rep * len(names) + vi
            fn, bound = jaug._VARIANTS[name]
            keys = jax.random.split(jax.random.fold_in(key, block))
            for side, k in enumerate(keys):
                A, t, _ = fn(k, n, h, w, bound)
                out[block, side] = (np.asarray(A), np.asarray(t))
    return out


def _draw_from(mats):
    def draw(block, variant, side, n, h, w):
        A, t = mats[block, side]
        return torch.tensor(A[:n]), torch.tensor(t[:n])
    return draw


@pytest.mark.parametrize("size", [(24, 24), (20, 33)])
def test_augment_pairs_match_jax_on_its_draws(size):
    n, (h, w) = 5, size
    rng = np.random.default_rng(3)
    left = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    labels = np.eye(2, dtype=np.float32)[np.arange(n) % 2]
    key = jax.random.PRNGKey(7)
    want = jaug.augment_pairs(key, jnp.asarray(left), jnp.asarray(right),
                              jnp.asarray(labels))
    got = taug.augment_pairs(None, torch.from_numpy(left),
                             torch.from_numpy(right),
                             torch.from_numpy(labels),
                             draw=_draw_from(_jax_matrices(key, n, h, w)))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_augment_default_draws_follow_keras_ranges():
    g = torch.Generator().manual_seed(0)
    draw = taug.torch_draws(g)
    A, t = draw(0, "rotation", 0, 2000, 30, 40)
    theta = torch.rad2deg(torch.atan2(A[:, 1, 0], A[:, 0, 0]))
    assert float(theta.abs().max()) <= 20.0 and float(theta.abs().max()) > 19
    assert torch.equal(t, torch.zeros_like(t))
    A, t = draw(1, "shear", 1, 2000, 30, 40)
    assert torch.equal(A[:, 1, 0], torch.zeros(2000))
    assert float(torch.asin(-A[:, 0, 1]).abs().max()) <= 0.2 + 1e-6
    A, t = draw(2, "shift", 0, 2000, 30, 40)
    assert torch.equal(A, torch.eye(2).expand(2000, 2, 2))
    assert float(t[:, 0].abs().max()) <= 6.0 and float(
        t[:, 1].abs().max()) <= 8.0 and float(t[:, 1].abs().max()) > 7.5


# -- the loop against JAX ----------------------------------------------------

def _heads(jh, members, m2_params):
    head = lambda p: load_flax(  # noqa: E731
        SiameseHead(DF, (16, 8), dtype=torch.float32),
        jax.tree.map(np.asarray, p))
    return head(members[0]), [head(p).state_dict() for p in members], \
        head(m2_params)


def _jax_and_port_loops(m2_state=None, **cfg_kw):
    kw = dict(noise=("plain",), image_res=(SIZE, SIZE), feature_res=DF,
              alink_bs=2, batch_send=1000, ft_epochs=2, mixture_ratio=0,
              disparity_ratio=0.2, eps=0.01)
    kw.update(cfg_kw)
    cfg = ALinkConfig(**kw)
    jh = JSiameseHead(widths=(16, 8), dtype=jnp.float32)
    ex = jnp.zeros((2, DF))
    m2 = m2_state if m2_state is not None else JT.create_train_state(
        jh, jax.random.PRNGKey(0), ex, ex)
    members = [jh.init(jax.random.PRNGKey(i), ex, ex) for i in (1, 2)]
    jl = jloop_mod.ALinkLoop(
        cfg, featurize=_flat, committee=JCommittee.from_param_list(
            jh, members, cfg.noise), m2_state=m2, pool_uint8=True,
        key=jax.random.PRNGKey(4))
    chead, cparams, student = _heads(jh, members, m2.params)
    tl = tloop_mod.ALinkLoop(
        cfg, featurize=_flat, committee=Committee.from_param_list(
            chead, cparams, cfg.noise), m2_state=T.TrainState(student),
        pool_uint8=True)
    return cfg, jl, tl, m2


def _slabs(p=4, seed=5):
    rng = np.random.default_rng(seed)
    mk = lambda: PersonStacks(  # noqa: E731
        rng.integers(0, 256, (p, 2, SIZE, SIZE, 3)).astype(np.float32),
        np.full(p, 2, np.int32))
    return mk(), mk()


def _jax_stacks(st):
    return jpairs.PersonStacks(st.images, st.counts)


def _assert_m2_close(tl, jl, start_params):
    want = state_dict_from_flax(jax.tree.map(np.asarray,
                                             jl.state.m2_state.params))
    start = state_dict_from_flax(jax.tree.map(np.asarray, start_params))
    got = tl.state.m2_state.module.state_dict()
    scale = max(float((want[k] - start[k]).abs().max()) for k in want)
    assert scale > 0
    for k in want:
        assert float((got[k] - want[k]).abs().max()) <= 1e-3 * scale, k


def test_augmented_finetune_matches_jax(monkeypatch):
    """One slab with augment=True finetunes M2 on the queue and the four
    variant blocks of the queried pairs, the JAX loop fed the same matrices
    through its augment_pairs and the port through ``draw``."""
    cfg, jl, tl, m2 = _jax_and_port_loops(augment=True, batch_send=1)
    mats = _jax_matrices(jax.random.PRNGKey(11), 64, SIZE, SIZE)

    def jax_augment(key, left, right, labels):
        n, h, w, _ = left.shape
        outs = [[left], [right]]
        for block, name in enumerate(("rotation", "shear", "shift")):
            center = name != "shift"
            for side, x in enumerate((left, right)):
                A, t = mats[block, side]
                outs[side].append(jaug._warp_batch(x, jnp.asarray(A[:n]),
                                                   jnp.asarray(t[:n]),
                                                   center))
        return (jnp.concatenate(outs[0]), jnp.concatenate(outs[1]),
                jnp.tile(labels, (4, 1)))

    monkeypatch.setattr(jloop_mod, "augment_pairs", jax_augment)
    monkeypatch.setattr(tloop_mod, "augment_pairs",
                        lambda g, l, r, y: taug.augment_pairs(
                            g, l, r, y, draw=_draw_from(mats)))
    fits = []
    real_fit = tloop_mod.fit
    monkeypatch.setattr(tloop_mod, "fit", lambda st, l, r, y, **k: (
        fits.append((l, r, y)), real_fit(st, l, r, y, **k))[1])
    plain, dig = _slabs()
    jlog = jl.run_iteration(_jax_stacks(plain).take_people([0, 1]),
                            _jax_stacks(dig).take_people([0, 1]))
    tlog = tl.run_iteration(plain.take_people([0, 1]),
                            dig.take_people([0, 1]))
    assert tlog == jlog and tlog.finetuned and tlog.queried > 0
    q = tlog.queried
    assert 5 * q <= 20    # fit's 80 % train part is one batch of <= 16
    (fl, fr, fy), = fits
    assert len(fy) == 5 * q
    _assert_m2_close(tl, jl, m2.params)


def test_every_variant_block_reaches_fit(monkeypatch):
    cfg, _, tl, _ = _jax_and_port_loops(augment=True, batch_send=1)
    fits = []
    monkeypatch.setattr(tloop_mod, "fit", lambda st, l, r, y, **k: (
        fits.append((l, r, y)), (st, []))[1])
    drawn = []
    real = taug.augment_pairs

    def recording(g, left, right, labels):
        out = real(g, left, right, labels)
        drawn.append(out)
        return out

    monkeypatch.setattr(tloop_mod, "augment_pairs", recording)
    plain, dig = _slabs()
    log = tl.run_iteration(plain.take_people([0, 1]), dig.take_people([0, 1]))
    (al, ar, ay), = drawn
    (fl, fr, fy), = fits
    q = log.queried
    assert al.shape[0] == 4 * q
    # Rows: the queue (q), then the 4 variant blocks of q rows each.
    np.testing.assert_array_equal(fl[q:], _flat(al).numpy())
    np.testing.assert_array_equal(fr[q:], _flat(ar).numpy())
    np.testing.assert_array_equal(fy[q:], ay.numpy())
    for b in range(1, 4):
        assert not np.array_equal(fl[q + b * q:q + (b + 1) * q], fl[q:2 * q])


def test_loop_state_from_jax_continues_a_jax_run():
    """A JAX loop's state after slab 1 (a pretrained student with a
    non-trivial Adadelta state and a moved learning rate, counters, the
    queue) carried into a port loop; slab 2 on both."""
    jh = JSiameseHead(widths=(16, 8), dtype=jnp.float32)
    ex = jnp.zeros((2, DF))
    m2 = JT.create_train_state(jh, jax.random.PRNGKey(0), ex, ex)
    rng = np.random.default_rng(2)
    m2, _ = JT.fit(m2, rng.random((40, DF), np.float32),
                   rng.random((40, DF), np.float32),
                   (rng.random(40) > 0.5).astype(np.int32), epochs=2,
                   batch_size=16, key=jax.random.PRNGKey(3))
    m2 = m2.with_learning_rate(0.5)
    cfg, jl, tl, _ = _jax_and_port_loops(m2_state=m2)
    plain, dig = _slabs()
    jl.run_iteration(_jax_stacks(plain).take_people([0, 1]),
                     _jax_stacks(dig).take_people([0, 1]))
    assert jl.state.buffer_size() > 0
    s = jl.state
    start = s.m2_state.params
    loop_state_from_jax(
        tl, jax.tree.map(np.asarray, s.m2_state.params),
        jax.tree.map(np.asarray, s.m2_state.opt_state),
        np.array([s.active_count, s.un_size, s.pool_cursor, s.replay_draws,
                  len(jl.logs)]),
        {"buffer_left": s.buffer_left, "buffer_right": s.buffer_right,
         "buffer_y": s.buffer_y})
    assert tl.state.m2_state.learning_rate == 0.5
    assert tl.state.m2_state.step == int(m2.step)
    queued = tl.state.buffer_size()
    jl.config = tl.config = dataclasses.replace(cfg, batch_send=1)
    jlog = jl.run_iteration(_jax_stacks(plain).take_people([2, 3]),
                            _jax_stacks(dig).take_people([2, 3]))
    tlog = tl.run_iteration(plain.take_people([2, 3]),
                            dig.take_people([2, 3]))
    assert tlog == jlog and tlog.finetuned and tlog.iteration == 1
    assert queued + 2 * tlog.queried <= 20   # one batch of fit
    _assert_m2_close(tl, jl, start)


def test_device_batch_auto_matches_jax_on_a_local_device():
    cfg, _, tl, _ = _jax_and_port_loops()
    loop = tloop_mod.ALinkLoop(
        dataclasses.replace(cfg, device_batch="auto"), featurize=_flat,
        committee=tl.committee, m2_state=tl.state.m2_state)
    assert loop.device_batch == resolve_device_batch(
        "auto", probe=lambda: 1e-4) == 64
    for bad in (0, -3):
        with pytest.raises(ValueError):
            tloop_mod.ALinkLoop(cfg, featurize=_flat, committee=tl.committee,
                                m2_state=tl.state.m2_state, device_batch=bad)


# -- resume within the port --------------------------------------------------

def _port_loop(seed=3, **cfg_kw):
    kw = dict(noise=("gaussian",), image_res=(SIZE, SIZE), feature_res=DF,
              alink_bs=2, batch_send=4, ft_epochs=2, mixture_ratio=1,
              disparity_ratio=0.9, eps=0.0, seed=seed)
    kw.update(cfg_kw)
    cfg = ALinkConfig(**kw)
    g = torch.Generator().manual_seed(0)
    heads = [SiameseHead(DF, (16, 8), dtype=torch.float32, generator=g)
             for _ in range(2)]
    committee = Committee.from_param_list(heads[0], [heads[0].state_dict()],
                                          cfg.noise)

    def replay():
        rng = np.random.default_rng(3)
        while True:
            yield ((rng.random((8, DF)).astype(np.float32),
                    rng.random((8, DF)).astype(np.float32)),
                   (rng.random(8) > 0.5).astype(np.int32))

    return tloop_mod.ALinkLoop(cfg, featurize=_flat, committee=committee,
                               m2_state=T.TrainState(heads[1]),
                               replay_gen=replay(), pool_uint8=True)


def _pool(p=6):
    return _slabs(p=p, seed=8)


def _assert_same_end(a, b):
    """Counters, M2 module and optimizer state bit-equal; ``b``'s logs are
    the tail of ``a``'s, numbered as in ``a``."""
    sa, sb = a.state, b.state
    for f in ("active_count", "un_size", "pool_cursor", "replay_draws"):
        assert getattr(sa, f) == getattr(sb, f), f
    assert sb.logs == sa.logs[len(sa.logs) - len(sb.logs):]
    ma, mb = sa.m2_state.module.state_dict(), sb.m2_state.module.state_dict()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    oa = sa.m2_state.optimizer.state_dict()
    ob = sb.m2_state.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i in oa["state"]:
        for k in oa["state"][i]:
            assert torch.equal(oa["state"][i][k], ob["state"][i][k]), (i, k)
    assert sa.m2_state.step == sb.m2_state.step
    assert a.generator.get_state().equal(b.generator.get_state())
    assert a.host_generator.get_state().equal(b.host_generator.get_state())


def _uninterrupted(tmp_path, **kw):
    loop = _port_loop(**kw)
    loop.run(*_pool(), checkpoint_path=str(tmp_path / "gt"))
    assert len(loop.logs) == 3 and all(lg.finetuned for lg in loop.logs)
    return loop


@pytest.mark.parametrize("augment", [False, True])
def test_kill_after_slab_one_then_resume_is_exact(tmp_path, augment):
    gt = _uninterrupted(tmp_path, augment=augment)
    path = str(tmp_path / "run")
    first = _port_loop(augment=augment)
    real = first.run_iteration

    def killed(*a, **k):
        if first.logs:
            raise RuntimeError("killed")
        return real(*a, **k)

    first.run_iteration = killed
    with pytest.raises(RuntimeError, match="killed"):
        first.run(*_pool(), checkpoint_path=path)
    resumed = _port_loop(augment=augment)
    resumed.run(*_pool(), checkpoint_path=path)
    assert [lg.iteration for lg in resumed.logs] == [1, 2]
    assert resumed.timings.counts["restore"] == 1
    _assert_same_end(gt, resumed)


def test_second_restore_does_not_skip_replay_twice(tmp_path):
    gt = _uninterrupted(tmp_path)
    path = str(tmp_path / "run")
    first = _port_loop()
    first.run_iteration(*(s.take_people([0, 1]) for s in _pool()))
    first.state.pool_cursor = 2
    first.save(path)
    assert first.state.replay_draws == 1
    resumed = _port_loop()
    assert resumed.restore(path) and resumed.restore(path)
    assert resumed._replay_consumed == resumed.state.replay_draws == 1
    resumed.run(*_pool(), checkpoint_path=path)   # a third restore
    _assert_same_end(gt, resumed)


def test_checkpoint_past_the_stop_runs_nothing(tmp_path):
    path = str(tmp_path / "stop")
    loop = _port_loop(active_ratio=0.0)
    loop.run(*_pool(), checkpoint_path=path)
    assert len(loop.logs) == 1
    again = _port_loop(active_ratio=0.0)
    calls = []
    again.run_iteration = lambda *a: calls.append(a)
    state = again.run(*_pool(), checkpoint_path=path)
    assert calls == [] and state.un_size == loop.state.un_size
    assert state.pool_cursor == 2


def test_restore_of_a_missing_path_returns_false(tmp_path):
    loop = _port_loop()
    before = {k: v.clone() for k, v in
              loop.state.m2_state.module.state_dict().items()}
    assert loop.restore(str(tmp_path / "nothing")) is False
    (tmp_path / "half" / "m2").mkdir(parents=True)
    assert loop.restore(str(tmp_path / "half")) is False
    for k, v in loop.state.m2_state.module.state_dict().items():
        assert torch.equal(v, before[k])
    assert loop.state.un_size == 0 and loop._iteration_offset == 0


def test_restore_refuses_a_torn_checkpoint(tmp_path):
    """A save cut between its two writes: ``m2`` from slab 2, ``loop`` from
    slab 1.  restore() refuses the pair and changes nothing, and a run over
    it starts afresh and ends as the uninterrupted run."""
    gt = _uninterrupted(tmp_path)
    path, later = str(tmp_path / "torn"), str(tmp_path / "later")
    first = _port_loop()
    for i, sl in enumerate(([0, 1], [2, 3])):
        first.run_iteration(*(s.take_people(sl) for s in _pool()))
        first.state.pool_cursor = sl[-1] + 1
        first.save(path if i == 0 else later)
    shutil.rmtree(os.path.join(path, "m2"))
    shutil.copytree(os.path.join(later, "m2"), os.path.join(path, "m2"))
    resumed = _port_loop()
    before = {k: v.clone() for k, v in
              resumed.state.m2_state.module.state_dict().items()}
    host = resumed.host_generator.get_state()
    assert resumed.restore(path) is False
    for k, v in resumed.state.m2_state.module.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert resumed.host_generator.get_state().equal(host)
    assert resumed.state.pool_cursor == 0 and resumed._replay_consumed == 0
    resumed.run(*_pool(), checkpoint_path=path)
    assert [lg.iteration for lg in resumed.logs] == [0, 1, 2]
    _assert_same_end(gt, resumed)


def test_queue_and_learning_rate_survive_a_checkpoint(tmp_path):
    loop = _port_loop(batch_send=1000)
    loop.run_iteration(*(s.take_people([0, 1]) for s in _pool()))
    assert loop.state.buffer_size() > 0
    loop.state.m2_state.with_learning_rate(0.04)   # as ReduceLROnPlateau
    loop.save(str(tmp_path / "q"))
    other = _port_loop(batch_send=1000)
    other.state.append_buffer(np.ones((1, DF), np.float32),
                              np.ones((1, DF), np.float32), np.ones(1))
    assert other.restore(str(tmp_path / "q"))
    assert other.state.m2_state.learning_rate == 0.04
    for b in ("buffer_left", "buffer_right", "buffer_y"):
        np.testing.assert_array_equal(getattr(other.state, b),
                                      getattr(loop.state, b))
    # A checkpoint without a queue flushes the live one.
    loop.state.flush_buffer()
    loop.save(str(tmp_path / "q"))
    assert other.restore(str(tmp_path / "q")) and other.state.buffer_size() == 0


def test_metrics_stream_and_heartbeat(tmp_path, capsys):
    path = tmp_path / "m.jsonl"
    with tutils.MetricsLogger(str(path), echo=False) as metrics:
        loop = _port_loop()
        loop.metrics = metrics
        hb = tutils.Heartbeat(str(tmp_path / "hb"), 0, 1)
        state = loop.run(*_pool(), heartbeat=hb)
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["event"] for r in recs] == ["alink_iteration"] * 3
    assert [{k: r[k] for k in state.logs[0]._fields} for r in recs] == [
        lg._asdict() for lg in state.logs]
    assert hb.last_seen(0) is not None
    dead = _port_loop()
    hb = tutils.Heartbeat(str(tmp_path / "hb2"), 0, 2)
    open(tmp_path / "hb2" / "heartbeat_1", "w").close()
    _age(tmp_path / "hb2" / "heartbeat_1", 1200.0)
    with pytest.raises(tutils.PeerFailure):
        dead.run(*_pool(), heartbeat=hb, heartbeat_timeout_s=600.0)
    assert dead.logs == []


# -- debug_nans --------------------------------------------------------------

def test_debug_nans_names_the_selection_probabilities():
    loop = _port_loop(debug_nans=True)
    with torch.no_grad():
        for v in loop.committee.params.values():
            v.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="selection probabilities"):
        loop.run_iteration(*(s.take_people([0, 1]) for s in _pool()))


def test_debug_nans_names_the_finetuned_params(monkeypatch):
    loop = _port_loop(debug_nans=True)

    def diverge(state, *a, **k):
        with torch.no_grad():
            state.module.hidden[0].weight.fill_(float("inf"))
        return state, []

    monkeypatch.setattr(tloop_mod, "fit", diverge)
    with pytest.raises(FloatingPointError, match="finetuned M2 params"):
        loop.run_iteration(*(s.take_people([0, 1]) for s in _pool()))
    unguarded = _port_loop()
    unguarded.run_iteration(*(s.take_people([0, 1]) for s in _pool()))


# -- run_alink supervision ---------------------------------------------------

def _run_cfg(tmp_path, side, **kw):
    base = dict(synthetic_people=6, image_res=(SIZE, SIZE), feature_res=DF,
                noise=("gaussian",), dig_epochs=1, undig_epochs=1,
                ft_epochs=1, alink_bs=2, batch_send=4, batch_size=8,
                train_steps=32, mixture_ratio=1, disparity_ratio=0.5,
                eps=0.02, seed=0,
                out_model=str(tmp_path / side / "post"),
                ensemble_basepath=str(tmp_path / side / "ens"),
                disguised_basemodel=str(tmp_path / side / "dig"),
                loop_checkpoint=str(tmp_path / side / "loop"))
    base.update(kw)
    return ALinkConfig(**base)


class _Ends:
    """The loops ``run_alink`` built, kept for the comparison."""

    def __init__(self, monkeypatch, fail_at=None):
        self.loops = []
        self.faults = []
        ends = self

        def fault():
            ends.faults.append(len(ends.loops))
            raise RuntimeError("injected device fault")

        class Loop(tloop_mod.ALinkLoop):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                ends.loops.append(self)

            def run_iteration(self, *a, **k):
                if fail_at == ("iteration", len(ends.loops), len(self.logs)):
                    fault()
                return super().run_iteration(*a, **k)

            def save(self, path):
                if fail_at == ("save", len(ends.loops)):
                    fault()
                return super().save(path)

        monkeypatch.setattr(talink, "ALinkLoop", Loop)


@pytest.mark.parametrize("fail_at", [("iteration", 1, 1), ("save", 1)],
                         ids=["after_checkpoint", "before_checkpoint"])
def test_supervised_restart_gives_the_uninterrupted_end(tmp_path,
                                                        monkeypatch,
                                                        fail_at):
    gt = _Ends(monkeypatch)
    talink.run_alink(_run_cfg(tmp_path, "gt"), featurize=_flat,
                     device="cpu")
    (gt_loop,) = gt.loops
    assert len(gt_loop.logs) == 3 and gt_loop.logs[0].finetuned
    sup = _Ends(monkeypatch, fail_at)
    state = talink.run_alink(_run_cfg(tmp_path, "sup", max_restarts=1),
                             featurize=_flat, device="cpu")
    # One fault, in the first attempt; the second attempt's loop ends it.
    assert len(sup.loops) == 2 and sup.faults == [1]
    assert state is sup.loops[1].state
    # Before the first checkpoint the second attempt starts over (M2 and
    # the generators reset from their snapshots); after it, it resumes.
    assert len(state.logs) == (3 if fail_at[0] == "save" else 2)
    _assert_same_end(gt_loop, sup.loops[1])


def test_max_restarts_needs_a_loop_checkpoint(tmp_path):
    with pytest.raises(ValueError, match="loop_checkpoint"):
        _run_cfg(tmp_path, "t", max_restarts=1, loop_checkpoint="")
    with pytest.raises(ValueError, match="loop_checkpoint"):
        dataclasses.replace(_run_cfg(tmp_path, "t"), max_restarts=2,
                            loop_checkpoint="")


# -- prefetch ----------------------------------------------------------------

def _both(src_fn, **kw):
    """The JAX prefetcher (no placement) and the port's (CPU) on the same
    source."""
    return (jprefetch.DevicePrefetcher(src_fn(), transfer=None, **kw),
            tprefetch.DevicePrefetcher(src_fn(), device="cpu", **kw))


def test_prefetch_order_and_pytrees_match_jax():
    src = [np.full((4,), i, np.float32) for i in range(10)]
    j, t = _both(lambda: iter(src), depth=3)
    jo, to = list(j), list(t)
    assert len(to) == 10 and all(isinstance(x, torch.Tensor) for x in to)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    trees = [{"x": np.ones((2,)), "y": (np.zeros((1,)), i)} for i in range(3)]
    out = list(tprefetch.DevicePrefetcher(iter(trees), device="cpu"))
    assert out[2]["y"][1] == 2 and isinstance(out[0]["y"], tuple)
    np.testing.assert_array_equal(out[0]["x"].numpy(), [1.0, 1.0])
    assert list(tprefetch.DevicePrefetcher([], device="cpu")) == []


def test_prefetch_exception_propagates_like_jax():
    def gen():
        yield np.zeros((1,))
        raise RuntimeError("decode failed")

    for it in _both(gen):
        next(it)
        with pytest.raises(RuntimeError, match="decode failed"):
            next(it)
        with pytest.raises(StopIteration):
            next(it)


def test_prefetch_depth_bounds_readahead():
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield np.full((1,), i, np.float32)

    it = tprefetch.DevicePrefetcher(gen(), depth=2, device="cpu")
    time.sleep(0.3)
    # queue(depth=2) + one item the worker holds while blocked on put.
    assert len(produced) <= 4
    next(it)
    it.close()
    assert not it._thread.is_alive()


def test_prefetch_close_then_next_race_terminates():
    for round_ in range(30):
        it = tprefetch.DevicePrefetcher(iter([np.ones((1,))] * 5), depth=1,
                                        device="cpu")
        next(it)
        it.close()
        out = []
        th = threading.Thread(target=lambda: out.append(sum(1 for _ in it)),
                              daemon=True)
        th.start()
        th.join(timeout=10.0)
        assert not th.is_alive(), f"iteration after close() hung ({round_})"
        with pytest.raises(StopIteration):
            next(it)


def test_prefetch_context_manager_and_validation():
    with tprefetch.prefetch_to_device([np.ones((1,))] * 3, depth=1,
                                      device="cpu") as it:
        first = next(it)
    assert not it._thread.is_alive()
    np.testing.assert_array_equal(first.numpy(), [1.0])
    for mod, kw in ((jprefetch, {}), (tprefetch, {"device": "cpu"})):
        with pytest.raises(ValueError):
            mod.DevicePrefetcher([], depth=0, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tprefetch.DevicePrefetcher([])


def test_prefetch_overlap_actually_happens():
    events = []
    lock = threading.Lock()

    def gen():
        for i in range(4):
            with lock:
                events.append(i)
            yield np.full((1,), i, np.float32)

    it = tprefetch.DevicePrefetcher(gen(), depth=2, device="cpu")
    next(it)
    time.sleep(0.2)
    with lock:
        assert len(events) >= 2
    assert [int(x) for x in it] == [1, 2, 3]


def test_custom_train_through_the_prefetcher_is_exact():
    d = 16

    def gen():
        rng = np.random.default_rng(0)
        while True:
            yield ((rng.random((8, d)).astype(np.float32),
                    rng.random((8, d)).astype(np.float32)),
                   (rng.random(8) > 0.5).astype(np.int64))

    def train(data_iter):
        g = torch.Generator().manual_seed(0)
        state = T.TrainState(SiameseHead(d, (8, 4), dtype=torch.float32,
                                         generator=g))
        return T.custom_train(state, data_iter, epochs=2, batch_size=8,
                              generator=g, n_steps=24)

    s_raw, l_raw = train(gen())
    with tprefetch.prefetch_to_device(gen(), depth=2, device="cpu") as it:
        s_pre, l_pre = train(it)
    assert l_raw == l_pre
    for a, b in zip(s_raw.module.parameters(), s_pre.module.parameters()):
        assert torch.equal(a, b)


# -- imports -----------------------------------------------------------------

def test_new_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
            "sys.modules['alink_tpu'] = None\n"
            "import alink_tpu_torch.utils, alink_tpu_torch.utils.debug, "
            "alink_tpu_torch.ops.augment, alink_tpu_torch.data.prefetch, "
            "alink_tpu_torch.active.loop, alink_tpu_torch.drivers.alink, "
            "alink_tpu_torch.convert\n"
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
