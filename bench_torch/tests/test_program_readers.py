"""The readers of the program's own spans and counters, on CPU profiles of
a tiny serving pipeline and a tiny A2 slab, with ``Run`` built as
``run.py`` builds it; and None where the program has no such span or
counter, as a program without them gives.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import importlib

import pytest
import torch

from bench_torch import program_spans as PS
from bench_torch import run as R
from bench_torch.tracing import profiled

CPU = torch.device("cpu")
SEED = 3_141_592_653


def tiny_run(name: str, window_s: float = 0.5):
    """Set-up, a short window and both profiled tails of a tiny cell."""
    c = R.load_cell(name)
    cfg, t = c["config"], c["traffic"]
    if "embedder" in cfg:
        cfg["embedder"]["stage_sizes"] = [1, 1, 1, 1]
        t.update(photo=[48, 48, 3], batch=3, pool_batches=2, tail_calls=2)
    else:
        cfg["teacher"].update(stage_sizes=[1, 1, 1, 1], input=[32, 32, 3])
        cfg.update(de_pixel_count=1, de_popsize=5, de_maxiter=2)
        t.update(image=[32, 32, 3], people=12, replay_people=4,
                 people_per_slab=4, pairs_per_slab=4, tail_slabs=1)
    system = importlib.import_module(
        f"bench_torch.systems.{cfg['system']}").System(cfg, SEED, CPU)
    driver = importlib.import_module(
        f"bench_torch.drivers.{t['driver']}").Driver(system, t, SEED, CPU)
    driver.setup()
    win = driver.window(window_s)
    units, trace = profiled(driver.tail, CPU, host=False)
    span_units, spans = profiled(driver.tail, CPU)
    spans.units = span_units
    return R.Run(window=win, trace=trace, spans=spans, units=units,
                 system=system, driver=driver, config=cfg, traffic=t)


@pytest.fixture(scope="module")
def serve():
    return tiny_run("serve_r100_typical")


@pytest.fixture(scope="module")
def a2():
    return tiny_run("alink_vgg_a2")


def test_span_idle_is_wall_less_device_overlap():
    segs = [(0.0, 10.0), (20.0, 30.0), (40.0, 50.0)]
    assert PS.busy_us(segs, 5.0, 45.0) == 5.0 + 10.0 + 5.0
    assert PS.busy_us(segs, 10.0, 20.0) == 0.0
    assert PS.busy_us(segs, 22.0, 25.0) == 3.0
    assert PS.busy_us([], 0.0, 9.0) == 0.0


def test_serving_readers(serve):
    from alink_tpu_torch.utils.profiling import counters

    sweeps = R.reader("nms_sweeps_per_batch.serve")(serve)
    c = counters()
    assert sweeps == c["nms.sweeps"] / c["pipeline.calls"]
    # Four NMS calls a pipeline call, each one sweep or more.
    assert sweeps >= 4
    idle = R.reader("detect_idle_ms.serve")(serve)
    walls = PS.intervals(serve.spans, "detect")
    assert len(walls) == serve.spans.units == 2
    # On the CPU no device activity: the whole span is idle.
    assert idle == pytest.approx(
        1e-3 * sum(e - s for s, e in walls) / len(walls))
    assert idle > 0


def test_a2_readers(a2):
    from alink_tpu_torch.utils.profiling import counters

    pct = R.reader("de_evals_pct.alink")(a2)
    c = counters()
    assert pct == 100.0 * c["de.evals"] / c["de.budget"]
    assert 0 < pct <= 100
    idle = R.reader("de_idle_ms.alink")(a2)
    walls = PS.intervals(a2.spans, "de")
    assert len(walls) == 1     # one batched DE a slab, one tail slab
    assert idle == pytest.approx(1e-3 * (walls[0][1] - walls[0][0]))


def test_idle_subtracts_device_segments(a2):
    (s, e), = PS.intervals(a2.spans, "de")
    whole = R.Run(spans=a2.spans)
    a2.spans.segments, saved = [(s - 1.0, e + 1.0)], a2.spans.segments
    try:
        assert PS.idle_ms(whole, "de") == 0.0
        a2.spans.segments = [(s, s + 0.25 * (e - s))]
        assert PS.idle_ms(whole, "de") == pytest.approx(
            1e-3 * 0.75 * (e - s))
    finally:
        a2.spans.segments = saved


def test_readers_give_none_without_spans_or_counters(monkeypatch, serve):
    from alink_tpu_torch.utils import profiling

    _, empty = profiled(lambda: torch.ones(4).sum(), CPU)
    bare = R.Run(spans=empty)
    for name in ("detect_idle_ms.serve", "de_idle_ms.alink"):
        assert R.reader(name)(bare) is None
    assert R.reader("de_idle_ms.alink")(serve) is None   # no DE there
    monkeypatch.delattr(profiling, "counters")
    for name in ("nms_sweeps_per_batch.serve", "de_evals_pct.alink"):
        assert R.reader(name)(serve) is None
    monkeypatch.setattr(profiling, "counters", lambda: {"nms.sweeps": 4},
                        raising=False)
    assert R.reader("nms_sweeps_per_batch.serve")(serve) is None
