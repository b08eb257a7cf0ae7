"""The yardstick of ``reembed_swin_b1024`` on the CPU: the Swin's operations
and its windowed core's least time against hand values; the new readers on
CPU profiles of a tiny Swin cell (and None where the program has no such
span); and the check that decides ``correct``: a sound run passes, the
float8 control does not, and neither does a program whose shifted blocks
drop their mask, whose patch merging gathers in another order, or whose
bias table is read transposed.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import importlib

import pytest
import torch

from bench_torch import roofline_swin as RS
from bench_torch import run as R
from bench_torch.reference.numerics import Numerics, exact_f32
from bench_torch.tracing import profiled

CPU = torch.device("cpu")
SEED = 3_141_592_653
CELL = "reembed_swin_b1024"


def test_swin_s_flops_at_112():
    st = [(56, 96, 2), (28, 192, 2), (14, 384, 18), (7, 768, 2)]
    assert [s[:3] for s in RS.stages()] == st
    patch = 2 * 56 * 56 * 12 * 96
    blocks = sum(d * (2 * s * s * (3 * c * c + c * c + 8 * c * c)
                      + 4 * s * s * 49 * c) for s, c, d in st)
    merges = sum(2 * (s // 2) ** 2 * 4 * c * 2 * c for s, c, _ in st[:3])
    hand = patch + blocks + merges + 2 * 768 * 512
    assert hand == 17_459_324_928
    assert RS.swin_flops() == hand
    # The tiny cell: 28^2 at patch 2, width 32, depths (2, 2).
    tiny = (2 * 196 * 12 * 32
            + 2 * (2 * 196 * 12 * 32 * 32 + 4 * 196 * 49 * 32)
            + 2 * 49 * 4 * 32 * 64
            + 2 * (2 * 49 * 12 * 64 * 64 + 4 * 49 * 49 * 64)
            + 2 * 64 * 16)
    assert RS.swin_flops(28, 2, 32, (2, 2), 7, 4, 16) == tiny


def test_wattn_bound_is_the_bf16_bytes_at_every_batch():
    # 4 T 49 C operations against 8 T C bytes: 24.5 operations a byte,
    # under the card's 989e12 / 3.35e12 = 295.
    assert RS.wattn_flops(3136, 96) == 4 * 3136 * 49 * 96
    assert RS.wattn_bytes(3136, 96) == 8 * 3136 * 96
    for n in (1, 64, 1024):
        assert RS.wattn_bound_s(n, 56, 96) == pytest.approx(
            n * 8 * 3136 * 96 / 3.35e12)
    per_chip = 8 * (2 * 3136 * 96 + 2 * 784 * 192 + 18 * 196 * 384
                    + 2 * 49 * 768)
    assert RS.wattn_bound_per_forward_s(1024) == pytest.approx(
        1024 * per_chip / 3.35e12)
    assert RS.wattn_bound_per_forward_s(1024) * 1e3 == pytest.approx(
        5.7055, abs=1e-4)


def tiny(depths=(2, 2)) -> dict:
    c = R.load_cell(CELL)
    cfg, t = c["config"], c["traffic"]
    cfg["embedder"].update(input_size=[28, 28], embed_dim=32,
                           depths=list(depths), num_heads=[2, 4],
                           embedding_dim=16)
    cfg["check"]["wattn_blocks"] = [[0, 1], [1, 1]]
    t.update(chip=[28, 28, 3], batch=4, pool_batches=2, capture_within=1,
             capture_calls=1, tail_calls=2)
    return c


def _driver(c):
    cfg, t = c["config"], c["traffic"]
    system = importlib.import_module(
        f"bench_torch.systems.{cfg['system']}").System(cfg, SEED, CPU)
    return importlib.import_module(
        f"bench_torch.drivers.{t['driver']}").Driver(system, t, SEED, CPU)


@pytest.fixture(scope="module")
def traced():
    c = tiny()
    driver = _driver(c)
    driver.setup()
    win = driver.window(0.5)
    units, trace = profiled(driver.tail, CPU, host=False)
    span_units, spans = profiled(driver.tail, CPU)
    spans.units = span_units
    return R.Run(window=win, trace=trace, spans=spans, units=units,
                 system=driver.sys, driver=driver, config=c["config"],
                 traffic=c["traffic"])


def test_the_cell_is_in_the_benchmark():
    c = R.load_cell(CELL)
    assert c["cell"]["chips"] == 1 and c["config"]["system"] == "swin_embed"
    assert [m["name"] for m in c["e2e"]] == ["faces_per_s", "setup_s"]
    assert sorted(m["name"] for m in c["per_layer"]) == sorted(
        f"{m}.reembed_swin" for m in ("embed_device_ms", "wattn_device_ms",
                                      "wattn_roofline", "mfu_pct",
                                      "device_idle_pct"))
    assert set(c["config"]["limits"]) == {"embed_gap", "wattn_gap"}


def test_readers_on_a_cpu_profile(traced):
    from bench_torch import program_device as D

    hits = [e for e in traced.spans.host if e.name == "alink/swin.attn"]
    assert len(hits) == 4 * traced.spans.units    # a block each, 4 blocks
    embeds = [e for e in traced.spans.host if e.name == "alink/embed"]
    assert len(embeds) == traced.spans.units
    # No device on the CPU: no kernel time inside the spans.
    assert D.span_device_s(traced, "embed") == 0.0
    assert R.reader("embed_device_ms.reembed_swin")(traced) == 0.0
    assert R.reader("wattn_device_ms.reembed_swin")(traced) == 0.0
    assert R.reader("wattn_roofline.reembed_swin")(traced) is None
    assert R.reader("device_idle_pct.reembed_swin")(traced) == 100.0
    w = traced.window.counters
    assert R.reader("mfu_pct.reembed_swin")(traced) == pytest.approx(
        100.0 * RS.swin_flops(28, 2, 32, (2, 2), 7, 4, 16) * w["faces"]
        / w["window_s"] / 989e12)


def test_roofline_reader_scales_the_bound_by_the_span_time(traced,
                                                           monkeypatch):
    from bench_torch import program_device as D

    monkeypatch.setattr(D, "span_device_s", lambda run, name: 1e-3)
    bound = 2 * RS.wattn_bound_s(4, 14, 32) + 2 * RS.wattn_bound_s(4, 7, 64)
    want = 100.0 * bound * traced.spans.units / 1e-3
    assert R.reader("wattn_roofline.reembed_swin")(traced) == \
        pytest.approx(want)


def test_readers_give_none_without_the_spans():
    _, empty = profiled(lambda: torch.ones(4).sum(), CPU)
    empty.units = 1
    bare = R.Run(spans=empty, config=tiny()["config"],
                 traffic=tiny()["traffic"])
    for name in ("embed_device_ms.reembed_swin",
                 "wattn_device_ms.reembed_swin",
                 "wattn_roofline.reembed_swin"):
        assert R.reader(name)(bare) is None


# -- the check ----------------------------------------------------------------

def correct(c, seconds=1.0) -> dict:
    return R.run_cell(c, SEED, seconds, False, CPU)


def test_a_sound_run_is_correct():
    res = correct(tiny())
    assert res["correct"], res["checks"]
    # The tiny cell's products run in bf16 on the CPU too; its core is the
    # plain float32 one on the program's own qkv.
    assert 0 < res["checks"]["embed_gap"]["value"] < 0.02
    assert res["checks"]["wattn_gap"]["value"] < 1e-5


def test_the_control_is_not_correct():
    """The reference in float8 in the program's place fails both limits."""
    c = tiny()
    driver = _driver(c)
    driver.setup()
    driver.window(0.5)
    driver.release()
    with exact_f32():
        got = driver.check(Numerics("f32"), substitute=Numerics("fp8"))
    limits = c["config"]["limits"]
    assert got["wattn_gap"] > limits["wattn_gap"]
    assert got["embed_gap"] > limits["embed_gap"], got


def _fault_fails(monkeypatch, target, name, fn) -> dict:
    monkeypatch.setattr(target, name, fn)
    res = correct(tiny())
    assert not res["correct"], res["checks"]
    return res["checks"]


def test_a_shifted_block_without_its_mask(monkeypatch):
    from alink_tpu_torch.ops import attention as A

    checks = _fault_fails(monkeypatch, A, "shift_mask",
                          lambda size, window, shift: torch.zeros(
                              (size // window) ** 2, window ** 2,
                              window ** 2))
    assert checks["wattn_gap"]["value"] > 10 * checks["wattn_gap"]["limit"]


def test_patch_merging_in_another_order(monkeypatch):
    from alink_tpu_torch.models import swin

    def swapped(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 0::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x).to(
            self.reduction.weight.dtype)).float()

    checks = _fault_fails(monkeypatch, swin.PatchMerging, "forward",
                          swapped)
    assert checks["embed_gap"]["value"] > checks["embed_gap"]["limit"]


def test_a_bias_table_read_transposed(monkeypatch):
    from alink_tpu_torch.ops import attention as A

    index = A.relative_position_index
    checks = _fault_fails(monkeypatch, A, "relative_position_index",
                          lambda window: index(window).t())
    assert checks["wattn_gap"]["value"] > checks["wattn_gap"]["limit"]
