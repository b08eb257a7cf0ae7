"""The yardstick of ``serve_vitl_typical`` on the CPU: the ViT's operations
and its attention core's least time against hand values; the new readers
on CPU profiles of a tiny ViT cell (and None where the program has no
such span); and the check that decides ``correct``: a sound run passes,
the float8 control does not, and neither does a run with an embedding
altered where it is produced or with its attention core computed in bf16.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import importlib

import pytest
import torch
import torch.nn.functional as F

from bench_torch import roofline as RR
from bench_torch import roofline_vit as RV
from bench_torch import run as R
from bench_torch.reference.numerics import Numerics, exact_f32
from bench_torch.tracing import profiled

CPU = torch.device("cpu")
SEED = 2_718_281_828
CELL = "serve_vitl_typical"


def test_vit_l_flops_at_112():
    t, d, m = 144, 768, 3072
    patch = 2 * t * (3 * 9 * 9) * d
    block = 2 * t * (d * 3 * d + d * d + d * m + m * d) + 4 * t * t * d
    head = 2 * t * d * d + 2 * d * 512
    hand = patch + 24 * block + head
    assert hand == 50_675_589_120
    assert RV.vit_flops() == hand
    assert RV.vit_flops(112, 9, 32, 2, 64, 16) == (
        2 * t * 243 * 32 + 2 * (2 * t * (32 * 96 + 32 * 32 + 2 * 32 * 64)
                                + 4 * t * t * 32)
        + 2 * t * 32 * 32 + 2 * 32 * 16)


def test_attention_bound_is_the_bf16_bytes_at_every_batch():
    # 4 T^2 D operations against 4 T D bf16 values a face: T / 2 = 72
    # operations a byte, under the card's 494.7e12 / 3.35e12 = 147.7.
    assert RV.attn_flops(144, 768) == 4 * 144 * 144 * 768
    assert RV.attn_bytes(144, 768) == 4 * 144 * 768 * 2
    for n in (1, 64, 256):
        assert RV.attn_bound_s(n, 144, 768) == pytest.approx(
            n * 884_736 / 3.35e12)
    assert RV.attn_bound_s(256, 144, 768) * 1e6 == pytest.approx(67.61,
                                                                  abs=0.01)
    # The operations alone at batch 256: 33.0 us at the TF32 peak.
    assert 256 * RV.attn_flops(144, 768) / 494.7e12 * 1e6 == pytest.approx(
        32.96, abs=0.01)


def tiny(depth: int = 2) -> dict:
    c = R.load_cell(CELL)
    cfg, t = c["config"], c["traffic"]
    cfg["embedder"].update(embed_dim=32, depth=depth, num_heads=2,
                           mlp_dim=64, embedding_dim=16)
    t.update(photo=[64, 64, 3], batch=4, pool_batches=2, capture_within=1,
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


def test_readers_on_a_cpu_profile(traced):
    from bench_torch import program_device as D

    hits = [e for e in traced.spans.host if e.name == "alink/vit.attn"]
    assert len(hits) == 2 * traced.spans.units    # a block each, 2 blocks
    # No device on the CPU: no kernel time inside the spans.
    assert D.span_device_s(traced, "embed") == 0.0
    assert R.reader("embed_device_ms.serve_vit")(traced) == 0.0
    assert R.reader("attn_device_ms.serve_vit")(traced) == 0.0
    assert R.reader("attn_roofline.serve_vit")(traced) is None
    assert R.reader("device_idle_pct.serve_vit")(traced) == 100.0
    e, w = traced.config["embedder"], traced.window.counters
    per_face = (RR.cascade_flops(64, 64, 40, 0.709, 32, 8)
                + RV.vit_flops(112, 9, 32, e["depth"], 64, 16))
    assert R.reader("mfu_pct.serve_vit")(traced) == pytest.approx(
        100.0 * per_face * w["faces"] / w["window_s"] / 989e12)


def test_roofline_reader_scales_the_bound_by_the_span_time(traced,
                                                           monkeypatch):
    from bench_torch import program_device as D

    monkeypatch.setattr(D, "span_device_s", lambda run, name: 1e-3)
    want = 100.0 * 2 * RV.attn_bound_s(4, 144, 32) * traced.spans.units \
        / 1e-3
    assert R.reader("attn_roofline.serve_vit")(traced) == pytest.approx(want)


def test_readers_give_none_without_the_spans():
    _, empty = profiled(lambda: torch.ones(4).sum(), CPU)
    empty.units = 1
    bare = R.Run(spans=empty, config=tiny()["config"],
                 traffic=tiny()["traffic"])
    for name in ("embed_device_ms.serve_vit", "attn_device_ms.serve_vit",
                 "attn_roofline.serve_vit"):
        assert R.reader(name)(bare) is None


# -- the check ------------------------------------------------------------------

def correct(c, seconds=2.0) -> dict:
    return R.run_cell(c, SEED, seconds, False, CPU)


def test_a_sound_run_is_correct():
    res = correct(tiny())
    assert res["correct"], res["checks"]
    assert res["checks"]["attn_gap"]["value"] < 1e-5


def test_the_control_is_not_correct():
    """The reference in float8 in the program's place fails a limit, at
    the published depth (24 blocks, tiny widths)."""
    c = tiny(depth=24)
    driver = _driver(c)
    driver.setup()
    driver.window(1.0)
    driver.release()
    with exact_f32():
        got = driver.check(Numerics("f32"), substitute=Numerics("fp8"))
    limits = c["config"]["limits"]
    assert got["attn_gap"] > limits["attn_gap"]
    assert any(got[k] > limits[k] for k in limits if k != "attn_gap"), got


def test_an_embedding_altered_where_it_is_produced(monkeypatch):
    from alink_tpu_torch.models import vit

    forward = vit.FaceViT.forward

    def broken(self, x):
        out = forward(self, x).clone()
        out[0] = -out[0]
        return out

    monkeypatch.setattr(vit.FaceViT, "forward", broken)
    res = correct(tiny())
    assert res["checks"]["embed_gap"]["value"] > 1.0
    assert not res["correct"]


def test_an_attention_core_computed_in_bf16(monkeypatch):
    from alink_tpu_torch.models import vit

    def bf16_core(self, q, k, v):
        n, h, t, d = q.shape
        out = F.scaled_dot_product_attention(*(a.to(torch.bfloat16)
                                               for a in (q, k, v)))
        return out.transpose(1, 2).reshape(n, t, h * d).float()

    monkeypatch.setattr(vit.AttentionCore, "forward", bf16_core)
    res = correct(tiny())
    assert res["checks"]["attn_gap"]["value"] > 20 * res["checks"][
        "attn_gap"]["limit"]
    assert not res["correct"]
