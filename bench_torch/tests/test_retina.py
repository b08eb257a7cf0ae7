"""The yardstick of ``serve_retina_r100`` on the CPU: RetinaFace-R50's
operations and the NMS kernel's least time against hand values; the new
readers on CPU profiles of a tiny RetinaFace cell (and None where the
program has no such span or kernel); and the check that decides
``correct``: a sound run passes, the float8 control does not, and neither
does a run whose NMS is skipped, whose top-k is cut, whose heads are
rounded to float8, whose landmarks are moved at a few anchors of one
photo, or whose boxes are altered for half a batch.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import importlib

import pytest
import torch

from bench_torch import roofline as RR
from bench_torch import roofline_retina as RT
from bench_torch import run as R
from bench_torch.reference.numerics import Numerics, exact_f32
from bench_torch.tracing import profiled

CPU = torch.device("cpu")
SEED = 3_141_592_653
CELL = "serve_retina_r100"


def test_retina_flops_at_640():
    # stem 1.93, K3 46.56, strided blocks 18.25, FPN 12.37, SSH 9.29,
    # heads 0.14 GFLOP a photo.
    k3 = 2 * 160 ** 2 * (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256) \
        + 12 * 2 * 160 ** 2 * (256 * 64 + 9 * 64 * 64 + 64 * 256)
    assert sum(RR.k3_flops(1, *b) for b in RT.retina_stride1_blocks()) == k3
    assert k3 == 46_556_774_400
    assert RT.retina_flops() == 88_529_305_600
    assert len(RT.retina_stride1_blocks()) == 13


def test_nms_bound_is_the_overlap_tests_at_the_float32_rate():
    k = 5000
    assert RT.mask_words(k) == sum(64 * (79 - r) for r in range(78)) + 8
    ops = 256 * k * (k - 1) / 2 * 16
    assert RT.nms_ops(256, k) == ops
    assert RT.nms_bound_s(256, k) == pytest.approx(ops / 67e12)
    assert RT.nms_bound_s(256, k) * 1e3 == pytest.approx(0.7640, abs=1e-4)
    # One candidate: no test, the bytes bound it.
    assert RT.nms_bound_s(1, 1) == pytest.approx((18 + 16) / 3.35e12)


def tiny() -> dict:
    c = R.load_cell(CELL)
    cfg, t = c["config"], c["traffic"]
    d = cfg["detector"]
    d["backbone"]["widths"] = [8, 16, 32, 64]
    d["fpn"]["out_channels"] = 16
    d.update(input_size=[96, 96], top_k=64, keep_top_k=16)
    cfg["embedder"].update(stage_sizes=[1, 1, 1, 1],
                           stage_widths=[8, 8, 16, 16], embedding_dim=16)
    t.update(photo=[96, 96, 3], batch=2, pool_batches=2, capture_within=1,
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
    for span in ("detect", "retina.backbone", "retina.post", "nms", "embed"):
        hits = [e for e in traced.spans.host if e.name == "alink/" + span]
        assert len(hits) == traced.spans.units, span
    # No device on the CPU: no kernel time inside the spans, no K3 or
    # NMS kernel in the card-only trace.
    assert R.reader("detect_device_ms.serve_retina")(traced) == 0.0
    assert R.reader("embed_device_ms.serve_retina")(traced) == 0.0
    assert R.reader("k3_roofline.serve_retina")(traced) is None
    assert R.reader("nms_roofline.serve_retina")(traced) is None
    assert R.reader("k2_roofline.serve_retina")(traced) is None
    assert R.reader("launches_per_batch.serve_retina")(traced) is None
    assert R.reader("post_idle_ms.serve_retina")(traced) > 0.0
    assert R.reader("device_idle_pct.serve_retina")(traced) == 100.0
    d, e = traced.config["detector"], traced.config["embedder"]
    w = traced.window.counters
    per_face = (RT.retina_flops(96, (3, 4, 6, 3), (8, 16, 32, 64), 16)
                + RR.arcface_flops((1, 1, 1, 1), (8, 8, 16, 16), 112, 16))
    assert R.reader("mfu_pct.serve_retina")(traced) == pytest.approx(
        100.0 * per_face * w["faces"] / w["window_s"] / 989e12)


def test_roofline_readers_scale_the_bound_by_the_kernel_time(traced,
                                                             monkeypatch):
    monkeypatch.setattr(traced.trace, "kernel", lambda pattern: (1e-3, 26))
    blocks = RT.retina_stride1_blocks(96, (3, 4, 6, 3), (8, 16, 32, 64))
    bound = sum(RR.bound_s(RR.k3_flops(2, *b), 989.0,
                           RT.k3_bytes(2, *b))[0] for b in blocks)
    assert R.reader("k3_roofline.serve_retina")(traced) == pytest.approx(
        100.0 * bound * traced.units / 1e-3)
    assert R.reader("nms_roofline.serve_retina")(traced) == pytest.approx(
        100.0 * RT.nms_bound_s(2, 64) * traced.units / 1e-3)
    # K2: each tail call's chips written (2 x 112^2 x 3 float32) and the
    # photo pixels under their taps, at most each whole 96^2 photo.
    needed = traced.driver.k2_input_bytes()
    assert len(needed) == traced.traffic["pool_batches"]
    assert all(0 < b <= 2 * 96 * 96 * 3 * 4 for b in needed), needed
    bound = sum(RR.bound_s(RR.k2_flops(2, 112, 112, 3), RR.H100_F32_TFLOPS,
                           needed[i % len(needed)] + 2 * 112 * 112 * 3 * 4)[0]
                for i in range(traced.units))
    assert R.reader("k2_roofline.serve_retina")(traced) == pytest.approx(
        100.0 * bound / 1e-3)


def test_launches_reader_counts_kernels_per_call(traced, monkeypatch):
    monkeypatch.setattr(traced.trace, "launches", lambda: 30)
    assert R.reader("launches_per_batch.serve_retina")(traced) == \
        pytest.approx(30 / traced.units)


def test_readers_give_none_without_the_spans():
    _, empty = profiled(lambda: torch.ones(4).sum(), CPU)
    empty.units = 1
    bare = R.Run(spans=empty, config=tiny()["config"],
                 traffic=tiny()["traffic"])
    for name in ("detect_device_ms.serve_retina",
                 "post_idle_ms.serve_retina",
                 "embed_device_ms.serve_retina"):
        assert R.reader(name)(bare) is None


# -- the check -----------------------------------------------------------------

def correct(c, seconds=1.0) -> dict:
    return R.run_cell(c, SEED, seconds, False, CPU)


def test_a_sound_run_is_correct():
    res = correct(tiny())
    assert res["correct"], res["checks"]
    assert res["checks"]["dets_mismatch"]["value"] == 0


def test_the_control_is_not_correct():
    """The references in float8 in the program's place fail every limit of
    the detector and of the chips (the tiny four-unit embedder's float8
    gap stays near its limit; the published r100's is twice it)."""
    c = tiny()
    driver = _driver(c)
    driver.setup()
    driver.window(0.5)
    driver.release()
    with exact_f32():
        got = driver.check(Numerics("f32"), substitute=Numerics("fp8"))
    limits = c["config"]["limits"]
    for k in ("heads_gap", "heads_max_gap", "boxes_gap", "dets_mismatch",
              "chip_gap"):
        assert got[k] > limits[k], (k, got[k])


def test_nms_skipped(monkeypatch):
    from alink_tpu_torch.detect import retina

    monkeypatch.setattr(retina, "nms", lambda b, s, v, t: v.clone())
    res = correct(tiny())
    assert res["checks"]["dets_mismatch"]["value"] > 0
    assert not res["correct"]


def test_top_k_cut(monkeypatch):
    """The top-k cut to a quarter of its budget (5,000 to 1,250 at the
    published size)."""
    from alink_tpu_torch.detect import retina

    init = retina.RetinaFaceDetector.__init__

    def cut(self, model, cfg):
        init(self, model, retina.RetinaConfig(**{**cfg.__dict__,
                                                 "top_k": cfg.top_k // 4}))

    monkeypatch.setattr(retina.RetinaFaceDetector, "__init__", cut)
    res = correct(tiny())
    assert res["checks"]["dets_mismatch"]["value"] > 0
    assert not res["correct"]


def test_heads_rounded_to_float8(monkeypatch):
    from alink_tpu_torch.models import retinaface

    forward = retinaface.RetinaFaceR50.forward

    def fp8(self, images):
        return tuple(Numerics("fp8").q(t) for t in forward(self, images))

    monkeypatch.setattr(retinaface.RetinaFaceR50, "forward", fp8)
    res = correct(tiny())
    assert res["checks"]["heads_gap"]["value"] > res["checks"][
        "heads_gap"]["limit"]
    assert not res["correct"]


def test_a_few_anchors_of_one_photo_altered(monkeypatch):
    """Two anchors of one photo with their landmark offsets moved by the
    head's widest value: the widest form (``heads_max_gap``) fails, as it
    does at the published size, where such a fault in 2 of 256 x 16,800
    anchors leaves the root-mean-square form far below its limit."""
    from alink_tpu_torch.models import retinaface

    forward = retinaface.RetinaFaceR50.forward

    def altered(self, images):
        loc, conf, landms = forward(self, images)
        landms = landms.clone()
        landms[0, :2] += landms.abs().max()
        return loc, conf, landms

    monkeypatch.setattr(retinaface.RetinaFaceR50, "forward", altered)
    res = correct(tiny())
    assert res["checks"]["heads_max_gap"]["value"] > res["checks"][
        "heads_max_gap"]["limit"]
    assert not res["correct"]


def test_half_a_batch_of_boxes_altered(monkeypatch):
    from alink_tpu_torch.detect import retina

    decode = retina.RetinaFaceDetector.decode

    def altered(self, *args):
        boxes, scores, marks = decode(self, *args)
        boxes = boxes.clone()
        boxes[: boxes.shape[0] // 2] += 0.5
        return boxes, scores, marks

    monkeypatch.setattr(retina.RetinaFaceDetector, "decode", altered)
    res = correct(tiny())
    assert res["checks"]["boxes_gap"]["value"] > res["checks"][
        "boxes_gap"]["limit"]
    assert not res["correct"]
