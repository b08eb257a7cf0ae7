"""The LayerNorms' yardstick in ``reembed_swin_b1024`` on the CPU: the bytes
bound of a forward's 53 norms against hand values, and the two readers of
the ``alink/ln`` spans on a CPU profile of a tiny Swin cell (None where the
program opens no such span).

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import importlib

import pytest
import torch

from bench_torch import roofline_ln as RL
from bench_torch import run as R
from bench_torch.tracing import profiled

CPU = torch.device("cpu")
SEED = 2_718_281_828
CELL = "reembed_swin_b1024"
READERS = ("ln_device_ms.reembed_swin", "ln_roofline.reembed_swin")


def test_ln_bound_counts_each_norm_once_at_its_dtypes():
    norms = RL.ln_norms()
    assert len(norms) == 53
    # The patch norm: bf16 in, float32 out.  Blocks and merges: float32
    # in, bf16 out.  The final norm: float32 both ways.
    hand = (3136 * 96 * 6
            + 4 * 3136 * 96 * 6 + 784 * 384 * 6
            + 4 * 784 * 192 * 6 + 196 * 768 * 6
            + 36 * 196 * 384 * 6 + 49 * 1536 * 6
            + 4 * 49 * 768 * 6
            + 49 * 768 * 8)
    assert hand == 33_266_688
    assert RL.ln_bytes_per_chip() == hand
    assert RL.ln_bound_per_forward_s(1024) == pytest.approx(
        1024 * hand / 3.35e12)
    assert RL.ln_bound_per_forward_s(1024) * 1e3 == pytest.approx(
        10.1687, abs=1e-4)
    # The tiny cell: 28^2 at patch 2, width 32, depths (2, 2).
    tiny = (196 * 32 * 6 + 4 * 196 * 32 * 6 + 49 * 128 * 6
            + 4 * 49 * 64 * 6 + 49 * 64 * 8)
    assert RL.ln_bytes_per_chip(28, 2, 32, (2, 2), 7) == tiny


def _tiny() -> dict:
    c = R.load_cell(CELL)
    cfg, t = c["config"], c["traffic"]
    cfg["embedder"].update(input_size=[28, 28], embed_dim=32,
                           depths=[2, 2], num_heads=[2, 4],
                           embedding_dim=16)
    cfg["check"]["wattn_blocks"] = [[0, 1], [1, 1]]
    t.update(chip=[28, 28, 3], batch=4, pool_batches=2, capture_within=1,
             capture_calls=1, tail_calls=2)
    return c


def test_the_cell_reads_the_ln_metrics():
    names = {m["name"] for m in R.load_cell(CELL)["per_layer"]}
    assert set(READERS) <= names
    for cell in ("serve_vitl_typical", "serve_r100_typical"):
        got = {m["name"] for m in R.load_cell(cell)["per_layer"]}
        assert not set(READERS) & got


def test_ln_readers_give_none_without_the_span():
    _, empty = profiled(lambda: torch.ones(4).sum(), CPU)
    empty.units = 1
    c = _tiny()
    bare = R.Run(spans=empty, config=c["config"], traffic=c["traffic"])
    for name in READERS:
        assert R.reader(name)(bare) is None


def test_ln_readers_on_a_cpu_profile():
    from bench_torch import program_device as D

    c = _tiny()
    system = importlib.import_module(
        f"bench_torch.systems.{c['config']['system']}").System(
            c["config"], SEED, CPU)
    driver = importlib.import_module(
        f"bench_torch.drivers.{c['traffic']['driver']}").Driver(
            system, c["traffic"], SEED, CPU)
    driver.setup()
    units, spans = profiled(driver.tail, CPU)
    spans.units = units
    run = R.Run(spans=spans, config=c["config"], traffic=c["traffic"])
    hits = [e for e in spans.host if e.name == "alink/ln"]
    # The patch norm, 2 a block over 4 blocks, 1 merge, the final norm.
    assert len(hits) == 11 * units
    # No device on the CPU: no kernel time inside the spans.
    assert D.span_device_s(run, "ln") == 0.0
    assert R.reader("ln_device_ms.reembed_swin")(run) == 0.0
    assert R.reader("ln_roofline.reembed_swin")(run) is None
    driver.release()


def test_ln_roofline_scales_the_bound_by_the_span_time(monkeypatch):
    from bench_torch import program_device as D

    monkeypatch.setattr(D, "span_device_s", lambda run, name: 2e-3)
    _, empty = profiled(lambda: torch.ones(4).sum(), CPU)
    empty.units = 3
    c = _tiny()
    run = R.Run(spans=empty, config=c["config"], traffic=c["traffic"])
    bound = 4 * RL.ln_bytes_per_chip(28, 2, 32, (2, 2), 7) / 3.35e12
    assert R.reader("ln_roofline.reembed_swin")(run) == pytest.approx(
        100.0 * bound * 3 / 2e-3)
