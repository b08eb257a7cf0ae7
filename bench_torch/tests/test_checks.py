"""The check that decides ``correct``, driven on the CPU at sizes a test
run holds (the program's plain versions stand in for its kernels): a
sound run is correct; the control (the reference in float8 in the
program's place) is not; and a run with its timed path broken underneath
is not, once for each fault the cell can have.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import pytest
import torch

from bench_torch import run as R
from bench_torch.reference.numerics import Numerics, exact_f32

CPU = torch.device("cpu")
SEED = 2_718_281_828


def tiny(name: str, depth=(1, 1, 1, 1)) -> dict:
    c = R.load_cell(name)
    cfg, t = c["config"], c["traffic"]
    if "embedder" in cfg:
        cfg["embedder"]["stage_sizes"] = list(depth)
        t.update(photo=[64, 64, 3], batch=4, pool_batches=2,
                 capture_within=1, capture_calls=1, tail_calls=1)
    else:
        cfg["teacher"]["stage_sizes"] = list(depth)
        cfg["teacher"]["input"] = [32, 32, 3]
        cfg.update(de_pixel_count=2, de_popsize=10, de_maxiter=2)
        # Every pair selected and no grey band, so that slabs query and M2
        # is finetuned within a short window.
        cfg["loop"].update(batch_send=4, disparity_ratio=1.0, eps=0.0)
        cfg["assumed"]["head_input_scale"] = 8.0
        t.update(image=[32, 32, 3], people=12, replay_people=4,
                 people_per_slab=4, pairs_per_slab=96, capture_within=1,
                 capture_slabs=1, check_pairs=96, tail_slabs=1)
    return c


def correct(c, seconds=2.0) -> bool:
    return R.run_cell(c, SEED, seconds, False, CPU)["correct"]


CELLS = ["serve_r100_typical", "alink_vgg_a2", "alink_vgg_noise"]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    assert correct(tiny(name))


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference in float8 in the program's place fails a limit, at
    full depth (serving at 64x64 photos, the teacher at 32x32)."""
    import importlib

    c = tiny(name, (3, 13, 30, 3) if "serve" in name else (3, 4, 6, 3))
    cfg, t = c["config"], c["traffic"]
    system = importlib.import_module(
        f"bench_torch.systems.{cfg['system']}").System(cfg, SEED, CPU)
    driver = importlib.import_module(
        f"bench_torch.drivers.{t['driver']}").Driver(system, t, SEED, CPU)
    driver.setup()
    driver.window(2.0 if "embedder" in cfg else 8.0)
    driver.release()
    with exact_f32():
        got = driver.check(Numerics("f32"), substitute=Numerics("fp8"))
    limits = cfg["limits"]
    assert any(got[k] > limits[k] for k in limits if k in got), got


# -- faults planted in the timed path ---------------------------------------

def _alter_first_row(fn):
    def broken(*a, **k):
        out = fn(*a, **k).clone()
        out[0] = 1.0 - out[0] if out.dim() == 1 else -out[0]
        return out
    return broken


def test_serving_an_embedding_altered_where_it_is_produced(monkeypatch):
    from alink_tpu_torch.models import arcface

    monkeypatch.setattr(arcface.ArcFaceResNet100, "forward", _alter_first_row(
        arcface.ArcFaceResNet100.forward))
    assert not correct(tiny("serve_r100_typical"))


def test_serving_half_the_batch_left_out(monkeypatch):
    from alink_tpu_torch.detect import face_model

    align = face_model.align_faces

    def half(images, landmarks, size):
        chips = align(images, landmarks, size)
        n = chips.shape[0] // 2
        return torch.cat([chips[:n], chips[:n].mean(0, keepdim=True)
                          .expand_as(chips[n:])])

    monkeypatch.setattr(face_model, "align_faces", half)
    assert not correct(tiny("serve_r100_typical"))


def test_alink_a_finetune_that_leaves_m2_unchanged(monkeypatch):
    from alink_tpu_torch.active import loop

    monkeypatch.setattr(loop, "fit", lambda state, *a, **k: (state, []))
    c = tiny("alink_vgg_noise")
    res = R.run_cell(c, SEED, 2.0, False, CPU)
    assert res["checks"]["m2_update_gap"]["value"] >= 0.99
    assert not res["correct"]


def test_alink_half_the_batch_left_out(monkeypatch):
    from alink_tpu_torch.active import committee

    predict = committee.Committee.predict

    def half(self, left, right):
        p = predict(self, left, right)
        n = max(1, p.shape[0] // 2)
        return torch.cat([p[:n], p[:n].mean(0, keepdim=True)
                          .expand(p.shape[0] - n, -1)])

    monkeypatch.setattr(committee.Committee, "predict", half)
    assert not correct(tiny("alink_vgg_noise"))


@pytest.mark.parametrize("name", ["alink_vgg_a2", "alink_vgg_noise"])
def test_alink_a_probability_altered_where_it_is_produced(monkeypatch,
                                                          name):
    from alink_tpu_torch.active import loop

    monkeypatch.setattr(loop, "pair_scores",
                        _alter_first_row(loop.pair_scores))
    assert not correct(tiny(name))


def test_alink_an_attack_that_returns_its_input(monkeypatch):
    from alink_tpu_torch.ops import attack

    monkeypatch.setattr(attack, "one_pixel_attack_pairs",
                        lambda predict, params, left, right, *a, **k:
                        (left, right))
    res = R.run_cell(tiny("alink_vgg_a2"), SEED, 2.0, False, CPU)
    assert res["checks"]["de_pixel_mismatch"]["value"] > 0
    assert not res["correct"]


def test_alink_an_attack_that_scores_part_of_its_population(monkeypatch):
    from alink_tpu_torch.ops import attack

    solve = attack.differential_evolution

    def half(fitness, *a, **k):
        def some(x, idx):
            m = x.shape[1] // 2
            return torch.cat([fitness(x[:, :m], idx),
                              torch.ones_like(x[:, m:, 0])], dim=1)
        return solve(some, *a, **k)

    monkeypatch.setattr(attack, "differential_evolution", half)
    res = R.run_cell(tiny("alink_vgg_a2"), SEED, 2.0, False, CPU)
    assert res["checks"]["de_eval_mismatch"]["value"] > 0
    assert not res["correct"]
