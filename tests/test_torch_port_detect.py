"""The rest of the port's detect and serving side against the JAX package,
on the CPU: L-Net, the pooled crop, the crowd profile's pool and scatter,
the crowd cascade, L-Net refinement, ``detect_faces_limited``,
``profile_cascade``, bf16 crops, genderage and ``calibrate_budgets``.

Both sides get the same weights (JAX ``init`` -> numpy -> ``convert``) and
the same images drawn with numpy.  As in ``test_torch_port_serving.py``,
every tower runs in f32 on both sides (the JAX cascade's module-level bf16
nets, L-Net included, are swapped for f32 instances for this module), and
the cascade configurations here are used by no other test file, so a JAX
trace made with the swapped nets never serves another file's call.
Tolerances:

- L-Net outputs 1e-5; the pooled crop 1e-4 on a 0-255 scale;
- pool and scatter bit-equal;
- detections: identical ``valid``, boxes and landmarks within 1e-2 px
  (L-Net's landmarks are truncated to integers: equal), scores 1e-3;
  ``profile_cascade`` counts equal;
- bf16 crops within 2^-7 on the [-1, 1] fold (one bf16 step and a
  rounding of the row pass); a bf16-crop cascade against JAX's at the
  JAX package's own bf16 bounds (``tests/test_cascade_bf16.py``: scores
  2e-2, landmarks 0.5 px, boxes 1 px on the jointly valid);
- genderage outputs within 1e-5 of their largest magnitude in f32, 2e-2
  with the head's bf16 layer; (gender, age) equal;
- ``recommend``'s dict and ``calibrate_budgets.main``'s report identical.

The seeds were checked to have no near-tie in a discrete decision: NMS,
the rounding of box corners, top-k and pooling order, L-Net's truncation
and the genderage argmaxes (both checked in the tests).  ``min_size`` is a multiple of 4 (20 for
``BASE``, 36 for the calibration): then no box corner of the first pyramid
level, ``(2c + 1 [+ 12]) * min_size / 12``, is an exact half-integer.
With ``min_size`` 22 such corners exist, and JAX under ``jit`` (the
decode's division by the scale turned into a product by its reciprocal)
rounds some of them the other way than JAX op by op and the port, which
agree.
"""

import dataclasses
import json
import os

import alink_tpu.detect.cascade as jcascade
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from alink_tpu.detect import CascadeConfig as JCascadeConfig
from alink_tpu.detect import FaceModel as JFaceModel
from alink_tpu.detect import detect_faces_limited as j_detect_limited
from alink_tpu.models import ArcFaceResNet100 as JArcFace
from alink_tpu.models import genderage as jga
from alink_tpu.models import mtcnn as jmtcnn
from alink_tpu.ops import image as jimage
from alink_tpu.tools import calibrate_budgets as jcal
from alink_tpu_torch.convert import load_flax
from alink_tpu_torch.detect import (CascadeConfig, FaceModel, MTCNNParams,
                                    detect_faces, detect_faces_limited,
                                    init_cascade_params)
from alink_tpu_torch.detect import cascade
from alink_tpu_torch.models import (ArcFaceResNet100, GenderAgeHead,
                                    GenderAgeResNet50, LNet, ONet, PNet, RNet,
                                    decode_ga)
from alink_tpu_torch.ops import image
from alink_tpu_torch.tools import calibrate_budgets as tcal

WIDTHS = (16, 16, 32, 32)
EMBED = 32
F32 = torch.float32
# Budgets no other test file uses (see the module docstring).
BASE = dict(thresholds=(0.0, 0.0, 0.0), stage1_scale_budget=24,
            stage1_budget=20, stage2_budget=10, stage3_budget=5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def _no_grad():
    """The cascade's stage functions are called directly here; the entry
    points run under ``no_grad`` themselves."""
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def f32_towers():
    """The JAX cascade with f32 towers for this module's tests."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcascade, "_PNET", jmtcnn.PNet(dtype=jnp.float32))
    mp.setattr(jcascade, "_RNET", jmtcnn.RNet(dtype=jnp.float32))
    mp.setattr(jcascade, "_ONET", jmtcnn.ONet(dtype=jnp.float32))
    mp.setattr(jcascade, "_LNET", jmtcnn.LNet(dtype=jnp.float32))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def towers(f32_towers):
    """(JAX cascade params with L-Net, the port's f32 towers)."""
    jp = jcascade.init_cascade_params(jax.random.PRNGKey(1), with_lnet=True)
    tp = MTCNNParams(load_flax(PNet(F32), _np(jp.pnet)),
                     load_flax(RNet(F32), _np(jp.rnet)),
                     load_flax(ONet(F32), _np(jp.onet)),
                     load_flax(LNet(F32), _np(jp.lnet)))
    return jp, tp


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).uniform(
        0, 255, (4, 64, 64, 3)).astype(np.float32)


def _assert_same_detections(d, jd, box_atol=1e-2, lmk_atol=1e-2):
    valid = np.asarray(jd.valid)
    np.testing.assert_array_equal(d.valid.numpy(), valid)
    assert valid.any()
    np.testing.assert_allclose(d.boxes.numpy()[valid],
                               np.asarray(jd.boxes)[valid], atol=box_atol)
    np.testing.assert_allclose(d.landmarks.numpy()[valid],
                               np.asarray(jd.landmarks)[valid],
                               atol=lmk_atol)
    np.testing.assert_allclose(d.scores.numpy(), np.asarray(jd.scores),
                               atol=1e-3)


# -- models -------------------------------------------------------------------

def test_lnet_matches_jax():
    model = jmtcnn.LNet(dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 24, 24, 15)))
    x = np.random.default_rng(3).uniform(-1, 1, (3, 24, 24, 15)).astype(
        np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    got = load_flax(LNet(F32), _np(params))(_t(x))
    assert got.shape == (3, 5, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    # The default (bf16) tower takes the same tree.
    load_flax(LNet(), _np(params))


@pytest.mark.parametrize("order", ["unsorted", "sorted"])
def test_crop_and_resize_gather_matches_jax(order, monkeypatch):
    rng = np.random.default_rng(4)
    imgs = rng.uniform(0, 255, (3, 40, 48, 3)).astype(np.float32)
    x1 = rng.integers(-12, 40, 12).astype(np.float32)
    y1 = rng.integers(-12, 32, 12).astype(np.float32)
    side = rng.integers(6, 30, 12).astype(np.float32)
    boxes = np.stack([x1, y1, x1 + side - 1, y1 + side - 1], axis=1)
    boxes[0] = [-20, -20, 60, 70]          # past every edge
    ids = rng.integers(0, 3, 12)
    if order == "sorted":
        ids = np.sort(ids)
    for fold in ({}, dict(offset=127.5, scale=0.0078125)):
        want = np.asarray(jimage.crop_and_resize_gather(
            jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(ids), (24, 24),
            **fold))
        got = image.crop_and_resize_gather(_t(imgs), _t(boxes), _t(ids),
                                           (24, 24), **fold)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-4 * (0.0078125 if fold else 1))
        # Each candidate equals its own image's crop_and_resize.
        each = torch.stack([image.crop_and_resize(
            _t(imgs[i]), _t(boxes[t:t + 1]), (24, 24), **fold)[0]
            for t, i in enumerate(ids)])
        np.testing.assert_allclose(got.numpy(), each.numpy(), atol=1e-4)
    # Chunks of one candidate's gather give the same crops.
    monkeypatch.setattr(image, "_GATHER_BYTES", 1)
    np.testing.assert_allclose(
        image.crop_and_resize_gather(_t(imgs), _t(boxes), _t(ids),
                                     (24, 24)).numpy(),
        np.asarray(jimage.crop_and_resize_gather(
            jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(ids),
            (24, 24))), atol=1e-4)


def test_affine_warp_is_one_image_of_the_batch():
    img = np.random.default_rng(5).uniform(0, 255, (20, 24, 3)).astype(
        np.float32)
    M = np.array([[0.9, 0.1, 2.0], [-0.1, 0.9, 1.0]], np.float32)
    got = image.affine_warp(_t(img), _t(M), (16, 16))
    want = np.asarray(jimage.affine_warp(jnp.asarray(img), jnp.asarray(M),
                                         (16, 16)))
    assert got.shape == (16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1.5)
    np.testing.assert_array_equal(got.numpy(), image.affine_warp_batch(
        _t(img)[None], _t(M)[None], (16, 16))[0].numpy())


# -- the crowd profile's pool and scatter (JAX's test_crowd.py cases) --------

POOL_CASES = {
    "image_then_score": (np.array([0.9, 0.1, 0.5, 0.8, 0.3, 0.7]),
                         np.ones(6, bool), 2, 3, 5),
    "invalid_last": (np.array([0.9, 0.8, 0.7, 0.6]),
                     np.array([True, False, True, False]), 2, 2, 4),
    # Ties across images and within one: lax.top_k takes the lower index.
    "ties": (np.array([0.5, 0.5, 0.2, 0.5, 0.9, 0.2, 0.2, 0.5]),
             np.array([True, True, True, True, True, False, True, True]),
             4, 2, 6),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_by_score_matches_jax(case):
    scores, valid, n, k, total = POOL_CASES[case]
    scores = scores.astype(np.float32)
    want = jcascade._pool_by_score(jnp.asarray(scores), jnp.asarray(valid),
                                   n, k, total)
    got = cascade._pool_by_score(_t(scores), _t(valid), n, k, total)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


SCATTER_CASES = {
    # Image 0 keeps its two best valid candidates (the dead one burns no
    # slot); the third overflows the cap.
    "cap_overflow": ([0, 0, 0, 0, 1], [True, True, False, True, True], 2, 2),
    "empty_image": ([1, 1], [True, True], 3, 2),
    "invalid_last": ([0, 1, 1, 3, 3], [True, True, True, False, False], 3, 4),
}


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_scatter_per_image_matches_jax(case):
    img_id, tvalid, n, cap = SCATTER_CASES[case]
    img_id, tvalid = np.array(img_id), np.array(tvalid)
    vals = np.arange(10.0, 10.0 - len(img_id), -1.0, dtype=np.float32)
    boxes = np.random.default_rng(6).uniform(0, 9, (len(img_id), 4)).astype(
        np.float32)
    (jv, jb), jm = jcascade._scatter_per_image(
        jnp.asarray(img_id), jnp.asarray(tvalid), n, cap, jnp.asarray(vals),
        jnp.asarray(boxes))
    (tv, tb), tm = cascade._scatter_per_image(
        _t(img_id), _t(tvalid), n, cap, _t(vals), _t(boxes))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


# -- the cascade ---------------------------------------------------------------

CROWD_CASES = {
    # Pooled totals cover every candidate: the lossless path's result.
    "within_budget": dict(stage2_total=4 * 20, stage3_total=4 * 10),
    # Over budget: the globally lowest-scoring candidates drop out.
    "over_budget": dict(stage2_total=30, stage3_total=12),
}


@pytest.mark.parametrize("case", sorted(CROWD_CASES))
def test_crowd_cascade_matches_jax(towers, images, case):
    jp, tp = towers
    kw = dict(BASE, **CROWD_CASES[case])
    jd = jcascade.detect_faces(jp, jnp.asarray(images),
                               JCascadeConfig(**kw))
    d = detect_faces(tp, _t(images), CascadeConfig(**kw))
    _assert_same_detections(d, jd)
    lossless = detect_faces(tp, _t(images), CascadeConfig(**BASE))
    if case == "within_budget":
        np.testing.assert_array_equal(d.valid.numpy(), lossless.valid.numpy())
        np.testing.assert_array_equal(d.boxes.numpy(), lossless.boxes.numpy())
    else:
        assert d.valid.sum() < lossless.valid.sum()
        # The pooled stage-2 candidates are the top stage-1 scores.
        _, s1, v1 = cascade._stage1(tp, _t(images), CascadeConfig(**kw))
        idx, _, tv = cascade._pool_by_score(s1.reshape(-1), v1.reshape(-1),
                                            4, 20, 30)
        flat = np.where(v1.reshape(-1).numpy(), s1.reshape(-1).numpy(),
                        -np.inf)
        want = np.argsort(-flat, kind="stable")[:30]
        assert sorted(idx[tv].tolist()) == sorted(want.tolist())


@pytest.mark.parametrize("path", ["full", "crowd", "limited"])
def test_accurate_landmark_matches_jax(towers, images, path):
    jp, tp = towers
    kw = dict(BASE, accurate_landmark=True)
    if path == "crowd":
        kw.update(stage2_total=40, stage3_total=24)
    x, jx = _t(images), jnp.asarray(images)
    if path == "limited":
        b, _, v = cascade._stage1(tp, x, CascadeConfig(**BASE))
        jd = j_detect_limited(jp, jx, jnp.asarray(b.numpy()),
                              jnp.asarray(v.numpy()), JCascadeConfig(**kw))
        d = detect_faces_limited(tp, x, b, v, CascadeConfig(**kw))
    else:
        jd = jcascade.detect_faces(jp, jx, JCascadeConfig(**kw))
        d = detect_faces(tp, x, CascadeConfig(**kw))
    _assert_same_detections(d, jd, lmk_atol=0.0)
    plain = detect_faces(tp, x, CascadeConfig(**dict(kw, accurate_landmark=
                                                     False)))
    valid = d.valid.numpy()
    moved = np.abs(d.landmarks.numpy() - plain.landmarks.numpy())[valid]
    assert (moved > 0.5).any()
    assert np.array_equal(d.landmarks.numpy(), np.trunc(d.landmarks.numpy()))
    with pytest.raises(ValueError, match="lnet"):
        detect_faces(tp._replace(lnet=None), x, CascadeConfig(**kw))


def test_refined_landmarks_have_no_near_tie(towers, images, monkeypatch):
    """The seed's refined coordinates sit clear of the integers that the
    truncation decides on: farther than ten times the two L-Nets'
    difference on the same patches times the widest patch (a row reset to
    its patch centre is an exact integer on both sides)."""
    jp, tp = towers
    x = _t(images)
    d = detect_faces(tp, x, CascadeConfig(**BASE))
    seen, inputs = [], []
    trunc = torch.trunc
    monkeypatch.setattr(torch, "trunc", lambda t: (seen.append(t),
                                                   trunc(t))[1])
    lnet = tp.lnet
    cascade._refine_landmarks(
        tp._replace(lnet=lambda a: (inputs.append(a), lnet(a))[1]), x,
        d.boxes, d.landmarks)
    monkeypatch.undo()
    err = np.abs(lnet(inputs[0]).numpy() - np.asarray(jcascade._LNET.apply(
        jp.lnet, jnp.asarray(inputs[0].numpy())))).max()
    side = (d.boxes[..., 2:] - d.boxes[..., :2] + 1).max().item()
    frac = seen[0].numpy()[d.valid.numpy()] % 1.0
    dist = np.minimum(frac, 1.0 - frac)
    assert ((dist > 10 * err * side) | (dist == 0)).all()
    assert (dist > 0).any()


def test_limited_from_stage1_boxes_reproduces_the_cascade(towers, images):
    """Stage 1's boxes are already squared and rounded, so starting at
    R-Net from them is the full cascade."""
    _, tp = towers
    cfg = CascadeConfig(**BASE)
    x = _t(images)
    b, _, v = cascade._stage1(tp, x, cfg)
    d = detect_faces_limited(tp, x, b, v, cfg)
    full = detect_faces(tp, x, cfg)
    for a, w in zip(d, full):
        np.testing.assert_array_equal(a.numpy(), w.numpy())


def test_limited_on_given_boxes_matches_jax(towers, images):
    """Raw, unsquared boxes (the reference crops them as given)."""
    jp, tp = towers
    rng = np.random.default_rng(7)
    x1 = rng.uniform(-8, 40, (4, 6)).astype(np.float32)
    y1 = rng.uniform(-8, 40, (4, 6)).astype(np.float32)
    boxes = np.stack([x1, y1, x1 + rng.uniform(16, 40, (4, 6)),
                      y1 + rng.uniform(12, 30, (4, 6))], -1).astype(
                          np.float32).round()
    valid = rng.uniform(size=(4, 6)) < 0.8
    cfg = dict(BASE, stage2_budget=6, stage3_budget=3)
    jd = j_detect_limited(jp, jnp.asarray(images), jnp.asarray(boxes),
                          jnp.asarray(valid), JCascadeConfig(**cfg))
    d = detect_faces_limited(tp, _t(images), _t(boxes), _t(valid),
                             CascadeConfig(**cfg))
    _assert_same_detections(d, jd)


def test_profile_cascade_matches_jax(towers, images):
    jp, tp = towers
    kw = dict(BASE, stage1_budget=21)
    jprof = jcascade.profile_cascade(jp, jnp.asarray(images),
                                     JCascadeConfig(**kw))
    cfg = CascadeConfig(**kw)
    prof = cascade.profile_cascade(tp, _t(images), cfg)
    assert set(prof) == set(jprof)
    for k in prof:
        np.testing.assert_array_equal(prof[k].numpy(), np.asarray(jprof[k]))
    # Each count is the valid sum of its stage.
    x = _t(images)
    b, _, v1 = cascade._stage1(tp, x, cfg)
    b, _, v2 = cascade._stage2(tp, x, b, v1, cfg)
    v3 = cascade._stage3(tp, x, b, v2, cfg)[2]
    for k, v in (("stage1", v1), ("stage2", v2), ("stage3", v3)):
        np.testing.assert_array_equal(prof[k].numpy(), v.sum(1).numpy())


def test_bf16_crops_match_jax(towers, images):
    jp, tp = towers
    rng = np.random.default_rng(8)
    x1 = rng.integers(-6, 50, 8).astype(np.float32)
    boxes = np.stack([x1, x1[::-1], x1 + 20, x1[::-1] + 20], 1)
    kw = dict(offset=127.5, scale=0.0078125)
    want = jimage.crop_and_resize(jnp.asarray(images[0]), jnp.asarray(boxes),
                                  (24, 24), compute_dtype=jnp.bfloat16,
                                  out_dtype=jnp.bfloat16, **kw)
    got = image.crop_and_resize(_t(images[0]), _t(boxes), (24, 24),
                                compute_dtype=torch.bfloat16,
                                out_dtype=torch.bfloat16, **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2 ** -7)
    # The bf16-crop cascade against JAX's, at JAX's own bf16 bounds.
    cfg = dict(BASE, crop_dtype="bfloat16", stage3_budget=6)
    jd = jcascade.detect_faces(jp, jnp.asarray(images), JCascadeConfig(**cfg))
    d = detect_faces(tp, _t(images), CascadeConfig(**cfg))
    both = np.asarray(jd.valid) & d.valid.numpy()
    assert both.sum() >= np.asarray(jd.valid).sum() - 1
    np.testing.assert_allclose(d.scores.numpy()[both],
                               np.asarray(jd.scores)[both], atol=2e-2)
    np.testing.assert_allclose(d.landmarks.numpy()[both],
                               np.asarray(jd.landmarks)[both], atol=0.5)
    np.testing.assert_allclose(d.boxes.numpy()[both],
                               np.asarray(jd.boxes)[both], atol=1.0)


def test_config_has_every_jax_field_and_profile():
    jf = {f.name: f.default for f in dataclasses.fields(JCascadeConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(CascadeConfig)}
    assert jf == tf
    for prof in ("typical", "worst_case", "crowd"):
        assert (dataclasses.asdict(getattr(CascadeConfig, prof)())
                == dataclasses.asdict(getattr(JCascadeConfig, prof)()))
    with pytest.raises(ValueError, match="crop_dtype"):
        cascade._crop_dtype(CascadeConfig(crop_dtype="pixels"))
    assert cascade._crop_dtype(CascadeConfig(crop_dtype="auto")) is None
    p = init_cascade_params(torch.Generator().manual_seed(0))
    assert isinstance(p.lnet, LNet)
    assert init_cascade_params(with_lnet=False).lnet is None


# -- genderage -------------------------------------------------------------

def test_decode_ga_matches_jax():
    out = np.random.default_rng(9).normal(size=(5, 202)).astype(np.float32)
    out[0, 0:2] = 1.0                      # a tie: the first unit wins
    jg, ja = jga.decode_ga(jnp.asarray(out))
    g, a = decode_ga(_t(out))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert g[0] == 0 and ((a >= 0) & (a <= 100)).all()


def _assert_no_near_tie(out, err):
    """Every pair that an argmax decides is apart by more than ten times
    the two packages' largest difference ``err``."""
    pairs = np.concatenate([out[:, 0:2][:, None],
                            out[:, 2:202].reshape(-1, 100, 2)], axis=1)
    assert (np.abs(pairs[..., 0] - pairs[..., 1]) > 10 * err).all()


@pytest.fixture(scope="module")
def ga_pair():
    """(JAX FaceModel, GA models and params; the port's)."""
    jemb = JArcFace(stage_sizes=(1, 1, 1, 1), stage_widths=WIDTHS,
                    embedding_dim=EMBED, dtype=jnp.float32)
    ep = jemb.init(jax.random.PRNGKey(10), jnp.zeros((1, 112, 112, 3)))
    jgam = jga.GenderAgeResNet50(stage_sizes=(1, 1, 1, 1),
                                 stage_widths=WIDTHS, dtype=jnp.float32)
    gp = jgam.init(jax.random.PRNGKey(11), jnp.zeros((1, 112, 112, 3)))
    jhead = jga.GenderAgeHead()
    hp = jhead.init(jax.random.PRNGKey(12), jnp.zeros((1, EMBED)))
    emb = load_flax(ArcFaceResNet100(stage_sizes=(1, 1, 1, 1),
                                     stage_widths=WIDTHS, embedding_dim=EMBED,
                                     dtype=F32), _np(ep))
    gam = load_flax(GenderAgeResNet50(stage_sizes=(1, 1, 1, 1),
                                      stage_widths=WIDTHS, dtype=F32),
                    _np(gp))
    head = load_flax(GenderAgeHead(EMBED), _np(hp))
    return ((JFaceModel(ep, None, embedder=jemb), jgam, gp, jhead, hp),
            (FaceModel(emb), gam, head))


def test_genderage_models_match_jax(ga_pair):
    (_, jgam, gp, jhead, hp), (_, gam, head) = ga_pair
    chips = np.random.default_rng(13).uniform(
        0, 255, (3, 112, 112, 3)).astype(np.float32)
    want = np.asarray(jgam.apply(gp, jnp.asarray(chips)))
    got = gam(_t(chips)).numpy()
    assert got.shape == (3, 202)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    feats = np.random.default_rng(14).normal(size=(3, EMBED)).astype(
        np.float32)
    np.testing.assert_allclose(head(_t(feats)).numpy(),
                               np.asarray(jhead.apply(hp, jnp.asarray(feats))),
                               atol=2e-2)
    f32 = GenderAgeHead(EMBED, dtype=F32)
    f32.load_state_dict(head.state_dict())
    np.testing.assert_allclose(
        f32(_t(feats)).numpy(),
        np.asarray(jga.GenderAgeHead(dtype=jnp.float32).apply(
            hp, jnp.asarray(feats))), atol=1e-5)
    # The full model's trunk is LResNet50E, raw (unnormalised) 202-d.
    full = GenderAgeResNet50(stage_widths=WIDTHS)
    assert full.stage_sizes == (3, 4, 14, 3) and not full.normalize
    assert full.embedding_dim == 202


def test_get_ga_matches_jax(ga_pair):
    """(gender, age) through ``FaceModel``, the f32 head for the embedding
    route (the bf16 layer's 2e-2 would leave no decided pair clear)."""
    (jfm, jgam, gp, _, hp), (fm, gam, head) = ga_pair
    chips = np.random.default_rng(15).uniform(
        0, 255, (4, 112, 112, 3)).astype(np.float32)
    out = gam(_t(chips)).numpy()
    _assert_no_near_tie(out, np.abs(out - np.asarray(
        jgam.apply(gp, jnp.asarray(chips)))).max())
    for got, want in zip(fm.get_ga(chips, gam),
                         jfm.get_ga(jnp.asarray(chips), jgam, gp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jhead = jga.GenderAgeHead(dtype=jnp.float32)
    thead = GenderAgeHead(EMBED, dtype=F32)
    thead.load_state_dict(head.state_dict())
    out = thead(fm.get_feature(chips)).numpy()
    _assert_no_near_tie(out, np.abs(out - np.asarray(jhead.apply(
        hp, jfm.get_feature(jnp.asarray(chips))))).max())
    for got, want in zip(fm.get_ga_from_embedding(chips, thead),
                         jfm.get_ga_from_embedding(jnp.asarray(chips), jhead,
                                                   hp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- calibrate_budgets ------------------------------------------------------

def test_recommend_matches_jax(towers, images):
    _, tp = towers
    cfg = CascadeConfig(**dict(BASE, stage1_budget=21))
    prof = {k: v.numpy()
            for k, v in cascade.profile_cascade(tp, _t(images), cfg).items()}
    jcfg = JCascadeConfig(**dict(BASE, stage1_budget=21))
    for q, hr in ((0.99, 2.0), (0.5, 1.3)):
        assert tcal.recommend(prof, cfg, q, hr) == jcal.recommend(
            {k: jnp.asarray(v) for k, v in prof.items()}, jcfg, q, hr)
    fake = dict(prof, stage2=np.full(4, cfg.stage2_budget))
    _, warns = tcal.recommend(fake, cfg, 0.99, 2.0)
    assert any("stage2" in w for w in warns)


def test_calibrate_main_matches_jax(towers, tmp_path, monkeypatch, capsys):
    """Both tools on the same PNGs with the same towers: the same report
    and recommended config, to the character."""
    jp, tp = towers
    from alink_tpu.data import native_loader
    from alink_tpu_torch.data import native_loader as tnative_loader

    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(tnative_loader, "available", lambda: False)
    rng = np.random.default_rng(16)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (72, 72, 3), dtype=np.uint8)
                        ).save(tmp_path / f"img{i}.png")
    ckpt = tmp_path / "towers"
    from alink_tpu_torch.train.checkpoint import save

    for name in ("pnet", "rnet", "onet", "lnet"):
        save(str(ckpt / name), getattr(tp, name).state_dict())
    for cls in ("PNet", "RNet", "ONet", "LNet"):
        monkeypatch.setattr(tcal, cls, lambda device, c=cls: getattr(
            __import__("alink_tpu_torch.models", fromlist=[c]), c)(
                F32, device=device))
    monkeypatch.setattr(jcal, "init_cascade_params", lambda key: jp)
    argv = [str(tmp_path), "--image_res", "64", "--min_size", "36",
            "--thresholds", "0.0", "0.0", "0.0"]
    jcal.main(argv)
    want = capsys.readouterr().out
    tcal.main(argv + ["--params", str(ckpt), "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    report = json.loads(got.split("\n\nRecommended")[0])
    assert report["sampled_images"] == 3 and report["warnings"] == []
    # Smoke mode: 8 seeded noise images, random towers.
    tcal.main(["--sample", "2", "--image_res", "48", "--device", "cpu"])
    assert "Recommended config" in capsys.readouterr().out
    assert os.path.isdir(ckpt / "lnet")
