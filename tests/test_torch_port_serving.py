"""The port's serving slice against the JAX package, end to end on the CPU.

Both sides get the same weights (JAX ``init`` -> numpy -> ``convert``) and
the same seeded images: JAX ``FaceModel`` + ``Verifier`` against
``alink_tpu_torch``'s.  The point here is the algorithm, so every tower
runs in f32 on both sides: the JAX cascade's module-level bf16 nets are
swapped for f32 instances of the same modules for this file's fixture (a
config no other test uses keeps the swapped traces apart).  bf16 towers on
two frameworks round different partial sums and move boxes by ~0.1 px;
the card checks the bf16 path against its own plain versions instead.
Tolerances:

- detections: identical ``valid``; boxes and landmarks within 1e-2 px;
- chips: the JAX CPU path warps with its einsum form, the port with the
  four-tap gather, 1.5 on 0-255 (``test_geometry.py``'s warp budget);
- embeddings 1e-3 and scores 2e-2 (bf16 head operands, as
  ``test_pairwise.py``).

The seed was checked to have no near-tie in a discrete decision (NMS,
rounding of box corners, top-k order).
"""

import threading

import alink_tpu.detect.cascade as jcascade
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu.detect import CascadeConfig as JCascadeConfig
from alink_tpu.detect import FaceModel as JFaceModel
from alink_tpu.detect import init_cascade_params as j_init_cascade
from alink_tpu.models import ArcFaceResNet100 as JArcFace
from alink_tpu.models import mtcnn as jmtcnn
from alink_tpu.models import SiameseHead as JSiameseHead
from alink_tpu.serving import Verifier as JVerifier
from alink_tpu_torch.convert import load_flax
from alink_tpu_torch.detect import (CascadeConfig, FaceModel, MTCNNParams,
                                    init_cascade_params)
from alink_tpu_torch.models import ArcFaceResNet100, ONet, PNet, RNet, SiameseHead
from alink_tpu_torch.serving import MicroBatcher, Verifier

WIDTHS = (16, 16, 32, 32)
EMBED = 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def f32_towers():
    """The JAX cascade with f32 towers for this module's tests."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcascade, "_PNET", jmtcnn.PNet(dtype=jnp.float32))
    mp.setattr(jcascade, "_RNET", jmtcnn.RNet(dtype=jnp.float32))
    mp.setattr(jcascade, "_ONET", jmtcnn.ONet(dtype=jnp.float32))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def pair(f32_towers):
    """(jax FaceModel, jax Verifier, port FaceModel, port Verifier)."""
    jemb = JArcFace(stage_sizes=(1, 1, 1, 1), stage_widths=WIDTHS,
                    embedding_dim=EMBED, dtype=jnp.float32)
    eparams = jemb.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 112, 112, 3), jnp.float32))
    cparams = j_init_cascade(jax.random.PRNGKey(1), with_lnet=False)
    jhead = JSiameseHead()
    hparams = jhead.init(jax.random.PRNGKey(2), jnp.zeros((1, EMBED)),
                         jnp.zeros((1, EMBED)))
    jcfg = JCascadeConfig.typical(thresholds=(0.0, 0.0, 0.0),
                                  crop_dtype="float32")
    jfm = JFaceModel(eparams, cparams, jcfg, embedder=jemb)

    emb = load_flax(ArcFaceResNet100(stage_sizes=(1, 1, 1, 1),
                                     stage_widths=WIDTHS, embedding_dim=EMBED,
                                     dtype=torch.float32), _np(eparams))
    f32 = torch.float32
    casc = MTCNNParams(load_flax(PNet(f32), _np(cparams.pnet)),
                       load_flax(RNet(f32), _np(cparams.rnet)),
                       load_flax(ONet(f32), _np(cparams.onet)))
    head = load_flax(SiameseHead(EMBED), _np(hparams))
    fm = FaceModel(emb, casc, CascadeConfig.typical(
        thresholds=(0.0, 0.0, 0.0)))
    return jfm, JVerifier(jfm.process, hparams), fm, Verifier(fm.process, head)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).uniform(
        0, 255, (4, 64, 64, 3)).astype(np.float32)


def test_detections_match_jax(pair, images):
    jfm, _, fm, _ = pair
    jd = jfm.detect(jnp.asarray(images))
    d = fm.detect(images)
    valid = np.asarray(jd.valid)
    np.testing.assert_array_equal(d.valid.numpy(), valid)
    assert valid.any()
    np.testing.assert_allclose(d.boxes.numpy()[valid],
                               np.asarray(jd.boxes)[valid], atol=1e-2)
    np.testing.assert_allclose(d.landmarks.numpy()[valid],
                               np.asarray(jd.landmarks)[valid], atol=1e-2)
    np.testing.assert_allclose(d.scores.numpy(), np.asarray(jd.scores),
                               atol=1e-3)


def test_chips_and_embeddings_match_jax(pair, images):
    jfm, _, fm, _ = pair
    jchips, jfound = jfm.get_input_valid(jnp.asarray(images))
    chips, found = fm.get_input_valid(images)
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_allclose(chips.numpy(), np.asarray(jchips), atol=1.5)
    np.testing.assert_allclose(fm.process(images).numpy(),
                               np.asarray(jfm.process(jnp.asarray(images))),
                               atol=1e-3)


def test_verifier_matches_jax(pair, images):
    _, jv, _, v = pair
    np.testing.assert_allclose(
        v.verify_pairs(images[:2], images[2:]).numpy(),
        np.asarray(jv.verify_pairs(images[:2], images[2:])), atol=2e-2)
    np.testing.assert_allclose(v.score_matrix(images).numpy(),
                               np.asarray(jv.score_matrix(images)), atol=2e-2)


def test_identify_matches_jax():
    """Enroll and identify over pre-aligned chips on fresh verifiers
    (enrollment mutates the gallery), f32 head on both sides."""
    jemb = JArcFace(stage_sizes=(1, 1, 1, 1), stage_widths=WIDTHS,
                    embedding_dim=EMBED, dtype=jnp.float32)
    eparams = jemb.init(jax.random.PRNGKey(3),
                        jnp.zeros((1, 112, 112, 3), jnp.float32))
    jhead = JSiameseHead(dtype=jnp.float32)
    hparams = jhead.init(jax.random.PRNGKey(4), jnp.zeros((1, EMBED)),
                         jnp.zeros((1, EMBED)))
    emb = load_flax(ArcFaceResNet100(stage_sizes=(1, 1, 1, 1),
                                     stage_widths=WIDTHS, embedding_dim=EMBED,
                                     dtype=torch.float32), _np(eparams))
    head = load_flax(SiameseHead(EMBED, dtype=torch.float32), _np(hparams))
    chips = np.random.default_rng(5).uniform(
        0, 255, (6, 112, 112, 3)).astype(np.float32)
    jv = JVerifier(lambda x: jemb.apply(eparams, x), hparams)
    v = Verifier(lambda x: emb(torch.as_tensor(np.ascontiguousarray(x))
                               ).detach(), head)
    labels = ["a", "b", "c", "d", "e", "f"]
    jv.enroll(chips, labels)
    v.enroll(chips, labels)
    jl, js = jv.identify(chips[::-1], k=3)
    pl, ps = v.identify(chips[::-1], k=3)
    assert pl == jl
    np.testing.assert_allclose(ps, js, atol=2e-2)


def test_no_face_chip_is_zero(pair, images):
    """Thresholds no score can pass: every image reports not-found and
    embeds the zero chip (``where``, so a NaN warp cannot leak)."""
    _, _, fm, _ = pair
    closed = FaceModel(fm.embedder, fm.cascade_params,
                       CascadeConfig.typical(thresholds=(1.0, 1.0, 1.0)))
    chips, found = closed.get_input_valid(images)
    assert not found.any()
    assert torch.count_nonzero(chips) == 0
    assert torch.isfinite(closed.process(images)).all()


def test_an_unalignable_face_is_not_found(pair, images, monkeypatch):
    """A best detection whose five landmarks coincide (a zero-size box,
    which open thresholds let through) has no similarity onto the template:
    that image reports not-found and embeds the zero chip, where the warp
    by a scale-0 similarity gave NaN; the other images are unchanged."""
    from alink_tpu_torch.detect import face_model

    _, _, fm, _ = pair
    chips0, found0 = fm.get_input_valid(images)
    assert found0.all()
    detect = face_model.detect_faces

    def collapsed(*a, **k):
        det = detect(*a, **k)
        lmk = det.landmarks.clone()
        lmk[0] = torch.tensor([63.0, 110.0])
        return det._replace(landmarks=lmk)

    monkeypatch.setattr(face_model, "detect_faces", collapsed)
    chips, found = fm.get_input_valid(images)
    assert found.tolist() == [False] + [True] * (len(images) - 1)
    assert torch.count_nonzero(chips[0]) == 0
    assert torch.equal(chips[1:], chips0[1:])
    assert torch.isfinite(fm.process(images)).all()


def test_no_cascade_resizes_precropped(pair):
    _, _, fm, _ = pair
    plain = FaceModel(fm.embedder)
    x = np.random.default_rng(7).uniform(0, 255, (2, 64, 64, 3)).astype(
        np.float32)
    chips, found = plain.get_input_valid(x)
    assert chips.shape == (2, 112, 112, 3) and found.all()
    with pytest.raises(ValueError):
        plain.detect(x)
    assert plain.process(x).shape == (2, EMBED)


def test_random_init_runs_the_slice():
    """The port's own seeded init (no JAX weights) drives the whole path."""
    g = torch.Generator().manual_seed(0)
    fm = FaceModel(ArcFaceResNet100(stage_sizes=(1, 1, 1, 1),
                                    stage_widths=WIDTHS, embedding_dim=EMBED,
                                    generator=g),
                   init_cascade_params(g),
                   CascadeConfig.typical(thresholds=(0.0, 0.0, 0.0)))
    v = Verifier(fm.process, SiameseHead(EMBED, generator=g))
    x = np.random.default_rng(8).uniform(0, 255, (3, 64, 64, 3)).astype(
        np.float32)
    emb = fm.process(x)
    assert emb.shape == (3, EMBED) and torch.isfinite(emb).all()
    np.testing.assert_allclose(emb.norm(dim=1).numpy(), 1.0, atol=1e-2)
    s = v.score_matrix(x)
    assert s.shape == (3, 3) and bool(((s >= 0) & (s <= 1)).all())


def test_profile_serving_stages_run_at_tiny_size():
    """The stage-timing tool drives every stage it names (CPU, tiny)."""
    from alink_tpu_torch.tools import profile_serving

    g = torch.Generator().manual_seed(1)
    fm = FaceModel(ArcFaceResNet100(stage_sizes=(1, 1, 1, 1),
                                    stage_widths=WIDTHS, embedding_dim=EMBED,
                                    generator=g),
                   init_cascade_params(g),
                   CascadeConfig.typical(thresholds=(0.0, 0.0, 0.0)))
    x = torch.as_tensor(np.random.default_rng(9).uniform(
        0, 255, (2, 48, 48, 3)), dtype=torch.float32)
    stages = profile_serving.stage_breakdown(fm, x, n_windows=1, iters=1)
    assert set(stages) == {"stage1", "stage2", "stage3", "detect", "align",
                           "embed", "process"}
    assert all(v > 0 for v in stages.values())
    s = profile_serving.summary([(3.0, 1.0), (1.0, 1.0), (2.0, 4.0)])
    assert s == {"median_ms": 2.0, "min_ms": 1.0, "max_ms": 3.0,
                 "cpu_median_ms": 1.0}


class TestMicroBatcher:
    def test_results_match_direct_calls(self):
        calls = []

        def fn(batch):
            calls.append(batch.shape[0])
            return batch.sum(dim=(1, 2))

        x = np.random.default_rng(9).uniform(size=(5, 3, 2)).astype(np.float32)
        with MicroBatcher(fn, max_batch=8, max_delay_s=0.2) as mb:
            futs = [mb.submit(x[i]) for i in range(5)]
            got = [f.result(timeout=10) for f in futs]
        np.testing.assert_allclose(torch.stack(got).numpy(),
                                   x.sum(axis=(1, 2)), rtol=1e-6)
        assert all(c in mb.buckets for c in calls)

    def test_failure_reaches_every_future(self):
        def fn(batch):
            raise RuntimeError("boom")

        with MicroBatcher(fn, max_batch=4, max_delay_s=0.05) as mb:
            futs = [mb.submit(np.zeros(2, np.float32)) for _ in range(3)]
            for f in futs:
                with pytest.raises(RuntimeError, match="boom"):
                    f.result(timeout=10)

    def test_closed_rejects_and_bad_size_raises(self):
        mb = MicroBatcher(lambda b: b, max_batch=2)
        mb.close()
        with pytest.raises(RuntimeError):
            mb.submit(np.zeros(1))
        with pytest.raises(ValueError):
            MicroBatcher(lambda b: b, max_batch=0)


class TestVerifierGallery:
    @staticmethod
    def _verifier():
        g = torch.Generator().manual_seed(1)
        head = SiameseHead(8, (16, 8), dtype=torch.float32, generator=g)
        return Verifier(lambda x: torch.as_tensor(x).reshape(
            len(x), -1)[:, :8].float(), head)

    def test_empty_and_mismatch_raise(self):
        v = self._verifier()
        with pytest.raises(ValueError):
            v.identify(np.zeros((1, 8), np.float32))
        with pytest.raises(ValueError):
            v.enroll(np.zeros((2, 8), np.float32), ["one"])

    def test_concurrent_enroll_keeps_labels_with_features(self):
        """Threads enrolling at once: every label keeps its own feature
        row (a lost update would leave labels and rows out of step)."""
        import sys

        v = self._verifier()
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            def work(t):
                for i in range(20):
                    val = float(t * 100 + i)
                    v.enroll(np.full((1, 8), val, np.float32), [val])

            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)
        assert v.gallery_size == 160
        feats = v._gallery_feats[:, 0].tolist()
        assert feats == v._gallery_labels
