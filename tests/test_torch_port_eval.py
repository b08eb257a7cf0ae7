"""The port's DFW evaluation chain against the JAX package's, on the CPU.

Inputs come from ``np.random.default_rng``; both sides get the same arrays
and, for heads, the same weights (``convert.load_flax``).  Tolerances:

- the mask split, the threshold sweep and everything fed the same score
  matrix (stats, the tools' files and printed lines) are identical: the
  same f32 scores and thresholds, the same counting, float64 statistics
  by the same numpy code;
- statistics of identical curves agree to 1e-12;
- score matrices from the two packages' heads agree to 2e-2, the bound of
  the port's K1 plain-version test (bf16 head operands, f32 sums in
  another order);
- features of a shared linear featurizer agree to 1e-5 of their largest
  (f32 products summed in another order);
- acquisition values agree to 1e-6 and their indices exactly, ties to the
  lower index; one Adadelta step of a full batch agrees to 1e-5.

``run_eval_regression`` runs here at the JAX fixture's toy scale
(``tests/test_eval_regression.py``) for its structure only: torch's draws
cannot match threefry, so its ordering is asserted on the card
(``chip_smoke.py`` phase (i)).  The kernels run only on the card; entry
points that default to CUDA raise here rather than fall back.
"""

import filecmp
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu import train as JT
from alink_tpu.active import learners as jlearners
from alink_tpu.active import uncertainty as juncertainty
from alink_tpu.active.committee import Committee as JCommittee
from alink_tpu.data import make_synthetic_dfw_test as j_make_test
from alink_tpu.data.loader import PersonStacks as JPersonStacks
from alink_tpu.evaluation import identification as jident
from alink_tpu.evaluation import roc as jroc
from alink_tpu.models import SiameseHead as JSiameseHead
from alink_tpu.tools import evaluate as jevaluate
from alink_tpu.tools import generate_matrix as jgenerate_matrix
from alink_tpu.tools import generate_predictions as jgp
from alink_tpu.tools import get_stats as jget_stats
from alink_tpu.tools import roc_precompute as jroc_precompute
from alink_tpu_torch import train as T
from alink_tpu_torch.active import learners, uncertainty
from alink_tpu_torch.active.committee import Committee
from alink_tpu_torch.convert import load_flax
from alink_tpu_torch.data import dfw_test_mask, make_synthetic_dfw_test
from alink_tpu_torch.data.loader import PersonStacks
from alink_tpu_torch.data.synth import dfw_test_protocol
from alink_tpu_torch.evaluation import identification, roc
from alink_tpu_torch.models import SiameseHead
from alink_tpu_torch.tools import (evaluate, generate_matrix,
                                   generate_predictions, get_stats,
                                   roc_precompute)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scores_and_mask(n=40, seed=0):
    rng = np.random.default_rng(seed)
    scores = rng.uniform(size=(n, n)).astype(np.float32)
    mask = rng.integers(0, 5, (n, n))
    return scores, mask


# ---------------------------------------------------------------- roc ----

@pytest.mark.parametrize("case", [1, 2, 3])
def test_masked_scores_match_jax(case):
    """The same genuine and imposter scores, in the same (row-major) order,
    as the JAX split; only the strict upper triangle counts."""
    scores, mask = _scores_and_mask()
    jg, ji = jroc.masked_scores(scores, mask, case)
    g, i = roc.masked_scores(torch.from_numpy(scores),
                             torch.from_numpy(mask), case)
    assert g.numel() > 0 and i.numel() > 0
    np.testing.assert_array_equal(g.numpy(), jg)
    np.testing.assert_array_equal(i.numpy(), ji)
    # Lower-triangle and diagonal entries never count.
    low = np.tril(np.ones_like(mask, bool))
    g2, _ = roc.masked_scores(torch.from_numpy(np.where(low, 9.0, scores)),
                              torch.from_numpy(mask), case)
    assert float(g2.max()) < 9.0


def test_masked_scores_bad_case_and_shape_raise():
    scores, mask = _scores_and_mask(8)
    for bad in (0, 4):
        with pytest.raises(ValueError, match="roc_case"):
            roc.masked_scores(torch.from_numpy(scores),
                              torch.from_numpy(mask), bad)
        with pytest.raises(ValueError, match="roc_case"):
            jroc.masked_scores(scores, mask, bad)
    with pytest.raises(ValueError, match="mask"):
        roc.masked_scores(torch.from_numpy(scores), torch.from_numpy(mask[1:]))


def test_threshold_sweep_bit_equal_to_jax():
    """TPR and FPR bit-equal to JAX's, with scores sitting exactly on
    thresholds (accept when score >= threshold) and repeated scores."""
    rng = np.random.default_rng(1)
    thresholds = np.linspace(0.0, 1.0, 101)
    on = thresholds.astype(np.float32)[[0, 25, 50, 50, 77, 100]]
    genuine = np.concatenate([rng.uniform(0.3, 1.0, 500), on]).astype(
        np.float32)
    imposter = np.concatenate([rng.uniform(0.0, 0.7, 900), on, on]).astype(
        np.float32)
    jt, jf = jroc.threshold_sweep(genuine, imposter, thresholds)
    t, f = roc.threshold_sweep(torch.from_numpy(genuine),
                               torch.from_numpy(imposter), thresholds)
    assert t.dtype == f.dtype == torch.float32
    for got, want in ((t, jt), (f, jf)):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))
    # A score equal to a threshold is accepted at it.
    accepted = np.float32((genuine >= np.float32(0.5)).sum())
    assert float(t[50]) == float(accepted / np.float32(len(genuine)))


def test_roc_stats_and_gar_match_jax():
    rng = np.random.default_rng(2)
    genuine = rng.beta(5, 2, 700)
    imposter = rng.beta(2, 5, 2000)
    tpr, fpr = (np.asarray(a) for a in jroc.threshold_sweep(
        genuine, imposter, np.linspace(0, 1, 1001)))
    want = jroc.roc_stats(tpr, fpr)
    got = roc.roc_stats(torch.from_numpy(tpr), torch.from_numpy(fpr))
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-12
    for far in (0.1, 0.01, 0.001, 0.0):
        assert abs(roc.gar_at_far(tpr, fpr, far)
                   - jroc.gar_at_far(tpr, fpr, far)) <= 1e-12
    # NaN in the curve: nanargmin skips it, as in the JAX package.
    tn = tpr.copy()
    tn[3] = np.nan
    assert abs(roc.roc_stats(tn, fpr).eer - jroc.roc_stats(tn, fpr).eer) \
        <= 1e-12


def test_roc_from_scores_and_histograms_match_jax():
    scores, mask = _scores_and_mask(48, seed=3)
    thresholds = np.linspace(0.0, 1.0, 257)
    for case in (1, 2, 3):
        jt, jf, js = jroc.roc_from_scores(scores, mask, case, thresholds)
        t, f, s = roc.roc_from_scores(torch.from_numpy(scores),
                                      torch.from_numpy(mask), case,
                                      thresholds)
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(f, jf)
        assert all(abs(a - b) <= 1e-12 for a, b in zip(s, js))
    jg, ji = jroc.masked_scores(scores, mask, 3)
    g, i = roc.masked_scores(torch.from_numpy(scores), torch.from_numpy(mask))
    for a, b in zip(roc.score_histograms(g, i, bins=20),
                    jroc.score_histograms(jg, ji, bins=20)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_gallery_top1_matches_jax():
    """Image 0 of each subject is its gallery entry, the rest probes; a
    subject with no image is skipped; the score function may return a
    tensor."""
    rng = np.random.default_rng(4)
    images = rng.normal(size=(5, 4, 6)).astype(np.float32)
    counts = np.array([4, 1, 3, 0, 2], np.int32)
    images[1, 1:] = 0

    def score_np(p, g):
        return -((p[:, None] - g[None]) ** 2).sum(-1)

    want = jident.gallery_top1(score_np, JPersonStacks(images, counts))
    got = identification.gallery_top1(score_np, PersonStacks(images, counts))
    got_t = identification.gallery_top1(
        lambda p, g: torch.from_numpy(score_np(p, g)),
        PersonStacks(images, counts))
    assert abs(got - want) <= 1e-12 and got == got_t and 0 < got <= 1


# ---------------------------------------------------------- the chain ----

def _flax_head(dim, key=0, widths=(512, 64)):
    jh = JSiameseHead(widths=widths)
    p = jh.init(jax.random.PRNGKey(key), np.zeros((1, dim), np.float32),
                np.zeros((1, dim), np.float32))
    return jh, jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """One feature stack and one head, carried across by the converter: a
    port checkpoint, an orbax checkpoint, a mask with codes 1-4."""
    d = tmp_path_factory.mktemp("chain")
    n, dim = 24, 32
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(n, dim)).astype(np.float32)
    np.save(d / "feats.npy", feats)
    _, params = _flax_head(dim)
    JT.save(str(d / "jax_ckpt"), params)
    head = load_flax(SiameseHead(dim), params)
    T.save(str(d / "torch_ckpt"), head.state_dict())
    mask = np.zeros((n, n), int)
    iu = np.triu_indices(n, 1)
    mask[iu] = rng.integers(1, 5, len(iu[0]))
    np.savetxt(d / "mask.txt", mask, fmt="%d")
    return d, feats


def test_restore_head_and_score_matches_jax(chain):
    """Each package restores its own checkpoint of the same head and
    scores the grid: within the K1 plain version's bound."""
    d, feats = chain
    want = jgenerate_matrix.restore_head_and_score(str(d / "jax_ckpt"), feats)
    got = generate_matrix.restore_head_and_score(str(d / "torch_ckpt"), feats,
                                                 "cpu")
    assert got.shape == want.shape == (24, 24) and got.device.type == "cpu"
    assert np.abs(got.numpy() - want).max() < 2e-2
    T.save(str(d / "narrow_ckpt"), SiameseHead(32, (16, 8)).state_dict())
    with pytest.raises(ValueError, match="shape"):
        generate_matrix.restore_head_and_score(str(d / "narrow_ckpt"), feats,
                                               "cpu")
    out = d / "port_scores.txt"
    generate_matrix.main([str(d / "torch_ckpt"), str(out), "--features",
                          str(d / "feats.npy"), "--device", "cpu"])
    np.testing.assert_allclose(np.loadtxt(out), got.numpy(), rtol=0,
                               atol=1e-7)


def test_evaluate_on_the_same_matrix_prints_what_jax_prints(chain, tmp_path,
                                                            monkeypatch,
                                                            capsys):
    """Fed the same score matrix, JAX's and the port's ``evaluate`` print
    the same lines (stat lines and JSON) and write the same TPR/FPR
    files."""
    d, feats = chain
    scores = jgenerate_matrix.restore_head_and_score(str(d / "jax_ckpt"),
                                                     feats)
    monkeypatch.setattr(jgenerate_matrix, "restore_head_and_score",
                        lambda ckpt, f: scores)
    monkeypatch.setattr(evaluate, "restore_head_and_score",
                        lambda ckpt, f, device: torch.from_numpy(scores))
    outs = {}
    for name, mod, extra in (("jax", jevaluate, []),
                             ("torch", evaluate, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        mod.main(["--model_ckpt", "unused", "--mask", str(d / "mask.txt"),
                  "--features", str(d / "feats.npy"), "--roc_case", "0",
                  "--save_tprfpr", str(tmp_path / name / "tprfpr.txt")]
                 + extra)
        outs[name] = capsys.readouterr().out
    assert outs["torch"] == outs["jax"]
    lines = [json.loads(x) for x in outs["torch"].splitlines()
             if x.startswith("{")]
    assert [x["case"] for x in lines] == ["impersonation", "obfuscation",
                                          "overall"]
    for case in ("impersonation", "obfuscation", "overall"):
        f = f"tprfpr_{case}.txt"
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "torch" / f,
                           shallow=False)


def test_roc_precompute_and_get_stats_match_jax(chain, tmp_path, capsys):
    d, feats = chain
    scores = jgenerate_matrix.restore_head_and_score(str(d / "jax_ckpt"),
                                                     feats)
    np.save(tmp_path / "scores.npy", scores)
    for case in ("1", "2", "3"):
        jroc_precompute.main([str(tmp_path / "scores.npy"),
                              str(tmp_path / f"j{case}.txt"), case,
                              "--mask", str(d / "mask.txt")])
        roc_precompute.main([str(tmp_path / "scores.npy"),
                             str(tmp_path / f"t{case}.txt"), case,
                             "--mask", str(d / "mask.txt"), "--device",
                             "cpu"])
        assert filecmp.cmp(tmp_path / f"j{case}.txt",
                           tmp_path / f"t{case}.txt", shallow=False)
        capsys.readouterr()
        jget_stats.main([str(tmp_path / f"j{case}.txt")])
        want = capsys.readouterr().out
        get_stats.main([str(tmp_path / f"t{case}.txt")])
        assert capsys.readouterr().out == want
        assert want.startswith("AUC ") and "GAR is" in want


def test_tools_default_to_the_card(chain):
    """The CLIs default to --device cuda: without a card they raise, they
    do not fall back to the CPU."""
    d, _ = chain
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--model_ckpt", str(d / "torch_ckpt"), "--mask",
                       str(d / "mask.txt"), "--features",
                       str(d / "feats.npy")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_matrix.main([str(d / "torch_ckpt"), str(d / "x.npy"),
                              "--features", str(d / "feats.npy")])
    with pytest.raises(SystemExit):
        evaluate.main(["--model_ckpt", "x", "--mask", "y"])


# -------------------------------------------------------------- data ----

def test_make_synthetic_dfw_test_writes_what_jax_writes(tmp_path):
    """Same seed, same protocol: identical names, mask, image bytes, name
    list and mask file."""
    kw = dict(num_people=3, plain_per_person=2, disguised_per_person=2,
              impostors_per_person=2, image_size=16, seed=9)
    jroot, jnames, jmask = j_make_test(str(tmp_path / "jax"), **kw)
    root, names, mask = make_synthetic_dfw_test(str(tmp_path / "torch"),
                                                **kw)
    assert names == jnames and len(names) == 18
    assert mask.dtype == jmask.dtype
    np.testing.assert_array_equal(mask, jmask)
    for rel in names + ["Testing_data_face_name.txt",
                        "updated_testing_mask.txt"]:
        assert filecmp.cmp(os.path.join(jroot, rel), os.path.join(root, rel),
                           shallow=False), rel


def test_vectorised_mask_equals_the_double_loop():
    """``dfw_test_mask`` equals the JAX writer's double loop on a protocol
    with two impostors per person (code 0 for two impostors of one
    target), and on the DFW-shaped 3 + 3 + 1."""
    def loop(kinds, persons):
        n = len(kinds)
        mask = np.zeros((n, n), np.int64)
        for i in range(n):
            for j in range(i + 1, n):
                ki, kj = kinds[i], kinds[j]
                imp, dig = 2 in (ki, kj), 1 in (ki, kj)
                if ki == kj == 2:
                    code = 0 if persons[i] == persons[j] else 3
                elif imp:
                    code = 3
                elif persons[i] == persons[j]:
                    code = 2 if dig else 1
                else:
                    code = 4 if dig else 3
                mask[i, j] = mask[j, i] = code
        return mask

    for proto in ((4, 2, 3, 2), (5, 3, 3, 1)):
        kinds, persons = dfw_test_protocol(*proto)
        got = dfw_test_mask(kinds, persons)
        np.testing.assert_array_equal(got, loop(kinds, persons))
        assert set(np.unique(got)) == {0, 1, 2, 3, 4}
    kinds, persons = dfw_test_protocol(4, 2, 3, 2)
    off = ~np.eye(len(kinds), dtype=bool)
    assert (dfw_test_mask(kinds, persons)[off] == 0).any()


def test_generate_predictions_matches_jax(tmp_path, monkeypatch):
    """The same features as JAX's under a shared linear featurizer on the
    numpy weights; a missing file raises (the masks are positional).  Both
    sides decode with their portable PIL path (both native loaders
    switched off; tests/test_torch_port_native.py holds the native one)."""
    from PIL import Image

    from alink_tpu.data import native_loader
    from alink_tpu_torch.data import native_loader as tnative_loader

    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(tnative_loader, "available", lambda: False)

    rng = np.random.default_rng(6)
    names = []
    for i in range(5):
        name = f"face_{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (20, 20, 3),
                                     dtype=np.uint8)).save(tmp_path / name)
        names.append(name)
    w = rng.normal(size=(16 * 16 * 3, 8)).astype(np.float32)
    want = jgp.generate_predictions(
        str(tmp_path), names,
        lambda x: jnp.reshape(x, (x.shape[0], -1)) @ w, image_res=(16, 16),
        batch=2)
    wt = torch.from_numpy(w)
    got = generate_predictions.generate_predictions(
        str(tmp_path), names, lambda x: x.reshape(x.shape[0], -1) @ wt,
        image_res=(16, 16), batch=2, device="cpu")
    assert got.shape == (5, 8) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(FileNotFoundError, match="positional"):
        generate_predictions.generate_predictions(
            str(tmp_path), names[:2] + ["nope.jpg"],
            lambda x: x.reshape(x.shape[0], -1)[:, :4], image_res=(16, 16),
            device="cpu")


# ------------------------------------------------------------ active ----

def _probs_with_ties(seed=7):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(3), 20).astype(np.float32)
    p[[3, 9, 15]] = p[1]                 # exact ties
    p[[4, 11]] = [1.0, 0.0, 0.0]         # saturated
    p[[6, 13]] = [0.0, 0.0, 1.0]
    return p


@pytest.mark.parametrize("name", sorted(juncertainty.STRATEGIES))
def test_sampling_matches_jax(name):
    """The same indices as JAX's ``lax.top_k`` order, ties to the lower
    index, for each strategy."""
    p = _probs_with_ties()
    for n in (1, 5, 12):
        want = np.asarray(juncertainty.get_strategy(name)(jnp.asarray(p), n))
        got = uncertainty.get_strategy(name)(torch.from_numpy(p), n)
        np.testing.assert_array_equal(got.numpy(), want)


def test_uncertainty_measures_match_jax():
    p = _probs_with_ties()
    for f in ("classifier_uncertainty", "classifier_margin",
              "classifier_entropy"):
        want = np.asarray(getattr(juncertainty, f)(jnp.asarray(p)))
        got = getattr(uncertainty, f)(torch.from_numpy(p)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError):
        uncertainty.get_strategy("nope")


D = 24


def _states(widths=(16, 8), seed=0):
    """A JAX train state and the port's on the same f32 head."""
    jh = JSiameseHead(widths=widths, dtype=jnp.float32)
    js = JT.create_train_state(jh, jax.random.PRNGKey(seed),
                               jnp.zeros((2, D)), jnp.zeros((2, D)))
    head = load_flax(SiameseHead(D, widths, dtype=torch.float32),
                     jax.tree_util.tree_map(np.asarray, js.params))
    return js, T.TrainState(head, 1.0)


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    left = rng.normal(size=(n, D)).astype(np.float32)
    y = (rng.random(n) > 0.5).astype(np.int32)
    right = np.where(y[:, None] == 1, left + 0.3 * rng.normal(size=(n, D)),
                     rng.normal(size=(n, D))).astype(np.float32)
    return left, right, y


def test_active_learner_query_and_teach_match_jax():
    """``query`` gives the same indices; one ``teach`` of one full batch
    and one epoch (so the shuffle cannot matter) gives parameters within
    1e-5 of JAX's, after a step that moves them by more than 1e-4."""
    js, ts = _states()
    jl = jlearners.ActiveLearner(js, epochs=1, batch_size=64,
                                 validation_split=0.0)
    tl = learners.ActiveLearner(ts, epochs=1, batch_size=64,
                                validation_split=0.0)
    left, right, y = _pairs(64, 8)
    np.testing.assert_allclose(tl.predict_proba(left, right).numpy(),
                               np.asarray(jl.predict_proba(left, right)),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tl.query(left, right, 10),
                                  jl.query(left, right, 10))
    before = {k: v.clone() for k, v in ts.module.state_dict().items()}
    jl.teach(left, right, y)
    tl.teach(left, right, y)
    moved = max(float((v - before[k]).abs().max())
                for k, v in ts.module.state_dict().items())
    assert moved > 1e-4
    want = load_flax(SiameseHead(D, (16, 8), dtype=torch.float32),
                     jax.tree_util.tree_map(np.asarray, jl.state.params))
    for k, v in ts.module.state_dict().items():
        assert float((v - want.state_dict()[k]).abs().max()) <= 1e-5, k
    assert tl.score(left, right, y) == pytest.approx(
        jl.score(left, right, y), abs=1e-6)
    np.testing.assert_array_equal(tl.predict(left, right).numpy(),
                                  np.asarray(jl.predict(left, right)))


def test_bayesian_optimizer_matches_jax():
    js, ts = _states(widths=(8, 4), seed=1)
    jb = jlearners.BayesianOptimizer(js, epochs=1, batch_size=16,
                                     validation_split=0.0)
    tb = learners.BayesianOptimizer(ts, epochs=1, batch_size=16,
                                    validation_split=0.0)
    left, right, y = _pairs(16, 9)
    jb.fit(left, right, y)
    tb.fit(left, right, y)
    (jx, jy), (tx, ty) = jb.get_max(), tb.get_max()
    assert ty == jy == float(y.max())
    np.testing.assert_array_equal(tx[0], jx[0])
    np.testing.assert_array_equal(tx[1], jx[1])
    np.testing.assert_array_equal(tb.query(left, right, 4),
                                  jb.query(left, right, 4))


def test_committee_regressor_matches_jax():
    rng = np.random.default_rng(10)
    left, right = (rng.normal(size=(9, D)).astype(np.float32)
                   for _ in range(2))
    left[4], right[4] = left[2], right[2]            # a tie in std

    def members(xp):
        def predict(params, l, r):
            return params * xp.mean(xp.abs(l - r), axis=-1)
        return [(1.0, predict), (3.0, predict), (2.5, predict)]

    jc = jlearners.CommitteeRegressor(members(jnp))
    tc = learners.CommitteeRegressor([
        (s, lambda p, l, r: p * torch.mean(torch.abs(l - r), dim=-1))
        for s, _ in members(np)])
    jm, jsd = jc.predict(left, right, return_std=True)
    tm, tsd = tc.predict(torch.from_numpy(left), torch.from_numpy(right),
                         return_std=True)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(tsd.numpy(), np.asarray(jsd), rtol=1e-6)
    np.testing.assert_array_equal(
        tc.query(torch.from_numpy(left), torch.from_numpy(right), 5),
        jc.query(left, right, 5))


def test_query_committee_matches_jax():
    """Vote entropy takes few values, so the query's ties go to the lower
    index, as in JAX."""
    heads = [_flax_head(D, key=k, widths=(16, 8)) for k in (0, 5, 11)]
    jq = jlearners.QueryCommittee(JCommittee.from_param_list(
        heads[0][0], [p for _, p in heads]))
    tq = learners.QueryCommittee(Committee.from_param_list(
        SiameseHead(D, (16, 8)),
        [load_flax(SiameseHead(D, (16, 8)), p).state_dict()
         for _, p in heads]))
    rng = np.random.default_rng(12)
    left, right = (rng.normal(size=(30, D)).astype(np.float32)
                   for _ in range(2))
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    np.testing.assert_array_equal(tq.vote(lt, rt).numpy(),
                                  np.asarray(jq.vote(left, right)))
    np.testing.assert_allclose(tq.vote_entropy(lt, rt).numpy(),
                               np.asarray(jq.vote_entropy(left, right)),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tq.query(lt, rt, 8),
                                  jq.query(left, right, 8))


# ---------------------------------------------------- eval_regression ----

@pytest.fixture(scope="module")
def artifact():
    """The JAX fixture's settings (tests/test_eval_regression.py), on the
    CPU, with a seeded linear featurizer."""
    from alink_tpu_torch.tools.eval_regression import run_eval_regression

    size, dim = 16, 64
    w = torch.randn((size * size * 3, dim),
                    generator=torch.Generator().manual_seed(0)) / 30.0

    def feat(imgs):
        return imgs.reshape(imgs.shape[0], -1).float() / 255.0 @ w

    return run_eval_regression(
        None, num_people=6, test_people=4, image_size=size, featurize=feat,
        feature_res=dim, n_steps=512, m2_n_steps=96, dig_epochs=1,
        undig_epochs=8, noise_bank=("gaussian", "speckle"), seed=7,
        verbose=False, device="cpu")


def test_eval_regression_chain_and_stages(artifact):
    assert artifact["chain"] == ["generate_predictions", "generate_matrix",
                                 "roc_precompute", "get_stats"]
    assert set(artifact["stages"]) == {"pre", "alink", "a2link",
                                       "existing_al"}
    for stage in artifact["stages"].values():
        for case in ("impersonation", "obfuscation", "overall"):
            s = stage[case]
            assert 0.0 <= s["auc"] <= 1.0 and 0.0 <= s["eer"] <= 1.0
            assert s["n_genuine"] > 0 and s["n_imposter"] > 0
    assert artifact["protocol"]["test_faces"] == 4 * 5


def test_eval_regression_loops_queried_at_equal_budget(artifact):
    st = artifact["stages"]
    assert st["alink"]["overall"]["oracle_queries"] > 0
    assert st["a2link"]["overall"]["oracle_queries"] > 0
    assert (st["existing_al"]["overall"]["oracle_queries"]
            == st["alink"]["overall"]["oracle_queries"])


def test_eval_regression_records_the_15_flags(artifact):
    with open(os.path.join(REPO, "EVAL_r05.json")) as f:
        want = json.load(f)["ordering"]
    flags = artifact["ordering"]
    assert sorted(flags) == sorted(want) and len(flags) == 15
    assert all(isinstance(v, bool) for v in flags.values())
    assert flags["alink_auc_gt_pre"] == flags["alink_auc_gt_pre_overall"]


def test_port_walk_reaches_the_evaluation_modules():
    """The no-JAX import check walks the package: the new subpackage and
    modules are among what it imports."""
    code = ("import pkgutil, alink_tpu_torch\n"
            "print(' '.join(m.name for m in pkgutil.walk_packages("
            "alink_tpu_torch.__path__, 'alink_tpu_torch.')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    names = set(res.stdout.split())
    for mod in ("evaluation", "evaluation.roc", "evaluation.identification",
                "active.learners", "active.uncertainty",
                "tools.evaluate", "tools.eval_regression",
                "tools.generate_matrix", "tools.generate_predictions",
                "tools.roc_precompute", "tools.get_stats"):
        assert f"alink_tpu_torch.{mod}" in names, mod
