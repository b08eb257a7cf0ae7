"""The port's ops against the JAX package's, on the CPU.

Inputs come from ``np.random.default_rng``; both sides get the same arrays.
Tolerances: discrete results (keep masks, valid masks, indices, rounded
box corners) must be identical; floats agree to 1e-4 (f32 arithmetic in
another order).  The warp's plain version is held to the JAX einsum warp
(what ``align_faces`` runs on the CPU) at 1.5 on 0-255, the JAX package's
own warp budget, and to the four-tap gather oracle at 1e-3.  The score
matrix is held to 2e-2 (bf16 head operands), as ``test_pairwise.py``.
The CUDA kernels themselves run only on the card (``chip_smoke.py``);
here their wrappers must refuse CPU tensors rather than fall back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu.models import SiameseHead as JSiameseHead
from alink_tpu.ops import boxes as jboxes
from alink_tpu.ops import image as jimage
from alink_tpu.ops import nms as jnms
from alink_tpu.ops import pairwise as jpairwise
from alink_tpu.ops import umeyama as jumeyama
from alink_tpu_torch.convert import load_flax
from alink_tpu_torch.models import SiameseHead
from alink_tpu_torch.ops import boxes, image, nms, pairwise, umeyama
from alink_tpu_torch.utils.profiling import counting


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rand_boxes(rng, k, span=60.0, size=(8.0, 30.0)):
    xy = rng.uniform(0, span, (k, 2))
    wh = rng.uniform(*size, (k, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# ---------------------------------------------------------------- boxes ---


@pytest.mark.parametrize("hw,budget", [((7, 9), 16), ((4, 5), 32)])
def test_generate_bbox_matches_jax(hw, budget):
    rng = np.random.default_rng(1)
    prob = rng.uniform(size=hw).astype(np.float32)
    prob[1, 2] = prob[0, 0]  # an exact tie: lower flat index first
    reg = rng.normal(size=hw + (4,)).astype(np.float32)
    want = jboxes.generate_bbox(jnp.asarray(prob), jnp.asarray(reg), 0.3, 0.5,
                                budget)
    got = boxes.generate_bbox(_t(prob), _t(reg), 0.3, 0.5, budget)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_generate_bbox_batched_equals_per_image():
    rng = np.random.default_rng(2)
    prob = _t(rng.uniform(size=(3, 6, 5)).astype(np.float32))
    reg = _t(rng.normal(size=(3, 6, 5, 4)).astype(np.float32))
    batched = boxes.generate_bbox(prob, reg, 0.5, 0.3, 12)
    for i in range(3):
        single = boxes.generate_bbox(prob[i], reg[i], 0.5, 0.3, 12)
        for b, s in zip(batched, single):
            assert torch.equal(b[i], s)


def test_box_arithmetic_matches_jax():
    rng = np.random.default_rng(3)
    b = _rand_boxes(rng, 20, span=80.0)
    b[:, :2] -= 10.0  # some corners outside the image
    reg = rng.normal(0, 0.1, (20, 4)).astype(np.float32)
    pairs = [
        (boxes.calibrate_box(_t(b), _t(reg)),
         jboxes.calibrate_box(jnp.asarray(b), jnp.asarray(reg))),
        (boxes.refine_with_reg(_t(b), _t(reg)),
         jboxes.refine_with_reg(jnp.asarray(b), jnp.asarray(reg))),
        (boxes.convert_to_square(_t(b)),
         jboxes.convert_to_square(jnp.asarray(b))),
        (boxes.clip_to_image(_t(b), 64, 48),
         jboxes.clip_to_image(jnp.asarray(b), 64, 48)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("budget", [6, 40])
def test_select_topk_matches_jax(budget):
    rng = np.random.default_rng(4)
    b = _rand_boxes(rng, 24)
    s = rng.uniform(size=24).astype(np.float32)
    s[5] = s[9] = s[17]  # exact ties keep the lower index first
    v = rng.uniform(size=24) > 0.3
    lmk = rng.normal(size=(24, 5, 2)).astype(np.float32)
    want = jboxes.select_topk(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v),
                              budget, jnp.asarray(lmk))
    got = boxes.select_topk(_t(b), _t(s), _t(v), budget, _t(lmk))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------ nms ---


def test_iou_matrix_matches_jax():
    b = _rand_boxes(np.random.default_rng(5), 30)
    for mode in ("union", "min"):
        np.testing.assert_allclose(
            nms.iou_matrix(_t(b), mode).numpy(),
            np.asarray(jnms.iou_matrix(jnp.asarray(b), mode)), atol=1e-6)


@pytest.mark.parametrize("k", [40, 300])
@pytest.mark.parametrize("mode", ["union", "min"])
def test_nms_matches_jax_greedy(k, mode):
    """Both JAX paths (Jacobi below 256, blocked at 256+), exact masks,
    with duplicated scores to exercise the (score, index) tie-break."""
    rng = np.random.default_rng(k)
    b = _rand_boxes(rng, k, span=100.0)
    s = rng.uniform(size=k).astype(np.float32)
    s[rng.integers(0, k, k // 4)] = s[0]
    v = rng.uniform(size=k) > 0.2
    want = np.asarray(jnms.nms(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v),
                               0.4, mode=mode))
    got = nms.nms(_t(b), _t(s), _t(v), 0.4, mode=mode).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < v.sum()


def test_nms_batch_matches_jax():
    rng = np.random.default_rng(6)
    b = np.stack([_rand_boxes(rng, 32) for _ in range(3)])
    s = rng.uniform(size=(3, 32)).astype(np.float32)
    v = rng.uniform(size=(3, 32)) > 0.1
    want = np.asarray(jnms.nms_batch(jnp.asarray(b), jnp.asarray(s),
                                     jnp.asarray(v), 0.5))
    np.testing.assert_array_equal(
        nms.nms_batch(_t(b), _t(s), _t(v), 0.5).numpy(), want)


# -------------------------------------------------------------- umeyama ---


def test_umeyama_matches_jax():
    rng = np.random.default_rng(7)
    tpl = np.asarray(jumeyama.arcface_template((112, 112)))
    src = (tpl[None] * rng.uniform(0.5, 2.0, (6, 1, 1))
           + rng.normal(0, 3, (6, 5, 2)) + 20).astype(np.float32)
    want = np.stack([np.asarray(jumeyama.umeyama(jnp.asarray(p),
                                                 jnp.asarray(tpl)))
                     for p in src])
    got = umeyama.umeyama(_t(src), umeyama.arcface_template((112, 112)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("size", [(112, 112), (112, 96)])
def test_arcface_template_matches_jax(size):
    np.testing.assert_array_equal(
        umeyama.arcface_template(size).numpy(),
        np.asarray(jumeyama.arcface_template(size)))
    with pytest.raises(ValueError):
        umeyama.arcface_template((100, 100))


# ---------------------------------------------------------------- image ---


@pytest.mark.parametrize("src,dst", [((160, 160), (48, 48)),
                                     ((160, 160), (25, 25)),
                                     ((37, 41), (13, 17)),
                                     ((20, 23), (33, 41))])
def test_resize_matches_jax(src, dst):
    """Downscale (the pyramid) and upscale, edges included."""
    x = np.random.default_rng(8).uniform(
        0, 255, (2,) + src + (3,)).astype(np.float32)
    want = np.asarray(jimage.resize(jnp.asarray(x), dst))
    np.testing.assert_allclose(image.resize(_t(x), dst).numpy(), want,
                               atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(image.resize(_t(x[0]), dst).numpy(), want[0],
                               atol=1e-4, rtol=1e-6)


def test_cast_like_rounds_half_even_and_saturates():
    x = torch.tensor([-3.0, 0.5, 1.5, 2.49, 254.5, 255.5, 300.0])
    np.testing.assert_array_equal(
        image._cast_like(x, torch.uint8).numpy(),
        np.asarray(jimage._cast_like(jnp.asarray(x.numpy()), jnp.uint8)))
    assert torch.equal(image._cast_like(x, torch.float32), x)


def test_inv2x2_matches_jax():
    A = np.random.default_rng(9).normal(size=(5, 2, 2)).astype(np.float32)
    np.testing.assert_allclose(image._inv2x2(_t(A)).numpy(),
                               np.asarray(jimage._inv2x2(jnp.asarray(A))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fold", [False, True])
def test_crop_and_resize_matches_jax(fold):
    """Boxes inside, across the border and smaller than the output
    (upscale), with and without the mtcnn (x - 127.5) * 2^-7 fold."""
    rng = np.random.default_rng(10)
    img = rng.uniform(0, 255, (40, 50, 3)).astype(np.float32)
    b = np.round(np.concatenate([_rand_boxes(rng, 5, 40.0, (10, 40)),
                                 [[-8, -5, 20, 30], [30, 25, 60, 55]]]))
    b = b.astype(np.float32)
    kw = dict(offset=127.5, scale=0.0078125) if fold else {}
    want = np.asarray(jimage.crop_and_resize(jnp.asarray(img), jnp.asarray(b),
                                             (24, 24), **kw))
    got = image.crop_and_resize(_t(img), _t(b), (24, 24), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # Batched: each image with its own boxes.
    batched = image.crop_and_resize(_t(np.stack([img, img[::-1]])),
                                    _t(np.stack([b, b])), (24, 24), **kw)
    np.testing.assert_allclose(batched[0].numpy(), want, atol=1e-4)


def _warp_inputs(seed, n=3, h=21, w=17):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    th = rng.uniform(-0.8, 0.8, n)
    sc = rng.uniform(0.7, 1.4, n)
    t = rng.uniform(-3, 3, (n, 2))
    c, s = np.cos(th) * sc, np.sin(th) * sc
    Ms = np.stack([np.stack([c, -s, t[:, 0]], -1),
                   np.stack([s, c, t[:, 1]], -1)], 1).astype(np.float32)
    return imgs, Ms


@pytest.mark.parametrize("border", ["zero", "nearest"])
@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_warp_plain_matches_jax_warp(border, interp):
    imgs, Ms = _warp_inputs(11)
    got = image.affine_warp_batch_reference(_t(imgs), _t(Ms), (13, 19),
                                            border, interp).numpy()
    want = np.asarray(jimage.affine_warp_batch(
        jnp.asarray(imgs), jnp.asarray(Ms), (13, 19), border=border,
        interp=interp))
    np.testing.assert_allclose(got, want, atol=1.5)


@pytest.mark.parametrize("border", ["zero", "nearest"])
def test_warp_plain_matches_gather_oracle(border):
    imgs, Ms = _warp_inputs(12)
    got = image.affine_warp_batch_reference(_t(imgs), _t(Ms), (13, 19),
                                            border).numpy()
    want = np.stack([np.asarray(jimage._affine_warp_gather(
        jnp.asarray(imgs[i]), jnp.asarray(Ms[i]), (13, 19), border=border))
        for i in range(len(imgs))])
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_warp_plain_uint8_matches_jax():
    imgs, Ms = _warp_inputs(13)
    u8 = np.round(imgs).astype(np.uint8)
    got = image.affine_warp_batch_reference(_t(u8), _t(Ms), (13, 19))
    want = np.asarray(jimage.affine_warp_batch(jnp.asarray(u8),
                                               jnp.asarray(Ms), (13, 19)))
    assert got.dtype == torch.uint8
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("border", ["zero", "nearest"])
@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_warp_plain_singular_transforms_match_jax(border, interp):
    """det 0 gives NaN and infinite sample coordinates: NaN pixels (0 in
    uint8) and out-of-image samples must land where the JAX warp puts them.
    The translations make some coordinates +-inf, not NaN."""
    imgs, _ = _warp_inputs(18)
    Ms = np.array([[[0, 0, 3], [0, 0, 4]],        # all landmarks at one point
                   [[1, 1, 0], [1, 1, 10]],       # rank 1: NaN and +-inf
                   [[2, 0, -5], [0, 0, 2]]], np.float32)
    for x in (imgs, np.round(imgs).astype(np.uint8)):
        got = image.affine_warp_batch_reference(_t(x), _t(Ms), (13, 19),
                                                border, interp).numpy()
        want = np.asarray(jimage.affine_warp_batch(
            jnp.asarray(x), jnp.asarray(Ms), (13, 19), border=border,
            interp=interp))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), atol=1.5)
    assert np.isnan(got).sum() == 0 and (got[0] == 0).all()


def test_warp_plain_matches_pallas_interpret():
    """One tiny call of the TPU kernel in interpret mode."""
    imgs, Ms = _warp_inputs(14, n=2)
    want = np.asarray(jimage.affine_warp_batch_pallas(
        jnp.asarray(imgs), jnp.asarray(Ms), (13, 19), interpret=True))
    got = image.affine_warp_batch_reference(_t(imgs), _t(Ms), (13, 19))
    np.testing.assert_allclose(got.numpy(), want, atol=1.5)


def test_warp_dispatch_on_cpu_and_kernel_refuses_cpu():
    imgs, Ms = _warp_inputs(15)
    with counting() as made:
        out = image.affine_warp_batch(_t(imgs), _t(Ms), (13, 19))
        with pytest.raises(ValueError):
            image.affine_warp_batch_kernel(_t(imgs), _t(Ms), (13, 19))
    assert torch.equal(out, image.affine_warp_batch_reference(
        _t(imgs), _t(Ms), (13, 19)))
    assert made["launches.k2"] == 0


# ------------------------------------------------------------- pairwise ---


@pytest.fixture(scope="module")
def heads():
    """(jax params, port head) for softmax and sigmoid heads, D = 96.
    flax initialises biases to zero; random ones make every bias count."""
    out = {}
    rng = np.random.default_rng(19)

    def leaf(path, x):
        if path[-1].key == "bias":
            return rng.normal(0.0, 0.5, x.shape).astype(np.float32)
        return np.asarray(x)

    for i, kind in enumerate(("softmax", "sigmoid")):
        jh = JSiameseHead(head=kind, dtype=jnp.float32)
        p = jh.init(jax.random.PRNGKey(i), jnp.zeros((1, 96)),
                    jnp.zeros((1, 96)))
        p = jax.tree_util.tree_map_with_path(leaf, p)
        head = load_flax(SiameseHead(96, head=kind, dtype=torch.float32), p)
        out[kind] = (p, head)
    return out


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(16)
    return (rng.normal(size=(37, 96)).astype(np.float32),
            rng.normal(size=(53, 96)).astype(np.float32))


def test_head_weights_match_jax(heads):
    for p, head in heads.values():
        for (w, b), (jw, jb) in zip(pairwise.head_weights(head),
                                    jpairwise.head_weights(p)):
            np.testing.assert_array_equal(w.detach().numpy(), np.asarray(jw))
            np.testing.assert_array_equal(b.detach().numpy(), np.asarray(jb))


@pytest.mark.parametrize("kind", ["softmax", "sigmoid"])
def test_score_matrix_plain_matches_xla(heads, feats, kind, monkeypatch):
    p, head = heads[kind]
    rows, cols = feats
    want = np.asarray(jpairwise.score_matrix_xla(
        p, jnp.asarray(rows), jnp.asarray(cols), row_block=16, col_block=32))
    got = pairwise.score_matrix(head, _t(rows), _t(cols))
    assert got.shape == (37, 53)
    assert np.abs(got.numpy() - want).max() < 2e-2
    # Ragged row blocks only change the blocking of the matmuls.
    monkeypatch.setattr(pairwise, "_MAX_TILE_ELEMS", 5 * 53 * 96)
    small = pairwise.score_matrix_reference(head, _t(rows), _t(cols))
    assert torch.allclose(small, got, atol=1e-6)


def test_score_matrix_plain_matches_pallas_interpret(heads, feats):
    p, head = heads["softmax"]
    rows, cols = feats
    want = np.asarray(jpairwise.score_matrix_pallas(
        p, jnp.asarray(rows), jnp.asarray(cols), row_block=16, col_block=128,
        d_chunk=128, interpret=True))
    got = pairwise.score_matrix_reference(head, _t(rows), _t(cols))
    assert np.abs(got.numpy() - want).max() < 2e-2


def test_pair_scores_match_jax_and_diagonal(heads, feats):
    p, head = heads["softmax"]
    rows = feats[0]
    want = np.asarray(jpairwise.pair_scores(p, jnp.asarray(rows),
                                            jnp.asarray(rows[::-1])))
    got = pairwise.pair_scores(head, _t(rows), _t(rows[::-1]))
    assert np.abs(got.numpy() - want).max() < 2e-2
    diag = torch.diagonal(pairwise.score_matrix(head, _t(rows), _t(rows)))
    assert torch.allclose(diag, pairwise.pair_scores(head, _t(rows), _t(rows)),
                          atol=1e-6)


def test_identification_topk_matches_jax_with_ties(heads):
    p, head = heads["softmax"]
    rng = np.random.default_rng(17)
    gallery = rng.normal(size=(11, 96)).astype(np.float32)
    gallery[7] = gallery[2]  # duplicate rows: exact score ties
    probes = gallery[[2, 5, 9]]
    jv, ji = jpairwise.identification_topk(p, jnp.asarray(probes),
                                           jnp.asarray(gallery), k=4)
    v, i = pairwise.identification_topk(head, _t(probes), _t(gallery), k=4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert np.abs(v.numpy() - np.asarray(jv)).max() < 2e-2
    assert bool(torch.all(v[:, :-1] >= v[:, 1:]))


def test_scorer_dispatch_on_cpu_and_kernel_refuses_cpu(heads, feats):
    _, head = heads["softmax"]
    rows, cols = feats
    with pytest.raises(ValueError):
        pairwise.score_matrix_kernel(head, _t(rows), _t(cols))
    # A head without exactly two hidden layers takes the plain path.
    three = SiameseHead(96, (32, 16, 8), dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0))
    assert pairwise.score_matrix(three, _t(rows), _t(cols)).shape == (37, 53)
