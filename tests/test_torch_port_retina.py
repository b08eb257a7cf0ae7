"""RetinaFace-R50's detector (``models/retinaface.py``, ``detect/retina.py``)
on the CPU, against the plain float32 reference ``tests/plain_retinaface.py``
(no JAX counterpart exists), on a tiny preset: backbone widths (8, 16, 32,
64) x 4, FPN and SSH 16 wide with the published slope 0, 96^2 photos,
batch 2, top-k 64, keep 16.  The heads in float32 and in bf16; the prior
order against the heads' layout; decode; the post-process exact when
teacher-forced; the NMS kernel's host mirror against ``ops.nms.nms`` and a
plain greedy loop; ``FaceModel(detector=...)`` end to end; the cascade's
path unchanged; spans and counters.
"""

from __future__ import annotations

import pytest
import torch

import plain_retinaface as plain
from alink_tpu_torch.detect import (CascadeConfig, FaceModel, RetinaConfig,
                                    RetinaFaceDetector, align_faces,
                                    detect_faces, init_cascade_params,
                                    priors)
from alink_tpu_torch.detect.retina import decode
from alink_tpu_torch.models import ArcFaceResNet100, RetinaFaceR50
from alink_tpu_torch.ops import nms as N
from alink_tpu_torch.utils import profiling as P

TINY = dict(widths=(8, 16, 32, 64), out_channels=16)
PHOTO = 96
CFG = RetinaConfig(top_k=64, keep_top_k=16)
# float32 convolutions on both sides, but the port's 13 stride-1 blocks
# keep K3's numerics on every device (bf16 operands, y1, y2 and outputs):
# ~2^-9 relative a rounding, over 13 blocks and the FPN and SSH after them.
F32_TOL = 2e-2
# bf16 convolutions besides (every operand and output of the stem, the
# strided blocks, the FPN and SSH rounded to bf16).
BF16_TOL = 6e-2


def _model(dtype=torch.float32, seed=0) -> RetinaFaceR50:
    """The tiny preset, its BN statistics moved off identity and the stem's
    BN at the second moment of the mean-subtracted levels (as the
    benchmark's configuration assumes), so activations stay near 1."""
    m = RetinaFaceR50(dtype=dtype, generator=torch.Generator().manual_seed(
        seed), **TINY).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in m.named_buffers():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("gamma", "var"):
                t.copy_(0.8 + 0.4 * torch.rand(t.shape, generator=g))
            elif leaf in ("beta", "mean"):
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
        m.body.bn[0].var.mul_(5688.83)
        for h in list(m.class_head) + list(m.bbox_head):
            h.bias.copy_(0.1 * torch.randn(h.bias.shape, generator=g))
    m.refold()
    return m


def _photos(n=2, seed=3) -> torch.Tensor:
    return torch.randint(0, 256, (n, PHOTO, PHOTO, 3),
                         generator=torch.Generator().manual_seed(seed)
                         ).float()


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_heads_match_the_plain_reference(dtype, tol):
    m = _model(dtype)
    x = _photos()
    got = m(x)
    want = plain.forward(m.state_dict(), x)
    anchors = 2 * sum((PHOTO // s) ** 2 for s in (8, 16, 32))
    for g_, w_, k in zip(got, want, (4, 2, 10)):
        assert g_.dtype == torch.float32 and g_.shape == (2, anchors, k)
        assert _rel(g_, w_) < tol, (k, _rel(g_, w_))


def test_folded_weights_follow_edits_and_loads():
    """The model caches its folded weights and the backbone's K3 layout
    (``resnet.FoldCache``): after a forward, an edit in place (a backbone
    BN and an FPN BN) shows only after ``refold()``, which drops both
    caches; ``load_state_dict`` drops them too."""
    x = _photos(1)
    a, b = _model(seed=0), _model(seed=1)
    before = a(x)
    with torch.no_grad():
        a.body.blocks[1].bn[0].gamma.mul_(1.5)
        a.fpn["merge1"].bn.beta.add_(0.25)
    assert all(torch.equal(p, q) for p, q in zip(a(x), before))
    a.refold()
    edited = a(x)
    assert not torch.equal(edited[0], before[0])
    fresh = _model(seed=0)
    fresh.load_state_dict(a.state_dict())
    assert all(torch.equal(p, q) for p, q in zip(fresh(x), edited))
    b(x)
    b.load_state_dict(a.state_dict())
    assert all(torch.equal(p, q) for p, q in zip(b(x), edited))


def test_priors_follow_the_heads_layout():
    """Prior a is level l, row i, column j, anchor m in that order, as the
    heads' NHWC views lay out their outputs: the box head's output at a
    equals the level's 1x1 head applied to the SSH output at (i, j),
    anchor m; and the priors equal ``PriorBox``'s."""
    m = _model()
    pri = priors(PHOTO, PHOTO, CFG)
    assert torch.equal(pri, plain.prior_box(PHOTO, PHOTO))
    feats = []
    orig = m._ssh

    def keep_ssh(x, w):
        y = orig(x, w)
        feats.append(y)
        return y

    m._ssh = keep_ssh
    loc, _, _ = m(_photos(1))
    a = 0
    for lvl, (f, step) in enumerate(zip(feats, (8, 16, 32))):
        conv = m.bbox_head[lvl]
        for i in range(f.shape[2]):
            for j in range(f.shape[3]):
                cell = f[0, :, i, j].float() @ conv.weight[:, :, 0, 0].t() \
                    + conv.bias
                for anc, size in enumerate(CFG.min_sizes[lvl]):
                    assert torch.allclose(loc[0, a], cell[4 * anc:4 * anc + 4],
                                          atol=1e-5)
                    want = torch.tensor([(j + .5) * step / PHOTO,
                                         (i + .5) * step / PHOTO,
                                         size / PHOTO, size / PHOTO])
                    assert torch.allclose(pri[a], want)
                    a += 1
    assert a == loc.shape[1] == pri.shape[0]


def test_decode_matches_the_plain_reference():
    g = torch.Generator().manual_seed(5)
    pri = priors(PHOTO, PHOTO, CFG)
    loc = torch.randn(2, pri.shape[0], 4, generator=g)
    lm = torch.randn(2, pri.shape[0], 10, generator=g)
    boxes, marks = decode(loc, lm, pri, PHOTO, PHOTO)
    for n in range(2):
        want = plain.decode(loc[n], pri) * PHOTO
        assert torch.allclose(boxes[n], want, rtol=0, atol=1e-4)
        want = plain.decode_landm(lm[n], pri) * PHOTO
        assert torch.allclose(marks[n].reshape(-1, 10), want, rtol=0,
                              atol=1e-4)


def _scores_and_boxes(n, a, seed):
    """Scores on a grid of 1/16 (ties by the dozen, some below 0.02) and
    integer boxes that often overlap."""
    g = torch.Generator().manual_seed(seed)
    s = torch.randint(0, 16, (n, a), generator=g).float() / 16
    xy = torch.randint(0, 40, (n, a, 2), generator=g).float()
    wh = torch.randint(1, 30, (n, a, 2), generator=g).float()
    return s, torch.cat([xy, xy + wh], -1)


@pytest.mark.parametrize("seed", [0, 1])
def test_post_process_exact_when_teacher_forced(seed):
    a = 2 * sum((PHOTO // s) ** 2 for s in (8, 16, 32))
    s, b = _scores_and_boxes(2, a, seed)
    marks = torch.randn(2, a, 5, 2)
    det = RetinaFaceDetector(_model(), CFG)
    got, anchors = det.select(b, s, marks)
    want = plain.post(s, b, CFG.confidence, CFG.top_k, CFG.nms_threshold,
                      CFG.keep_top_k)
    for n in range(2):
        k = len(want[n])
        assert got.valid[n].tolist() == [True] * k + [False] * (16 - k)
        assert anchors[n, :k].tolist() == want[n]
        assert torch.equal(got.boxes[n, :k], b[n, want[n]])
        assert torch.equal(got.scores[n, :k], s[n, want[n]])
        assert torch.equal(got.landmarks[n, :k], marks[n, want[n]])


def _greedy(boxes, scores, valid, threshold):
    """A plain greedy loop: visit by descending score (ties to the lower
    index), keep a valid candidate no kept one overlaps above the
    threshold (inclusive areas; float32 overlaps against the float32
    threshold, as numpy's float32 ``ovr <= thresh``)."""
    order = sorted(range(len(scores)), key=lambda i: (-float(scores[i]), i))
    keep = [False] * len(scores)
    kept = []
    for i in order:
        if not valid[i]:
            continue
        if all(bool(N.iou_matrix(boxes[[j, i]])[0, 1]
                    <= torch.tensor(threshold)) for j in kept):
            keep[i] = True
            kept.append(i)
    return torch.tensor(keep, dtype=torch.bool)


def _sweep_mirror(boxes, scores, valid, threshold):
    """``csrc/nms.cu``'s algorithm in Python on (K, 4) boxes and (K,)
    scores and valid of one photo -> (K,) bool keep: the visit order
    (``nms_kernel``'s callers sort into it); the mask words (bit j of word
    (i, c): candidate i suppresses the later 64 c + j), upper triangle of
    64-candidate blocks only; then the sweep, block by block: the block's
    candidates resolved one after another from its removed bits and
    diagonal words, then the kept rows' words ORed into the later blocks'
    removed bits."""
    k, word = boxes.shape[0], N.WORD
    order = torch.sort(scores, descending=True, stable=True)[1]
    b, v = boxes[order].float(), valid[order].bool().tolist()
    over = (N.iou_matrix(b) > threshold).tolist()
    words = -(-k // word)
    mask = {}
    for i in range(k):
        for c in range(i // word, words):
            mask[i, c] = sum(1 << (j - word * c)
                             for j in range(max(word * c, i + 1),
                                            min(word * (c + 1), k))
                             if over[i][j])
    removed = [0] * words
    keep = [False] * k
    for blk in range(words):
        base, rows = word * blk, min(word, k - word * blk)
        rem, kw = removed[blk], 0
        for t in range(rows):
            if v[base + t] and not (rem >> t) & 1:
                kw |= 1 << t
                rem |= mask[base + t, blk]
        for t in range(rows):
            keep[base + t] = bool((kw >> t) & 1)
            if (kw >> t) & 1:
                for c in range(blk + 1, words):
                    removed[c] |= mask[base + t, c]
    out = torch.zeros(k, dtype=torch.bool)
    out[order] = torch.tensor(keep, dtype=torch.bool)
    return out


@pytest.mark.parametrize("k", [1, 63, 64, 65, 300])
def test_nms_kernel_mirror_equals_nms_and_a_greedy_loop(k):
    """The kernel's block-and-sweep algorithm (``_sweep_mirror``) against
    ``ops.nms.nms`` and a plain greedy loop, with tied scores and pairs
    whose overlap is exactly 0.4 (a 4 x 10 box inside a 10 x 10 one:
    40 / 100), which the threshold keeps."""
    g = torch.Generator().manual_seed(k)
    s, b = _scores_and_boxes(1, k, k)
    s, b = s[0], b[0]
    v = torch.rand(k, generator=g) > 0.15
    pairs = min(k // 2, 20)
    for p in range(pairs):
        x, y = float(3 * p), float(2 * p)
        b[2 * p] = torch.tensor([x, y, x + 9, y + 9])
        b[2 * p + 1] = torch.tensor([x, y, x + 3, y + 9])
        s[2 * p + 1] = s[2 * p]
    if pairs:
        at = N.iou_matrix(b[:2 * pairs])[torch.arange(0, 2 * pairs, 2),
                                          torch.arange(1, 2 * pairs, 2)]
        assert bool((at == torch.tensor(0.4)).all())
    got = _sweep_mirror(b, s, v, 0.4)
    assert torch.equal(got, N.nms(b[None], s[None], v[None], 0.4)[0])
    assert torch.equal(got, _greedy(b, s, v, 0.4))


@pytest.mark.parametrize("words", [1, 2, 3, 78, 79, 80, 313])
def test_nms_mask_grid_covers_the_upper_triangle_once(words):
    """``csrc/nms.cu``'s ``nms_mask`` maps grid block x to (row block rb,
    column block cb >= rb): rb from the quadratic's root in float32, then
    settled against ``row_start``; every such pair once (79 words: K
    5,000)."""
    import numpy as np

    def row_start(rb):
        return rb * words - rb * (rb - 1) // 2

    seen = set()
    b2 = np.float32(2 * words + 1)
    for idx in range(words * (words + 1) // 2):
        root = np.sqrt(np.float32(b2 * b2 - np.float32(8) * np.float32(idx)))
        rb = min(max(int(np.float32(0.5) * (b2 - root)), 0), words - 1)
        while rb > 0 and row_start(rb) > idx:
            rb -= 1
        while rb + 1 < words and row_start(rb + 1) <= idx:
            rb += 1
        cb = rb + idx - row_start(rb)
        assert rb <= cb < words
        seen.add((rb, cb))
    assert len(seen) == words * (words + 1) // 2


def test_nms_kernel_refuses_what_it_cannot_run():
    b = torch.zeros(2, 5, 4)
    with pytest.raises(ValueError, match="CUDA"):
        N.nms_kernel(b, torch.ones(2, 5, dtype=torch.bool), 0.4)
    with pytest.raises(ValueError, match=r"\(N, K, 4\)"):
        N.nms_kernel(b[0], torch.ones(5, dtype=torch.bool), 0.4)
    with pytest.raises(ValueError, match=r"\(N, K, 4\)"):
        N.nms_kernel(b, torch.ones(2, 4, dtype=torch.bool), 0.4)


def _face_model(detector) -> FaceModel:
    emb = ArcFaceResNet100((1, 1, 1, 1), (8, 8, 16, 16), 16,
                           torch.float32,
                           generator=torch.Generator().manual_seed(9)).eval()
    return FaceModel(emb, cfg=CascadeConfig(), detector=detector)


def _landmark_prior(m: RetinaFaceR50) -> None:
    """The landmark heads at the mean-face prior, as the benchmark's
    configuration seeds them (a random head sends alignments to
    degenerate geometry)."""
    from alink_tpu_torch.detect.cascade import _MEAN_FACE

    pts = [10.0 * (p - 0.5) for xy in zip(_MEAN_FACE[:5], _MEAN_FACE[5:])
           for p in xy]
    with torch.no_grad():
        for h in m.landmark_head:
            h.weight.mul_(0.01)
            h.bias.copy_(torch.tensor(pts * 2))
    m.refold()


def test_face_model_with_the_detector_end_to_end():
    """Photos through ``FaceModel(detector=...)``: each photo embeds its
    best-scoring kept detection, aligned by K2's plain version, as the
    plain reference finds it on the same photos (heads, decode and
    post-process all plain)."""
    m = _model()
    _landmark_prior(m)
    fm = _face_model(RetinaFaceDetector(m, CFG))
    x = _photos()
    emb, found = fm.pipeline_valid(x)
    loc, conf, lm = plain.forward(m.state_dict(), x)
    pri = plain.prior_box(PHOTO, PHOTO)
    s = torch.softmax(conf, -1)[..., 1]
    b = torch.stack([plain.decode(loc[n], pri) * PHOTO for n in range(2)])
    kept = plain.post(s, b, CFG.confidence, CFG.top_k, CFG.nms_threshold,
                      CFG.keep_top_k)
    best = torch.tensor([k[0] for k in kept])
    marks = torch.stack([plain.decode_landm(lm[n], pri)[best[n]]
                         for n in range(2)]).reshape(2, 1, 5, 2) * PHOTO
    chips = align_faces(x, marks)[:, 0]
    assert bool(found.all())
    want = fm.embedder(chips)
    assert torch.allclose(emb, want, atol=2e-2), float((emb - want).abs()
                                                       .max())


def test_the_cascade_path_is_unchanged():
    """Without a detector, ``FaceModel`` runs the cascade as before:
    ``pipeline_valid`` equals detect_faces -> best detection -> align ->
    embed done by hand."""
    towers = init_cascade_params(torch.Generator().manual_seed(4),
                                 torch.float32, with_lnet=False)
    cfg = CascadeConfig.typical(thresholds=(0.0, 0.0, 0.0))
    emb = ArcFaceResNet100((1, 1, 1, 1), (8, 8, 16, 16), 16, torch.float32,
                           generator=torch.Generator().manual_seed(9)).eval()
    fm = FaceModel(emb, towers, cfg)
    assert fm.detector is None and fm.detects
    x = _photos(2, seed=7)[:, :64, :64]
    got, found = fm.pipeline_valid(x)
    det = detect_faces(towers, x, cfg)
    score = torch.where(det.valid, det.scores, torch.finfo(torch.float32).min)
    lmk = det.landmarks[torch.arange(2), torch.argmax(score, 1)]
    ok = det.valid.any(1) & ((lmk - lmk[:, :1]).abs().amax((1, 2)) > 0)
    chips = torch.where(ok[:, None, None, None],
                        align_faces(x, lmk[:, None])[:, 0], 0.0)
    assert torch.equal(found, ok)
    assert torch.equal(got, emb(chips))


def test_spans_and_counters(tmp_path):
    m = _model()
    det = RetinaFaceDetector(m, CFG)
    x = _photos()
    with P.counting() as made, P.trace(str(tmp_path)) as prof:
        det(x)
    names = {e.name for e in prof.events()}
    for span in ("detect", "retina.backbone", "retina.fpn", "retina.ssh",
                 "retina.heads", "retina.post", "nms"):
        assert "alink/" + span in names, span
    assert made["retina.forwards"] == 1 and made["retina.photos"] == 2
    assert made["retina.candidates"] == 2 * CFG.top_k
    assert 0 < made["retina.kept"] <= 2 * CFG.keep_top_k
    assert made["nms.calls"] == 1 and made["launches.nms"] == 0
