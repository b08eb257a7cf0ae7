"""Spans and counters inside the port (``alink_tpu_torch.utils.profiling``):
off unless a profiler records, nested where the work happens, never
crossing the benchmark's own ranges, and counting what the program does
(NMS sweeps, the DE's evaluations and budget) from host integers only.
CPU, tiny shapes."""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alink_tpu_torch import _build
from alink_tpu_torch.active.committee import Committee
from alink_tpu_torch.detect import (CascadeConfig, FaceModel,
                                    init_cascade_params)
from alink_tpu_torch.drivers.common import make_resnet50_featurizer
from alink_tpu_torch.models import (ArcFaceResNet100, SiameseHead,
                                    VGGFaceResNet50)
from alink_tpu_torch.ops import de as de_ops
from alink_tpu_torch.ops import nms as nms_ops
from alink_tpu_torch.utils import profiling as P

PREFIX = P.SPAN_PREFIX
LAUNCHES = ("launches.k1", "launches.k2", "launches.k3", "launches.k4",
            "launches.bn_act", "launches.bn_act_backward", "launches.attn",
            "launches.wattn", "launches.nms", "launches.ln")
NOISE = ("gaussian", "saltpepper", "adversarial", "fgsm")


def _face_model(seed: int = 0) -> FaceModel:
    g = torch.Generator().manual_seed(seed)
    return FaceModel(ArcFaceResNet100(stage_sizes=(1, 1, 1, 1),
                                      stage_widths=(16, 16, 32, 32),
                                      embedding_dim=32, generator=g),
                     init_cascade_params(g, with_lnet=False),
                     CascadeConfig.typical(thresholds=(0.0, 0.0, 0.0)))


def _photos(n: int = 2, hw: int = 48, seed: int = 9) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(seed).uniform(
        0, 255, (n, hw, hw, 3)), dtype=torch.float32)


def _toy_predict(w, left, right):
    s = torch.sum(w * (left - right), dim=(1, 2, 3)) / 512.0
    p1 = torch.sigmoid(s)
    return torch.stack([1.0 - p1, p1], dim=-1)


def _attack_bank(target_res=(6, 6)):
    """The noise bank with both model channels on 3 toy pairs, resized."""
    rng = np.random.default_rng(5)
    left, right = (torch.as_tensor(rng.integers(0, 256, (3, 8, 8, 3)),
                                   dtype=torch.float32) for _ in range(2))
    wts = torch.as_tensor(rng.integers(-2, 3, (8, 8, 3)), dtype=torch.float32)
    labels = torch.eye(2)[torch.as_tensor(rng.integers(0, 2, 3))]
    head = SiameseHead(8, generator=torch.Generator().manual_seed(0))
    com = Committee.from_param_list(head, [dict(head.named_parameters())],
                                    NOISE)
    return com.attack_model(
        torch.Generator().manual_seed(1), left, right, target_res,
        m1_labels=labels, adversarial_predict=_toy_predict,
        adversarial_params=wts,
        adversarial_kwargs=dict(pixel_count=2, maxiter=3, popsize=10))


def _featurize(n: int = 2):
    featurize, _ = make_resnet50_featurizer(model=VGGFaceResNet50(
        stage_sizes=(1, 1, 1, 1), dtype=torch.float32,
        generator=torch.Generator().manual_seed(3)))
    with torch.no_grad():
        return featurize(_photos(n, 32))


def _delta(before: dict, names) -> dict:
    after = P.counters()
    return {k: after.get(k, 0) - before.get(k, 0) for k in names}


def _spans(prof) -> list:
    return [e for e in prof.events() if e.name.startswith(PREFIX)]


def _parent(evt) -> str | None:
    p = evt.cpu_parent
    return None if p is None else p.name[len(PREFIX):] \
        if p.name.startswith(PREFIX) else p.name


def _seen(prof) -> dict[tuple[str, str | None], int]:
    """(span, parent) -> occurrences."""
    out: dict = {}
    for e in _spans(prof):
        key = (e.name[len(PREFIX):], _parent(e))
        out[key] = out.get(key, 0) + 1
    return out


# -- off unless a profiler records --------------------------------------------

def test_span_without_a_profiler_makes_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function while no profiler records")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert P.span("a") is P.span("b")           # one shared no-op
    before = P.counters()
    fm = _face_model()
    fm.pipeline(_photos())
    _attack_bank()
    _featurize()
    t = P.Timings()
    with t.phase("chunk"):
        pass
    got = _delta(before, ("pipeline.calls", "de.calls", "featurize.calls",
                          "noise.pairs"))
    assert got == {"pipeline.calls": 1, "de.calls": 1, "featurize.calls": 1,
                   "noise.pairs": 3}


def test_count_refuses_a_tensor():
    before = P.counters()
    for bad in (torch.tensor(3), torch.tensor([1, 2]), 2.0, np.int64(2)):
        with pytest.raises(TypeError, match="host int"):
            P.count("test.refused", bad)
    P.count("test.refused", 0)
    assert _delta(before, ["test.refused"]) == {"test.refused": 0}


@pytest.mark.parametrize("name", LAUNCHES)
def test_counters_carry_the_kernels_launch_counts(name):
    """Every kernel's launch counter is in ``counters()`` from the start,
    and the CPU launches nothing."""
    assert P.counters()[name] == 0


class _StubLibrary:
    """The kernel library's ``alink_pair_score`` and error strings: each
    call is recorded and returns ``status``."""

    def __init__(self, status: int):
        self.status, self.calls = status, []

    def alink_pair_score(self, *args):
        self.calls.append(args)
        return self.status

    def alink_error_string(self, status: int) -> bytes:
        return f"stub error {status}".encode()


@pytest.mark.parametrize("status", [0, 719])
def test_launch_counts_only_a_launch_that_succeeded(monkeypatch, status):
    """``_build.launch`` calls the entry on the device with its current
    stream last; status 0 counts one launch under the entry's counter,
    any other raises and counts nothing."""
    lib, entered = _StubLibrary(status), []
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(_build, "_LAUNCHES", dict(_build._LAUNCHES))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: entered.append(
        dev) or contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=4242))
    with P.counting() as made:
        if status:
            with pytest.raises(RuntimeError,
                               match="alink_pair_score.*stub error 719"):
                _build.launch("alink_pair_score", "cuda:0", 3, 5)
        else:
            _build.launch("alink_pair_score", "cuda:0", 3, 5)
    assert lib.calls == [(3, 5, 4242)] and entered == ["cuda:0"]
    assert made == {k: int(k == "launches.k1" and status == 0)
                    for k in made}
    assert set(LAUNCHES) <= set(made)


# -- under a CPU profiler -----------------------------------------------------

def test_pipeline_spans_nest_where_the_work_happens():
    fm = _face_model()
    x = _photos()
    fm.pipeline(x)
    before = P.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fm.pipeline(x)
    assert _seen(prof) == {
        ("pipeline", None): 1, ("detect", "pipeline"): 1,
        ("detect.stage1_select", "detect"): 1, ("detect.stage2", "detect"): 1,
        ("detect.stage3_select", "detect"): 1, ("align", "pipeline"): 1,
        ("embed", "pipeline"): 1,
        # per-level and global NMS, then stage 2's and stage 3's
        ("nms", "detect.stage1_select"): 2, ("nms", "detect.stage2"): 1,
        ("nms", "detect.stage3_select"): 1}
    assert _delta(before, ("pipeline.calls", "pipeline.photos",
                           "nms.calls")) == {
        "pipeline.calls": 1, "pipeline.photos": 2, "nms.calls": 4}


def test_noise_bank_and_de_spans_nest_where_the_work_happens():
    before = P.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _attack_bank()
    gens = _delta(before, ["de.generations"])["de.generations"]
    assert gens >= 1
    assert _seen(prof) == {
        ("noise.plain", None): 1, ("noise.adversarial", None): 1,
        ("de", "noise.adversarial"): 1, ("de.init", "de"): 1,
        ("de.generation", "de"): gens, ("noise.fgsm", None): 1,
        ("noise.resize", None): 1}
    assert _delta(before, ["noise.pairs", "de.problems"]) == {
        "noise.pairs": 3, "de.problems": 3}


def test_featurize_and_phase_spans():
    t = P.Timings()
    before = P.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.phase("chunk"):
            _featurize(3)
    assert _seen(prof) == {("chunk", None): 1, ("featurize", "chunk"): 1}
    assert t.counts == {"chunk": 1}
    assert _delta(before, ("featurize.calls", "featurize.images")) == {
        "featurize.calls": 1, "featurize.images": 3}


def test_no_program_span_crosses_the_benchmark_ranges():
    """A tiny FaceModel carrying the benchmark's hooks (``bench/cascade``
    from P-Net's pre-hook to O-Net's post-hook, ``bench/embed`` around the
    embedder): every ``alink/`` span contains each ``bench/`` range or
    lies wholly inside or outside it, and every host operation inside a
    range is its descendant in the profiler's tree."""
    from bench_torch.tracing import Span

    fm = _face_model(1)
    towers = fm.cascade_params
    spans = {"cascade": Span("cascade"), "embed": Span("embed")}
    hooks = [
        towers.pnet.register_forward_pre_hook(
            lambda m, a: spans["cascade"].begin()),
        towers.onet.register_forward_hook(
            lambda m, a, o: spans["cascade"].end()),
        fm.embedder.register_forward_pre_hook(
            lambda m, a: spans["embed"].begin()),
        fm.embedder.register_forward_hook(
            lambda m, a, o: spans["embed"].end()),
    ]
    try:
        x = _photos(3)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                fm.pipeline(x)
    finally:
        for h in hooks:
            h.remove()
    events = list(prof.events())
    ranges = [e for e in events if e.name.startswith("bench/")]
    ours = [e for e in events if e.name.startswith(PREFIX)]
    assert sorted(e.name for e in ranges) == ["bench/cascade"] * 2 + [
        "bench/embed"] * 2
    assert len(ours) == 2 * 11
    for b in ranges:
        bs, be = b.time_range.start, b.time_range.end
        for a in ours:
            s, e = a.time_range.start, a.time_range.end
            assert not (s < bs < e < be or bs < s < be < e), (a.name, b.name)
        inside = [e for e in events if e is not b and e.thread == b.thread
                  and bs <= e.time_range.start and e.time_range.end <= be]
        assert inside
        for e in inside:
            p = e.cpu_parent
            while p is not None and p is not b:
                p = p.cpu_parent
            assert p is b, (e.name, b.name)


# -- what the counters count --------------------------------------------------

def _sweeps(boxes, scores, valid, threshold):
    """A copy of ``nms``'s fixed-point loop that counts its sweeps."""
    k = boxes.shape[-2]
    overlap = nms_ops.iou_matrix(boxes)
    idx = torch.arange(k)
    s_j, s_i = scores[..., :, None], scores[..., None, :]
    higher = (s_j > s_i) | ((s_j == s_i) & (idx[:, None] < idx[None, :]))
    dom = (overlap > threshold) & higher & valid[..., :, None]
    keep, n = valid, 0
    for _ in range(k + 1):
        n += 1
        new = valid & ~torch.any(dom & keep[..., :, None], dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep, n


@pytest.mark.parametrize("seed,threshold", [(0, 0.1), (1, 0.3), (2, 0.7)])
def test_nms_sweeps_match_a_copy_of_the_loop(seed, threshold):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand((3, 40, 2), generator=g) * 30.0
    wh = 8.0 + torch.rand((3, 40, 2), generator=g) * 12.0
    boxes = torch.cat([xy, xy + wh], dim=-1)
    scores = torch.rand((3, 40), generator=g)
    valid = torch.rand((3, 40), generator=g) < 0.9
    want, n = _sweeps(boxes, scores, valid, threshold)
    before = P.counters()
    got = nms_ops.nms(boxes, scores, valid, threshold)
    assert torch.equal(got, want)
    assert _delta(before, ("nms.calls", "nms.sweeps")) == {
        "nms.calls": 1, "nms.sweeps": n}
    assert n >= 2


@pytest.mark.parametrize("early", [False, True])
def test_de_counts_its_evaluations_and_budget(early):
    n, k, popsize, maxiter = 5, 3, 4, 6
    m = popsize * k
    centers = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (n, k)),
                              dtype=torch.float32)
    stop = (lambda x, idx: ((x - centers[idx]) ** 2).sum(-1) < 0.5) \
        if early else None
    before = P.counters()
    res = de_ops.differential_evolution(
        lambda x, idx: ((x - centers[idx][:, None]) ** 2).sum(-1),
        torch.tensor([[-2.0, 2.0]] * k), n,
        generator=torch.Generator().manual_seed(4), maxiter=maxiter,
        popsize=popsize, tol=0.0, early_stop_fn=stop)
    got = _delta(before, ("de.calls", "de.problems", "de.generations",
                          "de.evals", "de.budget"))
    assert got == {
        "de.calls": 1, "de.problems": n, "de.generations": int(res.nit.max()),
        "de.evals": int(res.nfev.sum()),
        "de.budget": n * ((maxiter + 1) * m + (maxiter if early else 0))}
    if early:
        assert res.stopped_early.any() and got["de.evals"] < got["de.budget"]
