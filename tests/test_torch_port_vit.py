"""insightface's ViT face embedder (``models/vit.py``) on the CPU, against
the plain float32 reference ``tests/plain_vit.py`` (no JAX counterpart
exists): a tiny ViT (width 32, 2 blocks of 2 heads, 112x112 chips at patch
9, so 144 tokens) in float32 and in the stated mixed precision; the
float32 attention core alone, and a bf16 core that its tolerance refuses;
the ViT behind the MTCNN cascade through ``FaceModel.pipeline``; the
published ViT-L's sizes on ``meta``; its spans and counters; the loader
from insightface's state-dict names; and one ``ALinkLoop`` iteration with
a ViT teacher through the A-LINK ArcFace driver's featurizer.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import plain_vit
from alink_tpu_torch.active import loop as tloop
from alink_tpu_torch.active.committee import Committee
from alink_tpu_torch.config import ALinkConfig
from alink_tpu_torch.convert import load_insightface_vit
from alink_tpu_torch.data import PersonStacks
from alink_tpu_torch.detect import (CascadeConfig, FaceModel,
                                    init_cascade_params)
from alink_tpu_torch.drivers import alink_arc as tarc
from alink_tpu_torch.models import FaceViT, FaceViT_L, SiameseHead
from alink_tpu_torch.models.vit import AttentionCore
from alink_tpu_torch.train import TrainState
from alink_tpu_torch.utils import profiling as P

TINY = dict(embed_dim=32, depth=2, num_heads=2, mlp_dim=64,
            embedding_dim=16)
HEADS = TINY["num_heads"]
# float32 on both sides: only the order of the float32 sums differs (the
# port's layer_norm, SDPA and Linear against the reference's explicit
# operations), ~3e-7 on unit embeddings.
F32_TOL = 1e-5
# bf16 products: each operand of the patch convolution and of the blocks'
# Linears is rounded to bf16 (2^-9 relative) and each product's output
# too; two blocks of that move unit embeddings by ~5e-3.
BF16_TOL = 2e-2
# The attention core alone in float32 against the plain core, as a share
# of the widest reference value: float32 sum order only (~1e-7).  A core
# in bf16 misses it by far (its probabilities and output rounded to bf16).
CORE_TOL = 1e-5


def _tiny(dtype=torch.float32, seed=0, **kw) -> FaceViT:
    """A tiny ViT with LayerNorm, BN and biases moved off their identity
    starts, so that the comparison sees each of them."""
    m = FaceViT(dtype=dtype, generator=torch.Generator().manual_seed(seed),
                **{**TINY, **kw}).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in list(m.named_parameters()) + list(m.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("gamma", "var"):
                t.copy_(0.8 + 0.4 * torch.rand(t.shape, generator=g))
            elif leaf in ("beta", "mean", "bias"):
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
    return m


def _chips(n: int = 3, seed: int = 2, hw: int = 112) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(seed).uniform(
        0, 255, (n, hw, hw, 3)), dtype=torch.float32)


def _l2(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b, dim=1).max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_forward_matches_the_plain_reference(dtype, tol):
    m = _tiny(dtype)
    x = _chips()
    with torch.no_grad():
        got = m(x)
    want = plain_vit.forward(m.state_dict(), x, HEADS)
    assert got.dtype == torch.float32 and got.shape == (3, 16)
    assert torch.allclose(torch.linalg.vector_norm(got, dim=1),
                          torch.ones(3), atol=1e-6)
    assert _l2(got, want) <= tol
    raw = plain_vit.forward(m.state_dict(), x, HEADS, normalize=False)
    m.normalize = False
    with torch.no_grad():
        assert torch.allclose(m(x), raw, rtol=tol, atol=tol * float(
            raw.abs().max()))
    if dtype == torch.bfloat16:
        # The products really ran in bf16, and the weights are held in it.
        assert _l2(got, want) > F32_TOL
        assert m.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
        assert m.feature[0].weight.dtype == torch.float32


def _qkv(seed: int = 4):
    """q, k, v (N, H, T, d) as the qkv product gives them: bf16 values."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(2, HEADS, 144, 16, generator=g).to(torch.bfloat16)
            for _ in range(3)]


def test_attention_core_is_float32_and_a_bf16_core_is_refused():
    q, k, v = _qkv()
    want = plain_vit.core(q, k, v)
    scale = float(want.abs().max())
    got = AttentionCore()(q, k, v)
    assert got.dtype == torch.float32 and got.shape == (2, 144, 32)
    assert float((got - want).abs().max()) / scale <= CORE_TOL
    low = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(
        2, 144, 32)
    assert low.dtype == torch.bfloat16
    assert float((low.float() - want).abs().max()) / scale > 20 * CORE_TOL


def test_face_model_pipeline_embeds_its_chips_as_the_reference_does():
    g = torch.Generator().manual_seed(5)
    vit = _tiny()
    fm = FaceModel(vit, init_cascade_params(g, with_lnet=False),
                   CascadeConfig.typical(thresholds=(0.0, 0.0, 0.0)))
    seen = []
    hook = vit.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    try:
        emb, found = fm.pipeline_valid(_chips(2, seed=9, hw=64))
    finally:
        hook.remove()
    (chips,) = seen
    assert chips.shape == (2, 112, 112, 3) and found.shape == (2,)
    assert float(chips.abs().max()) > 0
    assert _l2(emb, plain_vit.forward(vit.state_dict(), chips, HEADS)) \
        <= F32_TOL


def test_published_vit_l_sizes_on_meta():
    with torch.device("meta"):
        m = FaceViT_L()
    d, t, mlp = 768, 144, 3072
    block = (2 * d + d * 3 * d + d * d + d + 2 * d + d * mlp + mlp
             + mlp * d + d)
    hand = (3 * 9 * 9 * d + d          # patch_embed.proj
            + t * d                     # pos_embed
            + 24 * block
            + 2 * d                     # norm
            + t * d * d + 4 * d         # feature.0, feature.1 (4 vectors)
            + d * 512 + 4 * 512)        # feature.2, feature.3
    assert hand == 255_686_144
    assert sum(v.numel() for v in m.state_dict().values()) == hand
    # insightface's count, its BN running statistics being buffers:
    assert hand - 2 * (d + 512) == 255_683_584
    assert m.num_tokens == t and len(m.blocks) == 24
    assert m.feature[0].in_features == t * d == 110_592
    assert m.blocks[0].attn.heads == 8
    assert m.blocks[0].mlp.fc1.out_features == mlp
    assert m.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert m.blocks[0].attn.qkv.bias is None
    assert m.pos_embed.dtype == m.feature[0].weight.dtype == torch.float32


def test_spans_and_counters_under_trace_only(tmp_path, monkeypatch):
    import json

    fm = FaceModel(_tiny(), init_cascade_params(
        torch.Generator().manual_seed(6), with_lnet=False),
        CascadeConfig.typical(thresholds=(0.0, 0.0, 0.0)))
    x = _chips(2, seed=3, hw=48)
    with P.trace(str(tmp_path)) as prof:
        fm.pipeline(x)
    spans = {}
    for e in prof.events():
        if e.name.startswith(P.SPAN_PREFIX + "vit."):
            parent = e.cpu_parent.name if e.cpu_parent is not None else None
            key = (e.name[len(P.SPAN_PREFIX):], parent)
            spans[key] = spans.get(key, 0) + 1
    embed = P.SPAN_PREFIX + "embed"
    assert spans == {("vit.patch", embed): 1, ("vit.attn", embed): 2,
                     ("vit.mlp", embed): 2, ("vit.head", embed): 1}
    counts = json.loads((tmp_path / "counters.json").read_text())
    assert counts["vit.forwards"] == 1 and counts["vit.tokens"] == 2 * 144

    def refuse(*a, **k):
        raise AssertionError("record_function while no profiler records")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    before = P.counters()
    fm.pipeline(x)      # no span opens: record_function would raise
    after = P.counters()
    assert after["vit.forwards"] - before["vit.forwards"] == 1
    assert after["vit.tokens"] - before["vit.tokens"] == 2 * 144


def _insightface_names(state: dict) -> dict:
    """The port's state dict under insightface's ``backbones/vit.py`` names,
    with the entries insightface has and the port drops."""
    out = {}
    leaf = {"gamma": "weight", "beta": "bias", "mean": "running_mean",
            "var": "running_var"}
    for k, v in state.items():
        head, _, last = k.rpartition(".")
        is_norm = (".norm" in k or k.startswith("norm.")
                   or k.startswith(("feature.1.", "feature.3.")))
        out[f"{head}.{leaf[last]}" if is_norm and last in leaf else k] = \
            v.clone()
    out["feature.1.num_batches_tracked"] = torch.tensor(7)
    out["feature.3.num_batches_tracked"] = torch.tensor(7)
    out["mask_token"] = torch.zeros(1, 1, TINY["embed_dim"])
    return out


def test_load_insightface_vit_state_dict():
    src = _tiny(seed=11)
    sd = _insightface_names(src.state_dict())
    assert "blocks.1.norm2.weight" in sd and "norm.bias" in sd
    assert "feature.3.running_var" in sd and "patch_embed.proj.bias" in sd
    dst = _tiny(seed=12)
    load_insightface_vit(dst, sd)
    x = _chips(2, seed=13)
    with torch.no_grad():
        got = dst(x)
    assert _l2(got, plain_vit.forward(src.state_dict(), x, HEADS)) \
        <= F32_TOL
    sd.pop("blocks.0.attn.qkv.weight")
    with pytest.raises(RuntimeError, match="qkv"):
        load_insightface_vit(dst, sd)


def test_alink_loop_iteration_with_a_vit_teacher(monkeypatch):
    monkeypatch.setattr(tarc, "_VIT", lambda **kw: FaceViT(**TINY, **kw))
    featurize, model = tarc.make_arcface_featurizer(
        torch.Generator().manual_seed(0), device="cpu", family="vit")
    assert isinstance(model, FaceViT) and featurize is model
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError, match="family"):
        tarc.make_arcface_featurizer(None, device="cpu", family="vgg")

    df = TINY["embedding_dim"]
    cfg = ALinkConfig(noise=("gaussian",), image_res=(112, 112),
                      feature_res=df, alink_bs=2, batch_send=4, ft_epochs=1,
                      mixture_ratio=1, disparity_ratio=1.0, eps=0.0, seed=3)
    g = torch.Generator().manual_seed(0)
    heads = [SiameseHead(df, (16, 8), dtype=torch.float32, generator=g)
             for _ in range(2)]
    committee = Committee.from_param_list(heads[0], [heads[0].state_dict()],
                                          cfg.noise)

    def replay():
        rng = np.random.default_rng(3)
        while True:
            yield ((rng.random((8, df)).astype(np.float32),
                    rng.random((8, df)).astype(np.float32)),
                   (rng.random(8) > 0.5).astype(np.int32))

    loop = tloop.ALinkLoop(cfg, featurize=featurize, committee=committee,
                           m2_state=TrainState(heads[1]),
                           replay_gen=replay(), pool_uint8=True)
    rng = np.random.default_rng(8)
    slabs = [PersonStacks(rng.integers(0, 256, (2, 2, 112, 112, 3)).astype(
        np.float32), np.full(2, 2, np.int32)) for _ in range(2)]
    calls = []
    model.register_forward_pre_hook(lambda m, a: calls.append(a[0].shape))
    log = loop.run_iteration(*slabs)
    assert log.pairs > 0 and log.iteration == 0
    assert calls and all(s[1:] == (112, 112, 3) for s in calls)
