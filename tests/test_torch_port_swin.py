"""The Swin face embedder (``models/swin.py``) on the CPU, against the plain
float32 reference ``tests/plain_swin.py`` (no JAX counterpart exists): a
tiny Swin (28 x 28 chips at patch 2, width 32, depths (2, 2), heads (2, 4)
of 16: a 14 x 14 grid of 4 windows, then 7 x 7, where the window is the
grid and nothing shifts) in float32 and in the stated mixed precision; one
shifted block; the mask and the bias index against the published
construction; patch merging's order; the windowed core's CPU path and a
mirror of the kernel's addressing and arithmetic; ``FaceModel.
get_feature``; Swin-S's sizes on ``meta``; the spans and counters.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import plain_swin
from alink_tpu_torch.detect import FaceModel
from alink_tpu_torch.models import FaceSwin, FaceSwin_S
from alink_tpu_torch.ops import attention as A
from alink_tpu_torch.utils import profiling as P

TINY = dict(input_size=28, patch_size=2, embed_dim=32, depths=(2, 2),
            num_heads=(2, 4), embedding_dim=16)
# float32 on both sides: only the order of the float32 sums differs
# (~3e-7 on unit embeddings).
F32_TOL = 1e-5
# bf16 products: each operand of the patch convolution and of the blocks'
# and merge's Linears rounded to bf16 (2^-9 relative) and each product's
# output too; four blocks and a merge move unit embeddings by ~5e-3.
BF16_TOL = 2e-2
# The windowed core against the published sequence, both float32: sum
# order only, as a share of the widest reference value (~1e-7).
CORE_TOL = 1e-5
# The kernel's arithmetic (P and the output rounded to bf16, 2^-9
# relative each) against the float32 core, as a share of the widest
# reference value: ~2e-3.  A core that drops the mask or transposes the
# bias misses the float32 core by far more.
KERNEL_TOL = 1e-2


def _tiny(dtype=torch.float32, seed=0, **kw) -> FaceSwin:
    """A tiny Swin with LayerNorm, BN, biases and the bias tables moved off
    their starts, so that the comparison sees each of them."""
    m = FaceSwin(dtype=dtype, generator=torch.Generator().manual_seed(seed),
                 **{**TINY, **kw}).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in list(m.named_parameters()) + list(m.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("gamma", "var"):
                t.copy_(0.8 + 0.4 * torch.rand(t.shape, generator=g))
            elif leaf in ("beta", "mean", "bias"):
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
            elif leaf == "relative_position_bias_table":
                t.copy_(torch.randn(t.shape, generator=g))
    return m


def _chips(n: int = 3, seed: int = 2, hw: int = 28) -> torch.Tensor:
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
    want = plain_swin.forward(m.state_dict(), x)
    assert got.dtype == torch.float32 and got.shape == (3, 16)
    assert torch.allclose(torch.linalg.vector_norm(got, dim=1),
                          torch.ones(3), atol=1e-6)
    assert _l2(got, want) <= tol
    raw = plain_swin.forward(m.state_dict(), x, normalize=False)
    m.normalize = False
    with torch.no_grad():
        assert torch.allclose(m(x), raw, rtol=tol, atol=tol * float(
            raw.abs().max()))
    if dtype == torch.bfloat16:
        # The products really ran in bf16, and the weights are held in it.
        assert _l2(got, want) > F32_TOL
        blk = m.layers[0].blocks[0]
        assert blk.attn.qkv.weight.dtype == torch.bfloat16
        assert m.layers[0].downsample.reduction.weight.dtype == \
            torch.bfloat16
        assert blk.attn.relative_position_bias_table.dtype == torch.float32
        assert m.feature[0].weight.dtype == torch.float32


def test_one_shifted_block_matches_the_plain_block():
    m = _tiny()
    blk = m.layers[0].blocks[1]
    assert (blk.attn.core.shift, blk.attn.core.window) == (3, 7)
    x = torch.randn(2, 14, 14, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = blk(x)
    want = plain_swin.block(m.state_dict(), "layers.0.blocks.1.", x, 7)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # Without its shift the block is another function.
    blk.attn.core.shift = 0
    with torch.no_grad():
        unshifted = blk(x)
    assert float((unshifted - want).abs().max()) > 1e-2


@pytest.mark.parametrize("size,shift", [(14, 3), (56, 3), (28, 3), (21, 2)])
def test_mask_and_index_are_the_published_ones(size, shift):
    assert torch.equal(A.relative_position_index(7),
                       plain_swin.relative_position_index(7))
    idx = A.relative_position_index(7)
    assert idx.shape == (49, 49) and int(idx.min()) == 0 and \
        int(idx.max()) == 168
    # Token 0 at (0, 0), token 48 at (6, 6): offset (-6, -6) is row 0.
    assert int(idx[0, 48]) == 0 and int(idx[48, 0]) == 168
    got = A.shift_mask(size, 7, shift)
    want = plain_swin.attn_mask(size, 7, shift)
    assert torch.equal(got, want)
    side = size // 7
    assert got.shape == (side * side, 49, 49)
    # Only the last row and column of windows hold more than one region.
    masked = (got != 0).flatten(1).any(1).reshape(side, side)
    assert not masked[:-1, :-1].any() and masked[-1].all() and \
        masked[:, -1].all()


def test_patch_merging_gathers_in_the_published_order():
    m = _tiny()
    merge = m.layers[0].downsample
    x = torch.randn(2, 14, 14, 32, generator=torch.Generator().manual_seed(4))
    seen = []
    hook = merge.norm.register_forward_pre_hook(
        lambda mod, a: seen.append(a[0]))
    try:
        with torch.no_grad():
            got = merge(x)
    finally:
        hook.remove()
    (cat,) = seen
    assert cat.shape == (2, 7, 7, 128)
    for i, (r, c) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
        assert torch.equal(cat[..., 32 * i:32 * (i + 1)], x[:, r::2, c::2])
    assert torch.equal(cat, plain_swin.merge(x))
    w = m.state_dict()
    want = plain_swin._linear(plain_swin.layer_norm(
        plain_swin.merge(x), w["layers.0.downsample.norm.gamma"],
        w["layers.0.downsample.norm.beta"]),
        w["layers.0.downsample.reduction.weight"])
    assert got.shape == (2, 7, 7, 64)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_no_shift_where_the_grid_is_the_window():
    m = _tiny()
    assert m.grids == [14, 7]
    cores = [[b.attn.core for b in s.blocks] for s in m.layers]
    assert [(c.shift, c.window) for c in cores[0]] == [(0, 7), (3, 7)]
    assert [(c.shift, c.window) for c in cores[1]] == [(0, 7), (0, 7)]
    # A grid smaller than the window takes the grid as its window.
    small = FaceSwin(input_size=24, patch_size=2, embed_dim=16,
                     depths=(2, 2, 2), num_heads=(1, 2, 4), window_size=6,
                     embedding_dim=8, dtype=torch.float32)
    assert small.grids == [12, 6, 3]
    assert [[(b.attn.core.shift, b.attn.core.window) for b in s.blocks]
            for s in small.layers] == [[(0, 6), (3, 6)], [(0, 6), (0, 6)],
                                       [(0, 3), (0, 3)]]
    assert small.layers[2].blocks[0].attn.relative_position_bias_table \
        .shape == (25, 4)
    with torch.no_grad():
        out = small(_chips(2, hw=24))
    assert _l2(out, plain_swin.forward(small.state_dict(), _chips(2, hw=24),
                                       window=6)) <= F32_TOL
    with pytest.raises(ValueError, match="window"):
        FaceSwin(input_size=20, patch_size=2, embed_dim=16, depths=(2, 2),
                 num_heads=(1, 2))


def _qkv(n=2, s=14, heads=2, d=32, seed=5):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(n, s, s, 3 * heads * d, generator=g)
    table = torch.randn(169, heads, generator=g)
    return qkv.to(torch.bfloat16).float(), table


@pytest.mark.parametrize("s,shift", [(14, 3), (14, 0), (21, 3), (7, 0)])
def test_window_core_cpu_path_is_the_published_sequence(s, shift):
    qkv, table = _qkv(s=s)
    got = A.window_attention(qkv, table, shift, 7)
    want = plain_swin.window_msa(qkv, table, shift, 7)
    assert got.dtype == torch.float32 and got.shape == (2, s, s, 64)
    assert float((got - want).abs().max()) <= CORE_TOL * float(
        want.abs().max())
    assert torch.equal(got, A.window_attention_reference(qkv, table, shift,
                                                         7))


def _region(win, local, side, shift, w=7):
    """The kernel's ``region``: 0 outside the last window of an axis."""
    return torch.where(win < side - 1, 0, torch.where(local < w - shift, 1,
                                                      2))


def kernel_mirror(qkv, table, shift, rounded=True, drop_mask=False,
                  transpose_bias=False, w=7):
    """``window_attention_kernel``'s addressing and arithmetic in torch: a
    window's token i at local (i / 7, i % 7) read from grid position
    ((7 wy + ly + shift) % S, (7 wx + lx + shift) % S) and its output
    stored there; bias row a(i) - b(j) with a(i) = 13 yi + xi + 84 and
    b(j) = 13 yj + xj; -100 where the kernel's regions differ; s = S *
    scale + B (+ M); P = e * (1 / sum) rounded to bf16 (``rounded``), the
    output rounded to bf16."""
    n, s, _, c3 = qkv.shape
    h = table.shape[1]
    side, t, r = s // w, w * w, 2 * w - 1
    i = torch.arange(t)
    ly, lx = i // w, i % w
    wy = torch.arange(side)[:, None, None]
    wx = torch.arange(side)[None, :, None]
    y = (wy * w + ly + shift) % s                      # side, 1, t
    x = (wx * w + lx + shift) % s                      # 1, side, t
    y, x = y.expand(side, side, t), x.expand(side, side, t)
    tok = qkv[:, y, x].reshape(n, side, side, t, 3, h, 32)
    q, k, v = (tok[..., p, :, :].permute(0, 1, 2, 4, 3, 5) for p in range(3))
    sc = (q @ k.transpose(-2, -1)) * 32 ** -0.5        # n, wy, wx, h, t, t
    idx = (r * ly + lx + (w - 1) * (r + 1))[:, None] - (r * ly + lx)[None]
    bias = table[idx.reshape(-1)].reshape(t, t, h).permute(2, 0, 1)
    if transpose_bias:
        bias = bias.transpose(-2, -1)
    sc = sc + bias
    if shift and not drop_mask:
        lab = (3 * _region(wy, ly, side, shift)
               + _region(wx, lx, side, shift))           # side, side, t
        m = (lab[..., :, None] != lab[..., None, :])[:, :, None]
        sc = sc + torch.where(m, -100.0, 0.0)
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    p = e * (1.0 / e.sum(-1, keepdim=True))
    if rounded:
        p = p.to(torch.bfloat16).float()
    o = p @ v                                            # n, wy, wx, h, t, d
    if rounded:
        o = o.to(torch.bfloat16).float()
    out = torch.empty(n, s, s, h * 32)
    out[:, y, x] = o.permute(0, 1, 2, 4, 3, 5).reshape(n, side, side, t,
                                                       h * 32)
    return out


@pytest.mark.parametrize("s,shift,heads", [(14, 3, 2), (56, 3, 3),
                                           (21, 3, 6), (7, 0, 4), (28, 0, 3)])
def test_kernel_mirror_matches_the_float32_core(s, shift, heads):
    qkv, table = _qkv(n=1, s=s, heads=heads)
    want = plain_swin.window_msa(qkv, table, shift, 7)
    scale = float(want.abs().max())
    exact = kernel_mirror(qkv, table, shift, rounded=False)
    assert float((exact - want).abs().max()) <= CORE_TOL * scale
    got = kernel_mirror(qkv, table, shift)
    gap = float((got - want).abs().max()) / scale
    assert 1e-4 < gap <= KERNEL_TOL
    if shift:
        for fault in ({"drop_mask": True}, {"transpose_bias": True}):
            bad = kernel_mirror(qkv, table, shift, **fault)
            assert float((bad - want).abs().max()) / scale > 10 * KERNEL_TOL


def test_window_core_refuses_what_the_kernel_does_not_take():
    qkv, table = _qkv()
    b = qkv.to(torch.bfloat16)
    A.check_window_inputs(b, table, 3, 7)
    assert A.window_group(3) == 3 and A.window_group(6) == 3 and \
        A.window_group(12) == 4 and A.window_group(24) == 4 and \
        A.window_group(5) == 1
    with pytest.raises(TypeError, match="bf16"):
        A.check_window_inputs(qkv, table, 3, 7)
    with pytest.raises(ValueError, match="window 7"):
        A.check_window_inputs(b, torch.zeros(81, 2), 2, 5)
    with pytest.raises(ValueError, match="multiple"):
        A.check_window_inputs(b, table, 7, 7)
    with pytest.raises(ValueError, match="heads of 32"):
        A.check_window_inputs(b[..., :96], torch.zeros(169, 2), 3, 7)
    with pytest.raises(TypeError, match="float32"):
        A.check_window_inputs(b, table.double(), 3, 7)
    with pytest.raises(ValueError, match="contiguous"):
        A.check_window_inputs(b.transpose(1, 2), table, 3, 7)
    with pytest.raises(ValueError, match="CUDA"):
        A.window_attention_kernel(b, table, 3, 7)


def test_face_model_get_feature_embeds_as_the_reference_does():
    m = _tiny()
    fm = FaceModel(m)
    x = _chips(2, seed=7)
    emb = fm.get_feature(x.numpy())
    assert emb.shape == (2, 16)
    assert _l2(emb, plain_swin.forward(m.state_dict(), x)) <= F32_TOL


def test_published_swin_s_sizes_on_meta():
    with torch.device("meta"):
        m = FaceSwin_S()
    assert m.grids == [56, 28, 14, 7]
    assert m.num_tokens == 4165 and m.num_windows == 234
    blocks = [b for s in m.layers for b in s.blocks]
    assert len(blocks) == 24
    assert sum(b.attn.core.shift == 3 for b in blocks) == 11
    assert [s.blocks[0].attn.heads for s in m.layers] == [3, 6, 12, 24]
    assert [s.blocks[0].attn.qkv.in_features for s in m.layers] == \
        [96, 192, 384, 768]
    assert all(b.attn.qkv.in_features // b.attn.heads == 32 for b in blocks)
    assert all(b.mlp.fc1.out_features == 4 * b.attn.qkv.in_features
               for b in blocks)
    assert all(b.attn.relative_position_bias_table.shape[0] == 169
               for b in blocks)

    def block(c):
        return (4 * c + 3 * c * c + 3 * c + 169 * c // 32 + c * c + c
                + 2 * 4 * c * c + 4 * c + c)

    hand = (3 * 2 * 2 * 96 + 96 + 2 * 96
            + sum(d * block(c) for d, c in zip((2, 2, 18, 2),
                                               (96, 192, 384, 768)))
            + sum(8 * c + 4 * c * 2 * c for c in (96, 192, 384))
            + 2 * 768 + 768 * 512 + 4 * 512)
    assert sum(v.numel() for v in m.state_dict().values()) == hand
    assert hand == 49_229_066
    assert blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert m.feature[0].weight.dtype == torch.float32


def test_spans_and_counters_under_trace_only(tmp_path, monkeypatch):
    fm = FaceModel(_tiny())
    x = _chips(2, seed=3)
    with P.trace(str(tmp_path)) as prof:
        fm.get_feature(x)
    spans = {}
    for e in prof.events():
        if e.name.startswith(P.SPAN_PREFIX):
            parent = e.cpu_parent.name if e.cpu_parent is not None else None
            key = (e.name[len(P.SPAN_PREFIX):], parent)
            spans[key] = spans.get(key, 0) + 1
    embed = P.SPAN_PREFIX + "embed"
    assert spans.pop(("embed", None)) == 1
    # Each LayerNorm in its own span: the blocks' two, the patch norm, the
    # merge's and the final norm inside the span around each.
    assert spans == {("swin.patch", embed): 1, ("swin.attn", embed): 4,
                     ("swin.mlp", embed): 4, ("swin.merge", embed): 1,
                     ("swin.head", embed): 1, ("ln", embed): 8,
                     ("ln", P.SPAN_PREFIX + "swin.patch"): 1,
                     ("ln", P.SPAN_PREFIX + "swin.merge"): 1,
                     ("ln", P.SPAN_PREFIX + "swin.head"): 1}
    counts = json.loads((tmp_path / "counters.json").read_text())
    assert counts["embed.calls"] == 1 and counts["swin.forwards"] == 1
    assert counts["swin.tokens"] == 2 * (14 * 14 + 7 * 7)
    assert counts["swin.windows"] == 2 * (2 * 4 + 2 * 1)
    assert counts["launches.wattn"] == 0          # no card: the plain core
    assert counts["launches.ln"] == 0             # nor the plain norms

    def refuse(*a, **k):
        raise AssertionError("record_function while no profiler records")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with P.counting() as made:
        fm.get_feature(x)      # no span opens: record_function would raise
    assert made["embed.calls"] == 1 and made["swin.forwards"] == 1
    assert made["swin.tokens"] == 2 * 245 and made["swin.windows"] == 20
