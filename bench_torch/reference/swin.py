"""The Swin face embedder (Swin Transformer, arXiv:2103.14030,
``microsoft/Swin-Transformer`` ``models/swin_transformer.py``, on 112^2
chips at patch 2 with a face head), plain float32.

Input raw RGB in [0, 255], NHWC.  x / 127.5 - 1; patch embedding
Conv2d(3 -> C, kernel = stride = P, bias), tokens in row-major order, LN;
per stage, per block t += proj(W-MSA(LN1(t))) and
t += fc2(GELU(fc1(LN2(t)))), W-MSA as the published code runs it:
torch.roll by -shift on odd blocks (shift W / 2; none where the grid is no
larger than the window, which is then the grid), the window partition,
qkv = Linear(C -> 3C, bias) split as (3, H, d), softmax((q d^-1/2) k^T +
B + M) v with B gathered from the block's table by the relative position
index and M the -100 mask between the shifted frame's regions, the heads
merged, proj, the reverse partition and roll back; patch merging
(concat[x(0::2, 0::2), x(1::2, 0::2), x(0::2, 1::2), x(1::2, 1::2)], LN,
Linear(4C -> 2C, no bias)) after every stage but the last; LN, the mean
over the tokens, Linear(C -> E, no bias) - BN1d; L2 normalisation.  LN
and BN epsilon 1e-5.

Every product goes through ``Numerics``: the patch convolution
(``nx.conv``), every Linear (``nx.linear``) and both attention products
(``nx.q`` on q, k, v and P).  Weights are keyed as the harness made them:
``patch_embed.proj.*``, ``patch_embed.norm.{gamma,beta}``,
``layers.<i>.blocks.<j>.{norm1,norm2}.{gamma,beta}``,
``layers.<i>.blocks.<j>.attn.{qkv,proj}.*``,
``layers.<i>.blocks.<j>.attn.relative_position_bias_table``,
``layers.<i>.blocks.<j>.mlp.{fc1,fc2}.*``,
``layers.<i>.downsample.norm.*``, ``layers.<i>.downsample.reduction.weight``,
``norm.*``, ``feature.0.weight``, ``feature.1.{gamma,beta,mean,var}``.
"""

from __future__ import annotations

import math

import torch

from bench_torch.reference.numerics import Numerics, bn

LN_EPS = 1e-5
BN_EPS = 1e-5


def embed(w: dict, x: torch.Tensor, window: int, nx: Numerics,
          block: int = 64) -> torch.Tensor:
    """(N, S, S, 3) -> (N, E) unit embeddings, ``block`` chips at a time
    (each block's heads from its bias table's columns)."""
    w = {k: v.float() for k, v in w.items()}
    return torch.cat([_embed(w, x[i:i + block], window, nx)
                      for i in range(0, x.shape[0], block)])


def core(qkv: torch.Tensor, table: torch.Tensor, shift: int, window: int,
         nx: Numerics, block: int = 64) -> torch.Tensor:
    """(N, S, S, 3C) qkv in grid order and the block's bias table -> (N,
    S, S, C) float32, the windowed attention from the roll to the roll
    back, ``block`` chips at a time."""
    return torch.cat([_attend(qkv[i:i + block].float(), table.float(), shift,
                              window, nx)
                      for i in range(0, qkv.shape[0], block)])


def relative_index(window: int) -> torch.Tensor:
    """(W^2, W^2): the published ``relative_position_index``."""
    coords = torch.stack(torch.meshgrid(torch.arange(window),
                                        torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def mask(size: int, window: int, shift: int) -> torch.Tensor:
    """(windows, W^2, W^2): the published ``attn_mask``."""
    img = torch.zeros(1, size, size, 1)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift),
               slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = partition(img, window).reshape(-1, window * window)
    m = win.unsqueeze(1) - win.unsqueeze(2)
    return m.masked_fill(m != 0, -100.0).masked_fill(m == 0, 0.0)


def partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * windows, W, W, C), the published order."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // window, window, wd // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)


def reverse(x: torch.Tensor, window: int, h: int, wd: int) -> torch.Tensor:
    b = x.shape[0] // (h * wd // window // window)
    x = x.reshape(b, h // window, wd // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, wd, -1)


def _ln(x, w, prefix):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return ((x - mean) / torch.sqrt(var + LN_EPS) * w[prefix + ".gamma"]
            + w[prefix + ".beta"])


def _attend(qkv, table, shift, window, nx):
    """The W-MSA from its qkv (the Linear is token-wise, so it commutes
    with the roll and the partition)."""
    n, s, _, c3 = qkv.shape
    heads = table.shape[1]
    c = c3 // 3
    d = c // heads
    t = window * window
    if shift:
        qkv = torch.roll(qkv, shifts=(-shift, -shift), dims=(1, 2))
    x = partition(qkv, window).reshape(-1, t, 3, heads, d).permute(
        2, 0, 3, 1, 4)
    q, k, v = nx.q(x[0]) * d ** -0.5, nx.q(x[1]), nx.q(x[2])
    a = q @ k.transpose(-2, -1)
    a = a + table[relative_index(window).reshape(-1).to(table.device)
                  ].reshape(t, t, -1).permute(2, 0, 1).unsqueeze(0)
    if shift:
        m = mask(s, window, shift).to(a.device)
        nw = m.shape[0]
        a = (a.reshape(-1, nw, heads, t, t) + m.unsqueeze(1).unsqueeze(0)
             ).reshape(-1, heads, t, t)
    a = torch.softmax(a, dim=-1)
    o = (nx.q(a) @ v).transpose(1, 2).reshape(-1, window, window, c)
    o = reverse(o, window, s, s)
    if shift:
        o = torch.roll(o, shifts=(shift, shift), dims=(1, 2))
    return o


def _embed(w, x, window, nx):
    p = w["patch_embed.proj.weight"].shape[-1]
    y = x.float().permute(0, 3, 1, 2) / 127.5 - 1.0
    y = nx.conv(y, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"],
                stride=p)
    t = _ln(y.permute(0, 2, 3, 1), w, "patch_embed.norm")
    stage = 0
    while f"layers.{stage}.blocks.0.norm1.gamma" in w:
        size = t.shape[1]
        win = min(window, size)
        j = 0
        while f"layers.{stage}.blocks.{j}.norm1.gamma" in w:
            b = f"layers.{stage}.blocks.{j}."
            shift = 0 if j % 2 == 0 or size <= window else window // 2
            qkv = nx.linear(_ln(t, w, b + "norm1"), w[b + "attn.qkv.weight"],
                            w[b + "attn.qkv.bias"])
            o = _attend(qkv, w[b + "attn.relative_position_bias_table"],
                        shift, win, nx)
            t = t + nx.linear(o, w[b + "attn.proj.weight"],
                              w[b + "attn.proj.bias"])
            z = nx.linear(_ln(t, w, b + "norm2"), w[b + "mlp.fc1.weight"],
                          w[b + "mlp.fc1.bias"])
            z = 0.5 * z * (1.0 + torch.erf(z / math.sqrt(2.0)))
            t = t + nx.linear(z, w[b + "mlp.fc2.weight"],
                              w[b + "mlp.fc2.bias"])
            j += 1
        d = f"layers.{stage}.downsample."
        if d + "reduction.weight" in w:
            t = torch.cat([t[:, 0::2, 0::2], t[:, 1::2, 0::2],
                           t[:, 0::2, 1::2], t[:, 1::2, 1::2]], dim=-1)
            t = nx.linear(_ln(t, w, d + "norm"), w[d + "reduction.weight"])
        stage += 1
    f = _ln(t, w, "norm").mean(dim=(1, 2))
    f = bn(nx.linear(f, w["feature.0.weight"]), w, "feature.1", BN_EPS)
    return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp(
        min=1e-12)
