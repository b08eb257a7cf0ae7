"""insightface's ViT face embedder (``arcface_torch`` ``backbones/vit.py``;
Partial FC, arXiv:2203.15565), plain float32.

Input raw RGB in [0, 255], NHWC.  x / 127.5 - 1; patch embedding
Conv2d(3 -> D, kernel = stride = P, bias), tokens in row-major order,
+ pos_embed; per block t += proj(core(LN1(t))) and
t += fc2(ReLU6(fc1(LN2(t)))), the core softmax(q k^T d^-1/2) v over
heads with qkv = Linear(D -> 3D, no bias) split as (N, T, 3, H, d); LN;
the token-major flatten; Linear(T * D -> D) - BN1d - Linear(D -> E) -
BN1d; L2 normalisation, the one departure (insightface normalises at
evaluation).  LN epsilon 1e-6, BN epsilon 2e-5.

Every product goes through ``Numerics``: the patch convolution
(``nx.conv``), every Linear (``nx.linear``) and both attention products
(``nx.q`` on q, k and v).  Weights are keyed as the harness made them:
``patch_embed.proj.*``, ``pos_embed``, ``blocks.<i>.{norm1,norm2}.{gamma,
beta}``, ``blocks.<i>.attn.qkv.weight``, ``blocks.<i>.attn.proj.*``,
``blocks.<i>.mlp.{fc1,fc2}.*``, ``norm.*``, ``feature.{0,2}.weight``,
``feature.{1,3}.{gamma,beta,mean,var}``.
"""

from __future__ import annotations

import torch

from bench_torch.reference.numerics import Numerics, bn

LN_EPS = 1e-6
BN_EPS = 2e-5


def embed(w: dict, x: torch.Tensor, heads: int, nx: Numerics,
          block: int = 64) -> torch.Tensor:
    """(N, S, S, 3) -> (N, E) unit embeddings, ``block`` rows at a time."""
    return torch.cat([_embed(w, x[i:i + block], heads, nx)
                      for i in range(0, x.shape[0], block)])


def core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nx: Numerics,
         block: int = 64) -> torch.Tensor:
    """(N, H, T, d) q, k, v -> (N, T, H * d) merged heads, ``block`` rows
    at a time."""
    return torch.cat([_core(q[i:i + block], k[i:i + block], v[i:i + block],
                            nx) for i in range(0, q.shape[0], block)])


def _core(q, k, v, nx):
    q, k, v = nx.q(q), nx.q(k), nx.q(v)
    n, h, t, d = q.shape
    s = torch.softmax(q @ k.transpose(-2, -1) * d ** -0.5, dim=-1)
    return (s @ v).transpose(1, 2).reshape(n, t, h * d)


def _ln(x, w, prefix):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return ((x - mean) / torch.sqrt(var + LN_EPS) * w[prefix + ".gamma"]
            + w[prefix + ".beta"])


def _embed(w, x, heads, nx):
    p = w["patch_embed.proj.weight"].shape[-1]
    y = x.float().permute(0, 3, 1, 2) / 127.5 - 1.0
    y = nx.conv(y, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"],
                stride=p)
    t = y.flatten(2).transpose(1, 2) + w["pos_embed"]
    n, tokens, dim = t.shape
    i = 0
    while f"blocks.{i}.norm1.gamma" in w:
        b = f"blocks.{i}."
        qkv = nx.linear(_ln(t, w, b + "norm1"), w[b + "attn.qkv.weight"])
        qkv = qkv.reshape(n, tokens, 3, heads, dim // heads).permute(
            2, 0, 3, 1, 4)
        t = t + nx.linear(_core(qkv[0], qkv[1], qkv[2], nx),
                          w[b + "attn.proj.weight"], w[b + "attn.proj.bias"])
        z = nx.linear(_ln(t, w, b + "norm2"), w[b + "mlp.fc1.weight"],
                      w[b + "mlp.fc1.bias"])
        t = t + nx.linear(z.clamp(0.0, 6.0), w[b + "mlp.fc2.weight"],
                          w[b + "mlp.fc2.bias"])
        i += 1
    f = _ln(t, w, "norm").reshape(n, -1)
    f = bn(nx.linear(f, w["feature.0.weight"]), w, "feature.1", BN_EPS)
    f = bn(nx.linear(f, w["feature.2.weight"]), w, "feature.3", BN_EPS)
    return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp(
        min=1e-12)
