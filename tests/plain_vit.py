"""insightface's ViT face embedder (``arcface_torch`` ``backbones/vit.py``),
plain float32, for the tests: torch operations only, no kernel of the
port, TF32 off.

Raw NHWC RGB chips in [0, 255] -> (N, E) unit embeddings:
x / 127.5 - 1; Conv2d(kernel = stride = P, bias) to a grid of tokens in
row-major order, + pos_embed; per block t += proj(core(LN1(t))) and
t += fc2(ReLU6(fc1(LN2(t)))) with the core softmax(q k^T d^-1/2) v over
heads (qkv split as (N, T, 3, H, d)); LN; the token-major flatten;
Linear - BN1d - Linear - BN1d.  LN eps 1e-6, BN eps 2e-5.  The one
departure from insightface: the L2 normalisation at the end (insightface
normalises at evaluation).

Weights are a dict keyed as the port's state dict: ``patch_embed.proj.*``,
``pos_embed``, ``blocks.<i>.{norm1,norm2}.{gamma,beta}``,
``blocks.<i>.attn.qkv.weight``, ``blocks.<i>.attn.proj.*``,
``blocks.<i>.mlp.{fc1,fc2}.*``, ``norm.{gamma,beta}``, ``feature.{0,2}.weight``,
``feature.{1,3}.{gamma,beta,mean,var}``.
"""

from __future__ import annotations

import torch

LN_EPS = 1e-6
BN_EPS = 2e-5


def layer_norm(x, g, b, eps=LN_EPS):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * g + b


def core(q, k, v):
    """(N, H, T, d) -> (N, T, H * d): softmax(q k^T d^-1/2) v, heads
    merged."""
    q, k, v = q.float(), k.float(), v.float()
    n, h, t, d = q.shape
    s = torch.softmax(q @ k.transpose(-2, -1) * d ** -0.5, dim=-1)
    return (s @ v).transpose(1, 2).reshape(n, t, h * d)


def _linear(x, w, b=None):
    y = x @ w.t()
    return y if b is None else y + b


def _bn(x, w, p):
    return ((x - w[p + ".mean"]) / torch.sqrt(w[p + ".var"] + BN_EPS)
            * w[p + ".gamma"] + w[p + ".beta"])


def forward(w: dict, x: torch.Tensor, heads: int,
            normalize: bool = True) -> torch.Tensor:
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _forward({k: v.float() for k, v in w.items()}, x, heads,
                            normalize)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _forward(w, x, heads, normalize):
    p = w["patch_embed.proj.weight"].shape[-1]
    y = x.float().permute(0, 3, 1, 2) / 127.5 - 1.0
    y = torch.nn.functional.conv2d(y, w["patch_embed.proj.weight"],
                                   w["patch_embed.proj.bias"], stride=p)
    t = y.flatten(2).transpose(1, 2) + w["pos_embed"]
    n, tokens, dim = t.shape
    i = 0
    while f"blocks.{i}.norm1.gamma" in w:
        b = f"blocks.{i}."
        z = layer_norm(t, w[b + "norm1.gamma"], w[b + "norm1.beta"])
        qkv = _linear(z, w[b + "attn.qkv.weight"]).reshape(
            n, tokens, 3, heads, dim // heads).permute(2, 0, 3, 1, 4)
        t = t + _linear(core(qkv[0], qkv[1], qkv[2]),
                        w[b + "attn.proj.weight"], w[b + "attn.proj.bias"])
        z = layer_norm(t, w[b + "norm2.gamma"], w[b + "norm2.beta"])
        z = _linear(z, w[b + "mlp.fc1.weight"], w[b + "mlp.fc1.bias"])
        t = t + _linear(z.clamp(0.0, 6.0), w[b + "mlp.fc2.weight"],
                        w[b + "mlp.fc2.bias"])
        i += 1
    f = layer_norm(t, w["norm.gamma"], w["norm.beta"]).reshape(n, -1)
    f = _bn(_linear(f, w["feature.0.weight"]), w, "feature.1")
    f = _bn(_linear(f, w["feature.2.weight"]), w, "feature.3")
    if not normalize:
        return f
    return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp(
        min=1e-12)
