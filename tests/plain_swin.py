"""The Swin face embedder (``microsoft/Swin-Transformer``
``models/swin_transformer.py`` on 112^2 chips at patch 2, with a face
head), plain float32, for the tests: torch operations only, no kernel of
the port, TF32 off.

Raw NHWC RGB chips in [0, 255] -> (N, E) unit embeddings:
x / 127.5 - 1; Conv2d(kernel = stride = P, bias), the grid's tokens
row-major, LN; per block t += proj(W-MSA(LN1(t))) and
t += fc2(GELU(fc1(LN2(t)))), where W-MSA is the published sequence:
``torch.roll`` by -shift on odd blocks (W / 2; none, and the window the
grid, where the grid is no larger than the window), ``window_partition``,
qkv = Linear(C -> 3C, bias) split (3, H, d), q d^-1/2, q k^T + B + the
published ``attn_mask`` on shifted blocks, softmax, P v with the heads
merged, proj, ``window_reverse``, ``torch.roll`` back; patch merging
after every stage but the last (x0, x1, x2, x3 = x[0::2, 0::2],
x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2] concatenated, LN,
Linear(4C -> 2C, no bias)); LN, the mean over the tokens, Linear(C -> E,
no bias) - BN1d.  LN and BN eps 1e-5.  The one departure: the L2
normalisation at the end.

Weights are a dict keyed as the port's state dict (``layers.<i>.blocks.
<j>.attn.relative_position_bias_table`` and so on).
"""

from __future__ import annotations

import math

import torch

LN_EPS = 1e-5
BN_EPS = 1e-5


def layer_norm(x, g, b, eps=LN_EPS):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * g + b


def relative_position_index(window: int) -> torch.Tensor:
    """The published ``relative_position_index``, line for line."""
    coords_h = torch.arange(window)
    coords_w = torch.arange(window)
    coords = torch.stack(torch.meshgrid([coords_h, coords_w],
                                        indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += window - 1
    relative_coords[:, :, 1] += window - 1
    relative_coords[:, :, 0] *= 2 * window - 1
    return relative_coords.sum(-1)


def window_partition(x, window):
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window, window,
                                                         c)


def window_reverse(windows, window, h, w):
    b = int(windows.shape[0] / (h * w / window / window))
    x = windows.view(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def attn_mask(size: int, window: int, shift: int) -> torch.Tensor:
    """The published ``attn_mask`` of a shifted block, line for line."""
    img_mask = torch.zeros((1, size, size, 1))
    h_slices = (slice(0, -window), slice(-window, -shift),
                slice(-shift, None))
    w_slices = (slice(0, -window), slice(-window, -shift),
                slice(-shift, None))
    cnt = 0
    for h in h_slices:
        for w in w_slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, window).view(-1,
                                                           window * window)
    mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, float(-100.0)).masked_fill(
        mask == 0, float(0.0))


def merge(x):
    """Patch merging's gather: (B, H, W, C) -> (B, H/2, W/2, 4C)."""
    x0 = x[:, 0::2, 0::2, :]
    x1 = x[:, 1::2, 0::2, :]
    x2 = x[:, 0::2, 1::2, :]
    x3 = x[:, 1::2, 1::2, :]
    return torch.cat([x0, x1, x2, x3], -1)


def window_msa(qkv, table, shift, window):
    """(B, S, S, 3C) qkv in grid order -> (B, S, S, C): roll, partition,
    attention with the bias (and the mask), reverse, roll back."""
    b, s, _, c3 = qkv.shape
    heads = table.shape[1]
    c = c3 // 3
    n = window * window
    if shift > 0:
        qkv = torch.roll(qkv, shifts=(-shift, -shift), dims=(1, 2))
    x = window_partition(qkv, window).view(-1, n, c3)
    b_ = x.shape[0]
    x = x.reshape(b_, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = x[0], x[1], x[2]
    q = q * (c // heads) ** -0.5
    attn = q @ k.transpose(-2, -1)
    bias = table[relative_position_index(window).view(-1)].view(n, n, -1)
    attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
    if shift > 0:
        mask = attn_mask(s, window, shift)
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, heads, n, n) + \
            mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    o = (attn @ v).transpose(1, 2).reshape(b_, n, c)
    o = window_reverse(o.view(-1, window, window, c), window, s, s)
    if shift > 0:
        o = torch.roll(o, shifts=(shift, shift), dims=(1, 2))
    return o


def _linear(x, w, b=None):
    y = x @ w.t()
    return y if b is None else y + b


def block(w: dict, prefix: str, t, window: int):
    """One Swin block on (B, S, S, C) float32; odd blocks shift."""
    size = t.shape[1]
    j = int(prefix.rstrip(".").rsplit(".", 1)[1])
    if size <= window:
        window, shift = size, 0
    else:
        shift = window // 2 if j % 2 else 0
    z = layer_norm(t, w[prefix + "norm1.gamma"], w[prefix + "norm1.beta"])
    qkv = _linear(z, w[prefix + "attn.qkv.weight"],
                  w[prefix + "attn.qkv.bias"])
    o = window_msa(qkv, w[prefix + "attn.relative_position_bias_table"],
                   shift, window)
    t = t + _linear(o, w[prefix + "attn.proj.weight"],
                    w[prefix + "attn.proj.bias"])
    z = layer_norm(t, w[prefix + "norm2.gamma"], w[prefix + "norm2.beta"])
    z = _linear(z, w[prefix + "mlp.fc1.weight"], w[prefix + "mlp.fc1.bias"])
    z = 0.5 * z * (1.0 + torch.erf(z / math.sqrt(2.0)))
    return t + _linear(z, w[prefix + "mlp.fc2.weight"],
                       w[prefix + "mlp.fc2.bias"])


def _f32(fn):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return fn()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def forward(w: dict, x: torch.Tensor, window: int = 7,
            normalize: bool = True) -> torch.Tensor:
    return _f32(lambda: _forward({k: v.float() for k, v in w.items()}, x,
                                 window, normalize))


def _forward(w, x, window, normalize):
    p = w["patch_embed.proj.weight"].shape[-1]
    y = x.float().permute(0, 3, 1, 2) / 127.5 - 1.0
    y = torch.nn.functional.conv2d(y, w["patch_embed.proj.weight"],
                                   w["patch_embed.proj.bias"], stride=p)
    t = layer_norm(y.permute(0, 2, 3, 1), w["patch_embed.norm.gamma"],
                   w["patch_embed.norm.beta"])
    i = 0
    while f"layers.{i}.blocks.0.norm1.gamma" in w:
        j = 0
        while f"layers.{i}.blocks.{j}.norm1.gamma" in w:
            t = block(w, f"layers.{i}.blocks.{j}.", t, window)
            j += 1
        d = f"layers.{i}.downsample."
        if d + "reduction.weight" in w:
            t = layer_norm(merge(t), w[d + "norm.gamma"], w[d + "norm.beta"])
            t = _linear(t, w[d + "reduction.weight"])
        i += 1
    f = layer_norm(t, w["norm.gamma"], w["norm.beta"]).mean(dim=(1, 2))
    f = _linear(f, w["feature.0.weight"])
    f = ((f - w["feature.1.mean"]) / torch.sqrt(w["feature.1.var"] + BN_EPS)
         * w["feature.1.gamma"] + w["feature.1.beta"])
    if not normalize:
        return f
    return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp(
        min=1e-12)
