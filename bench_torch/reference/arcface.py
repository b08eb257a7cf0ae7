"""ArcFace LResNet100E-IR (Deng et al., arXiv:1801.07698; insightface's
"E" output and "IR" unit), plain float32.

Input raw RGB in [0, 255], NHWC.  Stem conv3x3 (64) - BN - PReLU; each
unit BN - conv3x3 - BN - PReLU - conv3x3(stride) - BN, plus a shortcut
conv1x1(stride) - BN where the shape changes; the "E" output BN - flatten
(channels last) - fully connected 512 - BN (fc1, as an affine) and L2
normalisation.  BN epsilon 2e-5.  Weights are keyed as the harness made
them: ``conv.0``, ``bn.0``, ``prelu.0``, ``units.<i>.{conv,bn,prelu}.<j>``,
``bn.1``, ``dense.0``, ``fc1_gamma``, ``fc1_beta``.
"""

from __future__ import annotations

import torch

from bench_torch.reference.numerics import Numerics, bn, prelu

EPS = 2e-5


def embed(w: dict, x: torch.Tensor, stage_sizes, nx: Numerics,
          block: int = 64) -> torch.Tensor:
    """(N, 112, 112, 3) -> (N, 512) unit embeddings, ``block`` rows at a
    time."""
    return torch.cat([_embed(w, x[i:i + block], stage_sizes, nx)
                      for i in range(0, x.shape[0], block)])


def _embed(w, x, stage_sizes, nx):
    y = x.float().permute(0, 3, 1, 2)
    y = prelu(bn(nx.conv(y, w["conv.0.weight"], padding=1), w, "bn.0", EPS),
              w["prelu.0.alpha"])
    u = 0
    for n in stage_sizes:
        for b in range(n):
            p = f"units.{u}."
            stride = 2 if b == 0 else 1
            z = bn(y, w, p + "bn.0", EPS)
            z = nx.conv(z, w[p + "conv.0.weight"], padding=1)
            z = prelu(bn(z, w, p + "bn.1", EPS), w[p + "prelu.0.alpha"])
            z = nx.conv(z, w[p + "conv.1.weight"], stride=stride, padding=1)
            z = bn(z, w, p + "bn.2", EPS)
            if p + "conv.2.weight" in w:
                s = bn(nx.conv(y, w[p + "conv.2.weight"], stride=stride), w,
                       p + "bn.3", EPS)
            else:
                s = y
            y = z + s
            u += 1
    y = bn(y, w, "bn.1", EPS)
    y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)
    y = nx.linear(y, w["dense.0.weight"], w["dense.0.bias"])
    y = y * w["fc1_gamma"].float() + w["fc1_beta"].float()
    return y / torch.linalg.vector_norm(y, dim=-1, keepdim=True).clamp(
        min=1e-12)
