"""The VGGFace2 ResNet-50 teacher (Cao et al., arXiv:1710.08092; the
keras_vggface ``RESNET50`` with ``include_top=False`` and average
pooling), plain float32.

Input RGB pixels, NHWC; keras_vggface's version-2 preprocessing (RGB to
BGR, minus the per-channel means).  Stem: 7x7 stride-2 convolution with
TensorFlow's SAME padding, BN, ReLU, 3x3 stride-2 VALID max pooling.
Stages of (3, 4, 6, 3) bottlenecks 1x1 - 3x3 - 1x1 (x4) of widths 64 to
512, each BN and ReLU, the first of a stage with a 1x1 projection on the
shortcut and, from stage 2 on, stride 2 on its first 1x1 convolution and
on the projection.  BN epsilon 1e-3.  The feature is the mean over the
last map (2,048-d).  Weights keyed ``conv.0``, ``bn.0`` and
``blocks.<i>.{conv,bn}.<j>`` as the harness made them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_torch.reference.numerics import Numerics, bn

EPS = 1e-3
MEAN_BGR = (91.4953, 103.8827, 131.0912)


def _same(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def features(w: dict, images, stage_sizes, nx: Numerics,
             block: int = 64) -> torch.Tensor:
    """(N, H, W, 3) pixels -> (N, 2048), ``block`` images at a time."""
    return torch.cat([_features(w, images[i:i + block], stage_sizes, nx)
                      for i in range(0, images.shape[0], block)])


def _features(w, images, stage_sizes, nx):
    x = images.float().flip(-1) - torch.tensor(MEAN_BGR,
                                               device=images.device)
    y = x.permute(0, 3, 1, 2)
    ph, pw = _same(y.shape[2], 7, 2), _same(y.shape[3], 7, 2)
    y = nx.conv(F.pad(y, pw + ph), w["conv.0.weight"], stride=2)
    y = F.max_pool2d(torch.relu(bn(y, w, "bn.0", EPS)), 3, 2)
    i = 0
    for stage, n in enumerate(stage_sizes):
        for b in range(n):
            p = f"blocks.{i}."
            s = 2 if stage > 0 and b == 0 else 1
            z = torch.relu(bn(nx.conv(y, w[p + "conv.0.weight"], stride=s),
                              w, p + "bn.0", EPS))
            z = torch.relu(bn(nx.conv(z, w[p + "conv.1.weight"], padding=1),
                              w, p + "bn.1", EPS))
            z = bn(nx.conv(z, w[p + "conv.2.weight"]), w, p + "bn.2", EPS)
            if b == 0:
                sc = bn(nx.conv(y, w[p + "conv.3.weight"], stride=s), w,
                        p + "bn.3", EPS)
            else:
                sc = y
            y = torch.relu(z + sc)
            i += 1
    return y.mean(dim=(2, 3))
