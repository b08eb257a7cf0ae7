"""Closed-form 2-D similarity-transform estimation (Umeyama).

Counterpart of ``alink_tpu/ops/umeyama.py``: the least-squares scaled
proper rotation is the complex regression ``a + ib = sum d conj(s) /
sum |s|^2`` over centred points, so the whole fit is elementwise f32 —
pixel coordinates never pass through a matrix product (nor TF32).
"""

from __future__ import annotations

import torch


def umeyama(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Similarity transform M (..., 2, 3) with ``dst ~= src @ R^T * c + t``.

    ``src`` (..., K, 2) and ``dst`` (K, 2) or (..., K, 2), points in (x, y).
    """
    mu_s = src.mean(dim=-2)
    mu_d = dst.mean(dim=-2)
    src_c = src - mu_s[..., None, :]
    dst_c = dst - mu_d[..., None, :]
    a = torch.sum(dst_c[..., 0] * src_c[..., 0] + dst_c[..., 1] * src_c[..., 1],
                  dim=-1)
    b = torch.sum(dst_c[..., 1] * src_c[..., 0] - dst_c[..., 0] * src_c[..., 1],
                  dim=-1)
    denom = torch.clamp(torch.sum(src_c ** 2, dim=(-2, -1)), min=1e-12)
    a = a / denom
    b = b / denom
    tx = mu_d[..., 0] - (a * mu_s[..., 0] - b * mu_s[..., 1])
    ty = mu_d[..., 1] - (b * mu_s[..., 0] + a * mu_s[..., 1])
    return torch.stack([torch.stack([a, -b, tx], dim=-1),
                        torch.stack([b, a, ty], dim=-1)], dim=-2)


# Canonical ArcFace 5-point template for 112x96 output; 112x112 shifts x by 8.
ARCFACE_TEMPLATE_112x96 = torch.tensor(
    [[30.2946, 51.6963],
     [65.5318, 51.5014],
     [48.0252, 71.7366],
     [33.5493, 92.3655],
     [62.7299, 92.2041]], dtype=torch.float32)


def arcface_template(image_size: tuple[int, int],
                     device: torch.device | str | None = None) -> torch.Tensor:
    """Template for (h, w) in {(112, 112), (112, 96)}."""
    h, w = image_size
    if h != 112 or w not in (112, 96):
        raise ValueError("ArcFace alignment expects 112x112 or 112x96 output")
    tpl = ARCFACE_TEMPLATE_112x96
    if w == 112:
        tpl = tpl + torch.tensor([8.0, 0.0])
    return tpl.to(device)
