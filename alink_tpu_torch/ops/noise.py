"""The A2-LINK noise bank on batched tensors (counterpart of
``alink_tpu/ops/noise.py``).

Each channel is split in two: its draws (from a ``torch.Generator`` on the
images' device) and its arithmetic (``*_from``), so that a test can feed
the JAX package's draws to the port's arithmetic.  The reference's quirks
are kept:

- ``gaussian``    — ``x + 10 + sqrt(10) * z``;
- ``salt_pepper`` — ceil(0.004 * size / 2) salt points set to 1 and as many
  pepper points set to 0 per image, positions drawn with replacement in
  ``[0, dim - 2]`` (the reference's ``randint(0, dim - 1)``), salt 1 even on
  [0, 255] images, the dtype kept;
- ``poisson``     — Gaussian limit ``max(round(lam + sqrt(lam) z), 0) / vals``
  with ``lam = max(x * vals, 0)`` and ``vals = 2**ceil(log2(n_unique))``,
  the unique count over the 256 uint8 levels of ``round(x)``
  (``assume_uint8=False``: over the sorted values); ``exact=True`` draws a
  true Poisson instead;
- ``speckle``     — ``x + x * z / 15``;
- ``perlin``      — octaves (56, 32, 16) when size % 56 == 0 else (50, 30,
  15), one field per image on all channels, quintic fade;
- ``plain``       — identity.

Integer images are computed in f32 (gaussian, poisson, speckle).  The
adversarial channels (one-pixel DE, FGSM) need the student model: they
live in ``ops/attack.py`` and ``Committee.attack_model`` runs them.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

NoiseFn = Callable[[torch.Generator, torch.Tensor], torch.Tensor]


def _float(images: torch.Tensor) -> torch.Tensor:
    return images if images.is_floating_point() else images.float()


def _normal(g: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    x = _float(images)
    return torch.randn(x.shape, generator=g, device=x.device, dtype=x.dtype)


def plain(g: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """Identity noise."""
    return images


def gaussian_from(images, z, mean: float = 10.0, var: float = 10.0):
    return _float(images) + mean + var ** 0.5 * z


def gaussian(g, images, mean: float = 10.0, var: float = 10.0):
    """Additive Gaussian noise N(mean, var)."""
    return gaussian_from(images, _normal(g, images), mean, var)


def salt_pepper_counts(shape, s_vs_p: float = 0.5, amount: float = 0.004):
    _, h, w, c = shape
    size = h * w * c
    return (int(math.ceil(amount * size * s_vs_p)),
            int(math.ceil(amount * size * (1.0 - s_vs_p))))


def salt_pepper_from(images: torch.Tensor, salt: torch.Tensor,
                     pepper: torch.Tensor) -> torch.Tensor:
    """``salt``/``pepper``: (3, N, count) int (y, x, channel) positions."""
    out = images.clone()
    b = torch.arange(images.shape[0], device=images.device)[:, None]
    out[b, salt[0], salt[1], salt[2]] = 1
    out[b, pepper[0], pepper[1], pepper[2]] = 0
    return out


def salt_pepper(g, images, s_vs_p: float = 0.5, amount: float = 0.004):
    """Fixed-count salt & pepper noise."""
    n, h, w, c = images.shape
    counts = salt_pepper_counts(images.shape, s_vs_p, amount)

    def coords(count):
        return torch.stack([
            torch.randint(0, max(d - 1, 1), (n, count), generator=g,
                          device=images.device) for d in (h, w, c)])

    return salt_pepper_from(images, *(coords(k) for k in counts))


def _poisson_vals(img: torch.Tensor, assume_uint8: bool) -> torch.Tensor:
    """``vals = 2**ceil(log2(n_unique))`` per image, broadcastable to
    ``img``: the unique count over the 256 uint8 levels of ``round(x)``, or
    with ``assume_uint8=False`` over the sorted values themselves."""
    n = img.shape[0]
    if assume_uint8:
        levels = torch.round(img.reshape(n, -1).float())
        hit = ((levels >= 0) & (levels <= 255)).float()
        present = torch.zeros((n, 256), device=img.device)
        present.scatter_add_(1, levels.clamp(0, 255).long(), hit)
        n_unique = torch.clamp((present > 0).sum(dim=1), min=1)
    else:
        flat = torch.sort(img.reshape(n, -1), dim=1).values
        n_unique = 1 + (flat[:, 1:] != flat[:, :-1]).sum(dim=1)
    vals = 2.0 ** torch.ceil(torch.log2(n_unique.float()))
    return vals.reshape((n,) + (1,) * (img.dim() - 1))


def poisson_from(images: torch.Tensor, z: torch.Tensor,
                 assume_uint8: bool = True) -> torch.Tensor:
    img = _float(images)
    vals = _poisson_vals(img, assume_uint8)
    lam = torch.clamp(img * vals, min=0.0)
    noisy = torch.clamp(torch.round(lam + torch.sqrt(lam) * z), min=0.0)
    return noisy.to(img.dtype) / vals


def poisson(g, images, assume_uint8: bool = True, exact: bool = False):
    """Poisson shot noise with data-dependent scaling: the Gaussian limit,
    or with ``exact`` a true Poisson draw (``torch.poisson``)."""
    if not exact:
        return poisson_from(images, _normal(g, images).float(), assume_uint8)
    img = _float(images)
    vals = _poisson_vals(img, assume_uint8)
    lam = torch.clamp(img * vals, min=0.0).float()
    return torch.poisson(lam, generator=g).to(img.dtype) / vals


def speckle_from(images, z):
    x = _float(images)
    return x + x * (z / 15.0)


def speckle(g, images):
    """Multiplicative speckle noise."""
    return speckle_from(images, _normal(g, images))


def _quintic(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin_octaves(size: int) -> tuple[int, ...]:
    return (56, 32, 16) if size % 56 == 0 else (50, 30, 15)


def _perlin_octave(phi: torch.Tensor, size: int, ns: int) -> torch.Tensor:
    """One gradient-noise octave per image from gradient angles ``phi``
    (N, nc + 1, nc + 1), nc = ceil(size / ns) -> (N, size, size)."""
    g = torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
    r = torch.arange(size, device=phi.device)
    cell = r // ns
    local = (r % ns).float()
    fade = _quintic(local / ns)

    def corner(di, dj):
        return g[:, cell + di][:, :, cell + dj]

    u = local[:, None]
    v = local[None, :]
    c00, c01, c10, c11 = (corner(0, 0), corner(0, 1), corner(1, 0),
                          corner(1, 1))
    d00 = v * c00[..., 0] + u * c00[..., 1]
    d01 = (v - ns) * c01[..., 0] + u * c01[..., 1]
    d10 = v * c10[..., 0] + (u - ns) * c10[..., 1]
    d11 = (v - ns) * c11[..., 0] + (u - ns) * c11[..., 1]
    fu = fade[:, None]
    fv = fade[None, :]
    top = d00 + fv * (d01 - d00)
    bot = d10 + fv * (d11 - d10)
    return top + fu * (bot - top)


def perlin_from(images: torch.Tensor, phis) -> torch.Tensor:
    """``phis``: one (N, nc + 1, nc + 1) angle grid per octave."""
    size = images.shape[1]
    field = sum(_perlin_octave(phi, size, ns)
                for phi, ns in zip(phis, perlin_octaves(size)))
    return images + field[..., None]


def perlin(g, images):
    """Additive multi-octave Perlin noise (square images)."""
    n, h, w, _ = images.shape
    if h != w:
        raise ValueError(f"perlin requires square images, got {h}x{w}")
    phis = []
    for ns in perlin_octaves(h):
        nc = -(-h // ns)
        phis.append(torch.rand((n, nc + 1, nc + 1), generator=g,
                               device=images.device) * (2 * math.pi))
    return perlin_from(images, phis)


NOISE_FNS: dict[str, NoiseFn] = {
    "gaussian": gaussian,
    "saltpepper": salt_pepper,
    "poisson": poisson,
    "speckle": speckle,
    "perlin": perlin,
    "plain": plain,
}


def get_relevant_noise(name: str) -> NoiseFn:
    """Name -> noise fn (the reference's error contract)."""
    try:
        return NOISE_FNS[name.lower()]
    except KeyError:
        raise NotImplementedError(f"{name} noise is not implemented!") from None


def add_pair_noise(fn: NoiseFn, g: torch.Generator, left: torch.Tensor,
                   right: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One channel on both halves of a pair batch (left drawn first)."""
    return fn(g, left), fn(g, right)


def apply_noise_bank(names, g: torch.Generator, left: torch.Tensor,
                     right: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A bank of non-adversarial channels over a pair batch:
    (len(names), N, H, W, C) for each half, channels in ``names`` order."""
    outs = [add_pair_noise(get_relevant_noise(n), g, left, right)
            for n in names]
    return (torch.stack([_float(o[0]) for o in outs]),
            torch.stack([_float(o[1]) for o in outs]))
