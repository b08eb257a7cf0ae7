"""Paired data augmentation (counterpart of ``alink_tpu/ops/augment.py``).

Reference: ``code/helpers.py:114-141`` (``augment_data``): for every pair it
appends the original plus a randomly rotated (20 deg), randomly sheared
(0.2 intensity) and randomly shifted (0.2 fraction) copy, applying *the same
kind* of transform to both halves of the pair, with keras
``fill_mode='nearest'`` borders and nearest-pixel sampling.  Each variant is
one batched affine warp, ``ops.image.affine_warp_batch`` with
``border="nearest", interp="nearest"``: kernel K2 on a CUDA tensor, its
plain version on a CPU tensor.

As in the JAX package (SURVEY.md section 7), the parameters are drawn
*independently* for the left and right half of a pair (the reference calls
``random_rotation`` separately per half, helpers.py:127-138, despite its
"same transformations together" comment).

The draws are separate from the warps, as in ``ops.de``: every matrix comes
from ``draw(block, variant, side, n, h, w) -> (A_rc, t_rc)``, the keras
(row, col) pull-back matrices (n, 2, 2) and translations (n, 2) in f32.
``block`` is ``rep * len(variants) + variant index`` (the JAX package's
``fold_in`` index), ``side`` 0 for the left halves and 1 for the right.
``torch_draws(generator)`` is the default; ``torch.Generator`` cannot give
``jax.random``'s numbers, so a test feeds the JAX side's matrices through
the same function.
"""

from __future__ import annotations

from typing import Callable

import torch

from alink_tpu_torch.ops.image import affine_warp_batch

# variant -> (range of its draw, whether keras applies it about the centre)
_VARIANTS = {"rotation": (20.0, True), "shear": (0.2, True),
             "shift": (0.2, False)}

DrawFn = Callable[[int, str, int, int, int, int],
                  "tuple[torch.Tensor, torch.Tensor]"]


def torch_draws(generator: torch.Generator | None = None) -> DrawFn:
    """The default ``draw``: keras' random_rotation / random_shear /
    random_shift matrices from ``generator``, on its device (the CPU when
    there is none)."""
    dev = generator.device if generator is not None else torch.device("cpu")

    def uniform(n, bound):
        return torch.empty(n, device=dev).uniform_(-bound, bound,
                                                    generator=generator)

    def draw(block, variant, side, n, h, w):
        bound = _VARIANTS[variant][0]
        t = torch.zeros((n, 2), device=dev)
        if variant == "rotation":
            # pull-back [[cos, -sin], [sin, cos]]
            theta = torch.deg2rad(uniform(n, bound))
            c, s = torch.cos(theta), torch.sin(theta)
            A = torch.stack([torch.stack([c, -s], -1),
                             torch.stack([s, c], -1)], dim=1)
        elif variant == "shear":
            # pull-back [[1, -sin(s)], [0, cos(s)]] in (row, col)
            sh = uniform(n, bound)
            one, zero = torch.ones_like(sh), torch.zeros_like(sh)
            A = torch.stack([torch.stack([one, -torch.sin(sh)], -1),
                             torch.stack([zero, torch.cos(sh)], -1)], dim=1)
        else:
            # pull-back translation (rows, cols), no centre offset
            tr = uniform(n, bound) * h
            tc = uniform(n, bound) * w
            A = torch.eye(2, device=dev).expand(n, 2, 2).clone()
            t = torch.stack([tr, tc], dim=-1)
        return A, t

    return draw


def _pullback_to_forward(h: int, w: int, A_rc: torch.Tensor,
                         t_rc: torch.Tensor, center: bool) -> torch.Tensor:
    """Keras (row, col) PULL-BACK affines (n, 2, 2), (n, 2) -> forward
    (n, 2, 3) for ``affine_warp_batch``.

    Keras hands its matrices to ``ndi.affine_transform``, which samples the
    INPUT at ``A @ out + t`` (output -> input); ``affine_warp_batch`` takes
    a forward (input -> output) matrix and inverts it, so the keras matrix
    is inverted here.  ``center=True`` wraps in
    ``transform_matrix_offset_center``'s translation about (h/2 + 0.5,
    w/2 + 0.5): keras' literal formula, NOT the pixel-grid centre
    ((h-1)/2).  Elementwise f32, in the JAX function's order.
    """
    A_rc = A_rc.float()
    t_rc = t_rc.float()
    a00, a01 = A_rc[:, 0, 0], A_rc[:, 0, 1]
    a10, a11 = A_rc[:, 1, 0], A_rc[:, 1, 1]
    tr, tc = t_rc[:, 0], t_rc[:, 1]
    if center:
        o0, o1 = h / 2.0 + 0.5, w / 2.0 + 0.5
        tr = o0 - (a00 * o0 + a01 * o1) + tr
        tc = o1 - (a10 * o0 + a11 * o1) + tc
    # (row, col) -> (x, y): swap both axes of A and the translation.
    a, b, c, d = a11, a10, a01, a00
    tx, ty = tc, tr
    # Forward = inverse of the pull-back: A_f = A_xy^-1, b_f = -A_f t_xy
    # (the warp's own inversion then recovers src = A_xy @ dst + t_xy).
    det = a * d - b * c
    f00, f01, f10, f11 = d / det, -b / det, -c / det, a / det
    bx = -f00 * tx + -f01 * ty
    by = -f10 * tx + -f11 * ty
    return torch.stack([torch.stack([f00, f01, bx], -1),
                        torch.stack([f10, f11, by], -1)], dim=1)


def warp_pullback(images: torch.Tensor, A_rc: torch.Tensor,
                  t_rc: torch.Tensor, center: bool) -> torch.Tensor:
    """Warp NHWC ``images`` by keras pull-back matrices, nearest border and
    nearest-pixel sampling (old keras ``apply_transform``: ndi order 0)."""
    h, w = images.shape[1], images.shape[2]
    Ms = _pullback_to_forward(h, w, A_rc, t_rc, center)
    return affine_warp_batch(images, Ms.to(images.device), (h, w),
                             border="nearest", interp="nearest")


def augment_pairs(generator: torch.Generator | None, left: torch.Tensor,
                  right: torch.Tensor, labels: torch.Tensor, factor: int = 1,
                  use_rotation: bool = True, use_shear: bool = True,
                  use_shift: bool = True, draw: DrawFn | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expand a labelled pair batch with augmented copies.

    ``augment_data``'s output (helpers.py:119-141): for each repetition of
    ``factor``, the original pair plus one copy per enabled transform, the
    labels repeated alongside, grouped by variant (original block, rotation
    block, shear block, shift block) as in the JAX package.  Matrices come
    from ``draw`` (default ``torch_draws(generator)``).
    """
    if draw is None:
        draw = torch_draws(generator)
    n, h, w, _ = left.shape
    names = [name for name, on in (("rotation", use_rotation),
                                   ("shear", use_shear),
                                   ("shift", use_shift)) if on]
    outs_l, outs_r, outs_y = [], [], []
    for rep in range(factor):
        outs_l.append(left)
        outs_r.append(right)
        outs_y.append(labels)
        for vi, name in enumerate(names):
            center = _VARIANTS[name][1]
            block = rep * len(names) + vi
            for side, (x, outs) in enumerate(((left, outs_l),
                                              (right, outs_r))):
                A, t = draw(block, name, side, n, h, w)
                outs.append(warp_pullback(x, A, t, center))
            outs_y.append(labels)
    return torch.cat(outs_l), torch.cat(outs_r), torch.cat(outs_y)
