"""The A2-LINK adversarial channels: the one-pixel DE attack and FGSM, on
batches of pairs (counterpart of ``alink_tpu/ops/attack.py``; the
reference's attack.py and noise.py:153-188).

Semantics kept from the JAX package:

- a candidate is a flat ``[x, y, r, g, b] * pixel_count`` vector over the
  vertically concatenated pair (2H x W): bounds ``(0, 2H), (0, W),
  (0, 256)^3``; coordinates are truncated to ints, x indexes rows (dim 0)
  and y columns (dim 1), and each pixel's RGB is overwritten;
- DE as the reference's ``attack_all`` runs it: pixel_count 40, maxiter 50,
  popsize 250 -> ``popmul = max(1, popsize // (5 * pixel_count))`` = 1, so
  m = 200 members, recombination 1, atol -1, polish off;
- the attack is TARGETED toward ``argmax(m1_labels)``: DE minimises
  ``1 - P(target)``, and a pair stops early once the model's argmax is the
  target (the reference's ``attack_success``);
- FGSM is targeted and descending: both halves move by
  ``-epsilon * sign(grad)`` of the cross-entropy against the labels, with
  epsilon 2 in raw pixel units.

The one-pixel search runs one batched DE over all pairs (``ops.de``): a
generation scores every live pair's population, ``EVAL_BATCH`` candidates
per ``predict_fn`` call.
"""

from __future__ import annotations

from typing import Callable

import torch

from alink_tpu_torch.ops.de import DrawFn, differential_evolution
from alink_tpu_torch.ops.image import resize

# (params, left (N, H, W, C), right) -> (N, 2) probabilities.
PredictFn = Callable[[object, torch.Tensor, torch.Tensor], torch.Tensor]

# Candidates per predict call in a DE generation: bounds its memory (the JAX
# package scores every pair's 200 candidates in one program: 1,024 x 200
# full-size pair images at the default chunk).
EVAL_BATCH = 256


def _perturb_batch(xs: torch.Tensor, imgs: torch.Tensor) -> torch.Tensor:
    """xs (A, M, 5k) candidates on imgs (A, H, W, C) -> (A, M, H, W, C).

    The writes are two scatter-adds, of the RGB values and of the hit
    counts: a pixel written twice by one candidate takes the mean of its
    writes, as the JAX package's one-hot contraction gives."""
    a, mm, k5 = xs.shape
    _, h, w, c = imgs.shape
    px = xs.to(torch.int32).reshape(a, mm, k5 // 5, 5)
    rows = px[..., 0].clamp(0, h - 1).long()
    cols = px[..., 1].clamp(0, w - 1).long()
    rgb = px[..., 2:5].float()
    cand = torch.arange(a * mm, device=xs.device).reshape(a, mm, 1)
    lin = ((cand * h + rows) * w + cols).flatten()
    vals = torch.zeros((a * mm * h * w, c), device=xs.device).index_add_(
        0, lin, rgb.reshape(-1, 3))
    hits = torch.zeros(a * mm * h * w, device=xs.device).index_add_(
        0, lin, torch.ones_like(lin, dtype=torch.float32))
    vals = vals.reshape(a, mm, h, w, c)
    hits = hits.reshape(a, mm, h, w, 1)
    out = (imgs.float()[:, None] * torch.clamp(1.0 - hits, min=0.0)
           + vals / torch.clamp(hits, min=1.0))
    return out.to(imgs.dtype)


def perturb_image(xs: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Apply ``[x, y, r, g, b] * k`` vectors ``xs`` (..., 5k) to one image
    (H, W, C): returns ``xs.shape[:-1] + img.shape``."""
    lead = xs.shape[:-1]
    out = _perturb_batch(xs.reshape(1, -1, xs.shape[-1]), img[None])
    return out.reshape(lead + img.shape)


def _bounds(h2: int, w: int, pixel_count: int, device) -> torch.Tensor:
    one = torch.tensor([[0, h2], [0, w], [0, 256], [0, 256], [0, 256]],
                       dtype=torch.float32, device=device)
    return one.repeat(pixel_count, 1)


def one_pixel_attack_pairs(
    predict_fn: PredictFn,
    predict_params,
    left: torch.Tensor,
    right: torch.Tensor,
    target_labels: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    draw: DrawFn | None = None,
    pixel_count: int = 40,
    maxiter: int = 50,
    popsize: int = 250,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A2-LINK's one-pixel channel over a pair batch.

    Args:
        predict_fn: the end-to-end student ``(params, left, right) -> (N,
            2)`` probabilities (PredictionWrappedModel, noise.py:153-168).
        left/right: (N, H, W, C) raw pair halves.
        target_labels: (N, 2) one-hot M1 labels; the attack drives the
            student toward their argmax.
        generator/draw: the DE's randomness (``ops.de``).

    Returns the perturbed (left, right), shapes and dtype of the inputs.
    """
    n, h, w, _ = left.shape
    popmul = max(1, popsize // (5 * pixel_count))  # attack.py:71
    concat = torch.cat([left, right], dim=1)       # (N, 2H, W, C)
    target = torch.argmax(target_labels, dim=-1)

    def predict(imgs: torch.Tensor) -> torch.Tensor:
        return predict_fn(predict_params, imgs[:, :h], imgs[:, h:])

    def fitness(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        a, mm = x.shape[:2]
        flat = x.reshape(a * mm, 1, -1)
        prob = idx.repeat_interleave(mm)
        b = EVAL_BATCH
        p_target = torch.cat([
            predict(_perturb_batch(flat[s:s + b], concat[prob[s:s + b]])[:, 0])
            .gather(1, target[prob[s:s + b]][:, None])[:, 0]
            for s in range(0, a * mm, b)])
        return 1.0 - p_target.reshape(a, mm)

    def success(best: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        probs = predict(_perturb_batch(best[:, None], concat[idx])[:, 0])
        return torch.argmax(probs, dim=-1) == target[idx]

    result = differential_evolution(
        fitness, _bounds(2 * h, w, pixel_count, left.device), n,
        draw=draw, generator=generator, maxiter=maxiter, popsize=popmul,
        recombination=1.0, atol=-1.0, early_stop_fn=success)
    out = _perturb_batch(result.x[:, None], concat)[:, 0]
    return out[:, :h], out[:, h:]


def one_pixel_attack_pairs_proxy(
    predict_fn: PredictFn,
    predict_params,
    left: torch.Tensor,
    right: torch.Tensor,
    target_labels: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    draw: DrawFn | None = None,
    proxy_hw: tuple[int, int] = (56, 56),
    pixel_count: int = 40,
    maxiter: int = 50,
    popsize: int = 250,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The low-resolution surrogate of ``one_pixel_attack_pairs`` (opt-in,
    no reference counterpart): the search runs at ``proxy_hw``, each
    changed proxy pixel is written over its block at full resolution, and
    one full-resolution forward per pair keeps the attack only where the
    student's argmax is the target; other pairs return unattacked.
    ``proxy_hw`` must divide the pair resolution."""
    n, h, w, _ = left.shape
    ph, pw = proxy_hw
    if h % ph or w % pw:
        raise ValueError(f"proxy_hw {proxy_hw} must divide ({h}, {w})")
    sy, sx = h // ph, w // pw
    pl_, pr_ = resize(left, (ph, pw)), resize(right, (ph, pw))
    al, ar = one_pixel_attack_pairs(
        predict_fn, predict_params, pl_, pr_, target_labels, generator,
        draw=draw, pixel_count=pixel_count, maxiter=maxiter, popsize=popsize)

    def inject(full, proxy_orig, proxy_att):
        changed = torch.any(proxy_att != proxy_orig, dim=-1, keepdim=True)
        up_mask = changed.repeat_interleave(sy, 1).repeat_interleave(sx, 2)
        up_vals = proxy_att.repeat_interleave(sy, 1).repeat_interleave(sx, 2)
        return torch.where(up_mask, up_vals.to(full.dtype), full)

    fl, fr = inject(left, pl_, al), inject(right, pr_, ar)
    probs = predict_fn(predict_params, fl, fr)
    ok = (torch.argmax(probs, dim=-1)
          == torch.argmax(target_labels, dim=-1))[:, None, None, None]
    return torch.where(ok, fl, left), torch.where(ok, fr, right)


def fgsm_pairs(
    predict_fn: PredictFn,
    predict_params,
    left: torch.Tensor,
    right: torch.Tensor,
    target_labels: torch.Tensor,
    epsilon: float = 2.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Targeted fast gradient-sign step on a pair batch: both halves move
    by ``-epsilon * sign(grad)`` of the mean cross-entropy of
    ``predict_fn`` against ``target_labels`` (toward M1's labels).  Grad is
    enabled here only; the inputs are not modified."""
    with torch.enable_grad():
        lh = left.detach().float().requires_grad_(True)
        rh = right.detach().float().requires_grad_(True)
        probs = predict_fn(predict_params, lh, rh)
        loss = -torch.mean(torch.sum(
            target_labels * torch.log(probs + 1e-12), dim=-1))
        gl, gr = torch.autograd.grad(loss, (lh, rh))
    return (left - epsilon * torch.sign(gl).to(left.dtype),
            right - epsilon * torch.sign(gr).to(right.dtype))
