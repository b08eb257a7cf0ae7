"""The A-LINK loop's steps besides the models (Dhar et al.'s A-LINK / A2-LINK,
the reference implementation's ALINK.py and noise.py), plain PyTorch:

- the plain noise channels, drawn from a copy of the loop's generator in
  the loop's order (per channel the left half, then the right):
  gaussian ``x + 10 + sqrt(10) z``; salt and pepper, ceil(0.004 * size / 2)
  positions each drawn in [0, dim - 2] per axis, salt 1 and pepper 0;
  poisson, the Gaussian limit ``max(round(lam + sqrt(lam) z), 0) / v``
  with ``lam = max(x v, 0)`` and ``v`` = 2^ceil(log2(distinct uint8
  levels)); speckle ``x + x z / 15``;
- disparity selection: per channel the top ``int(n * ratio)`` pairs by
  |student - committee| (ties to the lower index), the intersection over
  channels, the oracle gate (outside 0.5 +- eps, committee agrees with
  the label);
- the finetune: Keras ``fit`` with the last 20 % held out, a fresh
  permutation of the rest each epoch from the given CPU generator,
  batches of 16, binary cross-entropy over the 2-way softmax, Adadelta
  (rho 0.95, eps 1e-8), all in float32.
"""

from __future__ import annotations

import math

import torch

from bench_torch.reference import head as ref_head
from bench_torch.reference.numerics import Numerics


# -- noise ------------------------------------------------------------------

def _gaussian(g, x):
    return x + 10.0 + math.sqrt(10.0) * torch.randn(
        x.shape, generator=g, device=x.device)


def _saltpepper(g, x):
    n, h, w, c = x.shape
    count = int(math.ceil(0.004 * h * w * c * 0.5))
    out = x.clone()
    b = torch.arange(n, device=x.device)[:, None]
    for value in (1.0, 0.0):
        yy, xx, cc = (torch.randint(0, max(d - 1, 1), (n, count),
                                    generator=g, device=x.device)
                      for d in (h, w, c))
        out[b, yy, xx, cc] = value
    return out


def _poisson(g, x):
    n = x.shape[0]
    levels = torch.round(x.reshape(n, -1))
    distinct = torch.tensor([torch.unique(r[(r >= 0) & (r <= 255)]).numel()
                             for r in levels], device=x.device)
    v = (2.0 ** torch.ceil(torch.log2(distinct.clamp(min=1).float())))
    v = v.reshape(n, 1, 1, 1)
    lam = (x * v).clamp(min=0.0)
    z = torch.randn(x.shape, generator=g, device=x.device)
    return torch.round(lam + torch.sqrt(lam) * z).clamp(min=0.0) / v


def _speckle(g, x):
    return x + x * (torch.randn(x.shape, generator=g, device=x.device) / 15.0)


NOISE = {"gaussian": _gaussian, "saltpepper": _saltpepper,
         "poisson": _poisson, "speckle": _speckle}


def noise_bank(names, g, left, right):
    """(K, N, H, W, C) noisy left and right halves of the plain channels."""
    ls, rs = [], []
    for name in names:
        ls.append(NOISE[name](g, left.float()))
        rs.append(NOISE[name](g, right.float()))
    return torch.stack(ls), torch.stack(rs)


# -- selection --------------------------------------------------------------

def select(student, committee, labels, ratio: float, eps: float):
    """(selected count, queried mask) from (K, N) student and (N,)
    committee P(genuine) and (N,) oracle labels."""
    k, n = student.shape
    take = int(n * ratio)
    chosen = torch.ones(n, dtype=torch.bool, device=student.device)
    for ch in range(k):
        d = (student[ch] - committee).abs()
        order = sorted(range(n), key=lambda i: (-float(d[i]), i))
        mask = torch.zeros(n, dtype=torch.bool, device=student.device)
        mask[order[:take]] = True
        chosen &= mask
    confident = (committee <= 0.5 - eps) | (committee >= 0.5 + eps)
    agree = (committee >= 0.5) == (labels >= 0.5)
    return int(chosen.sum()), chosen & confident & agree


# -- finetune ---------------------------------------------------------------

def _bce(logits, labels):
    p = torch.softmax(logits, dim=-1).clamp(1e-7, 1 - 1e-7)
    t = torch.nn.functional.one_hot(labels.long(), 2).float()
    return (-(t * torch.log(p) + (1 - t) * torch.log(1 - p))).mean(-1).mean()


def finetune(w: dict, opt: dict, left, right, labels, *, epochs: int,
             batch_size: int, host_state: torch.Tensor, lr: float,
             nx: Numerics, rho: float = 0.95, eps: float = 1e-8):
    """Train the head ``w`` (float32 copies) as Keras ``fit`` does;
    ``opt`` holds each leaf's Adadelta (square_avg, acc_delta) at the
    start.  Returns the trained weights and the first step's gradient
    norm per leaf."""
    w = {k: v.detach().float().clone().requires_grad_(True)
         for k, v in w.items()}
    state = {k: (opt[k][0].float().clone(), opt[k][1].float().clone())
             for k in w}
    g = torch.Generator()
    g.set_state(host_state)
    n = labels.shape[0]
    n_train = int(n * 0.8) or n
    first = None
    for _ in range(epochs):
        perm = torch.randperm(n_train, generator=g).to(left.device)
        for s in range(0, n_train, batch_size):
            idx = perm[s:s + batch_size]
            with torch.enable_grad():
                loss = _bce(ref_head.logits(w, left[idx], right[idx], nx),
                            labels[idx])
                grads = torch.autograd.grad(loss, list(w.values()))
            with torch.no_grad():
                if first is None:
                    first = {k: float(gr.norm()) for k, gr in zip(w, grads)}
                for (k, p), gr in zip(w.items(), grads):
                    sq, acc = state[k]
                    sq.mul_(rho).addcmul_(gr, gr, value=1 - rho)
                    delta = (acc + eps).sqrt() / (sq + eps).sqrt() * gr
                    acc.mul_(rho).addcmul_(delta, delta, value=1 - rho)
                    p.sub_(lr * delta)
    return {k: v.detach() for k, v in w.items()}, first
