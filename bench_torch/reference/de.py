"""A2-LINK's one-pixel attack (Su et al., arXiv:1710.08864, as the
reference implementation's attack.py runs it through its batched fork of
SciPy's differential evolution), replayed in plain PyTorch from the draws
and the student's answers that the program used.

The attack, over a batch of pairs:

- a candidate is ``[x, y, r, g, b] * pixel_count`` over the pair stacked
  vertically (2H x W); bounds ``(0, 2H), (0, W), (0, 256)^3``; each
  coordinate truncated to an integer (x indexes rows) and clamped into
  the image; each pixel's RGB overwritten, a pixel that one candidate
  writes twice taking the mean of its writes;
- DE ``best1bin``: ``m = max(5, max(1, popsize // K) * K)`` members in
  [0, 1]^K, scaled ``mid + (x - 0.5) * width``; a Latin-hypercube start;
  the energy ``1 - P(target)`` from the student, the target the
  committee's label; the best member swapped into slot 0; per generation
  a dithered scale ``F ~ U(0.5, 1)``, five members other than the
  candidate, the mutant ``best + F (r0 - r1)``, binomial crossover at
  the recombination rate with one forced parameter, parameters out of
  [0, 1] drawn anew, greedy replacement, the best copied into slot 0;
  stop at ``maxiter`` generations, once ``std(E) <= atol + tol |mean(E)|``
  or once the student's argmax on the best is the target (checked after
  each generation); a stopped pair is no longer scored.

``replay`` is teacher-forced: it takes the program's energies and early
stops, computed from the answers it recorded, so that a rounding of the
program cannot send the replay down another branch, and it returns what
the reference has to score itself: every population the program scored
and every incumbent it probed.  The pixels it ends on are then the
attack's output as the algorithm and these draws give it.
"""

from __future__ import annotations

import dataclasses

import torch

# The attack's solver settings (attack.py): best1bin, recombination 1,
# dither (0.5, 1), tol 0.01, atol -1 (so the spread test never stops it).
RECOMBINATION = 1.0
MUTATION = (0.5, 1.0)
TOL, ATOL = 0.01, -1.0


@dataclasses.dataclass
class Replay:
    images: torch.Tensor | None   # (B, 2H, W, C) the attacked pairs
    nit: torch.Tensor | None      # (B,) generations run
    scored: list                  # (problems, scaled (a, m, K), energies)
    probed: list                  # (problems, scaled (a, K), answers (a, 2))
    rows_missing: int             # answers the algorithm needed, not given
    rows_extra: int               # answers given beyond what it needed
    draws_missing: int            # draws the algorithm needed, not given


def bounds(h2: int, w: int, pixel_count: int, device) -> torch.Tensor:
    one = torch.tensor([[0, h2], [0, w], [0, 256], [0, 256], [0, 256]],
                       dtype=torch.float32, device=device)
    return one.repeat(pixel_count, 1)


def perturb(xs: torch.Tensor, imgs: torch.Tensor) -> torch.Tensor:
    """Candidates xs (A, M, 5k), scaled, on imgs (A, H, W, C) ->
    (A, M, H, W, C) float32."""
    a, mm, k5 = xs.shape
    _, h, w, c = imgs.shape
    px = xs.trunc().reshape(a, mm, k5 // 5, 5)
    rows = px[..., 0].long().clamp(0, h - 1)
    cols = px[..., 1].long().clamp(0, w - 1)
    flat = (torch.arange(a * mm, device=xs.device).reshape(a, mm, 1) * h
            + rows) * w + cols
    total = torch.zeros(a * mm * h * w, c, device=xs.device)
    total.index_add_(0, flat.flatten(), px[..., 2:5].reshape(-1, 3).float())
    count = torch.zeros(a * mm * h * w, device=xs.device)
    count.index_add_(0, flat.flatten(),
                     torch.ones(flat.numel(), device=xs.device))
    total = total.reshape(a, mm, h, w, c)
    count = count.reshape(a, mm, h, w, 1)
    base = imgs.float()[:, None].expand(a, mm, h, w, c)
    return torch.where(count > 0, total / count.clamp(min=1.0), base)


def replay(draws: dict, answers: torch.Tensor, pairs: torch.Tensor,
           target: torch.Tensor, *, pixel_count: int, popsize: int,
           maxiter: int) -> Replay:
    """The attack on ``pairs`` (B, 2H, W, C) toward ``target`` (B,).

    ``draws``: {(generation, name): tensor} as the program drew them
    (``lhs_u``, ``lhs_perm`` at 0; per generation ``dither``,
    ``samples``, ``fill``, ``cross``, ``resample``), each over all B
    problems.  ``answers``: the student's (rows, 2) probabilities in the
    order the program asked for them: the start's B * m candidates, then
    per generation each live problem's m trials and its incumbent."""
    b, h2, w, _ = pairs.shape
    dev = pairs.device
    k = 5 * pixel_count
    m = max(5, max(1, popsize // k) * k)
    bd = bounds(h2, w, pixel_count, dev)
    mid = 0.5 * (bd[:, 0] + bd[:, 1])
    width = torch.abs(bd[:, 0] - bd[:, 1])
    out = Replay(None, None, [], [], 0, 0, 0)
    used = 0

    def scale(x):
        return mid + (x - 0.5) * width

    def draw(step, name):
        t = draws.get((step, name))
        if t is None:
            out.draws_missing += 1
        return t

    def take(n):
        nonlocal used
        got = answers[used:used + n]
        used += n
        if got.shape[0] < n:
            out.rows_missing += n - got.shape[0]
            return None
        return got

    def energy(rows, tgt):
        return (1.0 - rows.gather(1, tgt[:, None])[:, 0]).float()

    u, perm = draw(0, "lhs_u"), draw(0, "lhs_perm")
    if u is None or perm is None:
        return out
    strata = (1.0 / m) * u.float() + (torch.arange(
        m, dtype=torch.float32, device=dev) * (1.0 / m))[None, :, None]
    pop = torch.gather(strata, 1, perm.long().transpose(1, 2))
    rows = take(b * m)
    if rows is None:
        return out
    e = energy(rows, target.repeat_interleave(m)).reshape(b, m)
    every = torch.arange(b, device=dev)
    out.scored.append((every, scale(pop), e.clone()))
    best = torch.argmin(e, dim=1)
    for t in (pop, e):
        first = t[:, 0].clone()
        t[:, 0] = t[every, best]
        t[every, best] = first

    nit = torch.zeros(b, dtype=torch.int64, device=dev)
    stopped = torch.zeros(b, dtype=torch.bool, device=dev)
    member = torch.arange(m, device=dev)
    lo, hi = MUTATION
    step = 0
    while True:
        converged = e.std(dim=1, unbiased=False) <= ATOL + TOL * \
            e.mean(dim=1).abs()
        live = torch.nonzero((nit < maxiter) & ~stopped & ~converged
                             ).flatten()
        if live.numel() == 0:
            break
        got = [draw(step, n) for n in ("dither", "samples", "fill", "cross",
                                       "resample")]
        if any(g is None for g in got):
            return out
        dither, samples, fill, cross, fresh = (g[live] for g in got)
        a = live.numel()
        f = dither.float() * (hi - lo) + lo
        r = samples.long()
        if r.shape[-1] < 5:
            r = torch.cat([r, r[..., :5 - r.shape[-1]]], dim=-1)
        others = torch.where(r >= member[None, :, None], r + 1, r)
        p, ep = pop[live], e[live]
        rows_of = torch.arange(a, device=dev)[:, None]
        mutant = p[:, :1] + f[:, None, None] * (p[rows_of, others[..., 0]]
                                                - p[rows_of, others[..., 1]])
        keep = cross.float() < RECOMBINATION
        keep[rows_of, member[None], fill.long()] = True
        trial = torch.where(keep, mutant, p)
        trial = torch.where((trial < 0) | (trial > 1), fresh.float(), trial)
        rows = take(a * m)
        if rows is None:
            return out
        et = energy(rows, target[live].repeat_interleave(m)).reshape(a, m)
        out.scored.append((live, scale(trial), et))
        better = et < ep
        p = torch.where(better[..., None], trial, p)
        ep = torch.where(better, et, ep)
        top = torch.argmin(ep, dim=1)
        ar = torch.arange(a, device=dev)
        swap = ep[ar, top] < ep[:, 0]
        p[:, 0] = torch.where(swap[:, None], p[ar, top], p[:, 0])
        ep[:, 0] = torch.where(swap, ep[ar, top], ep[:, 0])
        pop[live], e[live] = p, ep
        nit[live] += 1
        probe = take(a)
        if probe is None:
            return out
        out.probed.append((live, scale(p[:, 0]), probe))
        stopped[live] |= torch.argmax(probe, dim=-1) == target[live]
        step += 1

    out.rows_extra = max(0, answers.shape[0] - used)
    out.nit = nit
    out.images = perturb(scale(pop[:, 0])[:, None], pairs)[:, 0]
    return out
