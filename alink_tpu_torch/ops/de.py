"""Differential evolution over a batch of problems (counterpart of
``alink_tpu/ops/de.py``; the reference's forked SciPy DE, whose change is
that the fitness function scores a whole population at once).

The JAX package ``vmap``s one solve over a batch of problems; here the
batch is a leading dimension written out, so every generation is one
fitness call for the populations of all live problems.  Kept from the JAX
solver:

- the population lives in [0, 1]^K, scaled by ``mid + (x - 0.5) * width``;
- ``m = max(5, popsize * K)`` members; Latin-hypercube init (stratified
  uniforms, each parameter column permuted on its own) or uniform init;
- per generation: the dithered mutation scale, one of the 12 strategies
  (six mutations, binomial or exponential crossover), one draw of 5
  member indices per candidate that excludes the candidate and wraps onto
  its first draws when ``m = 5``; binomial crossover with the forced fill
  point; exponential crossover that may copy zero parameters (the fork's
  semantics); out-of-bounds resampling; greedy replacement and the copy of
  the best member into slot 0 (ties keep the incumbent);
- the stop test ``std(E) <= atol + tol * |mean(E)|``, ``maxiter``, and the
  early-stop callback on the incumbent best, checked after each generation;
- ``nfev = (nit + 1) * m`` plus ``nit`` early-stop probes when the
  callback is set.

A problem that stops freezes, as under JAX's batched ``while_loop``; its
fitness is no longer evaluated.  Randomness comes from one function,
``draw(step, name, shape, high)`` (``torch_draws`` by default).  ``torch.Generator``
cannot give ``jax.random``'s numbers, so a test injects the JAX key
schedule's draws through the same function.  polish (L-BFGS-B) is absent,
as in the JAX package: the only caller disables it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from alink_tpu_torch.utils.profiling import count, span

_BINOMIAL = {"best1bin", "randtobest1bin", "currenttobest1bin",
             "best2bin", "rand2bin", "rand1bin"}
_EXPONENTIAL = {"best1exp", "rand1exp", "randtobest1exp",
                "currenttobest1exp", "best2exp", "rand2exp"}

# draw(step, name, shape, high) -> tensor.  ``step`` is the generation
# (0-based; the init draws come at step 0); ``high`` bounds an integer draw
# (exclusive) and is None for a uniform one.  Names, shapes and laws, B
# problems:
#   "lhs_u"     (B, m, K) U[0, 1)         Latin-hypercube offsets
#   "lhs_perm"  (B, K, m) int64           one permutation per column
#   "init_u"    (B, m, K) U[0, 1)         init="random"
#   "dither"    (B,)      U[0, 1)         mutation scale draw
#   "samples"   (B, m, min(5, m-1)) int64 distinct, in [0, m - 1)
#   "fill"      (B, m)    int64 in [0, K)
#   "cross"     (B, m, K) U[0, 1) binomial; (B, m) U[1e-12, 1) exponential
#   "resample"  (B, m, K) U[0, 1)
DrawFn = Callable[[int, str, tuple, "int | None"], torch.Tensor]


class DEResult(NamedTuple):
    """One entry per problem along dim 0."""

    x: torch.Tensor            # (B, K) best parameters, scaled
    fun: torch.Tensor          # (B,) best energy
    nit: torch.Tensor          # (B,) generations run
    nfev: torch.Tensor         # (B,) fitness evaluations
    population: torch.Tensor   # (B, m, K) final population, scaled
    energies: torch.Tensor     # (B, m)
    stopped_early: torch.Tensor  # (B,) the early-stop callback fired


def torch_draws(generator: torch.Generator | None = None,
                device=None) -> DrawFn:
    """The default ``draw``: every tensor from ``generator`` on ``device``
    (the generator's own device when omitted)."""
    dev = torch.device(device) if device is not None else (
        generator.device if generator is not None else torch.device("cpu"))

    def rand(shape):
        return torch.rand(shape, generator=generator, device=dev)

    def draw(step: int, name: str, shape: tuple,
             high: int | None = None) -> torch.Tensor:
        if name == "lhs_perm":
            return torch.argsort(rand(shape), dim=-1)
        if name == "samples":
            # n distinct of high per candidate: the n largest of high
            # uniform keys, without replacement.
            return torch.topk(rand(shape[:-1] + (high,)), shape[-1],
                              dim=-1).indices
        if name == "fill":
            return torch.randint(0, high, shape, generator=generator,
                                 device=dev)
        if name == "cross" and len(shape) == 2:
            return rand(shape).clamp_min(1e-12)
        return rand(shape)

    return draw


def _mutate(strategy: str, pop: torch.Tensor, idxs: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    """The six mutations (de.py:820-877) for A problems at once.

    pop (A, m, K); idxs (A, m, 5) member indices excluding the candidate;
    scale (A,)."""
    base = strategy.replace("bin", "").replace("exp", "")
    a = torch.arange(pop.shape[0], device=pop.device)[:, None]
    p = lambda i: pop[a, idxs[:, :, i]]  # noqa: E731
    best = pop[:, :1]
    s = scale[:, None, None]
    if base == "best1":
        return best + s * (p(0) - p(1))
    if base == "rand1":
        return p(0) + s * (p(1) - p(2))
    if base == "randtobest1":
        bprime = p(0)
        bprime = bprime + s * (best - bprime)
        return bprime + s * (p(1) - p(2))
    if base == "currenttobest1":
        return pop + s * (best - pop + p(0) - p(1))
    if base == "best2":
        return best + s * (p(0) + p(1) - p(2) - p(3))
    if base == "rand2":
        return p(0) + s * (p(1) + p(2) - p(3) - p(4))
    raise ValueError(f"unknown strategy {strategy}")


def differential_evolution(
    fitness_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    bounds: torch.Tensor,
    n_problems: int,
    *,
    draw: DrawFn | None = None,
    generator: torch.Generator | None = None,
    strategy: str = "best1bin",
    maxiter: int = 1000,
    popsize: int = 15,
    tol: float = 0.01,
    mutation=(0.5, 1.0),
    recombination: float = 0.7,
    init: str = "latinhypercube",
    atol: float = 0.0,
    early_stop_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    | None = None,
) -> DEResult:
    """Minimise ``n_problems`` batched fitness functions over box bounds.

    Args:
        fitness_fn: ``(x (A, m, K) scaled, idx (A,) problem indices) ->
            (A, m)`` energies of the A live problems' populations.
        bounds: (K, 2) (low, high) per parameter, shared by the problems;
            its device is the solver's.
        draw: the randomness (see ``DrawFn``); default ``torch_draws``
            over ``generator``.
        early_stop_fn: optional ``(best (A, K) scaled, idx) -> (A,) bool``,
            checked after each generation.
    """
    if strategy not in _BINOMIAL | _EXPONENTIAL:
        raise ValueError("Please select a valid mutation strategy")
    if init not in ("latinhypercube", "random"):
        raise ValueError("init must be 'latinhypercube' or 'random'")
    with span("de"):
        bounds = torch.as_tensor(bounds, dtype=torch.float32)
        dev = bounds.device
        k = bounds.shape[0]
        m = max(5, popsize * k)
        bsz = n_problems
        probe = early_stop_fn is not None
        count("de.calls")
        count("de.problems", bsz)
        count("de.budget", bsz * ((maxiter + 1) * m + (maxiter if probe
                                                       else 0)))
        mid = 0.5 * (bounds[:, 0] + bounds[:, 1])
        width = torch.abs(bounds[:, 0] - bounds[:, 1])
        if draw is None:
            draw = torch_draws(generator, dev)

        def scale_params(x):
            return mid + (x - 0.5) * width

        def get(step, name, shape, high=None):
            t = torch.as_tensor(draw(step, name, shape, high), device=dev)
            return t.long() if high is not None else t.float()

        dither = mutation if hasattr(mutation, "__len__") and \
            len(mutation) > 1 else None

        with span("de.init"):
            if init == "latinhypercube":
                u = get(0, "lhs_u", (bsz, m, k))
                perm = get(0, "lhs_perm", (bsz, k, m), m)
                samples = (1.0 / m) * u + (torch.arange(
                    m, dtype=torch.float32, device=dev)
                    * (1.0 / m))[None, :, None]
                pop = torch.gather(samples, 1, perm.transpose(1, 2))
            else:
                pop = get(0, "init_u", (bsz, m, k))
            all_idx = torch.arange(bsz, device=dev)
            energies = fitness_fn(scale_params(pop), all_idx).float()
            # Swap the best member into slot 0 (de.py:661-668).
            ib = torch.argmin(energies, dim=1)
            first = pop[:, 0].clone()
            pop[:, 0] = pop[all_idx, ib]
            pop[all_idx, ib] = first
            e_first = energies[:, 0].clone()
            energies[:, 0] = energies[all_idx, ib]
            energies[all_idx, ib] = e_first

            n_drawn = min(5, m - 1)
            cand = torch.arange(m, device=dev)
            nit = torch.zeros(bsz, dtype=torch.int64, device=dev)
            stopped = torch.zeros(bsz, dtype=torch.bool, device=dev)

            def live():
                conv = energies.std(dim=1, unbiased=False) <= \
                    atol + tol * energies.mean(dim=1).abs()
                return (nit < maxiter) & ~stopped & ~conv

            active = live()
            more = bool(active.any())
        evals = bsz * m
        step = 0
        # A generation's span ends in the test that waits for its work, and
        # the next opens at once: the device's idle time between two
        # generations (the test, then ``nonzero``) falls inside a span.
        while more:
            with span("de.generation"):
                idx = torch.nonzero(active).flatten()
                na = idx.numel()
                p = pop[idx]
                e = energies[idx]
                if dither is not None:
                    lo, hi = sorted(dither)
                    scale = get(step, "dither", (bsz,))[idx] * (hi - lo) + lo
                else:
                    scale = torch.full((na,), float(mutation), device=dev)
                r = get(step, "samples", (bsz, m, n_drawn), m - 1)[idx]
                if n_drawn < 5:
                    r = torch.cat([r, r[..., :5 - n_drawn]], dim=-1)
                idxs = torch.where(r >= cand[None, :, None], r + 1, r)
                bprime = _mutate(strategy, p, idxs, scale)
                fill = get(step, "fill", (bsz, m), k)[idx]
                if strategy in _BINOMIAL:
                    cross = get(step, "cross", (bsz, m, k))[idx] < \
                        recombination
                    cross[torch.arange(na, device=dev)[:, None], cand[None],
                          fill] = True
                else:
                    u = get(step, "cross", (bsz, m))[idx]
                    if recombination >= 1.0:
                        length = torch.full((na, m), k, dtype=torch.int64,
                                            device=dev)
                    else:
                        cr = torch.tensor(max(recombination, 1e-12),
                                          dtype=torch.float32, device=dev)
                        length = torch.floor(torch.log(u) / torch.log(cr)).to(
                            torch.int32).long()
                    offs = (torch.arange(k, device=dev)[None, None, :]
                            - fill[..., None]) % k
                    cross = offs < torch.clamp(length, max=k)[..., None]
                trial = torch.where(cross, bprime, p)
                rnd = get(step, "resample", (bsz, m, k))[idx]
                trial = torch.where((trial < 0) | (trial > 1), rnd, trial)
                e_trial = fitness_fn(scale_params(trial), idx).float()
                improved = e_trial < e
                p = torch.where(improved[..., None], trial, p)
                e = torch.where(improved, e_trial, e)
                # Best-slot copy (de.py:712-714).
                ibest = torch.argmin(e, dim=1)
                ar = torch.arange(na, device=dev)
                better = e[ar, ibest] < e[:, 0]
                p[:, 0] = torch.where(better[:, None], p[ar, ibest], p[:, 0])
                e[:, 0] = torch.where(better, e[ar, ibest], e[:, 0])
                pop[idx] = p
                energies[idx] = e
                nit[idx] += 1
                if probe:
                    stopped[idx] |= early_stop_fn(scale_params(p[:, 0]),
                                                  idx).to(torch.bool)
                evals += na * m + (na if probe else 0)
                step += 1
                active = live()
                more = bool(active.any())
        count("de.generations", step)
        count("de.evals", evals)

        nfev = (nit + 1) * m + (nit if probe else 0)
        return DEResult(x=scale_params(pop[:, 0]), fun=energies[:, 0],
                        nit=nit, nfev=nfev, population=scale_params(pop),
                        energies=energies, stopped_early=stopped)
