"""The one-pixel DE's fitness rows scored (init, generations and
early-stop probes: what ``nfev`` sums) over the most its ``maxiter``
allows, in %: the program's counters ``de.evals`` over ``de.budget``,
over the whole process (warm-up, window and tail slabs)."""

from bench_torch import program_spans as P


def read(run):
    r = P.ratio("de.evals", "de.budget")
    return None if r is None else 100.0 * r
