"""Device-idle ms per solve inside the program's ``alink/de`` span (one
batched DE a slab: init, generations, early-stop probes) in the profiled
stretch with the host traced: the span's wall time less its overlap with
device activity, averaged over its occurrences."""

from bench_torch import program_spans as P


def read(run):
    return P.idle_ms(run, "de")
