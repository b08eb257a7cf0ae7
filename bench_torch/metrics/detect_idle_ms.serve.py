"""Device-idle ms per call inside the program's ``alink/detect`` span (the
cascade, from the pyramid to O-Net's tail) in the profiled stretch with
the host traced: the span's wall time less its overlap with device
activity, averaged over its occurrences.  Host recording slows the host,
so this reads above the card-only stretch's idle."""

from bench_torch import program_spans as P


def read(run):
    return P.idle_ms(run, "detect")
