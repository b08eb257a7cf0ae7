"""Device-idle ms per call inside the program's ``alink/retina.post`` span
(decode, softmax, threshold, top-k, the NMS kernel, keep-top-k) in the
profiled stretch with the host traced: the span's wall time less its
overlap with device activity, averaged over its occurrences."""

from bench_torch import program_spans as P


def read(run):
    return P.idle_ms(run, "retina.post")
