"""Fixed-point NMS sweeps per ``FaceModel.pipeline`` call, each ending in
a host sync: the program's counters ``nms.sweeps`` over
``pipeline.calls``, over the whole process (set-up, window and tails run
the cell's own batches)."""

from bench_torch import program_spans as P


def read(run):
    return P.ratio("nms.sweeps", "pipeline.calls")
