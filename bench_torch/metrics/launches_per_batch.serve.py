"""CUDA kernel launches per batch of ``FaceModel.pipeline`` in the
profiled stretch (copies and fills left out)."""


def read(run):
    n = run.trace.launches()
    return None if not n or not run.units else n / run.units
