"""CUDA kernel launches per call of ``FaceModel.pipeline`` with the
RetinaFace detector in the profiled stretch (copies and fills left
out)."""


def read(run):
    n = run.trace.launches()
    return None if not n or not run.units else n / run.units
