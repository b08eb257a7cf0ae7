"""Device ms per call of the kernels launched inside the program's
``alink/embed`` span (``FaceModel.get_feature`` around the Swin embedder)
in the profiled stretch with the host traced."""

from bench_torch import program_device as D


def read(run):
    return D.ms_per_unit(run, "embed")
