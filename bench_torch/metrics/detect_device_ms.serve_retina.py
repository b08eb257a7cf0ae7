"""Device ms per call of the kernels launched inside the program's
``alink/detect`` span (``RetinaFaceDetector``: the model, decode, top-k,
NMS and keep-top-k; K3 and the NMS kernel are ops, so their launches
count) in the profiled stretch with the host traced."""

from bench_torch import program_device as D


def read(run):
    return D.ms_per_unit(run, "detect")
