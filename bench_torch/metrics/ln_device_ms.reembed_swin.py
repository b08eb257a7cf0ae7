"""Device ms per call of the kernels launched inside the program's
``alink/ln`` spans (every LayerNorm of the forward, 53 a Swin-S call) in
the profiled stretch with the host traced.  None where the program opens
no such span."""

from bench_torch import program_device as D


def read(run):
    return D.ms_per_unit(run, "ln")
