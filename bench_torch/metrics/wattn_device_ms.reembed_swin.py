"""Device ms per call of the kernels launched inside the program's
``alink/swin.attn`` spans (the windowed attention core alone, one a
block) in the profiled stretch with the host traced."""

from bench_torch import program_device as D


def read(run):
    return D.ms_per_unit(run, "swin.attn")
