"""Device ms per batch of the kernels launched inside the harness's
``cascade`` span (first P-Net call to O-Net's return) in the profiled
stretch with the host traced."""


def read(run):
    s = run.spans.span_device_s("cascade")
    return None if s is None or not run.spans.units else \
        1e3 * s / run.spans.units
