"""Device ms per batch of the kernels launched inside the harness's
``embed`` span (a forward hook pair on the ArcFace embedder) in the
profiled stretch with the host traced."""


def read(run):
    s = run.spans.span_device_s("embed")
    return None if s is None or not run.spans.units else \
        1e3 * s / run.spans.units
