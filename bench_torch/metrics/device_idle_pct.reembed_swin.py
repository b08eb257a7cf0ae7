"""Share of the profiled stretch in which no operation ran on the
device."""


def read(run):
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
