"""``ALinkLoop.timings``' phase ``chunk`` over the sum of its phases in
the window (each phase synchronised)."""


def read(run):
    ph = run.window.counters["phases"]
    total = sum(ph.values())
    return None if total <= 0 else 100.0 * ph.get("chunk", 0.0) / total
