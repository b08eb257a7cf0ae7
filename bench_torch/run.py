"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for.  Set-up (weights and inputs made on the card from the seed,
every shape warmed) is timed from process start; then the traffic runs
for ``--seconds``.  ``--trace 1`` runs the same window, then a fixed
stretch more of the same traffic under ``torch.profiler``, and reports
the cell's per-layer metrics instead of its end-to-end ones.  Last, with
the program's state freed, the check compares what the window produced
with the plain references and prints each number beside its limit, on
standard error and under ``checks`` at the end of the result line.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench_torch"
# Run as a script, the interpreter puts this directory first on the path,
# where its modules would shadow the standard library's: the checkout's
# root takes its place.
if sys.path and Path(sys.path[0] or ".").resolve() == BENCH:
    sys.path[0] = str(ROOT)


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def load_cell(name: str) -> dict:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / config["file"]).read_text())
    traffic = load_traffic(cell["traffic"])

    def applies(m) -> bool:
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if applies(m)
             and m["moves"] in moved]
    return {"cell": cell, "config": cfg, "traffic": traffic, "e2e": e2e,
            "per_layer": layer}


def load_traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_torch.metrics._{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Run:
    """What a per-layer reader sees."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(c: dict, seed: int, seconds: float, trace: bool,
             device) -> dict:
    """Set-up, window, optional profiled tail, check; the result line."""
    import torch

    from bench_torch.tracing import profiled, sync
    from bench_torch.reference.numerics import Numerics, exact_f32

    kind = importlib.import_module(
        f"bench_torch.systems.{c['config']['system']}")
    drivers = importlib.import_module(
        f"bench_torch.drivers.{c['traffic']['driver']}")
    system = kind.System(c["config"], seed, device)
    driver = drivers.Driver(system, c["traffic"], seed, device)
    driver.setup()
    sync(device)
    setup_s = time.perf_counter() - PROCESS_START
    win = driver.window(seconds)
    print(f"window {json.dumps(win.metrics)} attempted {win.attempted} "
          f"failed {win.failed} counters "
          f"{json.dumps(win.counters, default=str)}", file=sys.stderr)
    result: dict = {"correct": False, "attempted": win.attempted,
                    "failed": win.failed}
    trace_data = spans = units = None
    if trace:
        units, trace_data = profiled(driver.tail, device, host=False)
        span_units, spans = profiled(driver.tail, device)
        spans.units = span_units
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = Run(window=win, trace=trace_data, spans=spans, units=units,
              system=system, driver=driver, config=c["config"],
              traffic=c["traffic"])
    metrics = {}
    if trace:
        for m in c["per_layer"]:
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in c["e2e"]:
            v = setup_s if m["name"] == "setup_s" else win.metrics[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu",
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak),
                   "power_limit": power_limit()}
    if trace:
        device_info.update(busy_s=trace_data.busy_s,
                           window_s=trace_data.window_s)
        result["breakdown"] = {"device_ops": trace_data.top_ops(10),
                               "idle_gaps": spans.idle_gaps(10)}
    driver.release()
    del run, trace_data, spans
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with exact_f32():
        numbers = driver.check(Numerics("f32"))
    limits = c["config"]["limits"]
    checks = {k: {"value": float(v), "limit": limits[k]}
              for k, v in numbers.items() if k in limits}
    ok = all(x["value"] <= x["limit"] for x in checks.values())
    other = {k: v for k, v in numbers.items() if k not in limits}
    print(f"check_s {time.perf_counter() - t0:.3f} counted {other}",
          file=sys.stderr)
    for k, x in checks.items():
        print(f"check {k} {x['value']!r} limit {x['limit']!r} "
              f"{'ok' if x['value'] <= x['limit'] else 'FAIL'}",
              file=sys.stderr)
    result.update(correct=bool(ok and win.failed == 0), metrics=metrics,
                  device=device_info, checks=checks)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    c = load_cell(args.workload)
    import torch

    chips = c["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import alink_tpu_torch  # noqa: F401  (no program, no result)

    torch.set_num_threads(2)
    device = torch.device("cuda:0")
    result = run_cell(c, args.seed, args.seconds, bool(args.trace), device)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
