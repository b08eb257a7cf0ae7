"""The readings that a cell's limits are set from, at the cell's own size.

    python3 bench_torch/control.py --workload <name> --seconds 8 \
        --seeds 11 12 13 ...

For each seed, in one process: set-up, a short window of the cell's own
traffic, then the check twice: the program against the reference (a
sound run's reading, the lower end of each limit) and the control (the
reference computed in float8 put in the program's place, the upper end).
One JSON line a seed, then per number the largest sound reading and the
smallest control reading.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(c: dict, seed: int, seconds: float, device) -> dict:
    import torch

    from bench_torch.reference.numerics import Numerics, exact_f32

    kind = importlib.import_module(
        f"bench_torch.systems.{c['config']['system']}")
    drivers = importlib.import_module(
        f"bench_torch.drivers.{c['traffic']['driver']}")
    driver = drivers.Driver(kind.System(c["config"], seed, device),
                            c["traffic"], seed, device)
    driver.setup()
    win = driver.window(seconds)
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with exact_f32():
        sound = driver.check(Numerics("f32"))
        control = driver.check(Numerics("f32"), substitute=Numerics("fp8"))
    return {"seed": seed, "attempted": win.attempted, "failed": win.failed,
            "counters": win.counters, "sound": sound, "control": control}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench_torch import run

    run._cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("control needs a CUDA card", file=sys.stderr)
        return 2
    c = run.load_cell(args.workload)
    limits = c["config"]["limits"]
    rows = []
    for seed in args.seeds:
        r = readings(c, seed, args.seconds, torch.device("cuda:0"))
        rows.append(r)
        print(json.dumps(r, default=str), flush=True)
    summary = {}
    for k in limits:
        s = [r["sound"][k] for r in rows if k in r["sound"]]
        u = [r["control"][k] for r in rows if k in r["control"]]
        summary[k] = {"lower": max(s) if s else None,
                      "upper": min(u) if u else None,
                      "limit": limits[k], "sound": s, "control": u}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
