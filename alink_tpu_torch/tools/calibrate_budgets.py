"""Size ``CascadeConfig`` budgets from a sample of the workload
(counterpart of ``alink_tpu/tools/calibrate_budgets.py``).

The fixed-budget cascade gives the reference's results whenever each
stage's budget covers its candidates, and a stage's cost grows with its
budget.  This tool profiles images (``detect.cascade.profile_cascade``
under ``worst_case`` budgets) and prints the counts' quantile, their
maxima, a recommended config at that quantile with headroom, and warnings
where the profiling budgets themselves saturated::

    python -m alink_tpu_torch.tools.calibrate_budgets /path/to/images \
        [--sample 256] [--quantile 0.99] [--headroom 2.0] \
        [--min_size 40] [--image_res 160] [--params DIR] [--device cuda]

With no directory it profiles 8 noise images drawn from a numpy seed
(smoke mode).  ``--params DIR`` holds the towers as ``train.checkpoint``
trees of their state dicts, ``DIR/pnet``, ``DIR/rnet``, ``DIR/onet`` and
optionally ``DIR/lnet``; without it the towers are random.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from alink_tpu_torch.detect import CascadeConfig, MTCNNParams
from alink_tpu_torch.detect.cascade import (init_cascade_params,
                                            profile_cascade)
from alink_tpu_torch.drivers.common import resolve_device
from alink_tpu_torch.models import LNet, ONet, PNet, RNet


def recommend(profile: dict, budgets: CascadeConfig, quantile: float,
              headroom: float) -> tuple[dict, list]:
    """The counts' quantile times ``headroom`` -> budgets, monotone along
    the cascade, with a warning for each profiling budget the counts
    reached."""
    warnings = []

    def q(x):
        return float(np.quantile(np.asarray(x, np.float64), quantile))

    def size(x, cap_hit_at, name):
        need = max(1, int(np.ceil(q(x) * headroom)))
        if float(np.max(np.asarray(x))) >= cap_hit_at:
            warnings.append(
                f"{name}: profiling budget {cap_hit_at} saturated — raise "
                "the profiling cfg's budgets and re-run for a trustworthy "
                "number")
        return need

    rec = {
        "stage1_scale_budget": size(profile["scale_raw_max"], 10**9,
                                    "scale_raw_max"),
        "stage1_budget": size(profile["stage1"], budgets.stage1_budget,
                              "stage1"),
        "stage2_budget": size(profile["stage2"], budgets.stage2_budget,
                              "stage2"),
        "stage3_budget": size(profile["stage3"], budgets.stage3_budget,
                              "stage3"),
    }
    rec["stage2_budget"] = min(rec["stage2_budget"], rec["stage1_budget"])
    rec["stage3_budget"] = min(rec["stage3_budget"], rec["stage2_budget"])
    return rec, warnings


def load_towers(path: str, device) -> MTCNNParams:
    """Towers from ``path/{pnet,rnet,onet[,lnet]}`` (f32 parameters, the
    towers' default bf16 compute)."""
    from alink_tpu_torch.train.checkpoint import restore

    def tower(cls, name):
        net = cls(device=device)
        net.load_state_dict(restore(os.path.join(path, name)), strict=True)
        return net.eval()

    lnet = (tower(LNet, "lnet") if os.path.isdir(os.path.join(path, "lnet"))
            else None)
    return MTCNNParams(tower(PNet, "pnet"), tower(RNet, "rnet"),
                       tower(ONet, "onet"), lnet)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("images", nargs="?", default=None,
                    help="directory of JPEG/PNG images (recursed)")
    ap.add_argument("--sample", type=int, default=256)
    ap.add_argument("--quantile", type=float, default=0.99)
    ap.add_argument("--headroom", type=float, default=2.0)
    ap.add_argument("--min_size", type=int, default=40)
    ap.add_argument("--image_res", type=int, default=160)
    ap.add_argument("--thresholds", type=float, nargs=3,
                    default=(0.6, 0.7, 0.8))
    ap.add_argument("--params", default=None,
                    help="directory of the towers' checkpoints "
                         "(default: random — synthetic smoke only)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "calibrate_budgets")

    res = args.image_res
    if args.images:
        from alink_tpu_torch.data.loader import load_image_list

        paths = []
        for root, _, files in os.walk(args.images):
            paths.extend(os.path.join(root, f) for f in files
                         if f.lower().endswith((".jpg", ".jpeg", ".png")))
        paths = sorted(paths)[: args.sample]
        if not paths:
            raise FileNotFoundError(f"no images under {args.images}")
        imgs = load_image_list(paths, (res, res))
    else:
        imgs = np.random.default_rng(0).uniform(
            0.0, 255.0, (min(args.sample, 8), res, res, 3)).astype(np.float32)
    imgs = torch.as_tensor(imgs, device=device)

    params = (load_towers(args.params, device) if args.params else
              init_cascade_params(torch.Generator().manual_seed(1),
                                  device=device))

    # Generous (worst-case) budgets so that truncation is rare; recommend()
    # flags the budgets the counts still reached.
    prof_cfg = CascadeConfig.worst_case(
        min_size=args.min_size, thresholds=tuple(args.thresholds))
    profile = {k: v.cpu().numpy()
               for k, v in profile_cascade(params, imgs, prof_cfg).items()}
    rec, warnings = recommend(profile, prof_cfg, args.quantile,
                              args.headroom)

    report = {
        "sampled_images": int(imgs.shape[0]),
        "quantiles": {k: float(np.quantile(np.asarray(v, np.float64),
                                           args.quantile))
                      for k, v in profile.items()},
        "max": {k: int(np.max(v)) for k, v in profile.items()},
        "recommended": rec,
        "warnings": warnings,
    }
    print(json.dumps(report, indent=2))
    print("\nRecommended config:\n"
          f"CascadeConfig(min_size={args.min_size}, "
          f"thresholds={tuple(args.thresholds)},\n"
          f"              stage1_scale_budget={rec['stage1_scale_budget']}, "
          f"stage1_budget={rec['stage1_budget']},\n"
          f"              stage2_budget={rec['stage2_budget']}, "
          f"stage3_budget={rec['stage3_budget']})")


if __name__ == "__main__":
    main()
