"""Classical active-learning baseline on DFW (counterpart of
``alink_tpu/drivers/existing_al.py``; the reference's existing_al.py).

The paper's comparison baseline: one siamese verifier trained by pool-based
uncertainty, margin or entropy sampling (modAL's ``ActiveLearner``) over
combined normal + disguised DFW pairs (``scan_dfw(combine_normal_imp=
True)``, existing_al.py:62-70), on VGGFace-ResNet50 features (kernel K3 on
a CUDA device).  Pretrain-if-missing, then per round: draw a balanced pool
batch, query the most informative tenth, teach on it with its oracle
labels; stop when the budget ``active_ratio * n_rounds * batch_size / 10``
is spent.  The run is on the CUDA card unless ``--device cpu`` asks for
the CPU.

    python -m alink_tpu_torch.drivers.existing_al --data_dir_prefix DFW_Data/
"""

from __future__ import annotations

import argparse

import torch

from alink_tpu_torch import train as T
from alink_tpu_torch.active.learners import ActiveLearner
from alink_tpu_torch.active.uncertainty import get_strategy
from alink_tpu_torch.config import ExistingALConfig
from alink_tpu_torch.data import (balanced_pair_batches, load_person_stacks,
                                  scan_dfw)
from alink_tpu_torch.drivers import common
from alink_tpu_torch.drivers.alink import parse_config


def run_existing_al(config: ExistingALConfig, *, featurize=None,
                    n_rounds: int = 50, n_steps: int = 320000,
                    device="cuda", generator: torch.Generator | None = None
                    ) -> ActiveLearner:
    """existing_al.py's flow on ``device``; returns the learner.
    ``featurize`` replaces the VGGFace-ResNet50 teacher (random weights from
    ``generator`` otherwise), which also draws the initialisation and the
    shuffles (CPU)."""
    device = common.resolve_device(device, "run_existing_al")
    g = generator if generator is not None else \
        torch.Generator().manual_seed(config.seed)
    if featurize is None:
        featurize, _ = common.make_resnet50_featurizer(g, device=device)

    people = scan_dfw(config.data_dir_prefix, config.train_images_dir,
                      combine_normal_imp=True)
    res = tuple(config.image_res)
    dct = config.ingest_dct_scale
    plain, imp = (common.featurize_stacks(
        load_person_stacks([getattr(p, kind) for p in people], res,
                           dct_scale=dct),
        featurize, device) for kind in ("plain", "impostor"))

    # Pretrain-if-missing (existing_al.py:75-83).
    gen = balanced_pair_batches(config.seed, plain, imp, config.batch_size)
    state = common.train_or_load_head(
        common.new_head_state(g, config.feature_res, 0.1, device),
        config.model_path, gen, epochs=config.epochs,
        batch_size=config.batch_size, generator=g, n_steps=n_steps)

    learner = ActiveLearner(state, get_strategy(config.query_strategy),
                            generator=g, epochs=config.epochs,
                            batch_size=min(64, config.batch_size))
    # Query / teach (existing_al.py:104-118).
    queried_total = 0
    budget = int(config.active_ratio * n_rounds * config.batch_size * 0.1)
    for _ in range(n_rounds):
        (left, right), y = next(gen)
        n_pick = max(1, len(y) // 10)
        idx = learner.query(left, right, n_instances=n_pick)
        learner.teach(left[idx], right[idx], y[idx], only_new=True)
        queried_total += n_pick
        if queried_total >= budget:
            break
    T.save(config.out_model, learner.state.module.state_dict())
    return learner


def main(argv=None) -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    known, rest = pre.parse_known_args(argv)
    run_existing_al(parse_config(rest, config_cls=ExistingALConfig),
                    device=known.device)


if __name__ == "__main__":
    main()
