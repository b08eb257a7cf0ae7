"""Classical active-learning baseline on Multi-PIE (counterpart of
``alink_tpu/drivers/existing_al_mtp.py``; the reference's
existing_AL_MTP.py, which does not run as shipped: it imports a
``readMTP3`` module and uses a ``conversionModel`` that do not exist).

What that baseline was meant to do: pool-based uncertainty sampling over
low-resolution Multi-PIE pairs with a SmallRes student (dropout on in
every fit).  One SmallRes-scaled pair stream feeds both the pretraining
and the query rounds, and every round runs (no budget break), as in the
JAX driver.  The run is on the CUDA card unless ``--device cpu`` asks for
the CPU.

    python -m alink_tpu_torch.drivers.existing_al_mtp \\
        --data_dir_prefix MultiPieSplits/split1/train
"""

from __future__ import annotations

import argparse

import torch

from alink_tpu_torch import train as T
from alink_tpu_torch.active.learners import ActiveLearner
from alink_tpu_torch.active.uncertainty import get_strategy
from alink_tpu_torch.config import MTPConfig
from alink_tpu_torch.data import (balanced_pair_batches, load_person_stacks,
                                  scan_mtp)
from alink_tpu_torch.drivers import common
from alink_tpu_torch.drivers.alink import parse_config
from alink_tpu_torch.drivers.alink_mtp import (make_smallres_state,
                                               smallres_pairs)


def run_existing_al_mtp(config: MTPConfig, *,
                        query_strategy: str = "uncertainty_sampling",
                        n_rounds: int = 50, n_steps: int = 320000,
                        device="cuda",
                        generator: torch.Generator | None = None
                        ) -> ActiveLearner:
    """The baseline's flow on ``device``; returns the learner.
    Initialisation and shuffles draw from ``generator`` (CPU), dropout
    masks from a generator on ``device``."""
    device = common.resolve_device(device, "run_existing_al_mtp")
    g = generator if generator is not None else \
        torch.Generator().manual_seed(config.seed)
    lo = load_person_stacks(list(scan_mtp(config.data_dir_prefix).values()),
                            (config.low_res, config.low_res),
                            dct_scale=config.ingest_dct_scale)
    state = make_smallres_state(g, config, device)
    dropout = torch.Generator(device).manual_seed(config.seed)
    gen = smallres_pairs(balanced_pair_batches(config.seed, lo, None,
                                               config.batch_size))
    params, ok = T.maybe_restore(config.lowres_basemodel,
                                 state.module.state_dict())
    if ok:
        state.module.load_state_dict(params)
    else:
        state, _ = T.custom_train(
            state, gen, epochs=config.lowres_epochs,
            batch_size=config.batch_size, generator=g, n_steps=n_steps,
            dropout_generator=dropout)
        T.save(config.lowres_basemodel, state.module.state_dict())

    learner = ActiveLearner(state, get_strategy(query_strategy), generator=g,
                            dropout_generator=dropout,
                            epochs=config.ft_epochs,
                            batch_size=min(64, config.batch_size))
    for _ in range(n_rounds):
        (left, right), y = next(gen)
        idx = torch.as_tensor(learner.query(
            left, right, n_instances=max(1, len(y) // 10)))
        learner.teach(left[idx], right[idx], y[idx.numpy()], only_new=True)
    T.save(config.out_model, learner.state.module.state_dict())
    return learner


def main(argv=None) -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    known, rest = pre.parse_known_args(argv)
    run_existing_al_mtp(parse_config(rest, config_cls=MTPConfig),
                        device=known.device)


if __name__ == "__main__":
    main()
