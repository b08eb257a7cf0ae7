"""A-LINK driver, DFW with the VGGFace-ResNet50 teacher (counterpart of
``alink_tpu/drivers/alink.py``; the reference's ALINK.py).

1. featurize the DFW person stacks with the 2048-d teacher backbone
   (kernel K3 on a CUDA device);
2. split the disguised pool into the M2 pretraining half and the loop pool;
3. train-or-load the student M2 and the M1 committee;
4. run the A-LINK loop and save the post-A-LINK head.

The configuration is ``alink_tpu_torch.config.ALinkConfig``, with the
reference's flag names; the default noise bank ends in "adversarial", the
one-pixel DE attack on the live student.  The run is on the CUDA card
unless ``--device cpu`` (or ``run_alink(device="cpu")``) asks for the CPU;
without a card it raises.  Not ported yet: ``max_restarts``.

    python -m alink_tpu_torch.drivers.alink --synthetic_people 8
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import typing

import torch

from alink_tpu_torch import train as T
from alink_tpu_torch.active.committee import MODEL_CHANNELS
from alink_tpu_torch.active.loop import NOT_PORTED, ALinkLoop, ALinkState
from alink_tpu_torch.config import ALinkConfig
from alink_tpu_torch.drivers import common
from alink_tpu_torch.ops.pairwise import pair_scores


def add_config_flags(parser: argparse.ArgumentParser, config_cls) -> None:
    """argparse flags from the config dataclass (the reference's names)."""
    hints = typing.get_type_hints(config_cls)
    for field in dataclasses.fields(config_cls):
        default = field.default
        if isinstance(default, bool):
            parser.add_argument(f"--{field.name}", type=lambda s: s.lower()
                                in ("1", "true", "yes"), default=default)
        elif {int, str} <= set(typing.get_args(hints.get(field.name))):
            parser.add_argument(
                f"--{field.name}",
                type=lambda s: int(s) if s.lstrip("-").isdigit() else s,
                default=default)
        elif isinstance(default, (int, float, str)):
            parser.add_argument(f"--{field.name}", type=type(default),
                                default=default)
        elif field.name == "noise":
            parser.add_argument("--noise", type=str,
                                default=",".join(default))


def parse_config(argv=None, config_cls=ALinkConfig, **overrides):
    parser = argparse.ArgumentParser(description=__doc__)
    add_config_flags(parser, config_cls)
    args = vars(parser.parse_args(argv))
    if isinstance(args.get("noise"), str):
        args["noise"] = tuple(args["noise"].split(","))
    known = {f.name for f in dataclasses.fields(config_cls)}
    args = {k: v for k, v in args.items() if k in known}
    args.update(overrides)
    return config_cls(**args)


def make_adversarial_predict(featurize):
    """The student end to end (PredictionWrappedModel, noise.py:153-168):
    raw pair halves -> teacher features -> M2 probabilities ``(N, 2)``,
    with the M2 module as the parameter; differentiable in the pixels when
    grad is enabled."""

    def predict(m2, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        p = pair_scores(m2, featurize(left), featurize(right))
        return torch.stack([1.0 - p, p], dim=-1)

    return predict


def run_alink(config: ALinkConfig, *, featurize=None,
              n_steps: int | None = None, device="cuda",
              generator: torch.Generator | None = None) -> ALinkState:
    """The whole ALINK.py flow on ``device``; returns the final loop state.

    ``featurize`` replaces the VGGFace-ResNet50 teacher (random weights from
    ``config.seed`` otherwise).  ``n_steps`` (samples per pretraining
    epoch) defaults to ``config.train_steps``.  Initialisations and
    shuffles draw from ``generator`` (CPU), the loop's noise and attacks
    from a generator on ``device``; neither can match ``jax.random``.
    """
    if config.max_restarts > 0:
        raise NotImplementedError(NOT_PORTED.format("max_restarts"))
    device = common.resolve_device(device, "run_alink")
    if n_steps is None:
        n_steps = config.train_steps
    g = generator if generator is not None else \
        torch.Generator().manual_seed(config.seed)

    if config.synthetic_people:
        from alink_tpu_torch.data import make_synthetic_dfw

        root = tempfile.mkdtemp(prefix="alink_synth_")
        make_synthetic_dfw(root, num_people=config.synthetic_people,
                           image_size=config.image_res[0],
                           train_folder=config.train_images_dir,
                           seed=config.seed)
        config = dataclasses.replace(config, data_dir_prefix=root)
        print(f"synthetic DFW tree: {root} "
              f"({config.synthetic_people} people)")

    if featurize is None:
        featurize, _ = common.make_resnet50_featurizer(g, device=device)

    data = common.load_dfw(config, featurize, device)
    dig_pre, dig_post_raw = common.split_pools(config, data)

    m2 = common.new_head_state(g, config.feature_res, 0.1, device)
    m2_gen = common.replay_generator(config.seed, dig_pre, data.imp_feats,
                                     config.batch_size)
    m2 = common.train_or_load_head(
        m2, config.disguised_basemodel, m2_gen, epochs=config.dig_epochs,
        batch_size=config.batch_size, generator=g,
        refine=config.train_disguised_model, n_steps=n_steps)

    plain_gen = common.replay_generator(config.seed + 1, data.plain_feats,
                                        data.imp_feats, config.batch_size)
    committee, _ = common.train_or_load_committee(
        g, config.feature_res, config.noise, config.num_ensemble_models,
        config.ensemble_basepath, plain_gen, epochs=config.undig_epochs,
        batch_size=config.batch_size, refine=config.refine_models,
        n_steps=n_steps, device=device)

    # Both model channels need the end-to-end predict function.
    adv = (make_adversarial_predict(featurize)
           if set(MODEL_CHANNELS) & set(config.noise) else None)
    replay = common.replay_generator(config.seed + 2, data.plain_feats,
                                     data.imp_feats, config.batch_size)
    loop = ALinkLoop(config, pool_uint8=True, featurize=featurize,
                     committee=committee, m2_state=m2, replay_gen=replay,
                     host_generator=g, adversarial_predict=adv,
                     device=device)
    if config.loop_checkpoint:
        raise NotImplementedError(NOT_PORTED.format("loop_checkpoint"))
    state = loop.run(data.plain_raw, dig_post_raw)
    print(f">> Active Count: {state.active_count} out of {state.un_size}")
    T.save(config.out_model, state.m2_state.module.state_dict())
    return state


def main(argv=None) -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    known, rest = pre.parse_known_args(argv)
    run_alink(parse_config(rest), device=known.device)


if __name__ == "__main__":
    main()
