"""A-LINK driver, Multi-PIE cross-resolution variant (counterpart of
``alink_tpu/drivers/alink_mtp.py``; the reference's ALINK_MTP.py).

The domain gap is resolution: the teacher committee scores 2048-d
VGGFace-ResNet50 features of 224x224 faces (kernel K3 on a CUDA device),
the student M2 is the raw-pixel ``SmallRes`` twin tower at ``low_res``
(default 48).  The flow:

1. scan the Multi-PIE directory (the four frontal captures per subject);
2. load the subject stacks at ``image_res`` and at ``low_res``;
3. train-or-load SmallRes (dropout on) on the first ``split_ratio`` of
   each subject's low-resolution images;
4. train-or-load the committee on the teacher's features;
5. run the A-LINK loop over the rest at 224^2: one-group all-pairs slabs
   (``mtp_all_pairs_index``), the adversarial-only default bank, the noisy
   pairs resized to ``low_res`` for the student;
6. finetune M2 inside the loop; 7. save it;
8. gallery top-1 identification over ``test_dir`` (ALINK_MTP.py:271-289):
   probes and gallery embedded once by the tower, the grid scored by the
   head through ``ops.pairwise.score_matrix`` (kernel K1 on CUDA).

The run is on the CUDA card unless ``--device cpu`` (or
``run_alink_mtp(device="cpu")``) asks for the CPU; without a card it
raises.

    python -m alink_tpu_torch.drivers.alink_mtp \\
        --data_dir_prefix MultiPieSplits/split1/train \\
        --test_dir MultiPieSplits/split1/test
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from alink_tpu_torch import train as T
from alink_tpu_torch.active.committee import MODEL_CHANNELS
from alink_tpu_torch.active.loop import ALinkLoop, ALinkState
from alink_tpu_torch.config import MTPConfig
from alink_tpu_torch.data import (balanced_pair_batches, load_person_stacks,
                                  mtp_all_pairs_index, scan_mtp,
                                  split_disguise_data)
from alink_tpu_torch.drivers import common
from alink_tpu_torch.drivers.alink import parse_config
from alink_tpu_torch.evaluation.identification import gallery_top1
from alink_tpu_torch.models import SmallRes, preprocess
from alink_tpu_torch.ops.image import resize
from alink_tpu_torch.ops.pairwise import score_matrix


def make_smallres_state(generator: torch.Generator | None, config: MTPConfig,
                        device=None) -> T.TrainState:
    """The low-resolution student, SmallRes at ``low_res`` (ALINK_MTP.py:
    107), with Adadelta at lr 0.1."""
    s = config.low_res
    model = SmallRes(feature_dim=config.feature_res, input_size=(s, s),
                     generator=generator, device=device)
    return T.TrainState(model, learning_rate=0.1)


def smallres_pairs(gen):
    """A pair stream's pixels scaled for SmallRes (CPU tensors)."""
    for (left, right), y in gen:
        yield ((preprocess.smallres(torch.as_tensor(left)),
                preprocess.smallres(torch.as_tensor(right))), y)


@torch.no_grad()
def embed(module: SmallRes, images, device, batch: int = 1024
          ) -> torch.Tensor:
    """Tower embeddings of raw pixels, ``batch`` images at a time."""
    x = torch.as_tensor(np.asarray(images), device=device)
    return torch.cat([module.embed(preprocess.smallres(x[i:i + batch]))
                      for i in range(0, x.shape[0], batch)])


def smallres_score_fn(state: T.TrainState, low_res: int | None = None,
                      probe_chunk: int = 32, *, batch: int = 1024):
    """``(probes, gallery) -> (N, G)`` P(genuine) for the top-1 tail.

    The tower is per image and deterministic in eval, so probes and gallery
    are embedded once and the grid is the head's all-pairs scorer over the
    embeddings (kernel K1 on CUDA): the same function as the JAX driver's,
    which runs the whole model on every repeated (probe, gallery) pair.
    ``low_res`` and ``probe_chunk`` take the JAX driver's positions and are
    ignored: the images arrive at the student's resolution, and no pair
    grid of images is built to chunk.  ``batch`` images are embedded at a
    time."""
    del low_res, probe_chunk

    def score(probes, gallery) -> torch.Tensor:
        m = state.module
        dev = state.device
        return score_matrix(m.verify_head, embed(m, probes, dev, batch),
                            embed(m, gallery, dev, batch))

    return score


def make_adversarial_predict(low_res: int):
    """SmallRes end to end on raw pairs: resized to ``low_res`` and scaled,
    ``(m2 module, left, right) -> (N, 2)`` probabilities."""
    size = (low_res, low_res)

    def predict(m2, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        ll = preprocess.smallres(resize(left, size))
        rr = preprocess.smallres(resize(right, size))
        return torch.softmax(m2.logits(ll, rr), dim=-1)

    return predict


def run_alink_mtp(config: MTPConfig, *, featurize=None,
                  n_steps: int | None = None, device="cuda",
                  generator: torch.Generator | None = None
                  ) -> tuple[ALinkState, float | None]:
    """The whole ALINK_MTP.py flow on ``device``; returns the loop state and
    the top-1 accuracy (None without test subjects).

    ``featurize`` replaces the VGGFace-ResNet50 teacher (random weights
    from ``config.seed`` otherwise); ``n_steps`` (samples per pretraining
    epoch) defaults to ``config.train_steps``.  Initialisations and
    shuffles draw from ``generator`` (CPU); SmallRes's pretraining dropout,
    the loop's noise, attacks and finetune dropout from generators on
    ``device``."""
    device = common.resolve_device(device, "run_alink_mtp")
    if n_steps is None:
        n_steps = config.train_steps
    g = generator if generator is not None else \
        torch.Generator().manual_seed(config.seed)
    if featurize is None:
        featurize, _ = common.make_resnet50_featurizer(g, device=device)
    lo_res = (config.low_res, config.low_res)

    # The subject pool (readMTP.readAllImages) at both resolutions.
    groups = list(scan_mtp(config.data_dir_prefix).values())
    hi = load_person_stacks(groups, tuple(config.image_res))
    lo = load_person_stacks(groups, lo_res)
    lo_pre, _ = split_disguise_data(lo, config.split_ratio)
    _, hi_post = split_disguise_data(hi, config.split_ratio)

    m2 = make_smallres_state(g, config, device)
    params, ok = T.maybe_restore(config.lowres_basemodel,
                                 m2.module.state_dict())
    if ok:
        m2.module.load_state_dict(params)
    else:
        m2, _ = T.custom_train(
            m2, smallres_pairs(balanced_pair_batches(
                config.seed, lo_pre, None, config.batch_size)),
            epochs=config.lowres_epochs, batch_size=config.batch_size,
            generator=g, n_steps=n_steps,
            dropout_generator=torch.Generator(device).manual_seed(
                config.seed + 3))
        T.save(config.lowres_basemodel, m2.module.state_dict())

    hi_feats = common.featurize_stacks(hi, featurize, device)
    committee, _ = common.train_or_load_committee(
        g, config.feature_res, config.noise, config.num_ensemble_models,
        config.ensemble_basepath,
        common.replay_generator(config.seed + 1, hi_feats, None,
                                config.batch_size),
        epochs=config.highres_epochs, batch_size=config.batch_size,
        refine=config.refine_models, n_steps=n_steps, device=device)

    loop = ALinkLoop(
        config, pool_uint8=True, featurize=featurize, committee=committee,
        m2_state=m2, student_featurize=preprocess.smallres,
        student_is_head=False, student_res=lo_res,
        pair_builder=lambda plain, _dig: mtp_all_pairs_index(plain),
        replay_gen=smallres_pairs(balanced_pair_batches(
            config.seed + 2, lo, None, config.batch_size)),
        adversarial_predict=(make_adversarial_predict(config.low_res)
                             if set(MODEL_CHANNELS) & set(config.noise)
                             else None),
        generator=torch.Generator(device).manual_seed(config.seed),
        host_generator=g, device=device)
    state = loop.run(hi_post, hi_post,
                     checkpoint_path=config.loop_checkpoint or None,
                     checkpoint_every=config.checkpoint_every)
    print(f">> Active Count: {state.active_count} out of {state.un_size}")
    T.save(config.out_model, state.m2_state.module.state_dict())

    # The gallery top-1 identification tail (ALINK_MTP.py:271-289).
    try:
        test_groups = list(scan_mtp(config.test_dir).values())
    except FileNotFoundError:
        test_groups = []
    top1 = None
    if test_groups:
        top1 = gallery_top1(smallres_score_fn(state.m2_state),
                            load_person_stacks(test_groups, lo_res))
        print(f">> Top-1 identification accuracy: {top1:.4f}")
    return state, top1


def main(argv=None) -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    known, rest = pre.parse_known_args(argv)
    run_alink_mtp(parse_config(rest, config_cls=MTPConfig),
                  device=known.device)


if __name__ == "__main__":
    main()
