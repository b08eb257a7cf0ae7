"""End-to-end accuracy regression through the DFW evaluation chain
(counterpart of ``alink_tpu/tools/eval_regression.py``).

Stage a synthetic DFW (training tree + the testing protocol with its
positional code-1..4 mask), train the system, and push a held-out test set
through the tool chain: featurize via ``tools.generate_predictions``,
score the all-pairs matrix via ``tools.generate_matrix.
restore_head_and_score`` (with the checkpoint round trip of
``generateMatrixDFW``: ``train.save`` trees here, orbax in the JAX
package), sweep masked ROCs with ``evaluation``'s split and sweep, and
reduce to AUC/EER/GAR via ``evaluation.roc_stats``, at four stages:

- ``pre``         — M2 after pretraining, before active learning (the
                    paper's "M2 before" row, create_figure_3.m),
- ``alink``       — after the A-LINK loop with the classical noise bank,
- ``a2link``      — after the loop with the bank + the one-pixel DE
                    adversarial channel (A2-LINK),
- ``existing_al`` — the classical uncertainty-sampling learner from the
                    same M2, at the ``alink`` arm's oracle budget.

Returns (and with ``out_json`` writes) an artifact with the per-stage,
per-case statistics and the 15 ordering flags of the paper's figure-3 /
figure-4 claims.  Each arm starts from its own copy of the pretrained M2
(the port trains states in place; the JAX package's are immutable).
Initialisations, shuffles and the linear projection draw from a CPU
``torch.Generator`` seeded with ``seed``, the loops' noise from one on the
device: the draws cannot match ``jax.random``'s, so the metrics are
compared with ``EVAL_r05.json``'s, not bit-equal.

    python -m alink_tpu_torch.tools.eval_regression [--out EVAL_torch.json]
        [--device cpu]

The defaults reproduce ``EVAL_r05.json``'s protocol (16 train / 24 test
people at 32^2, the seeded linear projection to 64-d, bank gaussian /
saltpepper / speckle, n_steps 2,048, m2_n_steps 96, dig 6 / undig 8
epochs, seed 42).  Nothing is written unless ``--out`` is given.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from alink_tpu_torch import train as T
from alink_tpu_torch.active.committee import Committee
from alink_tpu_torch.active.loop import ALinkLoop
from alink_tpu_torch.config import ALinkConfig
from alink_tpu_torch.data import make_synthetic_dfw, make_synthetic_dfw_test
from alink_tpu_torch.drivers import common
from alink_tpu_torch.evaluation import roc_stats, threshold_sweep
from alink_tpu_torch.evaluation.roc import CASE_NAMES as _CASES
from alink_tpu_torch.evaluation.roc import masked_scores
from alink_tpu_torch.tools.generate_matrix import restore_head_and_score
from alink_tpu_torch.tools.generate_predictions import generate_predictions

# The loop arms the ordering flags compare with the pre-A-LINK student.
ARMS = ("alink", "a2link")


def evaluate_stage(head, feats, mask, workdir: str, stage: str,
                   thresholds, device="cuda") -> dict:
    """One stage through the matrix -> ROC -> stats chain via the tool
    entry points, with the checkpoint round trip of generateMatrixDFW
    (:21-27): the head's state dict saved, restored and scored."""
    ckpt = os.path.join(workdir, f"head_{stage}")
    T.save(ckpt, head.state_dict())
    scores = restore_head_and_score(ckpt, feats, device)
    out = {}
    for case, label in _CASES.items():
        genuine, imposter = masked_scores(scores, mask, case)
        tpr, fpr = threshold_sweep(genuine, imposter, thresholds)
        s = roc_stats(tpr, fpr)
        out[label] = {
            "auc": round(float(s.auc), 6),
            "eer": round(float(s.eer), 6),
            "gar_at_1pct_far": round(float(s.gar_at_1pct_far), 6),
            "gar_at_01pct_far": round(float(s.gar_at_01pct_far), 6),
            "n_genuine": int(genuine.numel()),
            "n_imposter": int(imposter.numel()),
        }
    return out


def _copy_state(state: T.TrainState) -> T.TrainState:
    """An independent copy of a train state: module and optimizer."""
    new = T.TrainState(copy.deepcopy(state.module), state.learning_rate)
    new.optimizer.load_state_dict(state.optimizer.state_dict())
    new.step = state.step
    return new


def ordering_flags(stages: dict) -> dict:
    """The improvement orderings, per case (the paper reports
    impersonation / obfuscation / overall separately, create_figure_3.m),
    the equal-budget baseline flag and the r04 aliases: 15 flags."""
    ordering = {}
    for case in ("impersonation", "obfuscation", "overall"):
        for arm in ARMS:
            ordering[f"{arm}_auc_gt_pre_{case}"] = (
                stages[arm][case]["auc"] > stages["pre"][case]["auc"])
            ordering[f"{arm}_gar1_ge_pre_{case}"] = (
                stages[arm][case]["gar_at_1pct_far"]
                >= stages["pre"][case]["gar_at_1pct_far"])
    ordering["alink_auc_ge_existing_al"] = (
        stages["alink"]["overall"]["auc"]
        >= stages["existing_al"]["overall"]["auc"])
    ordering["alink_auc_gt_pre"] = ordering["alink_auc_gt_pre_overall"]
    ordering["a2link_auc_gt_pre"] = ordering["a2link_auc_gt_pre_overall"]
    return ordering


def run_eval_regression(
    out_json: str | None = None,
    *,
    num_people: int = 8,
    test_people: int = 6,
    test_plain_per_person: int = 2,
    test_disguised_per_person: int = 2,
    test_impostors_per_person: int = 1,
    image_size: int = 32,
    featurize=None,
    feature_res: int = 2048,
    n_steps: int = 512,
    m2_n_steps: int | None = None,
    dig_epochs: int = 6,
    undig_epochs: int = 8,
    noise_bank=("gaussian", "saltpepper", "speckle"),
    adversarial_kwargs=None,
    loop_overrides: dict | None = None,
    seed: int = 42,
    verbose: bool = True,
    device="cuda",
) -> dict:
    """Stage, train and evaluate the four stages on ``device``; returns
    the artifact dict (and writes it to ``out_json`` when given).

    ``featurize``: ``"linear"`` (the seeded random projection of the
    pixels to ``feature_res``), None (the VGGFace-ResNet50 teacher with
    random weights) or a callable on (N, H, W, 3) tensors on ``device``.
    """
    device = common.resolve_device(device, "run_eval_regression")
    g = torch.Generator().manual_seed(seed)
    root = tempfile.mkdtemp(prefix="alink_evalreg_")
    make_synthetic_dfw(root, num_people=num_people, image_size=image_size,
                       seed=seed)
    # Disjoint identities for the held-out protocol (another seed stream,
    # so other base patterns).
    _, names, mask = make_synthetic_dfw_test(
        root, num_people=test_people, image_size=image_size,
        plain_per_person=test_plain_per_person,
        disguised_per_person=test_disguised_per_person,
        impostors_per_person=test_impostors_per_person,
        seed=seed + 1000)

    overrides = dict(
        alink_bs=2, batch_send=8, ft_epochs=2, mixture_ratio=1,
        disparity_ratio=0.4, eps=0.05, batch_size=16,
    )
    overrides.update(loop_overrides or {})
    cfg = ALinkConfig(
        data_dir_prefix=root,
        noise=tuple(noise_bank),
        image_res=(image_size, image_size),
        feature_res=feature_res,
        dig_epochs=dig_epochs,
        undig_epochs=undig_epochs,
        seed=seed,
        **overrides,
    )

    featurizer_kind = ("linear-random-projection" if featurize == "linear"
                       else "resnet50-random-weights" if featurize is None
                       else "custom")
    if featurize == "linear":
        # The seeded random projection (D = feature_res): a fixed
        # distance-preserving linear map of the pixels; the task's
        # difficulty is set by the projection's width (the JAX package's
        # round-5 regime, which random ResNet50 weights made chaotic at
        # this synthetic scale).
        wp = (torch.randn((image_size * image_size * 3, feature_res),
                          generator=g) / 30.0).to(device)

        def featurize(imgs):
            x = imgs.reshape(imgs.shape[0], -1).float() / 255.0
            return x @ wp
    elif featurize is None:
        featurize, _ = common.make_resnet50_featurizer(g, device=device)

    if verbose:
        print(f"staged synthetic DFW at {root}: {num_people} train / "
              f"{test_people} test people at {image_size}^2")

    # --- training staging (the run_alink flow, stage-capturing) --------
    data = common.load_dfw(cfg, featurize, device)
    dig_pre, dig_post_raw = common.split_pools(cfg, data)
    workdir = tempfile.mkdtemp(prefix="alink_evalreg_models_")

    m2_gen = common.replay_generator(cfg.seed, dig_pre, data.imp_feats,
                                     cfg.batch_size)
    # m2_n_steps < n_steps keeps the pre-A-LINK student weak, as the
    # reference's "M2 before" is trained only on the limited pre-split
    # (ALINK.py:99-118; create_figure_3.m's 75.62 row).
    m2_pre = common.train_or_load_head(
        common.new_head_state(g, cfg.feature_res, 0.1, device),
        os.path.join(workdir, "m2_pre_ckpt"), m2_gen,
        epochs=cfg.dig_epochs, batch_size=cfg.batch_size, generator=g,
        n_steps=m2_n_steps if m2_n_steps is not None else n_steps)

    plain_gen = common.replay_generator(cfg.seed + 1, data.plain_feats,
                                        data.imp_feats, cfg.batch_size)
    committee, _head = common.train_or_load_committee(
        g, cfg.feature_res, cfg.noise, cfg.num_ensemble_models,
        os.path.join(workdir, "ensemble"), plain_gen,
        epochs=cfg.undig_epochs, batch_size=cfg.batch_size, n_steps=n_steps,
        device=device)

    # --- held-out featurization via the production tool ----------------
    feats = generate_predictions(root, names, featurize,
                                 image_res=cfg.image_res, device=device)
    mask_t = torch.as_tensor(mask, device=device)
    thresholds = np.linspace(0.0, 1.0, 10001)

    def stage(head, name):
        return evaluate_stage(head, feats, mask_t, workdir, name,
                              thresholds, device)

    stages = {"pre": stage(m2_pre.module, "pre")}
    if verbose:
        print("pre:", json.dumps(stages["pre"]["overall"]))

    # --- the two loop arms ---------------------------------------------
    def run_arm(arm: str, arm_seed: int, noise_names) -> dict:
        from alink_tpu_torch.drivers.alink import make_adversarial_predict

        arm_cfg = dataclasses.replace(cfg, noise=tuple(noise_names))
        arm_committee = Committee(committee.head, committee.params,
                                  noise_names=tuple(noise_names))
        kw = {}
        # Both model-backed channels (one-pixel DE and FGSM) need the
        # end-to-end predict function, as in drivers/alink.py.
        if {"adversarial", "fgsm"} & set(noise_names):
            kw["adversarial_predict"] = make_adversarial_predict(featurize)
            kw["adversarial_kwargs"] = dict(
                adversarial_kwargs
                or dict(pixel_count=2, maxiter=3, popsize=8))
        replay = common.replay_generator(cfg.seed + 2, data.plain_feats,
                                         data.imp_feats, cfg.batch_size)
        loop = ALinkLoop(
            arm_cfg, pool_uint8=True, featurize=featurize,
            committee=arm_committee, m2_state=_copy_state(m2_pre),
            replay_gen=replay,
            generator=torch.Generator(device).manual_seed(arm_seed),
            host_generator=g, device=device, **kw)
        loop.run(data.plain_raw, dig_post_raw)
        queried = sum(log.queried for log in loop.logs)
        if verbose:
            print(f"{arm}: active {loop.state.active_count}/"
                  f"{loop.state.un_size}, queried {queried}")
        st = stage(loop.state.m2_state.module, arm)
        st["overall"]["oracle_queries"] = queried
        return st

    stages["alink"] = run_arm("alink", seed + 101, tuple(noise_bank))
    if verbose:
        print("alink:", json.dumps(stages["alink"]["overall"]))
    stages["a2link"] = run_arm(
        "a2link", seed + 202, tuple(noise_bank) + ("adversarial",))
    if verbose:
        print("a2link:", json.dumps(stages["a2link"]["overall"]))

    # --- the classical-AL baseline at equal oracle budget ---------------
    # The paper's comparison (existing_al.py): one student trained by
    # pool-based uncertainty sampling from the same pretrained M2, given
    # exactly as many oracle labels as the alink arm spent, so the
    # ordering isolates the selection and committee machinery.
    def run_baseline(budget: int) -> dict:
        from alink_tpu_torch.active import ActiveLearner
        from alink_tpu_torch.active.uncertainty import get_strategy

        gen = common.replay_generator(cfg.seed + 3, data.plain_feats,
                                      data.imp_feats, cfg.batch_size)
        learner = ActiveLearner(_copy_state(m2_pre),
                                get_strategy("uncertainty_sampling"),
                                generator=g, epochs=overrides["ft_epochs"],
                                batch_size=cfg.batch_size)
        q = 0
        while q < budget:
            (left, right), y = next(gen)
            n_pick = min(max(1, len(y) // 10), budget - q)
            idx = learner.query(left, right, n_instances=n_pick)
            learner.teach(left[idx], right[idx], y[idx], only_new=True)
            q += n_pick
        st = stage(learner.state.module, "existing_al")
        st["overall"]["oracle_queries"] = q
        return st

    # Budget 0 (a committee that never disagrees) stays 0: the baseline is
    # then the untouched M2, keeping the equal-budget invariant.
    stages["existing_al"] = run_baseline(
        stages["alink"]["overall"]["oracle_queries"])
    if verbose:
        print("existing_al:", json.dumps(stages["existing_al"]["overall"]))

    artifact = {
        "protocol": {
            "train_people": num_people,
            "test_people": test_people,
            "test_faces": len(names),
            "test_plain_per_person": test_plain_per_person,
            "test_disguised_per_person": test_disguised_per_person,
            "test_impostors_per_person": test_impostors_per_person,
            "image_size": image_size,
            "feature_res": feature_res,
            "featurizer": featurizer_kind,
            "noise_bank": list(noise_bank),
            "n_steps": n_steps,
            "m2_n_steps": m2_n_steps,
            "dig_epochs": dig_epochs,
            "undig_epochs": undig_epochs,
            # The effective override set (the demonstration regime merged
            # with the caller's).
            "loop_overrides": dict(overrides),
            "seed": seed,
            "mask_pairs_scored": int(np.count_nonzero(np.triu(mask, 1))),
            "device": str(device),
        },
        "chain": ["generate_predictions", "generate_matrix",
                  "roc_precompute", "get_stats"],
        "stages": stages,
        "ordering": ordering_flags(stages),
        "reference": "utilities/create_figure_3.m + getStats.py:9-25 "
                     "(synthetic stand-in; real DFW weights/data not "
                     "available)",
    }
    if out_json:
        with open(out_json, "w") as f:
            json.dump(artifact, f, indent=1)
        if verbose:
            print(f"wrote {out_json}")
    return artifact


def main(argv=None) -> dict:
    import argparse

    # The defaults reproduce EVAL_r05.json's protocol (the round-5
    # demonstration regime: weak pre-student, seeded linear projection,
    # strong committee).  EVAL_r05.json itself is the JAX package's record
    # and is never written here.
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None,
                    help="write the artifact here (e.g. EVAL_torch.json)")
    ap.add_argument("--num_people", type=int, default=16)
    ap.add_argument("--test_people", type=int, default=24)
    ap.add_argument("--test_plain", type=int, default=3)
    ap.add_argument("--test_disguised", type=int, default=3)
    ap.add_argument("--test_impostors", type=int, default=1)
    ap.add_argument("--image_size", type=int, default=32)
    ap.add_argument("--n_steps", type=int, default=2048)
    ap.add_argument("--m2_n_steps", type=int, default=96)
    ap.add_argument("--dig_epochs", type=int, default=6)
    ap.add_argument("--undig_epochs", type=int, default=8)
    ap.add_argument("--featurizer", choices=("resnet50", "linear"),
                    default="linear")
    ap.add_argument("--feature_res", type=int, default=64)
    ap.add_argument("--mixture_ratio", type=int, default=None,
                    help="replay batches mixed per finetune")
    ap.add_argument("--ft_epochs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    loop_overrides = {}
    if args.mixture_ratio is not None:
        loop_overrides["mixture_ratio"] = args.mixture_ratio
    if args.ft_epochs is not None:
        loop_overrides["ft_epochs"] = args.ft_epochs
    art = run_eval_regression(
        args.out, num_people=args.num_people, test_people=args.test_people,
        test_plain_per_person=args.test_plain,
        test_disguised_per_person=args.test_disguised,
        test_impostors_per_person=args.test_impostors,
        image_size=args.image_size, n_steps=args.n_steps,
        featurize="linear" if args.featurizer == "linear" else None,
        feature_res=args.feature_res,
        m2_n_steps=args.m2_n_steps, dig_epochs=args.dig_epochs,
        undig_epochs=args.undig_epochs, loop_overrides=loop_overrides,
        seed=args.seed, device=args.device)
    print(json.dumps(art["ordering"]))
    return art


if __name__ == "__main__":
    main()
