"""Shared driver wiring (counterpart of ``alink_tpu/drivers/common.py``):
data staging, the featurizer, train-or-load of the student and the
committee (or a fresh one, ``build_committee``), the replay stream (the
reference's ALINK.py:65-143)."""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Sequence

import numpy as np
import torch

from alink_tpu_torch import train as T
from alink_tpu_torch.active.committee import (Committee, stack_params,
                                              unstack_params)
from alink_tpu_torch.data import (PersonStacks, balanced_pair_batches,
                                  load_person_stacks, scan_dfw,
                                  split_disguise_data)
from alink_tpu_torch.models import SiameseHead, VGGFaceResNet50, preprocess
from alink_tpu_torch.train.ensemble import (EnsembleState,
                                            create_ensemble_state,
                                            train_ensemble)
from alink_tpu_torch.utils.profiling import count, span


def resolve_device(device, who: str) -> torch.device:
    """``device`` as asked; a CUDA device must exist (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


@dataclasses.dataclass
class DFWData:
    """Featurized + raw DFW person stacks (host numpy arrays)."""

    plain_feats: PersonStacks
    dig_feats: PersonStacks
    imp_feats: PersonStacks
    plain_raw: PersonStacks
    dig_raw: PersonStacks


def make_resnet50_featurizer(generator: torch.Generator | None = None,
                             model: VGGFaceResNet50 | None = None,
                             device=None) -> tuple[Callable, VGGFaceResNet50]:
    """The VGGFace-ResNet50 2048-d teacher featurizer with its
    preprocessing (``vggface`` v2): ``(N, H, W, 3)`` pixels on ``device`` ->
    ``(N, 2048)`` f32.  Random weights from ``generator`` unless ``model``
    is given (converted keras_vggface weights load with ``convert``).
    Each call is a ``featurize`` span and adds to the counters
    ``featurize.calls`` and ``featurize.images``."""
    if model is None:
        model = VGGFaceResNet50(generator=generator, device=device)
    model.eval()

    def featurize(images: torch.Tensor) -> torch.Tensor:
        count("featurize.calls")
        count("featurize.images", images.shape[0])
        with span("featurize"):
            return model(preprocess.vggface(images, version=2))

    return featurize, model


def featurize_stacks(stacks: PersonStacks, featurize: Callable,
                     device=None, batch: int = 256) -> PersonStacks:
    """One padded pass over all images of the stacks, ``batch`` at a time."""

    @torch.no_grad()
    def run(flat: np.ndarray) -> np.ndarray:
        outs = [featurize(torch.as_tensor(flat[i:i + batch], device=device))
                .float().cpu().numpy()
                for i in range(0, max(flat.shape[0], 1), batch)]
        return np.concatenate(outs)

    return stacks.map_stacks(run)


def load_dfw(config, featurize: Callable, device=None) -> DFWData:
    """Scan + decode + featurize the DFW training tree
    (``config.ingest_dct_scale`` reaches the native decoder)."""
    people = scan_dfw(config.data_dir_prefix, config.train_images_dir)
    if not people:
        raise FileNotFoundError(
            "no DFW persons with plain + disguised (_h_) + impostor (_I_) "
            f"images found under "
            f"{os.path.join(config.data_dir_prefix, config.train_images_dir)}")
    res = tuple(config.image_res)
    dct = config.ingest_dct_scale
    plain_raw, dig_raw, imp_raw = (
        load_person_stacks([getattr(p, kind) for p in people], res,
                           dct_scale=dct)
        for kind in ("plain", "disguised", "impostor"))
    return DFWData(
        plain_feats=featurize_stacks(plain_raw, featurize, device),
        dig_feats=featurize_stacks(dig_raw, featurize, device),
        imp_feats=featurize_stacks(imp_raw, featurize, device),
        plain_raw=plain_raw,
        dig_raw=dig_raw,
    )


def split_pools(config, data: DFWData):
    """Pre/post disguise split: featurized pre-pool for M2 pretraining, raw
    post-pool for the loop."""
    dig_pre, _ = split_disguise_data(data.dig_feats, config.split_ratio)
    _, dig_post_raw = split_disguise_data(data.dig_raw, config.split_ratio)
    return dig_pre, dig_post_raw


def new_head_state(generator: torch.Generator | None, feature_dim: int,
                   learning_rate: float = 0.1, device=None) -> T.TrainState:
    """A SiameseNetwork-equivalent head state (lr 0.1)."""
    return T.TrainState(SiameseHead(feature_dim, generator=generator,
                                    device=device), learning_rate)


def train_or_load_head(state: T.TrainState, path: str, gen, *, epochs: int,
                       batch_size: int,
                       generator: torch.Generator | None = None,
                       refine: bool = False,
                       n_steps: int | None = None) -> T.TrainState:
    """maybeLoadFromMemory / customTrainModel / save staging."""
    params, ok = T.maybe_restore(path, state.module.state_dict())
    if ok:
        state.module.load_state_dict(params)
        if not refine:
            return state
    state, _ = T.custom_train(
        state, gen, epochs=epochs, batch_size=batch_size, generator=generator,
        n_steps=n_steps if n_steps is not None else 320000)
    T.save(path, state.module.state_dict())
    return state


def replay_generator(seed: int, normal: PersonStacks,
                     imp: PersonStacks | None, batch_size: int):
    """The balanced clean-pair stream (pretraining and finetune replay)."""
    return balanced_pair_batches(seed, normal, imp, batch_size)


def build_committee(generator: torch.Generator | None, feature_dim: int,
                    noise_names: Sequence[str], num_members: int,
                    device=None) -> tuple[Committee, SiameseHead]:
    """The M1 ensemble (ALINK.py:94-97) of ``num_members`` freshly
    initialised heads, as stacked parameters."""
    heads = [SiameseHead(feature_dim, generator=generator, device=device)
             for _ in range(num_members)]
    return Committee.from_param_list(
        heads[0], [dict(h.named_parameters()) for h in heads],
        noise_names), heads[0]


def train_or_load_committee(generator: torch.Generator | None,
                            feature_dim: int, noise_names: Sequence[str],
                            num_members: int, basepath: str, gen, *,
                            epochs: int, batch_size: int,
                            refine: bool = False, n_steps: int = 320000,
                            learning_rate: float = 0.1, device=None
                            ) -> tuple[Committee, SiameseHead]:
    """The M1 ensemble trained as one stacked program, with per-member
    checkpoints ``<basepath><i>``.  Members that restore are kept: the
    stacked trainer runs all of them, and a restored member's parameters
    are put back before saving unless ``refine``."""
    heads = [SiameseHead(feature_dim, generator=generator, device=device)
             for _ in range(num_members)]
    state = create_ensemble_state(heads, learning_rate)
    restored, oks = [], []
    for i in range(1, num_members + 1):
        like = unstack_params(state.params, i - 1)
        params, ok = T.maybe_restore(f"{basepath}{i}", like)
        restored.append(params)
        oks.append(ok)
    state = EnsembleState(heads[0], stack_params(restored), learning_rate)
    if not all(oks) or refine:
        state, _ = train_ensemble(state, gen, epochs=epochs,
                                  batch_size=batch_size, n_steps=n_steps)
        members = [restored[i] if oks[i] and not refine
                   else unstack_params(state.params, i)
                   for i in range(num_members)]
        state = EnsembleState(heads[0], stack_params(members), learning_rate)
        for i in range(1, num_members + 1):
            T.save(f"{basepath}{i}", unstack_params(state.params, i - 1))
    return Committee(heads[0], state.params, noise_names), heads[0]
