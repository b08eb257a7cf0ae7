"""A-LINK driver, ArcFace configuration (counterpart of
``alink_tpu/drivers/alink_arc.py``; the reference's ALINK_arc.py).

The same loop as ``drivers/alink.py`` with the InsightFace embedding stack:
112x112 inputs, 512-d L2-normalised ArcFace features (LResNet 34, 50 or
100, ``--embed_depth``), and perlin in the default noise bank.  The
embedder runs batched in place of the reference's one image at a time;
``make_arcface_featurizer(family="vit")`` gives insightface's ViT-L in its
place.  The run is on the CUDA card unless ``--device cpu`` asks for the
CPU.

    python -m alink_tpu_torch.drivers.alink_arc --synthetic_people 8
"""

from __future__ import annotations

import argparse
from typing import Callable, Mapping

import torch

from alink_tpu_torch.config import ALinkArcConfig
from alink_tpu_torch.convert import load_flax, load_insightface_vit
from alink_tpu_torch.drivers import common
from alink_tpu_torch.drivers.alink import parse_config, run_alink
from alink_tpu_torch.models import (ArcFaceResNet34, ArcFaceResNet50,
                                    ArcFaceResNet100, FaceViT, FaceViT_L)

_DEPTHS = {34: ArcFaceResNet34, 50: ArcFaceResNet50,
           100: ArcFaceResNet100}
_VIT = FaceViT_L


def make_arcface_featurizer(generator: torch.Generator | None,
                            params: Mapping | None = None, depth: int = 100,
                            device="cuda", family: str = "lresnet"
                            ) -> tuple[Callable, ArcFaceResNet100 | FaceViT]:
    """The batched 512-d face embedder: ``(N, 112, 112, 3)`` raw pixels on
    ``device`` -> ``(N, 512)`` f32.  ``family`` "lresnet" (the default)
    gives ArcFace, ``depth`` picking the LResNet (34, 50 or 100); "vit"
    gives insightface's ViT-L (``models.FaceViT_L``; ``depth`` unused).
    Random weights from ``generator`` unless ``params`` is given: for
    ArcFace a JAX parameter tree (numpy leaves, ``convert.load_flax``) or a
    torch state dict, for the ViT an insightface state dict
    (``convert.load_insightface_vit``).  The weights are frozen; the
    forward stays differentiable in the pixels (FGSM, the one-pixel
    attack's model channels).  The module is itself the featurizer (both
    take raw pixels)."""
    device = common.resolve_device(device, "make_arcface_featurizer")
    if family == "vit":
        model = _VIT(generator=generator, device=device)
        if params is not None:
            load_insightface_vit(model, params)
    elif family == "lresnet":
        model = _DEPTHS[depth](generator=generator, device=device)
        if params is not None:
            if all(isinstance(v, torch.Tensor) for v in params.values()):
                model.load_state_dict(params, strict=True)
            else:
                load_flax(model, params)
    else:
        raise ValueError(f"family must be 'lresnet' or 'vit', got "
                         f"{family!r}")
    model.eval().requires_grad_(False)
    return model, model


def main(argv=None) -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    known, rest = pre.parse_known_args(argv)
    config = parse_config(rest, config_cls=ALinkArcConfig)
    device = common.resolve_device(known.device, "alink_arc")
    featurize, _ = make_arcface_featurizer(
        torch.Generator().manual_seed(config.seed + 100),
        depth=config.embed_depth, device=device)
    run_alink(config, featurize=featurize, device=device)


if __name__ == "__main__":
    main()
