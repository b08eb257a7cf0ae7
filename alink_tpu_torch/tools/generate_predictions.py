"""Featurize the DFW test list -> processedData.npy (counterpart of
``alink_tpu/tools/generate_predictions.py``).

Reference: ``utilities/generatePredictions.py``: reads
``<prefix>/Testing_data_face_name.txt`` (7,771 file names), featurizes each
face with RESNET50 one image at a time (:56-57) and saves the feature
stack.  Here the list is decoded on a thread pool and embedded in batches
by the VGGFace-ResNet50 teacher (kernel K3 on the card).

    python -m alink_tpu_torch.tools.generate_predictions DFW_Data/ \\
        --out processedData.npy [--backbone_ckpt ckpt] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from alink_tpu_torch.data.loader import load_image_list
from alink_tpu_torch.data.manifest import lookup_file


def generate_predictions(prefix: str, names: list[str], featurize,
                         image_res=(224, 224), batch: int = 256,
                         device=None) -> np.ndarray:
    """Decode ``names`` (relative to ``prefix``) at ``image_res`` (cv2's
    (w, h)) and featurize them ``batch`` at a time on ``device``:
    ``featurize`` maps an (n, H, W, 3) f32 tensor to (n, D).  Returns the
    (N, D) f32 host array, row i for ``names[i]``."""
    paths = []
    missing = []
    for name in names:
        resolved = lookup_file(os.path.join(prefix, name))
        if resolved is None:
            missing.append(name)
            continue
        paths.append(resolved)
    if missing:
        # The downstream masks are positional over exactly this list
        # (generateMatrixDFW.py:29 asserts 7,771 rows), so silently
        # skipping (the reference's try/except, generatePredictions.
        # py:43-48) would shift every genuine/imposter label after the
        # first dropped index.  Fail loudly instead.
        raise FileNotFoundError(
            f"{len(missing)} of {len(names)} test-list images not found "
            f"(first few: {missing[:5]}); the ROC masks are positional, "
            "so a partial feature stack would mislabel every pair after "
            "the first gap")
    images = load_image_list(paths, image_res)
    feats = []
    with torch.no_grad():
        for i in range(0, len(images), batch):
            x = torch.as_tensor(images[i:i + batch], device=device)
            feats.append(torch.as_tensor(featurize(x)).float().cpu().numpy())
    return np.concatenate(feats)


def read_face_names(prefix: str) -> list[str]:
    """The test list ``<prefix>/Testing_data_face_name.txt``."""
    with open(os.path.join(prefix, "Testing_data_face_name.txt")) as f:
        return [line.rstrip() for line in f]


def resnet50_featurizer(backbone_ckpt: str | None, device):
    """The VGGFace-ResNet50 teacher (random weights from seed 0, or restored
    from ``backbone_ckpt``, a ``train.save`` of its state dict) on
    ``device``."""
    from alink_tpu_torch import train as T
    from alink_tpu_torch.drivers.common import make_resnet50_featurizer

    featurize, model = make_resnet50_featurizer(
        torch.Generator().manual_seed(0), device=device)
    if backbone_ckpt:
        model.load_state_dict(T.restore(backbone_ckpt, model.state_dict()))
    return featurize


def main(argv=None) -> None:
    from alink_tpu_torch.drivers.common import resolve_device

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("prefix", help="dataset prefix containing "
                        "Testing_data_face_name.txt")
    parser.add_argument("--out", default="processedData.npy")
    parser.add_argument("--backbone_ckpt", default=None,
                        help="train.save checkpoint of the featurizer")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device, "generate_predictions")
    featurize = resnet50_featurizer(args.backbone_ckpt, device)
    feats = generate_predictions(args.prefix, read_face_names(args.prefix),
                                 featurize, device=device)
    np.save(args.out, feats)
    print(f"wrote {args.out}: {feats.shape}")


if __name__ == "__main__":
    main()
