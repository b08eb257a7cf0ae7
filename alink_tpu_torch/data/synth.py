"""Synthetic DFW-protocol image trees (counterpart of
``alink_tpu/data/synth.py``).

Every image of person ``p`` is a noisy copy of a per-person base pattern,
so identities are separable.  The numpy draws are made in the JAX
package's order: the same seed writes the same files.  The Multi-PIE and
DFW-testing writers are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image


def _person_image(rng, base: np.ndarray, noise: float) -> np.ndarray:
    img = base + rng.normal(0.0, noise * 255.0, base.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_synthetic_dfw(
    root: str,
    *,
    num_people: int = 6,
    plain_per_person: int = 3,
    disguised_per_person: int = 4,
    impostors_per_person: int = 2,
    image_size: int = 32,
    train_folder: str = "Training_data",
    seed: int = 0,
) -> str:
    """Write a DFW-protocol tree; returns the dataset prefix (``root``)."""
    rng = np.random.default_rng(seed)
    base_dir = os.path.join(root, train_folder)
    for p in range(num_people):
        pdir = os.path.join(base_dir, f"person_{p:03d}")
        os.makedirs(pdir, exist_ok=True)
        base = rng.uniform(0, 255, (image_size, image_size, 3))
        # Disguised images share the identity pattern but heavier noise;
        # impostors are entirely different patterns (other identities).
        impostor_base = rng.uniform(0, 255, (image_size, image_size, 3))
        for i in range(plain_per_person):
            Image.fromarray(_person_image(rng, base, 0.05)).save(
                os.path.join(pdir, f"img_{i}.jpg")
            )
        for i in range(disguised_per_person):
            Image.fromarray(_person_image(rng, base, 0.20)).save(
                os.path.join(pdir, f"img_h_{i}.jpg")
            )
        for i in range(impostors_per_person):
            Image.fromarray(_person_image(rng, impostor_base, 0.05)).save(
                os.path.join(pdir, f"img_I_{i}.jpg")
            )
    return root
