"""Synthetic DFW-protocol image trees (counterpart of
``alink_tpu/data/synth.py``).

Every image of person ``p`` is a noisy copy of a per-person base pattern,
so identities are separable.  The numpy draws are made in the JAX
package's order: the same seed writes the same files: the DFW training
tree (``make_synthetic_dfw``), its testing protocol
(``make_synthetic_dfw_test``: images, face-name list, positional mask) and
a flat Multi-PIE directory (``make_synthetic_mtp``).
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from alink_tpu_torch.data.manifest import _MTP_SUFFIXES


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


def make_synthetic_mtp(root: str, *, num_subjects: int = 5,
                       image_size: int = 48, seed: int = 0) -> str:
    """Write a flat Multi-PIE-protocol directory (the four qualifying
    captures per subject, and one non-qualifying file the scanner must
    ignore); returns ``root``."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for subject in range(1, num_subjects + 1):
        base = rng.uniform(0, 255, (image_size, image_size, 3))
        for suffix in _MTP_SUFFIXES:
            Image.fromarray(_person_image(rng, base, 0.05)).save(
                os.path.join(root, f"{subject:03d}_{suffix}"))
        Image.fromarray(_person_image(rng, base, 0.05)).save(
            os.path.join(root, f"{subject:03d}_01_01_140_07.png"))
    return root


# Kinds of a test face (``dfw_test_mask``).
PLAIN, DISGUISED, IMPOSTOR = 0, 1, 2


def dfw_test_mask(kinds: np.ndarray, persons: np.ndarray) -> np.ndarray:
    """The positional (N, N) int64 mask of a synthetic DFW test list, from
    each face's kind (``PLAIN``, ``DISGUISED``, ``IMPOSTOR``) and person:

    - same person, both plain                  -> 1 (genuine, impersonation)
    - same person, either disguised            -> 2 (genuine, obfuscation)
    - any pair involving an impostor           -> 3 (imposter, impersonation)
    - cross-person, either disguised           -> 4 (imposter, obfuscation)
    - cross-person, both plain                 -> 3
    - two impostors of the same target         -> 0 (unscored: they share
      one base pattern, so neither polarity would be truthful)
    - the diagonal                             -> 0

    The JAX writer's double loop over the pairs, as array operations.
    """
    kinds, persons = np.asarray(kinds), np.asarray(persons)
    imp, dig = kinds == IMPOSTOR, kinds == DISGUISED
    same = persons[:, None] == persons[None, :]
    any_dig = dig[:, None] | dig[None, :]
    mask = np.where(same, np.where(any_dig, 2, 1), np.where(any_dig, 4, 3))
    mask[imp[:, None] | imp[None, :]] = 3
    mask[imp[:, None] & imp[None, :] & same] = 0
    np.fill_diagonal(mask, 0)
    return mask.astype(np.int64)


def dfw_test_protocol(num_people: int, plain_per_person: int,
                      disguised_per_person: int, impostors_per_person: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(kinds, persons) of the faces of ``make_synthetic_dfw_test``'s list,
    in its order: per person, the plain faces, the disguised, the
    impostors."""
    block = np.repeat([PLAIN, DISGUISED, IMPOSTOR],
                      [plain_per_person, disguised_per_person,
                       impostors_per_person])
    kinds = np.tile(block, num_people)
    persons = np.repeat(np.arange(num_people), len(block))
    return kinds, persons


def make_synthetic_dfw_test(
    root: str,
    *,
    num_people: int = 6,
    plain_per_person: int = 2,
    disguised_per_person: int = 2,
    impostors_per_person: int = 1,
    image_size: int = 32,
    test_folder: str = "Testing_data",
    seed: int = 1,
):
    """Write a DFW *testing* protocol: image tree + face-name list + mask.

    The artifacts the DFW evaluation reads
    (``utilities/generatePredictions.py:56`` reads
    ``Testing_data_face_name.txt``; ``utilities/ROC_precompute.py:19-40``
    the positional mask with codes 1-4, ``dfw_test_mask``).

    Returns ``(prefix, names, mask)``: the dataset prefix (``root``), the
    face-name list (relative paths, written to
    ``<test_folder>_face_name.txt`` under ``root``) and the (N, N) int64
    mask (written to ``updated_testing_mask.txt`` under ``root``).
    """
    rng = np.random.default_rng(seed)
    base_dir = os.path.join(root, test_folder)
    groups = (("img_{}.jpg", plain_per_person, False, 0.05),
              ("img_h_{}.jpg", disguised_per_person, False, 0.20),
              ("img_I_{}.jpg", impostors_per_person, True, 0.05))
    names: list[str] = []
    for p in range(num_people):
        pdir = os.path.join(base_dir, f"person_{p:03d}")
        os.makedirs(pdir, exist_ok=True)
        base = rng.uniform(0, 255, (image_size, image_size, 3))
        impostor_base = rng.uniform(0, 255, (image_size, image_size, 3))
        for pattern, count, impostor, noise in groups:
            for i in range(count):
                fn = pattern.format(i)
                img = _person_image(rng, impostor_base if impostor else base,
                                    noise)
                Image.fromarray(img).save(os.path.join(pdir, fn))
                names.append(f"{test_folder}/person_{p:03d}/{fn}")

    mask = dfw_test_mask(*dfw_test_protocol(
        num_people, plain_per_person, disguised_per_person,
        impostors_per_person))
    with open(os.path.join(root, f"{test_folder}_face_name.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    np.savetxt(os.path.join(root, "updated_testing_mask.txt"), mask,
               fmt="%d")
    return root, names, mask
