"""Decode + resize into person-padded fixed-shape arrays (counterpart of
``alink_tpu/data/loader.py``).

    images: (P, S_max, H, W, 3) float32   person-major, zero-padded
    counts: (P,)                int32     live images per person

Decoding runs on the host: through the JAX package's C++ loader
(``native/loader.cc``, bound by ``data.native_loader``) wherever it builds,
else with PIL on a thread pool, as the JAX package chooses.  The C++ path
resizes with cv2's ``INTER_LINEAR``, the reference's resize; PIL's
``BILINEAR`` widens its filter when it downscales, so the two paths give
different pixels at a downscaling ``image_res``.
``ALinkConfig.ingest_dct_scale`` reaches the C++ decoder through
``dct_scale``.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
from typing import Sequence

import numpy as np
import torch
from PIL import Image

from alink_tpu_torch.data import native_loader


@dataclasses.dataclass
class PersonStacks:
    """Padded per-person image (or feature) stacks + validity counts."""

    images: np.ndarray  # (P, S_max, ...) — pixels or features
    counts: np.ndarray  # (P,) int32

    @property
    def num_people(self) -> int:
        return int(self.images.shape[0])

    @property
    def max_stack(self) -> int:
        return int(self.images.shape[1])

    def mask(self) -> np.ndarray:
        """(P, S_max) bool validity mask."""
        return np.arange(self.max_stack)[None, :] < self.counts[:, None]

    def map_stacks(self, fn) -> "PersonStacks":
        """Apply ``fn`` over all images as one (P*S, ...) batch (the batched
        replacement for per-person ``model.process`` calls,
        readDFW.py:99-101), preserving padding layout."""
        p, s = self.images.shape[:2]
        flat = self.images.reshape((p * s,) + self.images.shape[2:])
        out = np.asarray(fn(flat))
        return PersonStacks(out.reshape((p, s) + out.shape[1:]), self.counts)

    def take_people(self, idx: Sequence[int]) -> "PersonStacks":
        idx = np.asarray(idx)
        return PersonStacks(self.images[idx], self.counts[idx])


def _decode_one(path: str, image_res: tuple[int, int]) -> np.ndarray:
    """PIL decode -> RGB float32 -> bilinear resize to (w, h).

    ``image_res`` follows the reference's cv2 convention of (width, height)
    (readDFW.py:82 passes cv2.resize's dsize).  Corrupt/missing files
    decode to zeros — the reference tolerates them with try/except around
    the decode (readDFW.py:81-96); a zero slot keeps shapes static.
    """
    w, h = image_res
    try:
        img = Image.open(path).convert("RGB")
        if img.size != (w, h):
            img = img.resize((w, h), Image.BILINEAR)
        return np.asarray(img, dtype=np.float32)
    except Exception as exc:  # noqa: BLE001 — decode resilience by design
        print(f"decode failed ({exc}): {path}")
        return np.zeros((h, w, 3), np.float32)


def load_image_list(
    paths: Sequence[str],
    image_res: tuple[int, int],
    *,
    threads: int = 16,
    backend: str = "auto",
    dct_scale: bool = False,
) -> np.ndarray:
    """Decode a flat list of paths into an (N, H, W, 3) float32 array.

    ``backend``: "native" (the C++ loader; raises when it cannot be built),
    "pil" (PIL on a thread pool), or "auto" (native when it is available).
    ``dct_scale`` (native only): libjpeg's scaled decode for large
    sources, faster and approximate (``native_loader.decode_resize_batch``).
    """
    if backend not in ("auto", "native", "pil"):
        raise ValueError(f"backend {backend!r}: 'auto', 'native' or 'pil'")
    if not paths:
        w, h = image_res
        return np.zeros((0, h, w, 3), np.float32)
    if backend in ("auto", "native"):
        if native_loader.available():
            out, _ = native_loader.decode_resize_batch(
                list(paths), image_res, threads=threads,
                dct_scale=dct_scale)
            return out
        if backend == "native":
            raise RuntimeError("native loader requested but unavailable: "
                               f"{native_loader.build_error()}")
    with cf.ThreadPoolExecutor(max_workers=threads) as ex:
        imgs = list(ex.map(lambda p: _decode_one(p, image_res), paths))
    return np.stack(imgs)


def load_person_stacks(
    path_groups: Sequence[Sequence[str]],
    image_res: tuple[int, int],
    *,
    threads: int = 16,
    pad_to: int | None = None,
    dct_scale: bool = False,
) -> PersonStacks:
    """Decode per-person path lists into a padded ``PersonStacks``.

    ``path_groups[p]`` is the image list of person ``p`` (one group of a
    ``DFWPerson``, or one Multi-PIE subject).  Stacks pad to the longest
    group (at least 1), or to ``pad_to`` (to align independently loaded
    groups).  ``dct_scale`` passes through to ``load_image_list``
    (``ALinkConfig.ingest_dct_scale`` sets it for the drivers).
    """
    counts = np.asarray([len(g) for g in path_groups], np.int32)
    s_max = (pad_to if pad_to is not None
             else max(1, int(counts.max(initial=0))))
    w, h = image_res
    flat_paths = [p for g in path_groups for p in g]
    flat = load_image_list(flat_paths, image_res, threads=threads,
                           dct_scale=dct_scale)
    images = np.zeros((len(path_groups), s_max, h, w, 3), np.float32)
    offset = 0
    for p, c in enumerate(counts):
        images[p, :c] = flat[offset:offset + c]
        offset += c
    return PersonStacks(images, counts)


def as_device(stacks: PersonStacks, device) -> PersonStacks:
    """The stacks with their pixels moved once to ``device`` (a tensor;
    the counts stay on the host), so later gathers do not upload them
    again."""
    return PersonStacks(torch.as_tensor(stacks.images, device=device),
                        stacks.counts)
