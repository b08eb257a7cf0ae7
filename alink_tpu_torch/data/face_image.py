"""InsightFace-style dataset manifests (counterpart of
``alink_tpu/data/face_image.py``; reference: code/face_image.py).

The reference enumerates face datasets into lists of edict records
``{id, classname, image_path, bbox, landmark}`` with one loader per
dataset family (webface/celeb/facescrub/megaface/fgnet/ytf/clfw/common,
face_image.py:19-250) plus a ``property`` file reader and a name dispatch
(face_image.py:252-267).

Rebuilt as typed records over three structural loaders that cover the
reference families:

- clean-list file  (``<dir>_clean_list.txt``: "relpath label" lines —
  webface; celeb's label-by-directory variant);
- directory-per-class trees (common/lfw/vgg; facescrub's two-level tree
  with optional per-image ``.json`` bbox + 3-point landmarks; megaface's
  json convention is identical);
- ytf/clfw-style trees reduce to directory-per-class as well.

``fgnet`` returns an empty list in the reference (face_image.py:245-247);
preserved.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np


@dataclasses.dataclass
class FaceRecord:
    """One dataset image (the reference's edict fields)."""

    id: str
    classname: str
    image_path: str
    bbox: np.ndarray | None = None       # (4,) [x1, y1, x2, y2]
    landmark: np.ndarray | None = None   # (K, 2)


@dataclasses.dataclass(frozen=True)
class DatasetProperty:
    num_classes: int
    image_size: tuple[int, int]


def load_property(data_dir: str) -> DatasetProperty:
    """Read the InsightFace ``property`` file (face_image.py:6-14)."""
    with open(os.path.join(data_dir, "property")) as f:
        for line in f:
            vec = line.strip().split(",")
            assert len(vec) == 3
            return DatasetProperty(int(vec[0]), (int(vec[1]), int(vec[2])))
    raise ValueError("empty property file")


def _read_json_annotations(image_path: str) -> tuple[np.ndarray | None,
                                                     np.ndarray | None]:
    """Optional per-image bbox + 3-landmark json (face_image.py:110-133)."""
    json_file = image_path + ".json"
    if not os.path.exists(json_file):
        return None, None
    with open(json_file) as f:
        data = json.loads(f.read())
    bbox = landmark = None
    if "bounding_box" in data:
        bb = data["bounding_box"]
        bbox = np.array([bb["x"], bb["y"], bb["x"] + bb["width"],
                         bb["y"] + bb["height"]], np.float32)
    lm = data.get("landmarks", {})
    if all(k in lm for k in ("0", "1", "2")):
        # Reference order: landmarks 1, 0, 2 (face_image.py:124-131).
        landmark = np.array(
            [[lm["1"]["x"], lm["1"]["y"]],
             [lm["0"]["x"], lm["0"]["y"]],
             [lm["2"]["x"], lm["2"]["y"]]], np.float32)
    return bbox, landmark


def get_dataset_from_list(input_dir: str,
                          suffix: str = "_clean_list.txt"
                          ) -> list[FaceRecord]:
    """"relpath label" list-file datasets (webface, face_image.py:18-29)."""
    records = []
    with open(input_dir + suffix) as f:
        for line in f:
            vec = line.strip().split()
            if len(vec) != 2:
                continue
            rel = vec[0].replace("\\", "/")
            records.append(FaceRecord(
                id=rel, classname=vec[1],
                image_path=os.path.join(input_dir, rel)))
    return records


def get_dataset_celeb(input_dir: str) -> list[FaceRecord]:
    """Celeb clean list with labels assigned per directory in encounter
    order (face_image.py:31-52)."""
    records = []
    dir2label: dict[str, int] = {}
    with open(input_dir + "_clean_list.txt") as f:
        for line in f:
            line = line.strip()
            if not line.startswith("./m."):
                continue
            line = line[2:]
            vec = line.split("/")
            assert len(vec) == 2
            label = dir2label.setdefault(vec[0], len(dir2label))
            records.append(FaceRecord(
                id=line, classname=str(label),
                image_path=os.path.join(input_dir, line)))
    return records


def get_dataset_common(input_dir: str,
                       with_json: bool = False) -> list[FaceRecord]:
    """Directory-per-class tree (face_image.py get_dataset_common); with
    ``with_json`` also reads facescrub/megaface-style sidecar
    annotations."""
    records = []
    # Label by CLASS DIRECTORY index, not raw listing index: a stray
    # file between class dirs must not leave a gap in 0..C-1 (the
    # reference increments its label only per directory,
    # face_image.py:71-85, and consumers treat int(classname) as a
    # contiguous softmax index).
    label = -1
    for subdir in sorted(os.listdir(input_dir)):
        full = os.path.join(input_dir, subdir)
        if not os.path.isdir(full):
            continue
        label += 1
        for img in sorted(os.listdir(full)):
            if img.endswith(".jpg.jpg") or img.endswith(".json"):
                continue  # face_image.py:104 skips double-extension files
            if not img.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                continue
            path = os.path.join(full, img)
            bbox = landmark = None
            if with_json:
                bbox, landmark = _read_json_annotations(path)
            records.append(FaceRecord(
                id=os.path.join(subdir, img), classname=str(label),
                image_path=path, bbox=bbox, landmark=landmark))
    return records


def get_dataset_fgnet(input_dir: str) -> list[FaceRecord]:
    """Preserved reference stub (face_image.py:245-247)."""
    del input_dir
    return []


def parse_lst_line(line: str) -> tuple[str, int, np.ndarray | None,
                                       np.ndarray | None, int]:
    """Parse an InsightFace .lst record (face_preprocess.py:6-26).

    Tab-separated: ``aligned  image_path  label  [x1 y1 x2 y2
    [lx1..lx5 ly1..ly5]]``; landmarks come as 2x5 column-major and are
    returned as (5, 2) points.  Returns
    ``(image_path, label, bbox, landmark, aligned)``.
    """
    vec = line.strip().split("\t")
    assert len(vec) >= 3
    aligned = int(vec[0])
    image_path = vec[1]
    label = int(vec[2])
    bbox = landmark = None
    if len(vec) > 3:
        bbox = np.array([int(vec[i]) for i in range(3, 7)], np.int32)
        if len(vec) > 7:
            flat = np.array([float(vec[i]) for i in range(7, 17)])
            landmark = flat.reshape(2, 5).T
    return image_path, label, bbox, landmark, aligned


def read_image(img_path: str, mode: str = "rgb",
               layout: str = "HWC") -> np.ndarray:
    """Image read with mode/layout options (face_preprocess.py:31-43),
    PIL-backed instead of cv2."""
    from PIL import Image

    with Image.open(img_path) as im:
        if mode == "gray":
            return np.asarray(im.convert("L"))
        arr = np.asarray(im.convert("RGB"))
    if mode == "bgr":
        arr = arr[..., ::-1]
    if layout == "CHW":
        arr = np.transpose(arr, (2, 0, 1))
    return arr


def get_dataset(name: str, input_dir: str) -> list[FaceRecord] | None:
    """Name dispatch (face_image.py:252-267)."""
    if name in ("webface",):
        return get_dataset_from_list(input_dir)
    if name in ("lfw", "vgg", "common", "ytf", "clfw"):
        return get_dataset_common(input_dir)
    if name == "celeb":
        return get_dataset_celeb(input_dir)
    if name in ("facescrub", "megaface"):
        return get_dataset_common(input_dir, with_json=True)
    if name == "fgnet":
        return get_dataset_fgnet(input_dir)
    return None
