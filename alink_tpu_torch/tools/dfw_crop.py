"""DFW face-box cropping staging tool (counterpart of
``alink_tpu/tools/dfw_crop.py``).

Reference: ``code/readDFW.py:28-62`` — reads a face-box index file
("<relpath> x1 y1 x2 y2" per line, ``constructIndexMap``), crops every
training image to its box **in place**, and deletes unreadable files
(``cropImages``/``cropAllFolders``).  In-place destruction is preserved
only behind ``--in_place``; the default writes to an output tree::

    python -m alink_tpu_torch.tools.dfw_crop PREFIX TRAIN_FOLDER BOX_FILE \
        --out OUT
"""

from __future__ import annotations

import argparse
import os

from PIL import Image

from alink_tpu_torch.data.manifest import lookup_file


def construct_index_map(file_path: str) -> dict[str, list[float]]:
    """"relpath x1 y1 x2 y2" lines -> box map (readDFW.py:47-53)."""
    mapping: dict[str, list[float]] = {}
    with open(file_path) as f:
        for row in f:
            imgname, *coords = row.rstrip("\n").rstrip().rsplit(" ", 4)
            mapping[imgname] = [float(x) for x in coords]
    return mapping


def crop_images(prefix: str, dir_path: str, face_boxes: dict,
                out_prefix: str | None = None,
                delete_bad: bool = False) -> int:
    """Crop one person directory; returns the failure count
    (readDFW.py:28-44)."""
    problems = 0
    full_dir = os.path.join(prefix, dir_path)
    for im_path in sorted(os.listdir(full_dir)):
        partial = os.path.join(dir_path, im_path)
        full = lookup_file(os.path.join(prefix, partial))
        if full is None or partial not in face_boxes:
            # Not a decode failure: the image may be perfectly fine and
            # merely missing a box-file entry — never delete it.
            problems += 1
            continue
        try:
            with Image.open(full) as im:
                img = im.convert("RGB")
        except Exception:
            # Only genuinely unreadable images are delete_bad candidates
            # (the reference deletes exactly these, readDFW.py:40-43).
            problems += 1
            if delete_bad and os.path.exists(full):
                os.remove(full)
            continue
        # Downstream failures (bad box, save error, full disk) must
        # propagate, not destroy the readable source image.
        x1, y1, x2, y2 = face_boxes[partial]
        img = img.crop((x1, y1, x2, y2))
        if out_prefix is None:
            img.save(full)  # in-place (reference behaviour)
        else:
            dst = os.path.join(out_prefix, partial)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            img.save(dst)
    return problems


def crop_all_folders(prefix: str, train_folder: str, box_map: dict,
                     out_prefix: str | None = None,
                     delete_bad: bool = False) -> int:
    """Crop every person directory (readDFW.py:57-62)."""
    root = os.path.join(prefix, train_folder)
    problems = 0
    for person in sorted(os.listdir(root)):
        # Skip stray regular files (.DS_Store, misplaced box files) —
        # same guard as data/manifest.scan_dfw; one such entry must not
        # abort a staging run that has already cropped in place.
        if not os.path.isdir(os.path.join(root, person)):
            continue
        problems += crop_images(prefix, os.path.join(train_folder, person),
                                box_map, out_prefix, delete_bad)
    print("Problem with", problems)
    return problems


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("prefix")
    parser.add_argument("train_folder")
    parser.add_argument("box_file", help="face-box index file")
    parser.add_argument("--out", default=None,
                        help="output tree (default: crop in place)")
    parser.add_argument("--in_place", action="store_true",
                        help="confirm in-place cropping")
    parser.add_argument("--delete_bad", action="store_true",
                        help="delete unreadable files (reference behaviour)")
    args = parser.parse_args(argv)
    if args.out is None and not args.in_place:
        parser.error("refusing to crop in place without --in_place")
    box_map = construct_index_map(args.box_file)
    crop_all_folders(args.prefix, args.train_folder, box_map, args.out,
                     args.delete_bad)


if __name__ == "__main__":
    main()
