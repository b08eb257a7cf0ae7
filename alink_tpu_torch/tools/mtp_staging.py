"""Multi-PIE dataset staging pipeline (counterpart of
``alink_tpu/tools/mtp_staging.py``; numpy and the standard library only).

Reference: ``utilities/process.py`` (flat dir -> per-person dirs),
``utilities/bisect_into_paths.py`` (20% unlabeled / 60% test / 15% HR /
5% LR person-wise split at seed 42), ``utilities/generate_image_dirs.py``
(per-person 80/20 train/val split) and ``utilities/readyData.sh`` (the
orchestration).  One Python CLI with subcommands replaces the script chain;
file/directory contracts are identical so existing staged trees interop.
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

SPLIT_RATIOS = {  # bisect_into_paths.py:11-14
    "unlabelled": 0.2,
    "test": 0.6,
    "highres": 0.15,
    "lowres": 0.05,
}


#: Canonical split -> list-file names (readyData.sh's fileLists/).
LIST_NAMES = {
    "unlabelled": "unlabelledData.txt",
    "test": "testData.txt",
    "highres": "highResData.txt",
    "lowres": "lowResData.txt",
}


def group_by_person(src: str, dst: str, move: bool = True) -> None:
    """Flat ``<person>_...`` files -> per-person directories (process.py)."""
    users: dict[str, list[str]] = {}
    for filename in sorted(os.listdir(src)):
        person = filename.split("_")[0]
        users.setdefault(person, []).append(filename)
    for person, files in users.items():
        pdir = os.path.join(dst, person)
        os.makedirs(pdir, exist_ok=True)
        for f in files:
            op = shutil.move if move else shutil.copy2
            op(os.path.join(src, f), os.path.join(pdir, f))


def bisect_into_paths(images_dir: str, files_dir: str, seed: int = 42
                      ) -> dict[str, list[str]]:
    """Person-wise 4-way split into path-list files
    (bisect_into_paths.py; np seed 42 for reproducibility)."""
    rng = np.random.RandomState(seed)
    splits: dict[str, list[str]] = {k: [] for k in SPLIT_RATIOS}
    for class_folder in sorted(os.listdir(images_dir)):
        paths = sorted(os.listdir(os.path.join(images_dir, class_folder)))
        rng.shuffle(paths)
        n = len(paths)
        t1 = int(SPLIT_RATIOS["unlabelled"] * n)
        t2 = int(SPLIT_RATIOS["test"] * n) + t1
        t3 = int(SPLIT_RATIOS["highres"] * n) + t2
        splits["unlabelled"] += paths[:t1]
        splits["test"] += paths[t1:t2]
        splits["highres"] += paths[t2:t3]
        splits["lowres"] += paths[t3:]
    os.makedirs(files_dir, exist_ok=True)
    for key, fname in LIST_NAMES.items():
        with open(os.path.join(files_dir, fname), "w") as f:
            f.write("".join(p + "\n" for p in splits[key]))
    return splits


def generate_image_dirs(base_dir: str, images_dir: str, file_list: str,
                        ratio: float = 0.8, seed: int = 42) -> None:
    """Per-person train/val split of a path list (generate_image_dirs.py)."""
    del seed  # the reference seeds numpy but uses no randomness here
    train_path = os.path.join(base_dir, "train")
    val_path = os.path.join(base_dir, "val")
    os.makedirs(train_path, exist_ok=True)
    os.makedirs(val_path, exist_ok=True)
    with open(file_list) as f:
        paths = [line.rstrip("\n") for line in f if line.strip()]
    posting: dict[str, list[str]] = {}
    for path in paths:
        posting.setdefault(path.split("_")[0], []).append(path)
    for person, files in posting.items():
        cut = int(ratio * len(files))
        for image in files[:cut]:
            shutil.move(os.path.join(images_dir, image),
                        os.path.join(train_path, image))
        for image in files[cut:]:
            shutil.move(os.path.join(images_dir, image),
                        os.path.join(val_path, image))


def ready_data(raw_dir: str, out_dir: str) -> None:
    """The full readyData.sh pipeline from an unpacked flat image dir."""
    work = os.path.join(out_dir, "_staging")
    segregated = os.path.join(work, "segregated")
    file_lists = os.path.join(out_dir, "fileLists")
    os.makedirs(segregated, exist_ok=True)
    group_by_person(raw_dir, segregated, move=False)
    bisect_into_paths(segregated, file_lists)
    for res in ("highres", "lowres"):
        res_dir = os.path.join(out_dir, res)
        pool = os.path.join(work, f"{res}_pool")
        os.makedirs(pool, exist_ok=True)
        # Rebuild a flat pool of this split's images, then train/val it.
        with open(os.path.join(file_lists, LIST_NAMES[res])) as f:
            for line in f:
                name = line.strip()
                if not name:
                    continue
                shutil.copy2(
                    os.path.join(segregated, name.split("_")[0], name),
                    os.path.join(pool, name),
                )
        generate_image_dirs(res_dir, pool,
                            os.path.join(file_lists, LIST_NAMES[res]))
        # Person-group the train/val splits (readyData.sh's TRAIN/VAL pass).
        for split in ("train", "val"):
            flat = os.path.join(res_dir, split)
            # NOT split.upper(): on case-insensitive filesystems (APFS,
            # NTFS) "TRAIN" IS "train", and the rmtree below would
            # destroy the just-grouped tree.
            grouped = os.path.join(res_dir, split + "_grouped")
            os.makedirs(grouped, exist_ok=True)
            group_by_person(flat, grouped)
            shutil.rmtree(flat)
            shutil.move(grouped, flat)
    shutil.rmtree(work)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("group")
    g.add_argument("src")
    g.add_argument("dst")
    b = sub.add_parser("bisect")
    b.add_argument("images_dir")
    b.add_argument("files_dir")
    d = sub.add_parser("dirs")
    d.add_argument("base_dir")
    d.add_argument("images_dir")
    d.add_argument("file_list")
    r = sub.add_parser("ready")
    r.add_argument("raw_dir")
    r.add_argument("out_dir")
    args = parser.parse_args(argv)
    if args.cmd == "group":
        group_by_person(args.src, args.dst)
    elif args.cmd == "bisect":
        bisect_into_paths(args.images_dir, args.files_dir)
    elif args.cmd == "dirs":
        generate_image_dirs(args.base_dir, args.images_dir, args.file_list)
    else:
        ready_data(args.raw_dir, args.out_dir)


if __name__ == "__main__":
    main()
