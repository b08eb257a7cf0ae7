"""Host-side manifests (counterpart of ``alink_tpu/data/manifest.py``).

Plain Python, no pixel IO.  DFW: one directory per person; a file whose
stem contains ``_h_`` is a disguised face, ``_I_`` an impostor, anything
else plain.  A person takes part only if all three groups are non-empty.
Filenames carrying UTF-8 BOM debris are resolved by probing variants.
Multi-PIE: one flat directory, the four frontal captures of each subject
grouped by the integer id that starts the file name (``scan_mtp``).
"""

from __future__ import annotations

import dataclasses
import os

_BOM = "\xef\xbb\xbf"

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm")


def lookup_file(full_path: str) -> str | None:
    """Resolve a path that may carry BOM junk in directory or file name.

    Mirrors the probe order of ``readDFW.lookupFile`` (readDFW.py:8-25):
    exact, BOM-suffixed directory, BOM on both, BOM-suffixed stem,
    space-prefixed stem.  Returns None when nothing exists.
    """
    if os.path.exists(full_path):
        return full_path
    directory, file_name = os.path.split(full_path)
    stem, ext = os.path.splitext(file_name)
    candidates = [
        os.path.join(directory + _BOM, stem + ext),
        os.path.join(directory + _BOM, stem + _BOM + ext),
        os.path.join(directory, stem + _BOM + ext),
        os.path.join(directory, " " + stem + ext),
    ]
    for cand in candidates:
        if os.path.exists(cand):
            return cand
    return None


@dataclasses.dataclass(frozen=True)
class DFWPerson:
    """One DFW identity with its three image groups (absolute paths)."""

    name: str
    plain: tuple[str, ...]
    disguised: tuple[str, ...]
    impostor: tuple[str, ...]


def _classify(stem: str) -> str:
    if "_h_" in stem:
        return "disguised"
    if "_I_" in stem:
        return "impostor"
    return "plain"


def scan_dfw(
    prefix: str,
    train_folder: str,
    *,
    combine_normal_imp: bool = False,
    require_all_groups: bool = True,
) -> list[DFWPerson]:
    """Enumerate the DFW ``_h_``/``_I_`` protocol into per-person manifests.

    ``combine_normal_imp`` folds disguised images into the plain group,
    matching ``getAllTrainData(combine_normal_imp=True)``
    (readDFW.py:87-94, used by the classical-AL baseline).
    ``require_all_groups`` keeps only persons with images in every group
    (readDFW.py:97); disable for the raw reader (``getRawTrainData``
    requires only disguised + impostor markers, readDFW.py:136).
    """
    root = os.path.join(prefix, train_folder)
    people = []
    for person in sorted(os.listdir(root)):
        dir_path = os.path.join(root, person)
        if not os.path.isdir(dir_path):
            continue
        groups: dict[str, list[str]] = {"plain": [], "disguised": [],
                                        "impostor": []}
        for impath in sorted(os.listdir(dir_path)):
            stem, ext = os.path.splitext(impath)
            if ext.lower() not in _IMG_EXTS:
                continue
            kind = _classify(stem)
            if combine_normal_imp and kind == "disguised":
                kind = "plain"
            resolved = lookup_file(os.path.join(dir_path, impath))
            if resolved is not None:
                groups[kind].append(resolved)
        if require_all_groups:
            needed = ("plain", "impostor") if combine_normal_imp else (
                "plain", "disguised", "impostor")
            if not all(groups[g] for g in needed):
                continue
        people.append(
            DFWPerson(
                name=person,
                plain=tuple(groups["plain"]),
                disguised=tuple(groups["disguised"]),
                impostor=tuple(groups["impostor"]),
            )
        )
    return people


# The four qualifying Multi-PIE frontal captures (readMTP.py:9-14).
_MTP_SUFFIXES = (
    "01_01_051_06.png",
    "02_01_051_06.png",
    "01_01_051_08.png",
    "02_01_051_08.png",
)


def mtp_qualifies(path: str) -> bool:
    """Session/camera filter (readMTP.qualifies, readMTP.py:8-18)."""
    return any(path.endswith(s) for s in _MTP_SUFFIXES)


def scan_mtp(dir_path: str) -> dict[int, list[str]]:
    """Group qualifying Multi-PIE files by integer subject id
    (readMTP.readAllImages, readMTP.py:21-39)."""
    person_wise: dict[int, list[str]] = {}
    for path in sorted(os.listdir(dir_path)):
        if not mtp_qualifies(path):
            continue
        person_id = int(path.split("_")[0])
        person_wise.setdefault(person_id, []).append(
            os.path.join(dir_path, path))
    return person_wise
