"""Checkpoints of parameter trees (counterpart of
``alink_tpu/train/checkpoint.py``).

A tree (a state dict, or nested dicts of tensors and numpy arrays) is
written with ``torch.save`` to ``<path>/tree.pt``, atomically (a temporary
file, then ``os.replace``).  ``maybe_restore`` keeps the reference's
``maybeLoadFromMemory`` contract: a missing or unreadable checkpoint gives
``(like, False)`` and never raises.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

_FILE = "tree.pt"


def _file(path: str) -> str:
    return os.path.join(os.path.abspath(path), _FILE)


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree.detach().cpu().clone()


def save(path: str, tree: Any) -> None:
    """Atomically save a tree of tensors (or numpy arrays) to ``path``."""
    os.makedirs(os.path.abspath(path), exist_ok=True)
    tmp = f"{_file(path)}.{os.getpid()}.tmp"
    torch.save(_to_cpu(tree), tmp)
    os.replace(tmp, _file(path))


def _like(tree: Any, like: Any) -> Any:
    if isinstance(like, dict):
        if set(tree) != set(like):
            raise KeyError(f"checkpoint keys {sorted(tree)} differ from "
                           f"{sorted(like)}")
        return {k: _like(tree[k], like[k]) for k in like}
    if tuple(tree.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint shape {tuple(tree.shape)} differs from "
                         f"{tuple(like.shape)}")
    return tree.to(like.device, like.dtype)


def restore(path: str, like: Any | None = None) -> Any:
    """Load a tree; ``like`` gives the keys, shapes, dtypes and devices to
    match (a mismatch raises)."""
    tree = torch.load(_file(path), map_location="cpu", weights_only=True)
    return tree if like is None else _like(tree, like)


def maybe_restore(path: str, like: Any | None = None) -> tuple[Any, bool]:
    """Restore if a checkpoint exists, else ``(like, False)``."""
    try:
        if not os.path.isfile(_file(path)):
            return like, False
        return restore(path, like), True
    except Exception:  # noqa: BLE001 — the reference's bare except contract
        return like, False
