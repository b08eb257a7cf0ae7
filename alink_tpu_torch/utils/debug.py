"""Opt-in numeric sanitizers (counterpart of ``alink_tpu/utils/debug.py``;
SURVEY.md section 5.2).

The reference has no NaN/Inf detection anywhere: a diverged finetune or a
degenerate noise channel silently poisons every later selection round.
Here the loop's selection and finetune outputs can be guarded by an opt-in
check (``ALinkConfig.debug_nans`` or ``enable_nan_guard()``): one
``torch.isfinite(...).all()`` reduction per floating leaf, stacked into one
flag per device, a single host sync, and a ``FloatingPointError`` naming the
phase that produced the first non-finite value.

Off by default: the host sync stalls the CUDA stream once per guarded
phase, which is why it is a debug mode and not an always-on assert.  Unlike
``torch.autograd.set_detect_anomaly`` it re-runs nothing; only outputs are
inspected.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from alink_tpu_torch.utils.tree import map_leaves

_ENABLED = False


def enable_nan_guard(on: bool = True) -> None:
    """Globally switch the guard (process-wide; also settable per-loop
    via ``ALinkConfig.debug_nans``)."""
    global _ENABLED
    _ENABLED = bool(on)


def nan_guard_enabled() -> bool:
    return _ENABLED


def _leaves(tree) -> list:
    """Floating tensors and numpy arrays of a module's state dict or of
    nested dicts, tuples and lists, in order."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    found: list = []
    map_leaves(found.append, tree)
    return [x.detach() if isinstance(x, torch.Tensor) else x for x in found
            if (x.is_floating_point() if isinstance(x, torch.Tensor)
                else np.issubdtype(x.dtype, np.inexact))]


def _finite(x) -> bool:
    if isinstance(x, np.ndarray):
        return bool(np.isfinite(x).all())
    return bool(torch.isfinite(x).all())


def check_finite(tree, phase: str, *, force: bool = False) -> None:
    """Raise ``FloatingPointError`` if any floating leaf of ``tree``
    contains a NaN/Inf.  No-op unless the guard is enabled (or
    ``force=True``).  One reduction per leaf and one host sync per device."""
    if not (_ENABLED or force):
        return
    leaves = _leaves(tree)
    flags: dict[torch.device, list] = {}
    ok = True
    for x in leaves:
        if isinstance(x, np.ndarray):
            ok = ok and bool(np.isfinite(x).all())
        else:
            flags.setdefault(x.device, []).append(torch.isfinite(x).all())
    ok = ok and all(bool(torch.stack(f).all()) for f in flags.values())
    if not ok:
        # Second pass only on failure: name the offending leaves.
        bad = [f"leaf[{i}] shape={tuple(x.shape)} dtype={x.dtype}"
               for i, x in enumerate(leaves) if not _finite(x)]
        raise FloatingPointError(
            f"nan-guard: non-finite values in phase '{phase}': "
            + "; ".join(bad))
