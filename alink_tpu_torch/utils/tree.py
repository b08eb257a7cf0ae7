"""The one walker over nested containers that the port's checkpoints,
prefetcher and NaN guard share."""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to the array leaves (numpy arrays and tensors) of nested
    dicts, tuples and lists, keeping the containers' types; other leaves
    pass through."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree
