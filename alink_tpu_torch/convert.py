"""JAX-package parameters -> the port's modules.

The JAX modules' parameters arrive as nested dicts of numpy arrays (a flax
``{"params": ...}`` tree after ``jax.tree.map(np.asarray, ...)``).  The
port's modules keep the flax creation order in ``nn.ModuleList``s, so the
mapping is by name:

    Conv_i -> conv.i      (kernel HWIO -> weight OIHW)
    Dense_i -> dense.i, hidden_i -> hidden.i, out -> out
                          (kernel (in, out) -> weight (out, in))
    _FrozenBN_i -> bn.i   (gamma, beta, mean, var)
    _PReLU_i -> prelu.i   (alpha)
    _IRUnit_i -> units.i, _Bottleneck_i -> blocks.i
    fc1_gamma, fc1_beta   (unchanged)

ArcFace flattens NHWC before fc1 in both packages, so fc1 needs no
permutation beyond the transpose.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

_MODULE_NAMES = {"Conv": "conv", "Dense": "dense", "_FrozenBN": "bn",
                 "_PReLU": "prelu", "_IRUnit": "units",
                 "_Bottleneck": "blocks", "hidden": "hidden"}


def _module_name(key: str) -> str:
    m = re.fullmatch(r"(.+)_(\d+)", key)
    if m and m.group(1) in _MODULE_NAMES:
        return f"{_MODULE_NAMES[m.group(1)]}.{m.group(2)}"
    if key == "out":
        return key
    raise KeyError(f"no port counterpart for parameter group {key!r}")


def _leaf(name: str, value: np.ndarray) -> tuple[str, torch.Tensor]:
    t = torch.from_numpy(np.array(value, dtype=np.float32))
    if name == "kernel":
        # HWIO -> OIHW for convolutions, (in, out) -> (out, in) for Dense.
        return "weight", t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()
    return name, t


def state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flatten a flax parameter tree into the port's state-dict names."""
    if "params" in params:
        params = params["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + _module_name(key) + ".")
            else:
                name, t = _leaf(key, value)
                out[prefix + name] = t.contiguous()

    walk(params, "")
    return out


def load_flax(module: nn.Module, params: Mapping) -> nn.Module:
    """Load JAX-package parameters into ``module`` (ArcFace, P/R/O-Net,
    VGGFaceResNet50 or SiameseHead); every tensor must match by name and shape
    (``load_state_dict(strict=True)`` raises otherwise)."""
    module.load_state_dict(state_dict_from_flax(params), strict=True)
    return module
