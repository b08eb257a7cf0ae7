"""Tensor-parallel ArcFace embedding: the Megatron split of the LResNetE
unit over the ``model`` axis (counterpart of ``alink_tpu/parallel/tp.py``).

For the regime data parallelism cannot reach: one small batch at minimum
latency, where the ``model`` axis must shrink the time per example.  The
improved-residual unit maps onto the column/row split with exactly ONE
collective per unit:

- ``conv.0`` (3x3, stride 1) is column-parallel: its weight, torch's
  ``(out, in, kh, kw)``, is split on dim 0, and each rank computes its
  slice of the channels;
- ``bn.1`` and ``prelu.0`` act per channel, so their tensors split the
  same way and apply locally;
- ``conv.1`` (3x3, stride s) is row-parallel: its weight is split on dim
  1, each rank contracts its slice of the channels, and one all-reduce
  over ``model`` restores the full activation;
- ``bn.0``, ``bn.2``, the 1x1 projection and its ``bn.3`` see the full
  channels and run replicated, as do the stem and the head.

Each rank runs the model's own unit (``_IRUnit.forward`` with the
all-reduce as its ``reduce``) on its slices of those tensors
(``functional_call``), so at ``model == 1`` the forward is bit-equal to
``ArcFaceResNet100.forward``.  Widths that do not divide the axis are
zero-padded (``_pad_unit_params``), exactly.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from alink_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, axis_size,
                                           block, coordinate, gather_axis,
                                           sum_axis)

# The split dim of each sharded tensor of a unit (torch layouts).
_UNIT_SHARDS = {"conv.0.weight": 0, "bn.1.gamma": 0, "bn.1.beta": 0,
                "bn.1.mean": 0, "bn.1.var": 0, "prelu.0.alpha": 0,
                "conv.1.weight": 1}


def _unit_strides(stage_sizes) -> tuple[int, ...]:
    return tuple(2 if b == 0 else 1
                 for blocks in stage_sizes for b in range(blocks))


def tp_param_specs(params) -> dict[str, int | None]:
    """{state-dict key: the dim it is split on over ``model``, or None
    (replicated)} of an ArcFace module or state dict: the counterpart of
    the JAX package's PartitionSpec tree."""
    keys = params.state_dict() if isinstance(params, nn.Module) else params
    specs = {}
    for key in keys:
        m = re.fullmatch(r"units\.\d+\.(.+)", key)
        specs[key] = _UNIT_SHARDS.get(m.group(1)) if m else None
    return specs


def _pad_unit(tensors: dict, n_ranks: int) -> dict:
    """One unit's split tensors (keyed by ``_UNIT_SHARDS``' names) with
    the unit's width zero-padded up to a multiple of ``n_ranks``."""
    pad = -tensors["conv.0.weight"].shape[0] % n_ranks
    if not pad:
        return tensors
    out = {"conv.0.weight": F.pad(tensors["conv.0.weight"],
                                  (0, 0, 0, 0, 0, 0, 0, pad)),
           "conv.1.weight": F.pad(tensors["conv.1.weight"],
                                  (0, 0, 0, 0, 0, pad)),
           "prelu.0.alpha": F.pad(tensors["prelu.0.alpha"], (0, pad),
                                  value=1.0)}
    for name, fill in (("gamma", 0.0), ("beta", 0.0), ("mean", 0.0),
                       ("var", 1.0)):
        out[f"bn.1.{name}"] = F.pad(tensors[f"bn.1.{name}"], (0, pad),
                                    value=fill)
    return out


def _pad_unit_params(params: dict, n_ranks: int) -> dict:
    """A state dict whose split unit widths are zero-padded up to
    multiples of ``n_ranks``.

    Only the split tensors change: ``conv.0``'s output channels (zero
    weights -> the padded activations are 0), ``bn.1`` (gamma, beta and
    mean 0, var 1 -> 0 maps to 0), ``prelu.0`` (alpha 1 -> 0 stays 0) and
    ``conv.1``'s input channels (zeros -> the dead channels add nothing to
    the row-parallel contraction).  Exact: every padded lane carries 0
    through the unit.  The identity when every width divides."""
    out = dict(params)
    for key in params:
        m = re.fullmatch(r"(units\.\d+\.)conv\.0\.weight", key)
        if m is not None:
            unit = m.group(1)
            out.update((unit + k, v) for k, v in _pad_unit(
                {k: params[unit + k] for k in _UNIT_SHARDS}, n_ranks).items())
    return out


def check_topology(model, stage_sizes=None, dtype=None,
                   stage_widths=None) -> None:
    """The JAX functions take the topology beside a parameter tree; the
    port's module carries it, so a given one must agree."""
    for name, want in (("stage_sizes", stage_sizes),
                       ("stage_widths", stage_widths)):
        if want is not None and tuple(want) != getattr(model, name):
            raise ValueError(f"{name} {tuple(want)} differ from the model's "
                             f"{getattr(model, name)}")
    if dtype is not None and dtype != model.dtype:
        raise ValueError(f"dtype {dtype} differs from the model's "
                         f"{model.dtype}: build the model in that dtype")


@torch.no_grad()
def arcface_tp_apply(mesh, model, images, *, stage_sizes=None,
                     dtype=None) -> torch.Tensor:
    """Tensor- and data-parallel ArcFace forward over a (data, model) mesh.

    ``model``: an ``ArcFaceResNet100`` (any depth and widths), replicated
    on every rank; ``images``: (N, H, W, 3) raw RGB, N divisible by the
    ``data`` axis.  Every rank passes the same ``images`` and gets the
    (N, embedding_dim) embeddings.  ``stage_sizes`` and ``dtype`` are the
    model's own (checked).  Equals ``model(images)`` up to the all-reduce's
    summation order across channel blocks (bit-equal at model 1).
    """
    check_topology(model, stage_sizes, dtype)
    nd, k = axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)
    d, m = coordinate(mesh)
    images = torch.as_tensor(images)
    n = images.shape[0]
    if n % nd:
        raise ValueError(f"batch {n} must divide the data axis {nd}")

    def reduce(y):
        return sum_axis(y, mesh, MODEL_AXIS)

    dev = next(model.parameters()).device
    x = model.stem(block(images, nd, d).to(dev))
    for unit in model.units:
        if k == 1:  # every slice is the whole tensor, the all-reduce a no-op
            x = unit(x)
            continue
        named = dict(unit.named_parameters())
        named.update(unit.named_buffers())
        padded = _pad_unit({name: named[name] for name in _UNIT_SHARDS}, k)
        shards = {}
        for name, dim in _UNIT_SHARDS.items():
            size = padded[name].shape[dim] // k
            shards[name] = padded[name].narrow(dim, m * size, size)
        x = functional_call(unit, shards, (x,), {"reduce": reduce})
    return gather_axis(model.head(x), mesh, DATA_AXIS)
