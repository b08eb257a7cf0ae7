"""The (data, model) mesh and its shardings on ``torch.distributed``
(counterpart of ``alink_tpu/parallel/mesh.py``).

One rank drives one device.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks with the dimension
names ``("data", "model")``:

- ``data`` shards the leading batch axis of images, features and pair
  pools, and the rows of the pairwise score grid;
- ``model`` shards the committee's members, the columns of the score grid
  and the channels of ArcFace's tensor-parallel units (``tp.py``), and
  carries the pipeline's stages (``pp.py``).

A collective over one axis is a collective over
``mesh.get_group(DATA_AXIS)`` or ``mesh.get_group(MODEL_AXIS)``: NCCL for
CUDA tensors, gloo for CPU tensors.  A sharded array is a ``DTensor`` with
``Shard(0)`` / ``Replicate()`` placements.

``create_mesh`` in a plain process, with no process group and no launcher
environment, makes a world-1 group of its own from a ``HashStore`` (gloo on
the CPU, NCCL on a CUDA mesh), so every axis has a real group and the
sharded ops run one code path at any world size.  A collective over an
axis of one rank is the identity and is skipped (on the card each NCCL
call costs ~0.35 ms of host time, which a world-1 path would pay for
nothing).  Under a launcher (``WORLD_SIZE`` > 1) ``create_mesh`` brings
the launcher's group up first (``distributed.initialize``).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from alink_tpu_torch.utils.tree import map_leaves

DATA_AXIS = "data"
MODEL_AXIS = "model"


def default_device_type() -> str:
    """``"cuda"`` where a card is present, else ``"cpu"``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def backend_for(device_type: str) -> str:
    """The collective backend of a device type: NCCL for CUDA (an error
    where this PyTorch has none: there is no gloo fallback for CUDA
    tensors), gloo for the CPU."""
    if device_type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, which this PyTorch "
                               "build lacks")
        return "nccl"
    if device_type != "cpu":
        raise ValueError(f"no collective backend for {device_type!r}")
    return "gloo"


def ensure_process_group(device_type: str) -> None:
    """Bring up the default process group if none exists: the launcher's
    world when ``WORLD_SIZE`` > 1, else a world of this process alone."""
    if dist.is_initialized():
        return
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from alink_tpu_torch.parallel.distributed import initialize

        initialize()
        return
    dist.init_process_group(backend_for(device_type), store=dist.HashStore(),
                            rank=0, world_size=1)


def infer_shape(mesh_shape: Sequence[int], n: int) -> tuple[int, int]:
    """``(data, model)`` for ``n`` ranks: a 1-dim shape gets model 1, a
    ``-1`` entry is inferred like a reshape; ``ValueError`` for 3 or more
    dims or a shape that does not cover the ``n`` ranks."""
    shape = tuple(mesh_shape)
    if len(shape) == 1:
        shape = (shape[0], 1)
    if len(shape) != 2:
        raise ValueError(f"mesh_shape must have 1 or 2 dims, got {mesh_shape}")
    known = int(np.prod([s for s in shape if s != -1]))
    shape = tuple(n // known if s == -1 else s for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    return shape


def mesh_from_grid(grid: np.ndarray, device_type: str):
    """A (data, model) ``DeviceMesh`` over the rank grid ``grid``."""
    from torch.distributed.device_mesh import DeviceMesh

    ensure_process_group(device_type)
    if device_type == "cuda":
        # The rank's card before the mesh's groups come up (NCCL binds
        # its communicators to the current device).
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", torch.cuda.current_device())))
    return DeviceMesh(device_type, torch.as_tensor(grid, dtype=torch.int64),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def create_mesh(mesh_shape: Sequence[int] = (-1,),
                devices: Sequence[int] | None = None,
                device_type: str | None = None):
    """A (data, model) mesh over ranks.

    ``mesh_shape`` is ``(data,)`` or ``(data, model)``; a ``-1`` entry is
    inferred from the rank count.  ``devices`` is a list of ascending ranks
    (default: every rank of the world); ``device_type`` is ``"cuda"`` or
    ``"cpu"`` (default: ``"cuda"`` where a card is present).  Every rank
    of the world calls it (the groups are made collectively); a rank
    outside ``devices`` gets a mesh it has no coordinate in.  One process
    gives a 1 x 1 mesh.
    """
    device_type = device_type or default_device_type()
    ensure_process_group(device_type)
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    if any(b <= a for a, b in zip(ranks, ranks[1:])):
        # A group numbers its ranks in ascending order; an axis's
        # coordinates must follow it for the gathers to assemble in order.
        raise ValueError(f"devices must be ascending ranks, got {ranks}")
    shape = infer_shape(mesh_shape, len(ranks))
    return mesh_from_grid(np.asarray(ranks).reshape(shape), device_type)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def coordinate(mesh) -> tuple[int, int]:
    """This rank's (data, model) coordinate; ``ValueError`` outside the
    mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in {mesh}")
    return int(coord[0]), int(coord[1])


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on: its current CUDA device on
    a CUDA mesh, the CPU otherwise."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class Sharding(NamedTuple):
    """Where a sharded array lives: the mesh and one ``DTensor`` placement
    per mesh axis (``Shard(0)`` / ``Replicate()``), the counterpart of a
    ``NamedSharding``."""

    mesh: object
    placements: tuple


def batch_sharding(mesh, ndim: int = 1) -> Sharding:
    """The leading axis split over ``data``, replicated over ``model`` and
    in every other axis: the layout of image, feature and pair batches.
    ``ndim`` (the arrays' rank) is the JAX signature's: the placements do
    not depend on it."""
    from torch.distributed.tensor import Replicate, Shard

    del ndim
    return Sharding(mesh, (Shard(0), Replicate()))


def replicated_sharding(mesh) -> Sharding:
    from torch.distributed.tensor import Replicate

    return Sharding(mesh, (Replicate(), Replicate()))


def axis_group(mesh, axis: str, x: torch.Tensor | None = None):
    """The process group of one mesh axis.  A CUDA tensor ``x`` needs an
    NCCL group: a sharded op never moves a shard to the CPU to reach a
    collective."""
    group = mesh.get_group(axis)
    if x is not None and x.is_cuda and "nccl" not in str(
            dist.get_backend(group)):
        raise RuntimeError(f"CUDA tensor on a {dist.get_backend(group)} "
                           f"group: a CUDA mesh needs NCCL")
    return group


def gather_axis(x: torch.Tensor, mesh, axis: str,
                dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along one mesh axis, concatenated on ``dim`` in
    the axis's order (``all_gather``); ``x`` itself on an axis of one
    rank."""
    group = axis_group(mesh, axis, x)
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def sum_axis(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` summed over one mesh axis, in place (``all_reduce``): the
    counterpart of ``psum``; ``x`` itself on an axis of one rank."""
    group = axis_group(mesh, axis, x)
    if dist.get_world_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


def block(x: torch.Tensor, parts: int, index: int) -> torch.Tensor:
    """Block ``index`` of ``parts`` equal blocks of x's leading axis (a
    view)."""
    rows = x.shape[0] // parts
    return x[index * rows:(index + 1) * rows]


def pad_axis0(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad the leading axis up to a multiple of ``multiple``: the one
    padding policy every parallel path shares."""
    pad = (-x.shape[0]) % multiple
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x


def local_rows(x, sharding: Sharding) -> tuple[torch.Tensor, torch.Size]:
    """(this rank's part of ``x`` under ``sharding``, x's global shape):
    its own rows where the placement shards, the whole array where it
    replicates.  The rows must divide over ``data``."""
    x = torch.as_tensor(x)
    nd = axis_size(sharding.mesh, DATA_AXIS)
    if not any(p.is_shard() for p in sharding.placements):
        return x, x.shape
    if x.dim() == 0 or x.shape[0] % nd:
        raise ValueError(f"an array of shape {tuple(x.shape)} does not "
                         f"split over a data axis of {nd}")
    return block(x, nd, coordinate(sharding.mesh)[0]), x.shape


def from_local(local: torch.Tensor, sharding: Sharding, shape):
    """A ``DTensor`` of global ``shape`` from this rank's ``local`` part
    under ``sharding``, with no communication."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local.contiguous(), sharding.mesh,
                              sharding.placements, run_check=False,
                              shape=shape, stride=stride)


def shard_batch(mesh, tree):
    """Place every tensor / array leaf batch-sharded on the mesh, its
    leading axis zero-padded up to a multiple of the ``data`` axis.
    Returns ``(sharded_tree, original_lengths_tree)`` so callers can mask
    out the padding."""
    nd = axis_size(mesh, DATA_AXIS)
    sharding = batch_sharding(mesh)

    def _place(x):
        local, shape = local_rows(pad_axis0(torch.as_tensor(x), nd),
                                  sharding)
        return from_local(local.to(mesh_device(mesh)), sharding, shape)

    return map_leaves(_place, tree), map_leaves(lambda x: x.shape[0], tree)
