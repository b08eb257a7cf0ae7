"""Multi-host execution on ``torch.distributed`` (counterpart of
``alink_tpu/parallel/distributed.py``).

The JAX package runs one controller per host over all of that host's
devices.  Here one rank drives one device, and a host runs as many ranks
as it has cards (``torchrun --nproc-per-node N``), so "process" below
means a rank:

- ``initialize()``             — bring up the default process group (NCCL
  where CUDA is present, gloo otherwise); a no-op for one process, so
  every single-process path is unchanged;
- ``create_multihost_mesh()``  — a (data, model) mesh whose ``data`` axis
  is process-major (ranks are numbered host by host), and whose ``model``
  groups never cross a host;
- ``global_batch_from_local()``— every rank loads only its rows, and the
  rows assemble into one ``DTensor`` sharded over ``data`` with no data
  moved;
- ``process_shard()``          — the rows of a dataset a rank loads.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from alink_tpu_torch.parallel.mesh import (DATA_AXIS, axis_size,
                                           backend_for, batch_sharding,
                                           coordinate, default_device_type,
                                           ensure_process_group, from_local,
                                           mesh_device, mesh_from_grid)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the default process group (a no-op for one process, and
    when a group exists already).  Safe to call unconditionally at driver
    start.

    A cluster is detected from the explicit arguments or from a launcher's
    ``WORLD_SIZE`` > 1 (``torchrun`` also sets ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT``), never by touching a device.
    ``coordinator_address`` is ``host:port`` of rank 0's store
    (``tcp://``); without it the launcher's environment is read
    (``env://``).  With CUDA present each rank takes the card
    ``LOCAL_RANK`` (else ``rank`` modulo the card count) and the group is
    NCCL; otherwise it is gloo.
    """
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes == 1 or (coordinator_address is None
                              and num_processes is None and env_world <= 1):
        return
    if dist.is_initialized():
        return
    world = num_processes if num_processes is not None else env_world
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    device_type = default_device_type()
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend_for(device_type), init_method=init,
                            world_size=world, rank=rank)


def _rank_and_world() -> tuple[int, int]:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def multihost_shape(n: int, local: int, model: int) -> tuple[int, int]:
    """``(data, model)`` of the multi-host mesh over ``n`` ranks with
    ``local`` ranks per host; ``ValueError`` when ``model`` does not divide
    the ranks or one host's ranks."""
    if n % model:
        raise ValueError(f"{n} devices not divisible by model={model}")
    if model > local or local % model:
        # model <= local is not enough: with the process-major order, any
        # model that does not DIVIDE the per-host count puts some model
        # group on two hosts (e.g. 5 hosts x 8 ranks with model=5 groups
        # ranks {5,6,7} of host 0 with {8,9} of host 1), which is exactly
        # the cross-host committee exchange this check exists to prevent.
        raise ValueError(
            f"model axis ({model}) must divide one process's {local} "
            f"devices — the committee axis must not cross DCN")
    return n // model, model


def create_multihost_mesh(model: int = 1, device_type: str | None = None):
    """(data, model) mesh over every rank of the world.

    Ranks are numbered host-major (``torchrun`` numbers a host's ranks
    contiguously), so ``data`` is process-major and an all-reduce over it
    can run within each host and then across hosts; ``model`` (committee,
    score-grid columns) always stays within one host, whose ranks count
    ``LOCAL_WORLD_SIZE`` (default: the whole world, one host).
    """
    device_type = device_type or default_device_type()
    ensure_process_group(device_type)
    n = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    shape = multihost_shape(n, local, model)
    return mesh_from_grid(np.arange(n).reshape(shape), device_type)


def global_batch_from_local(mesh, local_batch):
    """This rank's rows as its shard of one global batch ``DTensor``,
    sharded over ``data`` (replicated over ``model``).

    ``local_batch``: this rank's rows (numpy or a tensor).  Every rank
    passes the same shape, and the ranks of one ``model`` group (one data
    coordinate) the same rows.  The global batch has ``data x local_rows``
    rows; no rank holds or sends another's rows.
    """
    local = torch.as_tensor(np.asarray(local_batch)).to(mesh_device(mesh))
    coordinate(mesh)  # raises for a rank outside the mesh
    shape = (local.shape[0] * axis_size(mesh, DATA_AXIS),) + tuple(
        local.shape[1:])
    return from_local(local, batch_sharding(mesh, local.dim()), shape)


def process_shard(n: int) -> np.ndarray:
    """Row indices of a length-``n`` dataset this rank should load.

    File listing is deterministic, so no coordination is needed.  Every
    rank gets EXACTLY ``ceil(n / P)`` rows (P ranks): ``global_batch_from_
    local`` needs equal local shapes, so when P does not divide n the tail
    ranks wrap around to the front rows (deterministic duplication, never
    truncation: every row is owned by some rank).
    """
    p, count = _rank_and_world()
    q = -(-n // count)
    return (p * q + np.arange(q)) % n
