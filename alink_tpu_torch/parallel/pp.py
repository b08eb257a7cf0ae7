"""Pipeline-parallel ArcFace inference: the R-rank GPipe schedule over the
``model`` axis (counterpart of ``alink_tpu/parallel/pp.py``).

Tensor parallelism splits every unit across ranks; pipeline parallelism
instead places a contiguous segment of units on each rank of the
``model`` axis and streams microbatches through them:

- tick t (M + R - 1 ticks for M microbatches): rank r runs its segment on
  the microbatch that entered the pipe at tick t - r, then hands the
  boundary activation to rank r + 1 in ONE send/recv pair
  (``batch_isend_irecv``);
- the boundary shapes differ per rank, so activations travel in one f32
  envelope (NHWC, flattened, zero-padded to the largest boundary) that
  each rank unpacks to its own boundary shape;
- the stem rides with segment 0, the head with segment R - 1, which
  broadcasts the embeddings over ``model``; the data shards are then
  gathered, so every rank returns the full result.

Parameters are replicated: every rank holds the model and runs its own
segment of it (``ArcFaceResNet100.stem``, its units, ``.head``: the one
copy of the topology the tensor-parallel split shares).  Ranks run only
the ticks that carry a microbatch for them; the bubble is (R-1)/(M+R-1).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from alink_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, axis_group,
                                           axis_size, block, coordinate,
                                           gather_axis)
from alink_tpu_torch.parallel.tp import _unit_strides, check_topology


def boundary_shape(split_after_unit: int, in_hw: int = 112,
                   stage_sizes=(3, 13, 30, 3),
                   stage_widths=(64, 128, 256, 512)) -> tuple[int, int]:
    """(spatial, channels) of the activation after unit
    ``split_after_unit`` (0-based; every stage entry halves the spatial
    dims)."""
    strides = _unit_strides(stage_sizes)
    widths = [w for blocks, w in zip(stage_sizes, stage_widths)
              for _ in range(blocks)]
    hw = in_hw
    for s in strides[: split_after_unit + 1]:
        hw //= s
    return hw, widths[split_after_unit]


def _default_splits(n_ranks: int, strides, widths, in_hw: int
                    ) -> tuple[int, ...]:
    """R-1 FLOP-balanced split points (the unit each segment ends at).

    Per-unit cost ~ hw^2 * c^2 at its stage; split k closes when the
    prefix cost first reaches k/R of the total, while always leaving at
    least one unit per remaining rank.
    """
    hw, costs = in_hw, []
    for s, w in zip(strides, widths):
        hw //= s
        costs.append(float(hw * hw * w * w))
    total = sum(costs)
    n_units = len(costs)
    splits, acc, i = [], 0.0, 0
    for k in range(1, n_ranks):
        target = total * k / n_ranks
        while acc < target and i < n_units - (n_ranks - k):
            acc += costs[i]
            i += 1
        splits.append(i - 1)
    return tuple(splits)


def pp_splits(n_ranks: int, n_data: int, batch: int, in_hw: int, *,
              stage_sizes, stage_widths, split_after_unit=None, splits=None,
              microbatches: int = 4) -> tuple[int, ...]:
    """The R-1 split points of the schedule, after the JAX function's five
    checks in its order (each a ``ValueError``)."""
    if n_ranks < 2:
        raise ValueError("pipeline parallelism needs a model axis of >= 2 "
                         f"ranks — got {n_ranks}")
    strides = _unit_strides(stage_sizes)
    n_units = len(strides)
    if n_units < n_ranks:
        raise ValueError(f"{n_units} units cannot fill {n_ranks} ranks")
    widths = [w for blocks, w in zip(stage_sizes, stage_widths)
              for _ in range(blocks)]
    if splits is None and split_after_unit is not None:
        if n_ranks != 2:
            raise ValueError("split_after_unit is the 2-rank spelling; "
                             f"pass splits= for {n_ranks} ranks")
        splits = (split_after_unit,)
    if splits is None:
        splits = _default_splits(n_ranks, strides, widths, in_hw)
    splits = tuple(splits)
    if len(splits) != n_ranks - 1 or sorted(set(splits)) != list(splits) \
            or not all(0 <= s < n_units - 1 for s in splits) \
            or any(b - a < 1 for a, b in zip(splits, splits[1:])):
        raise ValueError(
            f"splits {splits} must be {n_ranks - 1} ascending unit indices "
            f"leaving at least one unit on both ranks of every boundary "
            f"(units: {n_units})")
    if batch % (n_data * microbatches):
        raise ValueError(
            f"batch {batch} must divide data axis {n_data} x microbatches "
            f"{microbatches}")
    return splits


@torch.no_grad()
def arcface_pp_apply(mesh, model, images, *, stage_sizes=None,
                     stage_widths=None, split_after_unit: int | None = None,
                     splits: tuple[int, ...] | None = None,
                     microbatches: int = 4, dtype=None) -> torch.Tensor:
    """Pipelined ArcFace forward over the ``model`` axis (R >= 2 ranks).

    Segment r (a contiguous run of units; the stem rides with segment 0,
    the head with segment R-1) runs on model rank r.  ``splits`` is the
    R-1 ascending unit indices each segment ends after; it defaults to the
    FLOP balance of ``_default_splits``.  ``split_after_unit`` is the
    2-rank spelling of one split point.  The batch of (N, H, W, 3) raw RGB
    images, the same on every rank, must divide ``data x microbatches``;
    every rank returns the (N, embedding_dim) embeddings.
    ``stage_sizes``, ``stage_widths`` and ``dtype`` are the model's own
    (checked).
    """
    check_topology(model, stage_sizes, dtype, stage_widths)
    n_ranks, nd = axis_size(mesh, MODEL_AXIS), axis_size(mesh, DATA_AXIS)
    images = torch.as_tensor(images)
    n, in_hw = images.shape[0], images.shape[1]
    splits = pp_splits(n_ranks, nd, n, in_hw, stage_sizes=model.stage_sizes,
                       stage_widths=model.stage_widths,
                       split_after_unit=split_after_unit, splits=splits,
                       microbatches=microbatches)
    d, r = coordinate(mesh)
    mb = n // nd // microbatches
    dev = next(model.parameters()).device
    local = block(images, nd, d).to(dev)
    mbs = local.reshape((microbatches, mb) + tuple(local.shape[1:]))

    # Segment r runs units [starts[r], ends[r]); boundary r (the hop from
    # rank r to r + 1) carries the activation after unit ends[r] - 1.
    n_units = len(model.units)
    starts = (0,) + tuple(s + 1 for s in splits)
    ends = tuple(s + 1 for s in splits) + (n_units,)
    bshapes = [boundary_shape(e - 1, in_hw, model.stage_sizes,
                              model.stage_widths) for e in ends[:-1]]
    blens = [hw * hw * ch for hw, ch in bshapes]
    env_len = max(blens)
    group = axis_group(mesh, MODEL_AXIS, local)
    peer = [dist.get_global_rank(group, i) for i in range(n_ranks)]
    env = torch.zeros((mb, env_len), dtype=torch.float32, device=dev)
    embs = []
    for t in range(microbatches + n_ranks - 1):
        k = t - r                   # the microbatch this rank runs now
        ops = []
        if 0 <= k < microbatches:
            if r == 0:
                x = model.stem(mbs[k])
            else:
                hw, ch = bshapes[r - 1]
                x = env[:, :blens[r - 1]].reshape(mb, hw, hw, ch).permute(
                    0, 3, 1, 2).to(model.dtype)
            for i in range(starts[r], ends[r]):
                x = model.units[i](x)
            if r == n_ranks - 1:
                embs.append(model.head(x))
            else:
                flat = x.permute(0, 2, 3, 1).reshape(mb, -1).float()
                out = torch.zeros((mb, env_len), dtype=torch.float32,
                                  device=dev)
                out[:, :flat.shape[1]] = flat
                ops.append(dist.P2POp(dist.isend, out, peer[r + 1], group))
        if r > 0 and 0 <= t + 1 - r < microbatches:
            ops.append(dist.P2POp(dist.irecv, env, peer[r - 1], group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    emb = (torch.cat(embs) if r == n_ranks - 1 else
           torch.empty((n // nd, model.embedding_dim), dtype=torch.float32,
                       device=dev))
    dist.broadcast(emb, src=peer[n_ranks - 1], group=group)
    return gather_axis(emb, mesh, DATA_AXIS)
