"""Mesh-sharded bulk passes (counterpart of ``alink_tpu/parallel/ops.py``).

Calling convention, shared by every sharded op of the port: every rank of
the mesh calls it with the same full input, computes its own shard on its
own device, and returns the full result (what JAX's single controller
returns), assembled by ``all_gather`` over the mesh's axes.

- ``sharded_featurize``       — embedding extraction, the batch split over
  both axes (no collective until the gather);
- ``sharded_face_pipeline``   — detect -> align -> embed the same way;
- ``sharded_committee_probs`` — committee members split over ``model``,
  the batch over ``data``; the mean is a ``model`` all-reduce of member
  sums divided by the member count;
- the pairwise score grid is ``ops.pairwise.score_matrix_sharded`` (rows
  over ``data``, columns over ``model``).
"""

from __future__ import annotations

from typing import Callable

import torch

from alink_tpu_torch.active.committee import Committee
from alink_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, axis_size,
                                           block, coordinate, gather_axis,
                                           pad_axis0, sum_axis)


def sharded_featurize(mesh, featurize: Callable[[torch.Tensor], torch.Tensor],
                      images) -> torch.Tensor:
    """``featurize`` with the batch split across the whole mesh.

    Both axes split the batch (a featurizer has no model axis): the batch
    is zero-padded to a multiple of the mesh size, rank (d, m) runs block
    ``d * model + m``, and the result keeps the original length.
    """
    images = torch.as_tensor(images)
    nd, nm = axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)
    d, m = coordinate(mesh)
    n = images.shape[0]
    out = featurize(block(pad_axis0(images, nd * nm), nd * nm, d * nm + m))
    out = gather_axis(gather_axis(out, mesh, MODEL_AXIS), mesh, DATA_AXIS)
    return out[:n]


def sharded_face_pipeline(mesh, face_model, images) -> torch.Tensor:
    """Detect -> align -> embed (``FaceModel.pipeline``) with the image
    batch split over the mesh; no collective until the gather, as the
    pipeline is per image."""
    return sharded_featurize(mesh, face_model.pipeline, images)


def sharded_committee_probs(mesh, head, stacked_params: dict,
                            left: torch.Tensor,
                            right: torch.Tensor) -> torch.Tensor:
    """Committee mean probabilities, (N, 2), with members split over
    ``model`` and pairs over ``data``.

    Requires members % model == 0.  Each rank runs its members with
    ``Committee.member_probs`` (``functional_call`` under ``vmap``); the
    mean is an all-reduce of the member sums over ``model`` divided by the
    member count.
    """
    nd, nm = axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)
    e = next(iter(stacked_params.values())).shape[0]
    if e % nm != 0:
        raise ValueError(f"{e} members not divisible over model axis {nm}")
    d, m = coordinate(mesh)
    n = left.shape[0]
    members = {k: block(v, nm, m) for k, v in stacked_params.items()}
    probs = Committee(head, members).member_probs(
        block(pad_axis0(torch.as_tensor(left), nd), nd, d),
        block(pad_axis0(torch.as_tensor(right), nd), nd, d))
    mean = sum_axis(probs.sum(dim=0), mesh, MODEL_AXIS) / e
    return gather_axis(mean, mesh, DATA_AXIS)[:n]
