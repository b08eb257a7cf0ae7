"""The port's counterpart of the JAX package's ``__graft_entry__.py``:
``entry()``, the flagship forward (ArcFace r100 embeds both halves of a
batch of pairs, ``SiameseHead`` scores them), and ``dryrun_multichip``,
which runs the sharded training and evaluation paths on an n-rank world.

``dryrun_multichip`` runs, on a (n/2, 2) mesh (n even and > 2), else
(n, 1), at toy sizes:

- a SmallRes training step with the batch split over ``data``: each rank
  takes the loss of its rows (class weights from the whole batch), and
  the gradients are averaged over ``data`` by ``all_reduce`` before the
  step (JAX gets this from sharding propagation; here it is explicit);
  the replicas must stay equal;
- the committee, and the score grid sharded over both axes against the
  local grid;
- ``sharded_featurize`` and ``sharded_committee_probs`` against their
  local counterparts;
- one ``ALinkLoop.run_iteration`` with a mesh-sharded featurizer;
- ``sharded_face_pipeline`` (tiny cascade and ArcFace) against the local
  pipeline;
- on a model axis of 2 or more, tensor- and pipeline-parallel ArcFace
  against the local forward (within 1e-3);
- the multi-host layer: ``initialize``, ``create_multihost_mesh``,
  ``global_batch_from_local``, ``process_shard``.

Every rank of the world calls ``dryrun_multichip()`` inside its process
group; or spawn a gloo world on the CPU:

    python -m alink_tpu_torch.tools.dryrun_multichip --ranks 4

Under ``torchrun --nproc-per-node N`` it joins the launcher's world (NCCL
on cards).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from alink_tpu_torch import parallel as P
from alink_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, axis_size,
                                           block, coordinate,
                                           default_device_type,
                                           ensure_process_group, gather_axis,
                                           mesh_device, sum_axis)

# Agreement of each sharded path with its local counterpart on the CPU
# (f32): the sharded ops run the same arithmetic on blocks of the batch,
# and only the matmuls' and convolutions' blocking may differ with the
# block's size.
_LOCAL_TOL = 1e-5
_TP_PP_TOL = 1e-3   # as the JAX dry run holds TP and PP to the local forward


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _maxdiff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def entry(device="cuda"):
    """``(forward, example_args)`` for the flagship forward step: ArcFace
    r100 (bf16, 512-d) embeds the left and the right 112^2 images, and
    ``SiameseHead`` (512, 64) returns P(genuine) per pair, shape (N, 2).

    ``forward(embedder_state, head_state, left, right)`` runs both modules
    through ``torch.func.functional_call`` on the state dicts it is given;
    ``example_args`` holds the seeded random states (seed 0) and two
    batches of 8 zeros, on ``device`` (the card unless the caller passes
    ``"cpu"``)."""
    from torch.func import functional_call

    from alink_tpu_torch.drivers.common import resolve_device
    from alink_tpu_torch.models import ArcFaceResNet100, SiameseHead

    dev = resolve_device(device, "entry")
    g = torch.Generator().manual_seed(0)
    embedder = ArcFaceResNet100(generator=g, device=dev)
    head = SiameseHead(embedder.embedding_dim, generator=g, device=dev)
    example = torch.zeros((8, 112, 112, 3), device=dev)

    def forward(embedder_state, head_state, left, right):
        """Embed both halves with the shared backbone, score the pairs."""
        el = functional_call(embedder, embedder_state, (left,))
        er = functional_call(embedder, embedder_state, (right,))
        return functional_call(head, head_state, (el, er))

    return forward, (embedder.state_dict(), head.state_dict(), example,
                     example)


def dp_train_step(mesh, state, left, right, labels,
                  generator: torch.Generator) -> torch.Tensor:
    """One training step of ``state`` (a ``train.TrainState``) with the
    batch split over ``data``: the loss of this rank's rows, weighted by
    the whole batch's class weights, its gradients averaged over ``data``
    (``all_reduce``), then the optimizer's step on every replica.  Every
    rank passes the whole batch; the batch must divide over ``data``.
    Returns the batch's mean loss (averaged over ``data``)."""
    from alink_tpu_torch.train.losses import (binary_crossentropy,
                                              class_weights_from_labels,
                                              one_hot)

    nd = axis_size(mesh, DATA_AXIS)
    d, _ = coordinate(mesh)
    n = labels.shape[0]
    if n % nd:
        raise ValueError(f"batch {n} must divide the data axis {nd}")
    weights = class_weights_from_labels(labels)
    logits = state.logits(block(left, nd, d), block(right, nd, d),
                          train=True, generator=generator)
    loss = binary_crossentropy(logits, one_hot(block(labels, nd, d)),
                               block(weights, nd, d))
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for p in state.module.parameters():
        if p.grad is not None:
            sum_axis(p.grad, mesh, DATA_AXIS).div_(nd)
    state.optimizer.step()
    state.step += 1
    return sum_axis(loss.detach().clone(), mesh, DATA_AXIS) / nd


def _replicas_equal(mesh, module) -> bool:
    flat = torch.cat([p.detach().reshape(-1) for p in module.parameters()])
    every = gather_axis(gather_axis(flat[None], mesh, MODEL_AXIS), mesh,
                        DATA_AXIS)
    return bool((every == every[0]).all())


def dryrun_multichip(n_ranks: int | None = None) -> dict:
    """Every sharded path once on a mesh over the whole world (``n_ranks``,
    if given, must be its size); raises on any disagreement.  Returns what
    it checked, with each path's largest difference from its local
    counterpart."""
    from alink_tpu_torch import train as T
    from alink_tpu_torch.active import ALinkLoop, Committee
    from alink_tpu_torch.config import ALinkConfig
    from alink_tpu_torch.data.loader import PersonStacks
    from alink_tpu_torch.detect import (CascadeConfig, FaceModel,
                                        init_cascade_params)
    from alink_tpu_torch.models import ArcFaceResNet100, SiameseHead, SmallRes
    from alink_tpu_torch.ops.pairwise import (score_matrix,
                                              score_matrix_sharded)

    ensure_process_group(default_device_type())
    world = dist.get_world_size()
    if n_ranks is not None and n_ranks != world:
        raise ValueError(f"n_ranks {n_ranks} != the world's {world} ranks")
    device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    mesh_shape = (world // 2, 2) if world % 2 == 0 and world > 2 \
        else (world, 1)
    mesh = P.create_mesh(mesh_shape, device_type=device_type)
    nd, nm = axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)
    d, _ = coordinate(mesh)
    dev = mesh_device(mesh)
    f32 = torch.float32
    out = {"mesh": (nd, nm)}

    # -- a training step, the batch split over the data axis --------------
    g = torch.Generator().manual_seed(0)
    size = 12
    state = T.TrainState(SmallRes(feature_dim=16, dtype=f32,
                                  input_size=(size, size), generator=g,
                                  device=dev))
    batch = 2 * nd
    left = torch.rand((batch, size, size, 3), generator=g).to(dev)
    right = torch.rand((batch, size, size, 3), generator=g).to(dev)
    labels = (torch.arange(batch) % 2).to(dev)
    drop = torch.Generator(dev).manual_seed(100 + d)
    loss = dp_train_step(mesh, state, left, right, labels, drop)
    _check(bool(torch.isfinite(loss)), "training step gave a non-finite loss")
    _check(_replicas_equal(mesh, state.module),
           "the replicas differ after the data-parallel step")
    out["train_loss"] = float(loss)

    # -- committee on the model axis + the 2-D sharded score grid ---------
    dim = 24
    heads = [SiameseHead(dim, (16, 8), dtype=f32, generator=g, device=dev)
             for _ in range(max(2, nm))]
    com = Committee.from_param_list(heads[0], [h.state_dict()
                                               for h in heads])
    feats_l = torch.randn((4 * nd, dim), generator=g).to(dev)
    feats_r = torch.randn((4 * nd, dim), generator=g).to(dev)
    probs = com.predict(feats_l, feats_r)
    _check(probs.shape == (4 * nd, 2), f"committee shape {probs.shape}")
    scores = score_matrix_sharded(mesh, heads[0], feats_l, feats_r,
                                  row_block=4, col_block=4)
    _check(scores.shape == (4 * nd, 4 * nd)
           and bool(torch.isfinite(scores).all()), "sharded grid")
    out["grid_diff"] = _maxdiff(scores,
                                score_matrix(heads[0], feats_l, feats_r))
    _check(out["grid_diff"] <= _LOCAL_TOL, f"grid {out['grid_diff']}")

    # -- mesh-wide featurize + the model-axis committee --------------------
    imgs = torch.rand((2 * nd * nm, 6, 6, 3), generator=g).to(dev)
    feats = P.sharded_featurize(mesh, lambda x: x.reshape(x.shape[0], -1),
                                imgs)
    _check(torch.equal(feats, imgs.reshape(imgs.shape[0], -1)),
           "sharded featurize")
    com2 = Committee.from_param_list(heads[0], [
        SiameseHead(dim, (16, 8), dtype=f32, generator=g,
                    device=dev).state_dict() for _ in range(2 * nm)])
    probs2 = P.sharded_committee_probs(mesh, com2.head, com2.params, feats_l,
                                       feats_r)
    out["committee_diff"] = _maxdiff(probs2, com2.predict(feats_l, feats_r))
    _check(probs2.shape == (4 * nd, 2)
           and out["committee_diff"] <= _LOCAL_TOL,
           f"sharded committee {out['committee_diff']}")

    # -- one A-LINK iteration with a mesh-sharded featurizer ---------------
    size = 6
    dd = size * size * 3
    lhead = SiameseHead(dd, (8, 4), dtype=f32, generator=g, device=dev)
    loop_com = Committee.from_param_list(
        lhead, [SiameseHead(dd, (8, 4), dtype=f32, generator=g,
                            device=dev).state_dict() for _ in range(2)],
        noise_names=("gaussian",))
    cfg = ALinkConfig(noise=("gaussian",), image_res=(size, size),
                      feature_res=dd, alink_bs=2, batch_send=2, ft_epochs=1,
                      mixture_ratio=0, disparity_ratio=0.9, eps=0.01,
                      device_batch=16)

    def mesh_featurize(images):
        return P.sharded_featurize(mesh, lambda x: x.reshape(x.shape[0], -1),
                                   images)

    loop = ALinkLoop(cfg, featurize=mesh_featurize, committee=loop_com,
                     m2_state=T.TrainState(lhead), device=dev,
                     generator=torch.Generator(dev).manual_seed(33),
                     host_generator=torch.Generator().manual_seed(33))
    rng = np.random.default_rng(34)
    people = 2 * nd
    stacks = [PersonStacks(rng.uniform(0, 255, (people, 2, size, size, 3))
                           .astype(np.float32), np.full(people, 2, np.int32))
              for _ in range(2)]
    log = loop.run_iteration(*stacks)
    _check(log.pairs > 0 and loop.state.un_size == log.pairs,
           f"loop iteration {log}")
    out["loop_pairs"] = log.pairs

    # -- detect -> align -> embed sharded over the mesh --------------------
    tiny = ArcFaceResNet100(stage_sizes=(1, 1, 1, 1), embedding_dim=8,
                            dtype=f32, generator=g, device=dev)
    fmodel = FaceModel(tiny, init_cascade_params(g, f32, dev,
                                                 with_lnet=False),
                       CascadeConfig(thresholds=(0.0, 0.0, 0.0), min_size=24,
                                     stage1_scale_budget=8, stage1_budget=8,
                                     stage2_budget=4, stage3_budget=2))
    pipe_imgs = (torch.rand((nd * nm, 48, 48, 3), generator=g) * 255).to(dev)
    feats_pipe = P.sharded_face_pipeline(mesh, fmodel, pipe_imgs)
    _check(feats_pipe.shape == (nd * nm, 8)
           and bool(torch.isfinite(feats_pipe).all()), "face pipeline")
    out["pipeline_diff"] = _maxdiff(feats_pipe, fmodel.pipeline(pipe_imgs))
    _check(out["pipeline_diff"] <= _TP_PP_TOL,
           f"face pipeline {out['pipeline_diff']}")

    # -- tensor- and pipeline-parallel ArcFace over the model axis ---------
    if nm > 1:
        tp_imgs = (torch.rand((2 * nd, 112, 112, 3), generator=g)
                   * 255).to(dev)
        with torch.no_grad():
            want = tiny(tp_imgs)
        got = P.arcface_tp_apply(mesh, tiny, tp_imgs)
        out["tp_diff"] = _maxdiff(got, want)
        _check(got.shape == (2 * nd, 8) and out["tp_diff"] < _TP_PP_TOL,
               "tensor-parallel forward diverged from the local forward")
        if nm == 2:
            got = P.arcface_pp_apply(mesh, tiny, tp_imgs, microbatches=2)
            out["pp_diff"] = _maxdiff(got, want)
            _check(got.shape == (2 * nd, 8) and out["pp_diff"] < _TP_PP_TOL,
                   "pipeline-parallel forward diverged from the local "
                   "forward")

    # -- the multi-host layer -----------------------------------------------
    P.initialize()      # a no-op: the group exists
    mh = P.create_multihost_mesh(model=nm, device_type=device_type)
    rows = 4
    gb = P.global_batch_from_local(
        mh, np.full((rows, 3), float(coordinate(mh)[0]), np.float32))
    _check(gb.shape[0] == rows * axis_size(mh, DATA_AXIS),
           f"global batch {tuple(gb.shape)}")
    full = gb.full_tensor()
    _check(all(bool((full[i * rows:(i + 1) * rows] == i).all())
               for i in range(axis_size(mh, DATA_AXIS))),
           "global batch rows out of order")
    shard = torch.as_tensor(P.process_shard(10), device=dev)
    every = gather_axis(gather_axis(shard[None], mh, MODEL_AXIS), mh,
                        DATA_AXIS)
    _check(set(every.reshape(-1).tolist()) == set(range(10))
           and shard.numel() == -(-10 // world), "process_shard")
    return out


def _spawned(rank: int, world: int, rendezvous: str) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        out = dryrun_multichip(world)
        if rank == 0:
            print(f"dryrun_multichip: {out}", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ranks", type=int, default=None,
                        help="spawn a gloo world of this many ranks on the "
                        "CPU (default: join the launcher's world)")
    args = parser.parse_args(argv)
    if args.ranks is not None and "WORLD_SIZE" not in os.environ:
        import torch.multiprocessing as mp

        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(_spawned, args=(args.ranks,
                                               os.path.join(tmp, "rdzv")),
                               nprocs=args.ranks, start_method="spawn")
    else:
        P.initialize()
        out = dryrun_multichip(args.ranks)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(f"dryrun_multichip: {out}", flush=True)
    print("dryrun_multichip OK", flush=True)


if __name__ == "__main__":
    main()
