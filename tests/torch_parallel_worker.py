"""One rank of a gloo world for ``tests/test_torch_port_parallel_mp.py``.

Not a test module (no ``test_`` prefix): the test spawns N of these, each
its own OS process with its own rank, rendezvousing through a file under
the test's directory.  Each rank imports only torch and the port, runs
every case of its scenario in one process group, and writes its results
to ``<dir>/<scenario>_r<rank>.pt`` for the parent to compare with the JAX
package.  The inputs (weights, images) come from ``<dir>/inputs.pt``,
written by the parent.

    python tests/torch_parallel_worker.py SCENARIO RANK WORLD DIR

Scenarios:

- ``world4``: the sharded ops, the score grid, TP and PP on (2, 2),
  (1, 4) and (4, 1) meshes, the multi-host layer (two "hosts" of two
  ranks: ``LOCAL_WORLD_SIZE=2``), ``dryrun_multichip`` and the first half
  of an elastic restart (an uninterrupted run, and one slab saved);
- ``world2`` (started beside ``world4``): ``generate_matrix``'s sharded
  branch, the two-process collective, the elastic restart's resume on
  half the ranks once ``world4`` has saved its slab (``elastic.ready``),
  the heartbeat, then rank 1 dies abruptly and rank 0 must detect it
  through the heartbeat (``PeerFailure``), as ``tests/mp_worker.py``
  does.
"""

import os
import shutil
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


def _np(t):
    return t.detach().cpu().numpy()


class _Cases:
    """Runs each case, keeping its result or its traceback."""

    def __init__(self):
        self.out = {}

    def __call__(self, name, fn):
        try:
            self.out[name] = fn()
        except Exception:  # noqa: BLE001 — reported to the parent's test
            self.out[name] = {"error": traceback.format_exc()}


def _loop(mesh, inputs):
    """The elastic-restart loop (``tests/test_parallel.py``'s
    ``TestElasticRestart._make_loop``): a flatten featurizer sharded over
    ``mesh``, one committee member, the student and the replay stream from
    fixed seeds."""
    from alink_tpu_torch import parallel as P
    from alink_tpu_torch import train as T
    from alink_tpu_torch.active import ALinkLoop, Committee
    from alink_tpu_torch.config import ALinkConfig
    from alink_tpu_torch.models import SiameseHead

    size = 4
    d = size * size * 3
    g = torch.Generator().manual_seed(0)
    m2 = T.TrainState(SiameseHead(d, (16, 8), dtype=torch.float32,
                                  generator=g))
    member = SiameseHead(d, (16, 8), dtype=torch.float32, generator=g)
    com = Committee.from_param_list(member, [member.state_dict()],
                                    noise_names=("gaussian",))
    cfg = ALinkConfig(noise=("gaussian",), image_res=(size, size),
                      feature_res=d, alink_bs=2, batch_send=4, ft_epochs=1,
                      mixture_ratio=1, disparity_ratio=0.9, eps=0.01)

    def featurize(imgs):
        return P.sharded_featurize(mesh, lambda x: x.reshape(x.shape[0], -1),
                                   imgs)

    def replay():
        rng = np.random.default_rng(3)
        while True:
            yield ((rng.random((8, d)).astype(np.float32),
                    rng.random((8, d)).astype(np.float32)),
                   (rng.random(8) > 0.5).astype(np.int32))

    return ALinkLoop(cfg, featurize=featurize, committee=com, m2_state=m2,
                     replay_gen=replay(),
                     generator=torch.Generator().manual_seed(4),
                     host_generator=torch.Generator().manual_seed(5),
                     device="cpu"), inputs["elastic_plain"], \
        inputs["elastic_dig"]


def _loop_end(loop) -> dict:
    s = loop.state
    return {"counters": [s.active_count, s.un_size, s.pool_cursor],
            "m2": {k: _np(v) for k, v in
                   s.m2_state.module.state_dict().items()}}


def _arcface(sd, sizes, widths, hw, embed):
    from alink_tpu_torch.models import ArcFaceResNet100

    model = ArcFaceResNet100(sizes, widths, embed, torch.float32,
                             input_size=(hw, hw))
    model.load_state_dict(sd)
    return model


def world4(rank, inputs, cases, work):
    from alink_tpu_torch import parallel as P
    from alink_tpu_torch.active import Committee
    from alink_tpu_torch.detect import (CascadeConfig, FaceModel,
                                        init_cascade_params)
    from alink_tpu_torch.drivers.common import make_resnet50_featurizer
    from alink_tpu_torch.models import (ArcFaceResNet100, SiameseHead,
                                        VGGFaceResNet50)
    from alink_tpu_torch.ops.pairwise import (score_matrix,
                                              score_matrix_sharded)
    from alink_tpu_torch.parallel import mesh as M
    from alink_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    meshes = {s: P.create_mesh(s, device_type="cpu")
              for s in ((2, 2), (1, 4), (4, 1))}
    m22 = meshes[(2, 2)]
    cases("mesh", lambda: {s: (tuple(m.shape), M.coordinate(m))
                           for s, m in meshes.items()})

    w = torch.from_numpy(inputs["feat_w"])

    def tfeat(v):
        return torch.tanh(v.reshape(v.shape[0], -1) @ w)

    cases("featurize", lambda: _np(P.sharded_featurize(
        m22, tfeat, torch.from_numpy(inputs["feat_x"]))))

    def vgg():
        featurize, _ = make_resnet50_featurizer(model=VGGFaceResNet50(
            stage_sizes=(1, 1, 1, 1),
            generator=torch.Generator().manual_seed(1)))
        x = torch.from_numpy(inputs["vgg_x"])
        with torch.no_grad():
            return {"sharded": _np(P.sharded_featurize(m22, featurize, x)),
                    "local": _np(featurize(x))}

    cases("vgg", vgg)

    def pipeline():
        g = torch.Generator().manual_seed(2)
        fm = FaceModel(ArcFaceResNet100((1, 1, 1, 1), (16, 16, 32, 32), 8,
                                        torch.float32, generator=g),
                       init_cascade_params(g, torch.float32,
                                           with_lnet=False),
                       CascadeConfig.typical(thresholds=(0.0, 0.0, 0.0)))
        x = inputs["pipe_x"]
        return {"sharded": _np(P.sharded_face_pipeline(m22, fm, x)),
                "local": _np(fm.pipeline(x))}

    cases("pipeline", pipeline)

    head = SiameseHead(16, (8, 4), dtype=torch.float32)
    left = torch.from_numpy(inputs["com_left"])
    right = torch.from_numpy(inputs["com_right"])

    def committee(key):
        params = inputs[key]
        return {"sharded": _np(P.sharded_committee_probs(m22, head, params,
                                                         left, right)),
                "local": _np(Committee(head, params).predict(left, right))}

    cases("committee", lambda: committee("com_params"))
    cases("committee3", lambda: committee("com3_params"))

    def grid():
        gh = SiameseHead(16, (512, 64), dtype=torch.float32)
        gh.load_state_dict(inputs["grid_head"])
        rows = torch.from_numpy(inputs["grid_rows"])
        cols = torch.from_numpy(inputs["grid_cols"])
        return {"sharded": _np(score_matrix_sharded(m22, gh, rows, cols,
                                                    row_block=8)),
                "local": _np(score_matrix(gh, rows, cols))}

    cases("grid", grid)

    x_tp = torch.from_numpy(inputs["tp_x"])
    counts = {"all_reduce": 0}
    all_reduce = dist.all_reduce

    def counted(*a, **k):
        counts["all_reduce"] += 1
        return all_reduce(*a, **k)

    for name, spec in inputs["arcfaces"].items():
        model = _arcface(inputs[f"{name}_sd"], *spec)
        for shape in ((2, 2), (1, 4)):
            def tp(model=model, shape=shape):
                counts["all_reduce"] = 0
                dist.all_reduce = counted
                try:
                    out = P.arcface_tp_apply(meshes[shape], model, x_tp)
                finally:
                    dist.all_reduce = all_reduce
                return {"out": _np(out), "all_reduce": counts["all_reduce"]}

            cases(f"tp_{name}_{shape[0]}x{shape[1]}", tp)
        for shape, splits in (((2, 2), None), ((1, 4), None),
                              ((1, 4), (0, 2, 3))):
            cases(f"pp_{name}_{shape[0]}x{shape[1]}_{splits}",
                  lambda model=model, shape=shape, splits=splits: _np(
                      P.arcface_pp_apply(meshes[shape], model, x_tp,
                                         splits=splits, microbatches=2)))

    def multihost():
        out = {}
        for model in (1, 2, 3, 4):
            try:
                mh = P.create_multihost_mesh(model=model, device_type="cpu")
            except ValueError as e:
                out[model] = str(e)
                continue
            d, m = M.coordinate(mh)
            # The ranks of one model group pass the same rows.
            local = np.full((3, 2), 10.0 * d, np.float32)
            gb = P.global_batch_from_local(mh, local)
            out[model] = {"shape": tuple(mh.shape), "coord": (d, m),
                          "global": tuple(gb.shape),
                          "local": _np(gb.to_local()),
                          "full": _np(gb.full_tensor())}
        return out

    cases("multihost", multihost)
    cases("process_shard", lambda: {n: P.process_shard(n)
                                    for n in (9, 10, 103)})
    cases("dryrun", lambda: dryrun_multichip(4))

    def elastic():
        m41 = meshes[(4, 1)]
        loop_a, plain, dig = _loop(m41, inputs)
        loop_a.run(plain, dig, checkpoint_path=os.path.join(
            work, f"elastic_gt_r{rank}"))
        loop_b, _, _ = _loop(m41, inputs)
        loop_b.run_iteration(plain.take_people([0, 1]),
                             dig.take_people([0, 1]))
        loop_b.state.pool_cursor = loop_b.config.alink_bs
        if rank == 0:
            loop_b.save(os.path.join(work, "elastic"))
            # The 2-rank world, started beside this one, waits for it.
            open(os.path.join(work, "elastic.ready"), "w").close()
        dist.barrier()
        return _loop_end(loop_a)

    cases("elastic", elastic)


def world2(rank, inputs, cases, work, out_path):
    from alink_tpu_torch import parallel as P
    from alink_tpu_torch.models import SiameseHead
    from alink_tpu_torch.ops.pairwise import score_matrix
    from alink_tpu_torch.parallel import mesh as M
    from alink_tpu_torch.tools import generate_matrix
    from alink_tpu_torch.utils.resilience import Heartbeat, PeerFailure

    def grid():
        feats = inputs["grid_rows"]
        got = generate_matrix.restore_head_and_score(
            os.path.join(work, "grid_head"), feats, device="cpu")
        gh = SiameseHead(16)
        gh.load_state_dict(inputs["grid_head"])
        t = torch.from_numpy(feats)
        return {"sharded": _np(got), "local": _np(score_matrix(gh, t, t))}

    cases("generate_matrix", grid)

    def collective():
        mesh = P.create_multihost_mesh(model=1, device_type="cpu")
        local = np.full((4, 3), float(rank + 1), np.float32)
        garr = P.global_batch_from_local(mesh, local)
        return {"shape": tuple(mesh.shape), "global": tuple(garr.shape),
                "total": float(garr.sum().full_tensor()),
                "shard10": len(P.process_shard(10)),
                "shard9": len(P.process_shard(9)),
                "coord": M.coordinate(mesh)}

    cases("collective", collective)

    def elastic():
        ready = os.path.join(work, "elastic.ready")
        deadline = time.time() + 120
        while not os.path.exists(ready) and time.time() < deadline:
            time.sleep(0.1)
        path = os.path.join(work, f"elastic_r{rank}")
        shutil.copytree(os.path.join(work, "elastic"), path)
        loop, plain, dig = _loop(P.create_mesh((-1,), device_type="cpu"),
                                 inputs)
        loop.run(plain, dig, checkpoint_path=path)
        return _loop_end(loop)

    cases("elastic", elastic)

    hb = Heartbeat(os.path.join(work, "hb"), rank, 2)
    hb.beat()
    deadline = time.time() + 30
    while hb.check_peers(timeout_s=30.0, grace_s=0.0) and \
            time.time() < deadline:
        time.sleep(0.05)
    print(f"WORKER{rank}_OK", flush=True)
    torch.save(cases.out, out_path)
    dist.barrier()
    if rank == 1:
        print("WORKER1_ABRUPT_EXIT", flush=True)
        os._exit(0)    # no process-group shutdown, no more beats
    detected = None
    deadline = time.time() + 30
    while time.time() < deadline:
        hb.beat()
        try:
            hb.ensure_peers_alive(timeout_s=1.0)
        except PeerFailure as e:
            detected = e
            break
        time.sleep(0.2)
    cases.out["peer_failure"] = None if detected is None else str(detected)
    torch.save(cases.out, out_path)
    print(f"PEER_FAILURE_DETECTED: {detected}", flush=True)
    # Skip the group's shutdown: the dead peer would hang it.
    os._exit(0 if detected is not None else 1)


def main() -> None:
    scenario, rank, world, work = (sys.argv[1], int(sys.argv[2]),
                                   int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(max(1, 8 // (2 * world)))
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(work, 'rdzv_' + scenario)}",
        rank=rank, world_size=world)
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    cases = _Cases()
    out_path = os.path.join(work, f"{scenario}_r{rank}.pt")
    if scenario == "world4":
        world4(rank, inputs, cases, work)
    else:
        world2(rank, inputs, cases, work, out_path)
    torch.save(cases.out, out_path)
    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK{rank}_DONE", flush=True)


if __name__ == "__main__":
    main()
