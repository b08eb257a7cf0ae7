"""Closed-loop bulk serving through the ViT embedder: ``pipeline_closed``'s
traffic, window and tail, with the check made for ``systems/vit_mtcnn``.

For each captured call, the towers, the cascade, the chips and the found
mask are checked as ``serving_check.check_call`` checks them
(``towers_gap``, ``crops_gap``, ``chip_gap``, ``found_mismatch``), with
``FaceModel``'s rule that a photo whose chosen landmarks coincide is not
found (``serving_check`` would warp it by a singular similarity); the
reference ViT (``reference/vit.py``) embeds the program's chips
(``embed_gap``, the widest L2 distance between the unit embeddings); and
the reference attention core, teacher-forced with the program's own q, k
and v in the first and the last block, gives ``attn_gap``: the widest
|program - reference| of the core's output over the widest |reference|.

``substitute``: the control, as in ``serving_check``; the attention
cores' outputs are replaced too.
"""

from __future__ import annotations

import torch

from bench_torch.drivers import pipeline_closed
from bench_torch.drivers.serving_check import _gap, _tower_gap, merge
from bench_torch.reference import mtcnn as ref_mtcnn
from bench_torch.reference import vit as ref_vit
from bench_torch.reference.numerics import Numerics


class Driver(pipeline_closed.Driver):
    def check(self, nx, substitute=None) -> dict:
        if not self.captured:
            raise RuntimeError("no pipeline call was captured in the window")
        return merge([check_call(self.sys, rec, nx, substitute)
                      for rec in self.captured])


def check_call(system, rec: dict, nx: Numerics,
               substitute: Numerics | None = None) -> dict:
    w, ccfg = system.weights, system.cfg["cascade"]
    heads = system.cfg["embedder"]["num_heads"]
    photos = rec["photos"].float()
    prog = {"pnet": [o for _, o in rec["pnet"]], "rnet": rec["rnet"][1],
            "onet": rec["onet"][1]}
    chips, emb = rec["embed"]
    cores = {k: v for k, v in rec.items() if k.startswith("attn.")}
    if not cores:
        raise RuntimeError("no attention core was captured in the call")
    if substitute is not None:
        prog = {"pnet": [ref_mtcnn.tower("pnet", w["pnet"], i, substitute)
                         for i, _ in rec["pnet"]],
                "rnet": ref_mtcnn.tower("rnet", w["rnet"], rec["rnet"][0],
                                        substitute),
                "onet": ref_mtcnn.tower("onet", w["onet"], rec["onet"][0],
                                        substitute)}
        emb = ref_vit.embed(w["embed"], chips, heads, substitute)
        cores = {k: (qkv, ref_vit.core(*qkv, substitute))
                 for k, (qkv, _) in cores.items()}
    towers = 0.0
    for (inp, _), out in zip(rec["pnet"], prog["pnet"]):
        towers = max(towers, _tower_gap(
            out, ref_mtcnn.tower("pnet", w["pnet"], inp, nx)))
    for name in ("rnet", "onet"):
        towers = max(towers, _tower_gap(
            prog[name], ref_mtcnn.tower(name, w[name], rec[name][0], nx)))

    inputs, marks, found = ref_mtcnn.cascade(photos, ccfg, prog)
    crops = max(_gap(a, b) for a, (b, _) in zip(inputs["pnet"],
                                                rec["pnet"]))
    for name in ("rnet", "onet"):
        ref_in, live = inputs[name]
        crops = max(crops, _gap(ref_in[live], rec[name][0].float()[live]))
    # A photo whose chosen landmarks coincide (a zero-size box) has no
    # similarity onto the template (scale 0): it is not found, and only
    # the found photos are warped (the others' chips are zero).
    size = tuple(ccfg["output_size"])
    mats = ref_mtcnn.similarity(marks, ref_mtcnn.template(size))
    found = found & (mats[:, 0, 0] ** 2 + mats[:, 1, 0] ** 2 > 0)
    ref_chips = torch.zeros_like(chips, dtype=torch.float64)
    if found.any():
        ref_chips[found] = ref_mtcnn.chips(photos[found], marks[found],
                                           found[found], size)
    prog_found = chips.flatten(1).abs().amax(1) > 0
    ref_emb = ref_vit.embed(w["embed"], chips, heads, nx)
    attn = 0.0
    for qkv, out in cores.values():
        ref = ref_vit.core(*qkv, nx)
        attn = max(attn, _gap(out, ref) / float(ref.abs().max()))
    return {"towers_gap": towers, "crops_gap": crops,
            "chip_gap": _gap(chips.double(), ref_chips),
            "found_mismatch": float((prog_found != found).sum()),
            "embed_gap": float(torch.linalg.vector_norm(
                emb.float() - ref_emb, dim=1).max()),
            "attn_gap": attn,
            "faces": photos.shape[0]}
