"""The check of what the serving path produced, shared by the serving
drivers.

For each captured pipeline call: every tower is run by the reference on
the inputs the program gave it (``towers_gap``, the widest gap of a
probability, regression or landmark output); the reference cascade,
teacher-forced with the program's tower outputs, recomputes every tower
input (``crops_gap``, in the towers' scaled units), the chosen landmarks
and the found mask, and warps the photos onto the template
(``chip_gap``, pixel levels, against the chips the embedder received;
``found_mismatch``, photos whose found flag differs); the reference
ArcFace embeds the program's chips (``embed_gap``, the widest L2 distance
between the unit embeddings).

``substitute``: the control.  The program's tower outputs and embeddings
are replaced by the reference's own, computed in that (lower) precision.
"""

from __future__ import annotations

import torch

from bench_torch.reference import arcface as ref_arcface
from bench_torch.reference import mtcnn as ref_mtcnn
from bench_torch.reference.numerics import Numerics


def _gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _tower_gap(out, ref) -> float:
    return max(_gap(o, r) for o, r in zip(out, ref))


def check_call(system, rec: dict, nx: Numerics,
               substitute: Numerics | None = None) -> dict:
    w, ccfg = system.weights, system.cfg["cascade"]
    photos = rec["photos"].float()
    prog = {"pnet": [o for _, o in rec["pnet"]], "rnet": rec["rnet"][1],
            "onet": rec["onet"][1]}
    chips, emb = rec["embed"]
    if substitute is not None:
        prog = {"pnet": [ref_mtcnn.tower("pnet", w["pnet"], i, substitute)
                         for i, _ in rec["pnet"]],
                "rnet": ref_mtcnn.tower("rnet", w["rnet"], rec["rnet"][0],
                                        substitute),
                "onet": ref_mtcnn.tower("onet", w["onet"], rec["onet"][0],
                                        substitute)}
        emb = ref_arcface.embed(w["embed"], chips,
                                system.cfg["embedder"]["stage_sizes"],
                                substitute)
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
    ref_chips = ref_mtcnn.chips(photos, marks, found,
                                tuple(ccfg["output_size"]))
    prog_found = chips.flatten(1).abs().amax(1) > 0
    ref_emb = ref_arcface.embed(w["embed"], chips,
                                system.cfg["embedder"]["stage_sizes"], nx)
    return {"towers_gap": towers, "crops_gap": crops,
            "chip_gap": _gap(chips.double(), ref_chips),
            "found_mismatch": float((prog_found != found).sum()),
            "embed_gap": float(torch.linalg.vector_norm(
                emb.float() - ref_emb, dim=1).max()),
            "faces": photos.shape[0]}


def merge(results: list[dict]) -> dict:
    """The widest gap of each number over the calls (counts add)."""
    out: dict = {}
    for r in results:
        for k, v in r.items():
            if k in ("found_mismatch", "faces"):
                out[k] = out.get(k, 0) + v
            else:
                out[k] = max(out.get(k, 0.0), v)
    return out
