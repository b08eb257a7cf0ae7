"""Closed-loop bulk serving through RetinaFace-R50: ``pipeline_closed``'s
traffic, window and tail, with the check made for ``systems/retina_r100``.

For each captured call (every photo):

- ``heads_gap``: the reference detector (``reference/retinaface.py``) on
  the program's photos against the program's three head outputs: per
  head the root-mean-square |program - reference| over the
  root-mean-square |reference|, the largest of the three; it holds the
  heads as a whole, where float8-rounded heads (at most 1/28 = 0.036 of
  the widest value each) stay near sound bf16 runs in the widest form;
- ``heads_max_gap``: per head the widest |program - reference| over the
  widest |reference|, the largest of the three; it holds every anchor of
  every photo, where a fault in a few photos or anchors hardly moves the
  root-mean-square over 256 x 16,800 anchors;
- ``boxes_gap``: the reference decode of the program's own head outputs
  against the program's boxes and landmarks of every anchor, in pixels;
- ``dets_mismatch`` (exact 0): the reference threshold, top-k, greedy NMS
  (a sequential loop) and keep-top-k, teacher-forced with the program's
  scores and boxes, against the program's kept set: the slots whose
  validity or anchor differ;
- ``chip_gap``, ``found_mismatch``, ``embed_gap``: each photo's best kept
  detection (the reference's), its landmarks decoded by the reference,
  warped by the reference onto the template against the program's chips
  (a photo whose landmarks coincide is not found, as in ``FaceModel``),
  and ``reference/arcface.py`` on the program's chips, as
  ``serving_check`` reads them.

``substitute``: the control.  The program's head outputs and embeddings
are replaced by the references' own in that (lower) precision, and the
teacher-forced post-process takes the scores and boxes of those heads.
"""

from __future__ import annotations

import torch

from bench_torch.drivers import pipeline_closed
from bench_torch.drivers.serving_check import _gap, merge
from bench_torch.reference import arcface as ref_arcface
from bench_torch.reference import mtcnn as ref_mtcnn
from bench_torch.reference import retinaface as ref_retina
from bench_torch.reference.numerics import Numerics


class Driver(pipeline_closed.Driver):
    def check(self, nx, substitute=None) -> dict:
        if not self.captured:
            raise RuntimeError("no pipeline call was captured in the window")
        return merge([check_call(self.sys, rec, nx, substitute)
                      for rec in self.captured])

    def k2_input_bytes(self) -> list[float]:
        """Per pool batch, the photo bytes K2 needs: the distinct in-image
        pixels under the four bilinear taps of every chip pixel, for each
        photo's best kept landmarks (the program's, which K2 warps).  Run
        after the window, for the roofline reader."""
        cap = self.sys.capture
        size = tuple(self.sys.cfg["align"]["output_size"])
        out = []
        for x in self.pool:
            cap.armed = True
            self.sys.model.pipeline(x)
            cap.armed = False
            det = cap.calls.pop()["select"][0]
            best = torch.argmax(torch.where(det.valid, det.scores, -1.0),
                                dim=1)
            marks = det.landmarks[torch.arange(x.shape[0],
                                               device=x.device), best]
            mats = ref_mtcnn.similarity(marks, ref_mtcnn.template(size))
            found = det.valid.any(1) & (mats[:, 0, 0] ** 2
                                        + mats[:, 1, 0] ** 2 > 0)
            pixels = ref_mtcnn.footprint(mats[found], x.shape[1],
                                         x.shape[2], size)
            out.append(float(pixels) * x.shape[3] * x.element_size())
        return out


def _rel_gap(a, b) -> float:
    return _gap(a, b) / max(float(b.abs().max()), 1e-30)


def _rms_gap(a, b) -> float:
    d = (a.float() - b.float()).pow(2).mean().sqrt()
    return float(d / b.float().pow(2).mean().sqrt().clamp(min=1e-30))


def check_call(system, rec: dict, nx: Numerics,
               substitute: Numerics | None = None) -> dict:
    w, d, cfg = system.weights, system.cfg["detector"], system.cfg
    photos = rec["photos"].float()
    n, h, wd = photos.shape[:3]
    heads = rec["detector"][1]
    boxes, scores, marks = rec["decode"]
    det, anchors = rec["select"]
    chips, emb = rec["embed"]
    ref = ref_retina.heads(w["detector"], photos, d, nx)
    if substitute is not None:
        heads = ref_retina.heads(w["detector"], photos, d, substitute)
        emb = ref_arcface.embed(w["embed"], chips,
                                cfg["embedder"]["stage_sizes"], substitute)
    loc, conf, landms = heads
    pri = ref_retina.priors(h, wd, d["min_sizes"], d["steps"])
    ref_boxes, ref_marks = ref_retina.decode(loc, landms, pri, h, wd,
                                             d["variances"])
    if substitute is not None:
        scores, boxes = ref_retina.scores(conf), ref_boxes
    post = {"confidence": d["confidence_threshold"], "top_k": d["top_k"],
            "nms_threshold": d["nms_threshold"],
            "keep_top_k": d["keep_top_k"]}
    ref_anchor, ref_valid = ref_retina.select(scores, boxes, post)
    differ = (ref_valid != det.valid) | (ref_valid & (ref_anchor != anchors))

    best = ref_anchor[:, 0].clamp(min=0)
    best_marks = ref_marks[torch.arange(n, device=best.device), best]
    size = tuple(cfg["align"]["output_size"])
    mats = ref_mtcnn.similarity(best_marks, ref_mtcnn.template(size))
    found = ref_valid[:, 0] & (mats[:, 0, 0] ** 2 + mats[:, 1, 0] ** 2 > 0)
    ref_chips = torch.zeros_like(chips, dtype=torch.float64)
    if found.any():
        ref_chips[found] = ref_mtcnn.chips(photos[found], best_marks[found],
                                           found[found], size)
    prog_found = chips.flatten(1).abs().amax(1) > 0
    ref_emb = ref_arcface.embed(w["embed"], chips,
                                cfg["embedder"]["stage_sizes"], nx)
    return {"heads_gap": max(_rms_gap(p, r) for p, r in zip(heads, ref)),
            "heads_max_gap": max(_rel_gap(p, r) for p, r in zip(heads, ref)),
            "boxes_gap": max(_gap(rec["decode"][0], ref_boxes),
                             _gap(rec["decode"][2], ref_marks)),
            "dets_mismatch": float(differ.sum()),
            "chip_gap": _gap(chips.double(), ref_chips),
            "found_mismatch": float((prog_found != found).sum()),
            "embed_gap": float(torch.linalg.vector_norm(
                emb.float() - ref_emb, dim=1).max()),
            "faces": n}
