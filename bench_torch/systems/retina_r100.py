"""The serving system with RetinaFace-R50 as the detector: RetinaFace-R50
-> K2 alignment -> ArcFace r100 (``detect.FaceModel`` with a
``detect.RetinaFaceDetector``), and the siamese head over its embeddings
that the configuration names, with random weights from the seed.

The program's imports come first, so that a program without the detector
fails at once.  No harness spans: the cell's readers read the program's
own (``alink/detect``, ``alink/retina.*``, ``alink/nms``,
``alink/embed``).  ``capture``
keeps, while armed, each call's photos and detector heads (``detector``:
(photos, (loc, conf, landms))), the detector's decode (``decode``:
(boxes, scores, landmarks) for every anchor) and selection (``select``:
(``Detections``, the anchor of each detection)), and the embedder's
chips and embeddings (``embed``).
"""

from __future__ import annotations

import torch

from bench_torch import weights as W
from bench_torch.systems.arcface_mtcnn import DTYPES, Capture


class System:
    def __init__(self, cfg: dict, seed: int, device: torch.device):
        from alink_tpu_torch.detect import (CascadeConfig, FaceModel,
                                            RetinaConfig, RetinaFaceDetector)
        from alink_tpu_torch.models import (ArcFaceResNet100, RetinaFaceR50,
                                            SiameseHead)

        self.cfg = cfg
        self.device = device
        dtype = DTYPES[cfg["precision"]]
        d, e, hd, a = (cfg["detector"], cfg["embedder"], cfg["head"],
                       cfg["assumed"])
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        det = W.on_meta(lambda: RetinaFaceR50(
            stage_sizes=tuple(d["backbone"]["stage_sizes"]),
            widths=tuple(d["backbone"]["widths"]),
            out_channels=d["fpn"]["out_channels"], leaky=d["fpn"]["leaky"],
            dtype=dtype))
        emb = W.on_meta(lambda: ArcFaceResNet100(
            stage_sizes=tuple(e["stage_sizes"]),
            stage_widths=tuple(e["stage_widths"]),
            embedding_dim=e["embedding_dim"], dtype=dtype,
            input_size=tuple(e["input_size"])))
        head = W.on_meta(lambda: SiameseHead(e["embedding_dim"],
                                             tuple(hd["widths"]),
                                             dtype=dtype))
        self.weights = {
            "detector": W.fill(det, g, device,
                               {"body.bn.0": a["stem_bn_input_var"]}),
            "embed": W.fill(emb, g, device,
                            {"bn.0": a["embed_stem_bn_input_var"]}),
            "head": W.fill(head, g, device),
        }
        with torch.no_grad():
            # The landmark heads start at the mean-face prior (a random
            # head sends every alignment to degenerate geometry).
            prior = torch.tensor(a["landmark_prior"] * d["anchors_per_cell"],
                                 device=device)
            for lmk in det.landmark_head:
                lmk.weight.mul_(a["landmark_kernel_scale"])
                lmk.bias.copy_(prior)
            W.centre_head(head, a["head_input_scale"])
        det.refold()
        self.weights = {k: {n: t.detach().float().clone()
                            for n, t in m.items()}
                        for k, m in self.weights.items()}
        for net in (det, emb, head):
            net.eval()
        self.detector = RetinaFaceDetector(det, RetinaConfig(
            steps=tuple(d["steps"]),
            min_sizes=tuple(tuple(m) for m in d["min_sizes"]),
            variances=tuple(d["variances"]),
            confidence=d["confidence_threshold"], top_k=d["top_k"],
            nms_threshold=d["nms_threshold"], keep_top_k=d["keep_top_k"]))
        self.model = FaceModel(emb, cfg=CascadeConfig(
            output_size=tuple(cfg["align"]["output_size"])),
            detector=self.detector)
        self.head = head

        self.capture = Capture()
        self._hooks = [det.register_forward_hook(self.capture.hook(
            "detector")), emb.register_forward_hook(self.capture.hook(
                "embed"))]
        for step in ("decode", "select"):
            setattr(self.detector, step, self._kept(step, getattr(
                self.detector, step)))

    def _kept(self, name: str, fn):
        def step(*args):
            out = fn(*args)
            if self.capture.armed:
                self.capture._open()[name] = out
            return out
        return step

    def release(self) -> None:
        """Drop the program's modules (the captures stay)."""
        for h in self._hooks:
            h.remove()
        self.model = self.head = self.detector = None
