"""The serving system: MTCNN cascade -> K2 alignment -> ArcFace embedder
(``detect.FaceModel``), and the siamese head over its embeddings that
the configuration names, with random weights from the seed.

Spans (``bench_torch.tracing.Span``) are forward hooks on the towers and
the embedder: ``cascade`` from the first P-Net call of a batch to O-Net's
return, ``embed`` around the embedder.  ``capture`` keeps every tower's
and the embedder's inputs and outputs while it is armed, for the check.
"""

from __future__ import annotations

import torch

from bench_torch import weights as W
from bench_torch.tracing import Span

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Capture:
    """Tower and embedder inputs/outputs of each pipeline call made while
    ``armed``: one dict per call (``pnet`` a list of levels)."""

    def __init__(self):
        self.armed = False
        self.calls: list[dict] = []

    def _open(self) -> dict:
        if not self.calls or "embed" in self.calls[-1]:
            self.calls.append({"pnet": []})
        return self.calls[-1]

    def hook(self, name: str):
        def fn(module, args, out):
            if not self.armed:
                return
            rec = self._open()
            if name == "pnet":
                rec["pnet"].append((args[0], out))
            else:
                rec[name] = (args[0], out)
        return fn


class System:
    def __init__(self, cfg: dict, seed: int, device: torch.device):
        from alink_tpu_torch.detect import (CascadeConfig, FaceModel,
                                            init_cascade_params)
        from alink_tpu_torch.detect.cascade import MTCNNParams
        from alink_tpu_torch.models import ArcFaceResNet100, SiameseHead

        self.cfg = cfg
        self.device = device
        dtype = DTYPES[cfg["precision"]]
        e, c, hd, a = (cfg["embedder"], cfg["cascade"], cfg["head"],
                       cfg["assumed"])
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        emb = W.on_meta(lambda: ArcFaceResNet100(
            stage_sizes=tuple(e["stage_sizes"]),
            stage_widths=tuple(e["stage_widths"]),
            embedding_dim=e["embedding_dim"], dtype=dtype,
            input_size=tuple(e["input_size"])))
        towers = W.on_meta(lambda: init_cascade_params(None, dtype, None,
                                                       with_lnet=False))
        head = W.on_meta(lambda: SiameseHead(e["embedding_dim"],
                                             tuple(hd["widths"]),
                                             dtype=dtype))
        self.weights = {
            "embed": W.fill(emb, g, device,
                            {"bn.0": a["stem_bn_input_var"]}),
            "pnet": W.fill(towers.pnet, g, device),
            "rnet": W.fill(towers.rnet, g, device),
            "onet": W.fill(towers.onet, g, device),
            "head": W.fill(head, g, device),
        }
        with torch.no_grad():
            # The O-Net landmark head starts at the mean-face prior, as
            # init_cascade_params seeds it (a random head sends every
            # alignment to degenerate geometry).
            lmk = towers.onet.dense[3]
            lmk.weight.mul_(a["landmark_kernel_scale"])
            lmk.bias.copy_(torch.tensor(a["landmark_prior"], device=device))
            W.centre_head(head, a["head_input_scale"])
        self.weights = {k: {n: t.detach().float().clone()
                            for n, t in m.items()}
                        for k, m in self.weights.items()}
        for net in (towers.pnet, towers.rnet, towers.onet, emb, head):
            net.eval()
        self.cascade_cfg = CascadeConfig.typical(
            thresholds=tuple(c["thresholds"]), min_size=c["min_size"],
            factor=c["factor"], stage1_scale_budget=c["stage1_scale_budget"],
            stage1_budget=c["stage1_budget"],
            stage2_budget=c["stage2_budget"],
            stage3_budget=c["stage3_budget"],
            output_size=tuple(c["output_size"]))
        self.model = FaceModel(emb, MTCNNParams(towers.pnet, towers.rnet,
                                                towers.onet, None),
                               self.cascade_cfg)
        self.head = head

        self.capture = Capture()
        self.spans = {"cascade": Span("cascade"), "embed": Span("embed")}
        self._hooks = [
            towers.pnet.register_forward_pre_hook(
                lambda m, a_: self.spans["cascade"].begin()),
            towers.onet.register_forward_hook(
                lambda m, a_, o: self.spans["cascade"].end()),
            emb.register_forward_pre_hook(
                lambda m, a_: self.spans["embed"].begin()),
            emb.register_forward_hook(
                lambda m, a_, o: self.spans["embed"].end()),
        ]
        for name, net in (("pnet", towers.pnet), ("rnet", towers.rnet),
                          ("onet", towers.onet), ("embed", emb)):
            self._hooks.append(net.register_forward_hook(
                self.capture.hook(name)))

    def release(self) -> None:
        """Drop the program's modules (the captures stay)."""
        for h in self._hooks:
            h.remove()
        self.model = self.head = None
