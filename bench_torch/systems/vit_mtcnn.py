"""The serving system with insightface's ViT as the embedder: MTCNN
cascade -> K2 alignment -> ``models.FaceViT`` (``detect.FaceModel``), and
the siamese head over its embeddings that the configuration names, with
random weights from the seed.

Spans and capture as ``arcface_mtcnn``'s (``cascade``, ``embed``; every
tower's and the embedder's inputs and outputs while armed), and besides,
while armed, the attention core's (q, k, v) and output in the first and
the last block, as ``attn.<i>`` of the call's record.
"""

from __future__ import annotations

import torch

from bench_torch import weights as W
from bench_torch.systems.arcface_mtcnn import DTYPES, Capture
from bench_torch.tracing import Span


class System:
    def __init__(self, cfg: dict, seed: int, device: torch.device):
        from alink_tpu_torch.detect import (CascadeConfig, FaceModel,
                                            init_cascade_params)
        from alink_tpu_torch.detect.cascade import MTCNNParams
        from alink_tpu_torch.models import FaceViT, SiameseHead

        self.cfg = cfg
        self.device = device
        dtype = DTYPES[cfg["precision"]]
        e, c, hd, a = (cfg["embedder"], cfg["cascade"], cfg["head"],
                       cfg["assumed"])
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        emb = W.on_meta(lambda: FaceViT(
            input_size=e["input_size"][0], patch_size=e["patch_size"],
            embed_dim=e["embed_dim"], depth=e["depth"],
            num_heads=e["num_heads"], mlp_dim=e["mlp_dim"],
            embedding_dim=e["embedding_dim"], dtype=dtype))
        towers = W.on_meta(lambda: init_cascade_params(None, dtype, None,
                                                       with_lnet=False))
        head = W.on_meta(lambda: SiameseHead(e["embedding_dim"],
                                             tuple(hd["widths"]),
                                             dtype=dtype))
        self.weights = {
            "embed": W.fill(emb, g, device),
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
        for i in sorted({0, len(emb.blocks) - 1}):
            self._hooks.append(emb.blocks[i].attn.core.register_forward_hook(
                self._attn_hook(f"attn.{i}")))

    def _attn_hook(self, name: str):
        def fn(module, args, out):
            if self.capture.armed:
                self.capture._open()[name] = (args, out)
        return fn

    def release(self) -> None:
        """Drop the program's modules (the captures stay)."""
        for h in self._hooks:
            h.remove()
        self.model = self.head = None
