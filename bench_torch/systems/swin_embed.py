"""The aligned-chip embedding system with a Swin face backbone:
``detect.FaceModel`` over ``models.FaceSwin`` with no detector, so that
``get_feature`` embeds chips that arrive aligned, with random weights from
the seed.

The program's imports come first, so that a program without the Swin
embedder fails at once.  No harness spans: the cell's readers read the
program's own (``alink/embed``, ``alink/swin.*``).  ``capture`` keeps,
while armed, each call's chips and embeddings (``embed``) and, for the
blocks the configuration names (``check.wattn_blocks``: [stage, block]),
the windowed core's qkv, bias table, shift and window and its output
(``wattn.<stage>.<block>``).
"""

from __future__ import annotations

import torch

from bench_torch import weights as W
from bench_torch.systems.arcface_mtcnn import DTYPES


class Capture:
    """Each armed call's records: one dict a call."""

    def __init__(self):
        self.armed = False
        self.calls: list[dict] = []

    def _open(self) -> dict:
        if not self.calls or "embed" in self.calls[-1]:
            self.calls.append({})
        return self.calls[-1]

    def embed(self, module, args, out):
        if self.armed:
            self._open()["embed"] = (args[0], out)

    def core(self, name: str):
        def fn(module, args, out):
            if self.armed:
                self._open()[name] = (args[0], args[1], module.shift,
                                      module.window, out)
        return fn


class System:
    def __init__(self, cfg: dict, seed: int, device: torch.device):
        from alink_tpu_torch.detect import FaceModel
        from alink_tpu_torch.models import FaceSwin

        self.cfg = cfg
        self.device = device
        dtype = DTYPES[cfg["precision"]]
        e, a = cfg["embedder"], cfg["assumed"]
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        emb = W.on_meta(lambda: FaceSwin(
            input_size=e["input_size"][0], patch_size=e["patch_size"],
            embed_dim=e["embed_dim"], depths=tuple(e["depths"]),
            num_heads=tuple(e["num_heads"]), window_size=e["window_size"],
            mlp_ratio=e["mlp_ratio"], embedding_dim=e["embedding_dim"],
            dtype=dtype))
        state = W.fill(emb, g, device)
        with torch.no_grad():
            # weights.fill draws every 2-D tensor as a kernel, N(0,
            # 1/heads) for a (169, heads) table: rescaled to the published
            # N(0, 0.02^2).
            for name, p in emb.named_parameters():
                if name.endswith("relative_position_bias_table"):
                    p.mul_(a["bias_table_std"] * p.shape[1] ** 0.5)
        self.weights = {"embed": {n: t.detach().float().clone()
                                  for n, t in state.items()}}
        emb.eval()
        self.model = FaceModel(emb)
        self.capture = Capture()
        self._hooks = [emb.register_forward_hook(self.capture.embed)]
        for stage, block in cfg["check"]["wattn_blocks"]:
            if stage < len(emb.layers) and \
                    block < len(emb.layers[stage].blocks):
                core = emb.layers[stage].blocks[block].attn.core
                self._hooks.append(core.register_forward_hook(
                    self.capture.core(f"wattn.{stage}.{block}")))

    def release(self) -> None:
        """Drop the program's modules (the captures stay)."""
        for h in self._hooks:
            h.remove()
        self.model = None
