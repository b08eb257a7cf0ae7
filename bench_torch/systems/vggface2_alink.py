"""The A-LINK loop's models: the VGGFace2 ResNet-50 teacher (its 13
stride-1 blocks on K3), the M1 committee and the student M2 (siamese
heads over its 2,048-d features), random weights from the seed.

``featurize`` is the program's featurizer (``drivers.common.
make_resnet50_featurizer``) behind a counter of the images it is given,
which the roofline and utilisation readers use.
"""

from __future__ import annotations

import torch

from bench_torch import weights as W

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class System:
    def __init__(self, cfg: dict, seed: int, device: torch.device):
        from alink_tpu_torch.active.committee import Committee
        from alink_tpu_torch.drivers.alink import make_adversarial_predict
        from alink_tpu_torch.drivers.common import make_resnet50_featurizer
        from alink_tpu_torch.models import SiameseHead, VGGFaceResNet50
        from alink_tpu_torch.train import TrainState

        self.cfg = cfg
        self.device = device
        dtype = DTYPES[cfg["precision"]]
        t, hd, a, loop = (cfg["teacher"], cfg["head"], cfg["assumed"],
                          cfg["loop"])
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        model = W.on_meta(lambda: VGGFaceResNet50(
            stage_sizes=tuple(t["stage_sizes"]), dtype=dtype))
        heads = [W.on_meta(lambda: SiameseHead(t["feature_dim"],
                                               tuple(hd["widths"]),
                                               dtype=dtype))
                 for _ in range(loop["num_ensemble_models"] + 1)]
        self.weights = {"teacher": W.fill(model, g, device,
                                          {"bn.0": a["stem_bn_input_var"]})}
        for i, h in enumerate(heads):
            self.weights[f"head{i}"] = W.fill(h, g, device)
            W.centre_head(h, a["head_input_scale"])
        # The student starts near the committee, as two heads trained on
        # like data do: each of its kernels is rho times the first
        # member's plus sqrt(1 - rho^2) times its own draw.
        W.blend(heads[0], heads[1], a["student_committee_rho"])
        model.refold()
        self.weights = {k: {n: v.detach().float().clone()
                            for n, v in m.items()}
                        for k, m in self.weights.items()}
        inner, self.model = make_resnet50_featurizer(model=model)
        self.images = 0
        self.calls: dict[int, int] = {}   # batch size -> featurize calls
        # While ``keep`` is above 0, featurize keeps its outputs (one a
        # call, counting ``keep`` down) in ``kept``, for the check.
        self.keep, self.kept = 0, []

        def featurize(x: torch.Tensor) -> torch.Tensor:
            n = x.shape[0]
            self.images += n
            self.calls[n] = self.calls.get(n, 0) + 1
            out = inner(x)
            if self.keep > 0:
                self.keep -= 1
                self.kept.append(out)
            return out

        self.featurize = featurize
        # heads[0] is the student M2, the rest the committee's members.
        self.m2 = TrainState(heads[0].train(False), loop["m2_learning_rate"])
        self.committee = Committee.from_param_list(
            heads[1], [dict(h.named_parameters()) for h in heads[1:]])
        self.adversarial_predict = make_adversarial_predict(featurize)

    def release(self) -> None:
        self.model = self.committee = self.m2 = None
        self.featurize = self.adversarial_predict = None
