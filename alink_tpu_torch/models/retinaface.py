"""RetinaFace-R50 (Deng et al., arXiv:1905.00641), the single-stage face
detector beside ArcFace, in the layout of its public PyTorch form
(github.com/biubug6/Pytorch_Retinaface, ``models/retinaface.py`` and
``models/net.py`` under ``cfg_re50``).

Input: (N, H, W, 3) RGB photos of levels 0-255 (``FaceModel``'s), turned
into Pytorch_Retinaface's own input in float32: BGR order, minus (104,
117, 123), no scaling, NCHW; the mean goes before the stem (folded into
the stem's bias it would differ at the zero-padded border).

- Backbone: torchvision's ResNet-50 (``resnet.ResNet50V15``), its 13
  stride-1 blocks on K3, the stem and the three strided blocks as cuDNN
  convolutions in ``dtype`` with BN folded in; C3, C4, C5 at H / 8, 16, 32.
- FPN, ``out_channels`` wide: laterals conv 1x1 - BN - act on C3, C4, C5;
  P4 = merge2(P4 + nearest-upsample(P5)), P3 = merge1(P3 +
  nearest-upsample(P4)), each merge conv 3x3 - BN - act.
- SSH on each level: a = conv3x3-BN (-> C/2), b1 = conv3x3-BN-act (-> C/4),
  b = conv3x3-BN(b1), c1 = conv3x3-BN-act(b1), c = conv3x3-BN(c1), out =
  ReLU(concat[a, b, c]).
- act is LeakyReLU(``leaky``); Pytorch_Retinaface sets 0.1 where
  out_channels <= 64, else 0, so 0 (ReLU) at the published 256.  Here the
  slope is a parameter, 0 by default, so that a narrow test preset keeps
  the published activation.
- Heads, per level, 2 anchors a cell: 1x1 convolutions with bias to 2 x 2
  class logits, 2 x 4 box offsets and 2 x 10 landmark offsets, each
  permuted NHWC and viewed as (N, H W 2, .), concatenated over the levels:
  ``(loc, conf, landms)`` as Pytorch_Retinaface returns them (its softmax
  over ``conf`` is taken by ``detect.retina``).

Numerics: every convolution in ``dtype`` (bf16) with BN folded into its
weights and bias (f32 fold, then rounded), f32 accumulation; the heads in
float32 on the bf16 SSH output and the bf16-rounded head weights, so the
offsets and logits carry float32 precision into the decode.  Spans
``retina.backbone``, ``retina.fpn``, ``retina.ssh`` and ``retina.heads``;
counters ``retina.forwards`` and ``retina.photos``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from alink_tpu_torch.models.resnet import (TORCH_BN_EPS, FoldCache,
                                           ResNet50V15, _FrozenBN, _make_conv,
                                           fold_conv)
from alink_tpu_torch.utils.profiling import count, span

BGR_MEAN = (104.0, 117.0, 123.0)
ANCHORS = 2          # anchors a cell, per level


class ConvBN(nn.Module):
    """A bias-free convolution and a frozen BN (``conv``, ``bn``), padding
    (k - 1) / 2, as Pytorch_Retinaface's ``conv_bn`` / ``conv_bn1X1`` /
    ``conv_bn_no_relu``; the activation is the caller's."""

    def __init__(self, cin: int, cout: int, k: int, dtype, generator,
                 device):
        super().__init__()
        self.conv = _make_conv(cin, cout, k, False, generator, device)
        self.bn = _FrozenBN(cout, TORCH_BN_EPS, dtype, device)


class SSH(nn.Module):
    """The context module of one level (names as Pytorch_Retinaface's)."""

    def __init__(self, c: int, dtype, generator, device):
        super().__init__()
        mk = lambda a, b: ConvBN(a, b, 3, dtype, generator, device)  # noqa
        self.conv3X3 = mk(c, c // 2)
        self.conv5X5_1 = mk(c, c // 4)
        self.conv5X5_2 = mk(c // 4, c // 4)
        self.conv7X7_2 = mk(c // 4, c // 4)
        self.conv7x7_3 = mk(c // 4, c // 4)


class RetinaFaceR50(FoldCache):
    """RetinaFace on a ResNet-50: (N, H, W, 3) RGB photos -> (loc (N, A, 4),
    conf (N, A, 2), landms (N, A, 10)) float32, A = 2 x the cells of the
    three levels (16,800 at 640^2).

    ``stage_sizes``, ``widths``, ``out_channels`` and ``leaky`` default to
    ``cfg_re50``'s; a test preset narrows them.  Inference only; the
    folded weights are cached (``FoldCache``: ``refold()`` after an edit
    in place drops the backbone's too)."""

    strides = (8, 16, 32)

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 out_channels: int = 256, leaky: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.leaky = leaky
        self.out_channels = c = out_channels
        self.body = ResNet50V15(stage_sizes, widths, dtype, generator,
                                device)
        mk = lambda a, b, k: ConvBN(a, b, k, dtype, generator,  # noqa: E731
                                    device)
        c3, c4, c5 = self.body.channels
        self.fpn = nn.ModuleDict({
            "output1": mk(c3, c, 1), "output2": mk(c4, c, 1),
            "output3": mk(c5, c, 1), "merge1": mk(c, c, 3),
            "merge2": mk(c, c, 3)})
        self.ssh = nn.ModuleList(SSH(c, dtype, generator, device)
                                 for _ in self.strides)
        heads = []
        for width in (2, 4, 10):
            heads.append(nn.ModuleList(
                _make_conv(c, ANCHORS * width, 1, True, generator, device)
                for _ in self.strides))
        self.class_head, self.bbox_head, self.landmark_head = heads
        self.requires_grad_(False)

    def _fold(self) -> dict:
        """The FPN's and SSH's convolutions with BN folded (``fold_conv``)
        and the heads' 1x1 kernels of each level side by side (class, box,
        landmark: 2 x 16 columns) as a bf16-rounded float32 (C, 32) matrix
        and its bias."""
        dt = self.dtype
        fold = {name: fold_conv(m.conv, m.bn, dt)
                for name, m in self.fpn.items()}
        ssh = [{name: fold_conv(m.conv, m.bn, dt)
                for name, m in s.named_children()} for s in self.ssh]
        heads = []
        for lvl in range(len(self.strides)):
            convs = (self.class_head[lvl], self.bbox_head[lvl],
                     self.landmark_head[lvl])
            w = torch.cat([h.weight[:, :, 0, 0] for h in convs])
            b = torch.cat([h.bias for h in convs])
            heads.append((w.to(dt).float().t().contiguous(), b.float()))
        return {"fpn": fold, "ssh": ssh, "heads": heads}

    def _act(self, y: torch.Tensor) -> torch.Tensor:
        if self.leaky:
            return F.leaky_relu(y, self.leaky, inplace=True)
        return torch.relu_(y)

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) RGB levels -> Pytorch_Retinaface's input: BGR minus
        the mean, in float32, then ``dtype``; NCHW over channels-last
        memory."""
        mean = torch.tensor(BGR_MEAN, device=images.device)
        x = images.float().flip(-1) - mean
        return x.to(self.dtype).permute(0, 3, 1, 2)

    @torch.no_grad()
    def forward(self, images: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        count("retina.forwards")
        count("retina.photos", images.shape[0])
        wts = self._cached(images.device, self._fold)
        with span("retina.backbone"):
            c3, c4, c5 = self.body(self.preprocess(images))
        with span("retina.fpn"):
            f = wts["fpn"]
            p3 = self._act(F.conv2d(c3, *f["output1"]))
            p4 = self._act(F.conv2d(c4, *f["output2"]))
            p5 = self._act(F.conv2d(c5, *f["output3"]))
            p4 = p4.add_(F.interpolate(p5, size=p4.shape[2:],
                                       mode="nearest"))
            p4 = self._act(F.conv2d(p4, *f["merge2"], padding=1))
            p3 = p3.add_(F.interpolate(p4, size=p3.shape[2:],
                                       mode="nearest"))
            p3 = self._act(F.conv2d(p3, *f["merge1"], padding=1))
        with span("retina.ssh"):
            feats = [self._ssh(p, s) for p, s in zip((p3, p4, p5),
                                                     wts["ssh"])]
        with span("retina.heads"):
            outs = [self._heads(p, w) for p, w in zip(feats, wts["heads"])]
            conf, loc, landms = (torch.cat(o, dim=1) for o in zip(*outs))
        return loc, conf, landms

    def _ssh(self, x: torch.Tensor, w: dict) -> torch.Tensor:
        a = F.conv2d(x, *w["conv3X3"], padding=1)
        b1 = self._act(F.conv2d(x, *w["conv5X5_1"], padding=1))
        b = F.conv2d(b1, *w["conv5X5_2"], padding=1)
        c1 = self._act(F.conv2d(b1, *w["conv7X7_2"], padding=1))
        c = F.conv2d(c1, *w["conv7x7_3"], padding=1)
        return torch.relu_(torch.cat([a, b, c], dim=1))

    def _heads(self, x: torch.Tensor, wb) -> tuple[torch.Tensor, ...]:
        """One level's class, box and landmark outputs, (N, H W 2, 2 / 4 /
        10) float32: the NHWC cells times the (C, 32) head matrix."""
        w, b = wb
        n = x.shape[0]
        y = torch.addmm(b, x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
                        .float(), w).reshape(n, -1, w.shape[1])
        cls, box = ANCHORS * 2, ANCHORS * 4
        return (y[..., :cls].reshape(n, -1, 2),
                y[..., cls:cls + box].reshape(n, -1, 4),
                y[..., cls + box:].reshape(n, -1, 10))

