"""RetinaFace-R50 (Deng et al., arXiv:1905.00641) as its public PyTorch form
computes it (github.com/biubug6/Pytorch_Retinaface: ``models/net.py``,
``models/retinaface.py``, ``layers/functions/prior_box.py``,
``utils/box_utils.py``, ``utils/nms/py_cpu_nms.py`` and ``detect.py``),
plain float32 with TF32 off, in blocks of photos.

Input (N, H, W, 3) RGB levels, taken as Pytorch_Retinaface's input: BGR,
minus (104, 117, 123), NCHW.  torchvision ResNet-50 (v1.5: a strided
block's stride on its 3x3) with BN eps 1e-5; FPN (laterals conv1x1-BN-act,
nearest upsample-add, merges conv3x3-BN-act), SSH per level, heads 1x1
with bias, 2 anchors a cell; act LeakyReLU(``leaky``).  Every BN is
applied after its convolution, unfolded.  Weights are keyed as the harness
made them (``models.RetinaFaceR50``'s state dict).

Post-process as ``detect.py``: softmax scores, decode with variances
(0.1, 0.2), scores above the threshold, the top ``top_k`` by score, greedy
NMS (``py_cpu_nms``: inclusive areas, a box suppressed unless its overlap
with a kept box is at most the threshold; a sequential loop over the
candidates in score order, every photo at once), the first
``keep_top_k``.  Departure, noted: ties in score go to the lower anchor
index (a stable sort), where numpy's reversed argsort sends them the
other way; the program breaks them the same way.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from bench_torch.reference.numerics import Numerics, bn, exact_f32

EPS = 1e-5
BGR_MEAN = (104.0, 117.0, 123.0)
STEPS = (8, 16, 32)


def heads(w: dict, photos: torch.Tensor, net: dict, nx: Numerics,
          block: int = 32) -> tuple[torch.Tensor, ...]:
    """(loc (N, A, 4), conf (N, A, 2), landms (N, A, 10)), float32 with TF32
    off, ``block`` photos at a time.  ``net``: the configuration's
    ``backbone`` and ``fpn`` groups (stage sizes, widths, FPN width,
    slope)."""
    with exact_f32():
        outs = [_heads(w, photos[i:i + block], net, nx)
                for i in range(0, photos.shape[0], block)]
    return tuple(torch.cat(o) for o in zip(*outs))


def _convbn(y, w, p, nx, stride=1, padding=0):
    return bn(nx.conv(y, w[p + ".conv.weight"], stride=stride,
                      padding=padding), w, p + ".bn", EPS)


def _heads(w, x, net, nx):
    leaky = net["fpn"]["leaky"]
    act = (lambda t: F.leaky_relu(t, leaky)) if leaky else torch.relu
    mean = torch.tensor(BGR_MEAN, device=x.device)
    y = (x.float().flip(-1) - mean).permute(0, 3, 1, 2)
    y = torch.relu(bn(nx.conv(y, w["body.conv.0.weight"], stride=2,
                              padding=3), w, "body.bn.0", EPS))
    y = F.max_pool2d(y, 3, 2, padding=1)
    taps, i = [], 0
    for stage, n in enumerate(net["backbone"]["stage_sizes"]):
        for b in range(n):
            p = f"body.blocks.{i}."
            s = 2 if stage > 0 and b == 0 else 1
            z = torch.relu(bn(nx.conv(y, w[p + "conv.0.weight"]), w,
                              p + "bn.0", EPS))
            z = torch.relu(bn(nx.conv(z, w[p + "conv.1.weight"], stride=s,
                                      padding=1), w, p + "bn.1", EPS))
            z = bn(nx.conv(z, w[p + "conv.2.weight"]), w, p + "bn.2", EPS)
            if p + "conv.3.weight" in w:
                y = bn(nx.conv(y, w[p + "conv.3.weight"], stride=s), w,
                       p + "bn.3", EPS)
            y = torch.relu(z + y)
            i += 1
        taps.append(y)
    c3, c4, c5 = taps[1:]
    p3 = act(_convbn(c3, w, "fpn.output1", nx))
    p4 = act(_convbn(c4, w, "fpn.output2", nx))
    p5 = act(_convbn(c5, w, "fpn.output3", nx))
    p4 = act(_convbn(p4 + F.interpolate(p5, size=p4.shape[2:],
                                        mode="nearest"),
                     w, "fpn.merge2", nx, padding=1))
    p3 = act(_convbn(p3 + F.interpolate(p4, size=p3.shape[2:],
                                        mode="nearest"),
                     w, "fpn.merge1", nx, padding=1))
    loc, conf, landms = [], [], []
    for lvl, f in enumerate((p3, p4, p5)):
        s = f"ssh.{lvl}."
        a = _convbn(f, w, s + "conv3X3", nx, padding=1)
        b1 = act(_convbn(f, w, s + "conv5X5_1", nx, padding=1))
        b = _convbn(b1, w, s + "conv5X5_2", nx, padding=1)
        c1 = act(_convbn(b1, w, s + "conv7X7_2", nx, padding=1))
        c = _convbn(c1, w, s + "conv7x7_3", nx, padding=1)
        o = torch.relu(torch.cat([a, b, c], 1))
        for out, name, k in ((conf, "class_head", 2), (loc, "bbox_head", 4),
                             (landms, "landmark_head", 10)):
            h = nx.conv(o, w[f"{name}.{lvl}.weight"],
                        w[f"{name}.{lvl}.bias"])
            out.append(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1, k))
    return torch.cat(loc, 1), torch.cat(conf, 1), torch.cat(landms, 1)


def priors(h: int, w: int, min_sizes, steps=STEPS) -> torch.Tensor:
    """``PriorBox.forward``: (A, 4) (cx, cy, s_kx, s_ky), Python floats
    made float32."""
    anchors = []
    for k, step in enumerate(steps):
        fh, fw = -(-h // step), -(-w // step)
        for i, j in itertools.product(range(fh), range(fw)):
            for m in min_sizes[k]:
                anchors += [(j + 0.5) * step / w, (i + 0.5) * step / h,
                            m / w, m / h]
    return torch.tensor(anchors, dtype=torch.float32).reshape(-1, 4)


def decode(loc, landms, pri, h: int, w: int, variances=(0.1, 0.2)):
    """``box_utils.decode`` and ``decode_landm`` then ``detect.py``'s
    scales: boxes (..., A, 4), landmarks (..., A, 5, 2) in pixels."""
    pri = pri.to(loc.device)
    boxes = torch.cat((pri[:, :2] + loc[..., :2] * variances[0] * pri[:, 2:],
                       pri[:, 2:] * torch.exp(loc[..., 2:] * variances[1])),
                      -1)
    xy = boxes[..., :2] - boxes[..., 2:] / 2
    boxes = torch.cat([xy, boxes[..., 2:] + xy], -1)
    scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                         device=loc.device)
    pts = [pri[:, :2] + landms[..., 2 * k:2 * k + 2] * variances[0]
           * pri[:, 2:] for k in range(5)]
    marks = torch.stack(pts, -2) * scale[:2]
    return boxes * scale, marks


def scores(conf: torch.Tensor) -> torch.Tensor:
    return F.softmax(conf, dim=-1)[..., 1]


def greedy_nms(boxes: torch.Tensor, live: torch.Tensor,
               threshold: float) -> torch.Tensor:
    """``py_cpu_nms`` on (N, K, 4) boxes already in score order, every
    photo at once: candidate t, if still live, is kept and removes every
    later candidate whose overlap with it is above the threshold."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    live = live.clone()
    keep = torch.zeros_like(live)
    k = boxes.shape[1]
    for t in range(k):
        kt = live[:, t]
        keep[:, t] = kt
        xx1 = torch.maximum(x1[:, t:t + 1], x1[:, t + 1:])
        yy1 = torch.maximum(y1[:, t:t + 1], y1[:, t + 1:])
        xx2 = torch.minimum(x2[:, t:t + 1], x2[:, t + 1:])
        yy2 = torch.minimum(y2[:, t:t + 1], y2[:, t + 1:])
        ww = torch.clamp(xx2 - xx1 + 1, min=0.0)
        hh = torch.clamp(yy2 - yy1 + 1, min=0.0)
        inter = ww * hh
        ovr = inter / (areas[:, t:t + 1] + areas[:, t + 1:] - inter)
        live[:, t + 1:] &= ~(kt[:, None] & ~(ovr <= threshold))
    return keep


def select(s: torch.Tensor, boxes: torch.Tensor, post: dict
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Threshold, top-k, greedy NMS and keep-top-k on (N, A) scores and
    (N, A, 4) boxes -> (the kept anchors' indices (N, keep_top_k), -1
    past each photo's last, and their validity)."""
    neg = torch.tensor(float("-inf"), device=s.device)
    order = torch.sort(torch.where(s > post["confidence"], s, neg), dim=1,
                       descending=True, stable=True)[1][:, :post["top_k"]]
    live = torch.gather(s, 1, order) > post["confidence"]
    b = torch.gather(boxes, 1, order[..., None].expand(order.shape + (4,)))
    keep = greedy_nms(b, live, post["nms_threshold"])
    n, kk = keep.shape
    rank = torch.cumsum(keep, 1) - 1
    out = torch.full((n, post["keep_top_k"]), -1, dtype=torch.long,
                     device=s.device)
    slot = keep & (rank < post["keep_top_k"])
    rows = torch.arange(n, device=s.device)[:, None].expand(n, kk)
    out[rows[slot], rank[slot]] = order[slot]
    return out, out >= 0
