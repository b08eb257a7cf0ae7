"""RetinaFace-R50 (arXiv:1905.00641) as github.com/biubug6/Pytorch_Retinaface
computes it, plain float32, for the tests: torch operations only, no
kernel of the port, TF32 off; its post-process as ``detect.py``, with
``py_cpu_nms`` as a sequential loop over each photo's candidates.

Forward: (N, H, W, 3) RGB levels -> BGR minus (104, 117, 123), NCHW;
torchvision ResNet-50 v1.5 (stem conv7x7 s2 p3 - BN - ReLU - maxpool 3
s2 p1; bottlenecks 1x1 - 3x3 (the stride) - 1x1, projection on each
stage's first block), every BN unfolded after its convolution (eps
1e-5); FPN (laterals conv1x1 - BN - act on C3, C4, C5; P4 = merge2(P4 +
up(P5)), P3 = merge1(P3 + up(P4)), merges conv3x3 - BN - act); SSH per
level; heads 1x1 with bias, each output NHWC and viewed as (N, H W 2, .).
act is LeakyReLU(``leaky``) (0 at the published width: ReLU).  Weights are
a dict keyed as the port's state dict (``body.*``, ``fpn.*``, ``ssh.<l>.*``,
``class_head.<l>``, ``bbox_head.<l>``, ``landmark_head.<l>``).

Departure, noted: the top-k breaks ties in score towards the lower anchor
index (a stable sort), where numpy's reversed argsort sends them the other
way; the port breaks them the same way.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-5
MEAN = (104.0, 117.0, 123.0)


def _bn(x, w, p):
    g, b, m, v = (w[f"{p}.{k}"].float().reshape(1, -1, 1, 1)
                  for k in ("gamma", "beta", "mean", "var"))
    return (x - m) / torch.sqrt(v + EPS) * g + b


def _cb(x, w, p, stride=1, padding=0):
    return _bn(F.conv2d(x, w[p + ".conv.weight"].float(), stride=stride,
                        padding=padding), w, p + ".bn")


def forward(w: dict, photos: torch.Tensor, stage_sizes=(3, 4, 6, 3),
            leaky: float = 0.0):
    """(loc (N, A, 4), conf (N, A, 2), landms (N, A, 10)) float32, TF32
    off."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _forward(w, photos, stage_sizes, leaky)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _forward(w, photos, stage_sizes, leaky):
    act = (lambda t: F.leaky_relu(t, leaky)) if leaky else torch.relu
    x = photos.float()[..., [2, 1, 0]] - torch.tensor(MEAN)
    y = x.permute(0, 3, 1, 2)
    y = torch.relu(_bn(F.conv2d(y, w["body.conv.0.weight"].float(),
                                stride=2, padding=3), w, "body.bn.0"))
    y = F.max_pool2d(y, 3, 2, padding=1)
    outs, i = [], 0
    for stage, n in enumerate(stage_sizes):
        for b in range(n):
            p = f"body.blocks.{i}"
            s = 2 if stage > 0 and b == 0 else 1
            z = torch.relu(_bn(F.conv2d(y, w[p + ".conv.0.weight"].float()),
                               w, p + ".bn.0"))
            z = torch.relu(_bn(F.conv2d(z, w[p + ".conv.1.weight"].float(),
                                        stride=s, padding=1), w, p + ".bn.1"))
            z = _bn(F.conv2d(z, w[p + ".conv.2.weight"].float()), w,
                    p + ".bn.2")
            sc = y
            if p + ".conv.3.weight" in w:
                sc = _bn(F.conv2d(y, w[p + ".conv.3.weight"].float(),
                                  stride=s), w, p + ".bn.3")
            y = torch.relu(z + sc)
            i += 1
        outs.append(y)
    o1 = act(_cb(outs[1], w, "fpn.output1"))
    o2 = act(_cb(outs[2], w, "fpn.output2"))
    o3 = act(_cb(outs[3], w, "fpn.output3"))
    up3 = F.interpolate(o3, size=[o2.size(2), o2.size(3)], mode="nearest")
    o2 = act(_cb(o2 + up3, w, "fpn.merge2", padding=1))
    up2 = F.interpolate(o2, size=[o1.size(2), o1.size(3)], mode="nearest")
    o1 = act(_cb(o1 + up2, w, "fpn.merge1", padding=1))
    heads = {"class_head": [], "bbox_head": [], "landmark_head": []}
    for lvl, f in enumerate((o1, o2, o3)):
        s = f"ssh.{lvl}"
        conv3 = _cb(f, w, s + ".conv3X3", padding=1)
        c5_1 = act(_cb(f, w, s + ".conv5X5_1", padding=1))
        conv5 = _cb(c5_1, w, s + ".conv5X5_2", padding=1)
        c7_2 = act(_cb(c5_1, w, s + ".conv7X7_2", padding=1))
        conv7 = _cb(c7_2, w, s + ".conv7x7_3", padding=1)
        out = torch.relu(torch.cat([conv3, conv5, conv7], dim=1))
        for name, k in (("class_head", 2), ("bbox_head", 4),
                        ("landmark_head", 10)):
            h = F.conv2d(out, w[f"{name}.{lvl}.weight"].float(),
                         w[f"{name}.{lvl}.bias"].float())
            heads[name].append(h.permute(0, 2, 3, 1).contiguous()
                               .view(h.shape[0], -1, k))
    return (torch.cat(heads["bbox_head"], 1),
            torch.cat(heads["class_head"], 1),
            torch.cat(heads["landmark_head"], 1))


def prior_box(h: int, w: int, min_sizes=((16, 32), (64, 128), (256, 512)),
              steps=(8, 16, 32)) -> torch.Tensor:
    """``PriorBox.forward`` (clip off)."""
    anchors = []
    for k, f in enumerate([[int(np.ceil(h / s)), int(np.ceil(w / s))]
                           for s in steps]):
        for i, j in itertools.product(range(f[0]), range(f[1])):
            for min_size in min_sizes[k]:
                s_kx, s_ky = min_size / w, min_size / h
                cx = (j + 0.5) * steps[k] / w
                cy = (i + 0.5) * steps[k] / h
                anchors += [cx, cy, s_kx, s_ky]
    return torch.Tensor(anchors).view(-1, 4)


def decode(loc, priors, variances=(0.1, 0.2)):
    boxes = torch.cat((
        priors[:, :2] + loc[:, :2] * variances[0] * priors[:, 2:],
        priors[:, 2:] * torch.exp(loc[:, 2:] * variances[1])), 1)
    boxes[:, :2] -= boxes[:, 2:] / 2
    boxes[:, 2:] += boxes[:, :2]
    return boxes


def decode_landm(pre, priors, variances=(0.1, 0.2)):
    return torch.cat([priors[:, :2] + pre[:, 2 * k:2 * k + 2] * variances[0]
                      * priors[:, 2:] for k in range(5)], dim=1)


def py_cpu_nms(dets: np.ndarray, thresh: float) -> list[int]:
    """Pure Python NMS baseline (Fast R-CNN's), on rows already in score
    order: the loop visits them in that order, not re-sorted, so that
    ties keep the stable sort's order."""
    x1, y1, x2, y2 = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = np.arange(dets.shape[0])
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(np.float32(0.0), xx2 - xx1 + np.float32(1))
        h = np.maximum(np.float32(0.0), yy2 - yy1 + np.float32(1))
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        inds = np.where(ovr <= np.float32(thresh))[0]
        order = order[inds + 1]
    return keep


def post(scores: torch.Tensor, boxes: torch.Tensor, confidence=0.02,
         top_k=5000, nms_threshold=0.4, keep_top_k=750) -> list[list[int]]:
    """``detect.py``'s post-process on one photo at a time, (N, A) scores
    and (N, A, 4) pixel boxes -> each photo's kept anchor indices, in
    score order."""
    out = []
    for s, b in zip(scores, boxes):
        inds = torch.nonzero(s > confidence)[:, 0]
        order = inds[torch.sort(s[inds], descending=True,
                                stable=True)[1]][:top_k]
        keep = py_cpu_nms(b[order].numpy().astype(np.float32),
                          nms_threshold)
        out.append(order[keep][:keep_top_k].tolist())
    return out
