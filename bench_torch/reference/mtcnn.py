"""MTCNN (Zhang et al., arXiv:1604.02878) as a plain reference: the three
towers, the cascade between them, and the 5-point alignment onto the
ArcFace template.

Towers (NHWC in, inputs scaled by (x - 127.5) / 128): VALID convolutions
with bias, channel-wise PReLU, ceil-mode max pooling, dense heads over
the channels-last flatten, softmax face probabilities.

The cascade runs with fixed candidate budgets (the program's
``CascadeConfig``): per pyramid level the top ``stage1_scale_budget``
cells decode to boxes ``round((2 * cell + 1 [+ 12]) / scale)``, NMS 0.5
per level and 0.7 over all levels, regression, squaring, the top
``stage1_budget``; R-Net on 24x24 crops, threshold, NMS 0.7,
calibration, squaring, the top ``stage2_budget``; O-Net on 48x48 crops,
threshold, landmarks from the pre-calibration boxes, calibration, NMS 0.7
over the smaller area, the top ``stage3_budget``.  Candidates are visited
by descending score with ties to the lower index, as a stable sort gives.
Crops are bilinear over the inclusive box with zero outside the image.

``cascade`` is teacher-forced: each stage takes the towers' outputs that
the program produced for its inputs (``towers``), so a rounding of the
program's bf16 towers cannot send the two cascades down different
branches; the towers themselves are compared on those same inputs
(``tower``).  What the reference computes itself is every tower input and
every decision between the towers, down to the landmarks and the chips.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench_torch.reference.numerics import Numerics, prelu

ARCFACE_112x96 = ((30.2946, 51.6963), (65.5318, 51.5014), (48.0252, 71.7366),
                  (33.5493, 92.3655), (62.7299, 92.2041))


# -- towers ---------------------------------------------------------------

def _conv(x, w, i, nx, stride=1):
    return nx.conv(x, w[f"conv.{i}.weight"], w[f"conv.{i}.bias"], stride)


def _flat(x):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def tower(kind: str, w: dict, x: torch.Tensor, nx: Numerics):
    """P-, R- or O-Net on preprocessed NHWC input; the outputs as the
    program's towers return them (P-Net's maps channels last)."""
    y = x.float().permute(0, 3, 1, 2)
    a = lambda t, i: prelu(t, w[f"prelu.{i}.alpha"])  # noqa: E731
    pool = lambda t, k, s: F.max_pool2d(t, k, s, ceil_mode=True)  # noqa
    if kind == "pnet":
        y = pool(a(_conv(y, w, 0, nx), 0), 2, 2)
        y = a(_conv(a(_conv(y, w, 1, nx), 1), w, 2, nx), 2)
        prob = torch.softmax(_conv(y, w, 3, nx), dim=1)
        return prob.permute(0, 2, 3, 1), _conv(y, w, 4, nx).permute(0, 2, 3, 1)
    dense = lambda t, i: nx.linear(t, w[f"dense.{i}.weight"],  # noqa: E731
                                   w[f"dense.{i}.bias"])
    if kind == "rnet":
        y = pool(a(_conv(y, w, 0, nx), 0), 3, 2)
        y = pool(a(_conv(y, w, 1, nx), 1), 3, 2)
        y = a(dense(_flat(a(_conv(y, w, 2, nx), 2)), 0), 3)
        return torch.softmax(dense(y, 1), dim=-1), dense(y, 2)
    y = pool(a(_conv(y, w, 0, nx), 0), 3, 2)
    y = pool(a(_conv(y, w, 1, nx), 1), 3, 2)
    y = pool(a(_conv(y, w, 2, nx), 2), 2, 2)
    y = a(dense(_flat(a(_conv(y, w, 3, nx), 3)), 0), 4)
    return torch.softmax(dense(y, 1), dim=-1), dense(y, 2), dense(y, 3)


# -- box arithmetic -----------------------------------------------------------

def _order(scores, valid):
    """Visit order: descending score, ties to the lower index; invalid
    candidates last, in index order."""
    masked = torch.where(valid, scores, -math.inf)
    return torch.sort(masked, dim=-1, descending=True, stable=True)[1]


def _take(x, idx):
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _overlap(a, b, mode):
    """Inclusive-pixel overlap of boxes a (n, 4) with b (n, K, 4)."""
    area = lambda t: (t[..., 2] - t[..., 0] + 1) * (t[..., 3] - t[..., 1] + 1)  # noqa
    iw = (torch.minimum(a[:, None, 2], b[..., 2])
          - torch.maximum(a[:, None, 0], b[..., 0]) + 1).clamp(min=0)
    ih = (torch.minimum(a[:, None, 3], b[..., 3])
          - torch.maximum(a[:, None, 1], b[..., 1]) + 1).clamp(min=0)
    inter = iw * ih
    if mode == "min":
        den = torch.minimum(area(a)[:, None], area(b))
    else:
        den = area(a)[:, None] + area(b) - inter
    return inter / den.clamp(min=1e-12)


def nms(boxes, scores, valid, thr, mode="union"):
    """Greedy keep-mask (n, K): a candidate is dropped when it overlaps an
    earlier kept one by more than ``thr``."""
    n, k = scores.shape
    order = _order(scores, valid)
    keep = torch.zeros_like(valid)
    dropped = ~valid
    rows = torch.arange(n, device=scores.device)
    for t in range(k):
        c = order[:, t]
        kept = ~dropped[rows, c]
        keep[rows, c] = kept
        hit = _overlap(boxes[rows, c], boxes, mode) > thr
        dropped = dropped | (hit & kept[:, None])
    return keep & valid


def top(budget, scores, valid, *arrays):
    """The ``budget`` best valid candidates first (then invalid ones)."""
    idx = _order(scores, valid)[:, :budget]
    return (_take(valid, idx), _take(scores, idx)) + tuple(
        _take(a, idx) for a in arrays)


def calibrate(boxes, reg):
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return boxes + torch.stack([w, h, w, h], dim=-1) * reg


def square(boxes):
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    side = torch.maximum(h, w)
    x1 = boxes[..., 0] + w * 0.5 - side * 0.5
    y1 = boxes[..., 1] + h * 0.5 - side * 0.5
    return torch.stack([x1, y1, x1 + side - 1.0, y1 + side - 1.0], dim=-1)


def clip(boxes, w, h):
    return torch.stack([boxes[..., 0].clamp(min=0.0),
                        boxes[..., 1].clamp(min=0.0),
                        boxes[..., 2].clamp(max=w - 1.0),
                        boxes[..., 3].clamp(max=h - 1.0)], dim=-1)


# -- crops and pyramid --------------------------------------------------------

def _bilinear_zero(img, ys, xs):
    """img (H, W, C); sample at float coordinates ys, xs (same shape),
    zero outside the image."""
    hgt, wid = img.shape[:2]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = y0 + dy, x0 + dx
            wgt = (1 - (ys - yi).abs()) * (1 - (xs - xi).abs())
            inside = (yi >= 0) & (yi < hgt) & (xi >= 0) & (xi < wid)
            v = img[yi.clamp(0, hgt - 1).long(), xi.clamp(0, wid - 1).long()]
            out = out + torch.where(inside, wgt, 0.0)[..., None] * v
    return out


def crops(images, boxes, size):
    """Crop each inclusive box of image i (boxes (n, K, 4)), resize to
    ``size`` by half-pixel bilinear sampling clamped into the box, and
    scale for the towers -> (n * K, size, size, 3)."""
    n, k = boxes.shape[:2]
    g = (torch.arange(size, dtype=torch.float32, device=images.device) + 0.5)
    out = []
    for i in range(n):
        b = boxes[i]
        sy = (b[:, 3] - b[:, 1] + 1.0) / size
        sx = (b[:, 2] - b[:, 0] + 1.0) / size
        ys = torch.minimum(torch.maximum(g * sy[:, None] - 0.5 + b[:, 1:2],
                                         b[:, 1:2]), b[:, 3:4])
        xs = torch.minimum(torch.maximum(g * sx[:, None] - 0.5 + b[:, 0:1],
                                         b[:, 0:1]), b[:, 2:3])
        yy = ys[:, :, None].expand(k, size, size)
        xx = xs[:, None, :].expand(k, size, size)
        out.append(_bilinear_zero(images[i].float(), yy, xx))
    return (torch.stack(out).reshape(n * k, size, size, 3) - 127.5) * 0.0078125


def pyramid(h, w, min_size, factor):
    scales, m, s = [], min(h, w) * 12.0 / min_size, 12.0 / min_size
    while m > 12.0:
        sh, sw = math.ceil(h * s), math.ceil(w * s)
        if sh >= 12 and sw >= 12:
            scales.append((s, sh, sw))
        s *= factor
        m *= factor
    return scales


def level_input(images, sh, sw):
    x = F.interpolate(images.float().permute(0, 3, 1, 2), size=(sh, sw),
                      mode="bilinear", align_corners=False)
    return (x.permute(0, 2, 3, 1) - 127.5) * 0.0078125


def level_boxes(prob, reg, scale, thr, budget):
    """The best ``budget`` cells of one level's maps (n, h, w)."""
    n, h, w = prob.shape
    flat = prob.reshape(n, -1)
    k = min(budget, h * w)
    scores, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    if k < budget:
        scores = torch.cat([scores, scores.new_full((n, budget - k),
                                                    -math.inf)], 1)
        idx = torch.cat([idx, idx.new_zeros((n, budget - k))], 1)
    r, c = (idx // w).float(), (idx % w).float()
    boxes = torch.stack([torch.round((2 * c + 1) / scale),
                         torch.round((2 * r + 1) / scale),
                         torch.round((2 * c + 1 + 12) / scale),
                         torch.round((2 * r + 1 + 12) / scale)], dim=-1)
    regs = _take(reg.reshape(n, h * w, 4), idx)
    valid = scores > thr
    return boxes, torch.where(valid, scores, 0.0), regs, valid


# -- the cascade, teacher-forced ----------------------------------------------

def cascade(images, cfg: dict, towers: dict):
    """``images`` (n, H, W, 3) raw; ``towers``: the program's outputs,
    ``pnet`` a list per level of (prob, reg), ``rnet`` (prob, reg),
    ``onet`` (prob, reg, lmk).  Returns the tower inputs it computed, per
    stage (with the mask of slots that matter), and the chosen landmarks
    (n, 5, 2) and found mask (n,)."""
    n, h, w = images.shape[:3]
    thr = cfg["thresholds"]
    inputs = {"pnet": [], "rnet": None, "onet": None}
    bl, sl, rl, vl = [], [], [], []
    levels = pyramid(h, w, cfg["min_size"], cfg["factor"])
    for (scale, sh, sw), (prob, reg) in zip(levels, towers["pnet"]):
        inputs["pnet"].append(level_input(images, sh, sw))
        b, s, r, v = level_boxes(prob[..., 1].float(), reg.float(), scale,
                                 thr[0], cfg["stage1_scale_budget"])
        v = v & nms(b, s, v, 0.5)
        bl.append(b)
        sl.append(s)
        rl.append(r)
        vl.append(v)
    boxes, scores = torch.cat(bl, 1), torch.cat(sl, 1)
    regs, valid = torch.cat(rl, 1), torch.cat(vl, 1)
    valid = valid & nms(boxes, scores, valid, 0.7)
    boxes = torch.round(square(calibrate(boxes, regs)))
    valid, scores, boxes = top(cfg["stage1_budget"], scores, valid, boxes)

    k = boxes.shape[1]
    inputs["rnet"] = (crops(images, boxes, 24), valid.reshape(-1))
    boxes = clip(boxes, w, h)
    prob, reg = towers["rnet"]
    scores, reg = prob[:, 1].float().reshape(n, k), reg.float().reshape(n, k, 4)
    valid = valid & (scores > thr[1])
    valid = valid & nms(boxes, scores, valid, 0.7)
    boxes = torch.round(square(calibrate(boxes, reg)))
    valid, scores, boxes = top(cfg["stage2_budget"], scores, valid, boxes)

    k = boxes.shape[1]
    inputs["onet"] = (crops(images, boxes, 48), valid.reshape(-1))
    boxes = clip(boxes, w, h)
    prob, reg, lmk = towers["onet"]
    scores = prob[:, 1].float().reshape(n, k)
    reg, lmk = reg.float().reshape(n, k, 4), lmk.float().reshape(n, k, 10)
    valid = valid & (scores > thr[2])
    bw = (boxes[..., 2] - boxes[..., 0] + 1.0)[..., None]
    bh = (boxes[..., 3] - boxes[..., 1] + 1.0)[..., None]
    marks = torch.stack([boxes[..., 0:1] + lmk[..., 0:5] * bw,
                         boxes[..., 1:2] + lmk[..., 5:10] * bh], dim=-1)
    boxes = calibrate(boxes, reg)
    valid = valid & nms(boxes, scores, valid, 0.7, mode="min")
    valid, scores, marks = top(cfg["stage3_budget"], scores, valid, marks)
    best = torch.argmax(torch.where(valid, scores, -math.inf), dim=1)
    found = valid.any(dim=1)
    return inputs, marks[torch.arange(n, device=images.device), best], found


# -- alignment ----------------------------------------------------------------

def template(out_size=(112, 112)):
    dx = 8.0 if out_size[1] == 112 else 0.0
    return torch.tensor(ARCFACE_112x96, dtype=torch.float64) + torch.tensor(
        [dx, 0.0], dtype=torch.float64)


def similarity(src, dst):
    """Least-squares similarity (Umeyama, rotation and uniform scale) of
    (n, 5, 2) points onto ``dst`` (5, 2), in float64 -> (n, 2, 3)."""
    src, dst = src.double(), dst.double().to(src.device)
    ms, md = src.mean(1, keepdim=True), dst.mean(0, keepdim=True)
    s, d = src - ms, dst - md
    den = (s ** 2).sum((1, 2)).clamp(min=1e-12)
    a = (d[None, :, 0] * s[..., 0] + d[None, :, 1] * s[..., 1]).sum(1) / den
    b = (d[None, :, 1] * s[..., 0] - d[None, :, 0] * s[..., 1]).sum(1) / den
    tx = md[0, 0] - (a * ms[:, 0, 0] - b * ms[:, 0, 1])
    ty = md[0, 1] - (b * ms[:, 0, 0] + a * ms[:, 0, 1])
    return torch.stack([torch.stack([a, -b, tx], -1),
                        torch.stack([b, a, ty], -1)], -2)


def warp(images, mats, out_size=(112, 112)):
    """cv2.warpAffine (bilinear, zero border) of each image by its forward
    affine (n, 2, 3), in float64."""
    n = images.shape[0]
    oh, ow = out_size
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=torch.float64,
                                         device=images.device),
                            torch.arange(ow, dtype=torch.float64,
                                         device=images.device), indexing="ij")
    out = []
    for i in range(n):
        m = mats[i]
        inv = torch.linalg.inv(m[:, :2])
        rx, ry = xs - m[0, 2], ys - m[1, 2]
        sx = inv[0, 0] * rx + inv[0, 1] * ry
        sy = inv[1, 0] * rx + inv[1, 1] * ry
        out.append(_bilinear_zero(images[i].double(), sy, sx))
    return torch.stack(out)


def footprint(mats, h, w, out_size=(112, 112)) -> int:
    """Distinct in-image source pixels under the four bilinear taps of
    every output pixel, summed over the affines (n, 2, 3)."""
    oh, ow = out_size
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=torch.float64,
                                         device=mats.device),
                            torch.arange(ow, dtype=torch.float64,
                                         device=mats.device), indexing="ij")
    total = 0
    for m in mats:
        inv = torch.linalg.inv(m[:, :2])
        rx, ry = xs - m[0, 2], ys - m[1, 2]
        sx = torch.floor(inv[0, 0] * rx + inv[0, 1] * ry)
        sy = torch.floor(inv[1, 0] * rx + inv[1, 1] * ry)
        keys = []
        for dy in (0, 1):
            for dx in (0, 1):
                yi, xi = sy + dy, sx + dx
                ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                keys.append((yi * w + xi)[ok])
        total += torch.unique(torch.cat(keys)).numel()
    return total


def chips(images, marks, found, out_size=(112, 112)):
    """The aligned chips, zero where no face was found."""
    c = warp(images, similarity(marks, template(out_size)), out_size)
    return torch.where(found[:, None, None, None], c, 0.0)
