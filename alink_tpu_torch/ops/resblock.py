"""Fused stride-1 ResNet bottleneck blocks (kernel K3).

Counterpart of ``alink_tpu/ops/resblock.py``.  One block is

    y1  = bf16(relu(x . W1 * s1 + b1))                 1x1 reduce
    y2  = bf16(relu(conv3x3_SAME(y1, W3) * s2 + b2))   zero padding
    y3  = y2 . W2 * s3 + b3                            1x1 expand
    out = bf16(relu(y3 + shortcut)),  shortcut = x . Wp * sp + bp  or  x

with bf16 operands, f32 accumulation and BN folded to f32 scale/shift: the
rounding points of the TPU kernel ``_block_kernel``.  Layout is NHWC, as in
the JAX package; the kernel keeps its own flat halo layout in shared
memory (``ops/qconv.py`` holds the chainable flat layout of K4).

- ``bottleneck_s1_reference`` — plain PyTorch (f32 products of bf16-rounded
  operands; TF32 is off package-wide, ``alink_tpu_torch/__init__.py``).
- ``bottleneck_s1_kernel``    — the hand-written kernel ``csrc/bottleneck.cu``;
  it takes weights already in its layout (``kernel_weights``: the JAX-layout
  matrices in bf16 plus, in the ``packed`` and ``vecs`` fields, the copy the
  kernel reads, zero-padded to the widths it tiles, ``pad_bottleneck`` and
  ``pack_bottleneck``), so a model prepares them once and no launch copies
  a weight.
- ``bottleneck_chain``        — dispatcher over a chain of blocks: the kernel
  on CUDA tensors (the padded width carried from block to block and sliced
  off once at the exit), the plain version on CPU tensors.  With grad
  enabled and an input or a weight that requires it, each block runs as
  ``BottleneckS1``, a ``torch.autograd.Function`` whose forward is that
  dispatch (the kernel pads and slices per block there) and whose
  backward recomputes y1, y2 and the ReLU masks with differentiable
  PyTorch ops (f32, the 3x3 as a convolution) and back-propagates through
  them: dx for FGSM through the frozen teacher, and the weight gradients
  too for the classifier's trainable backbone.  The TPU kernel has no
  backward either: the JAX package's gradients come from XLA's autodiff
  of unfused convolutions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from alink_tpu_torch import _build


class BottleneckPacked(NamedTuple):
    """The weight matrices in the order ``csrc/bottleneck.cu`` stages them
    (``pack_bottleneck``): for each pass of ``np`` output columns (128, or
    64 for a 64-wide matrix and for a projection block's W2 and Wp:
    ``_pass_width``) and each 16-row K slice, the slice's (np, 16)
    bf16 as np / 8 core matrices of 8 columns x 16 bytes (8 K rows), the
    two 8-row halves of the slice 128 bytes apart: the K-major layout a
    wgmma shared-memory descriptor reads without swizzle.  A pass's 64-row
    K chunks (and W3's taps) follow one another, so the kernel stages up
    to 4 chunks with one bulk copy.

    w1: (Cm / np, Cin / 16, np / 8, 2, 8, 8)
    w3: (Cm / np, 9, Cm / 16, np / 8, 2, 8, 8)
    w2: (Cout / np, Cm / 16, np / 8, 2, 8, 8)
    wp: (Cout / np, Cin / 16, np / 8, 2, 8, 8)
    element [p, s, g, h, i, j] of a matrix W (K, N) is
    W[16 s + 8 h + j, np p + 8 g + i].
    """

    w1: torch.Tensor
    w3: torch.Tensor
    w2: torch.Tensor
    wp: torch.Tensor | None


class BottleneckVecs(NamedTuple):
    """The folded-BN scales and shifts the kernel reads: f32, zero past the
    real channels (``pad_bottleneck``), so every pad channel of y1, y2 and
    the output is relu(0 * acc + 0) = 0."""

    s1: torch.Tensor
    b1: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    s3: torch.Tensor
    b3: torch.Tensor
    sp: torch.Tensor | None
    bp: torch.Tensor | None


class BottleneckWeights(NamedTuple):
    """One stride-1 bottleneck, BN folded to (scale, shift), JAX layouts.

    w1: (Cin, Cm)        s1/b1: (Cm,)
    w3: (3, 3, Cm, Cm)   s2/b2: (Cm,)     HWIO
    w2: (Cm, Cout)       s3/b3: (Cout,)
    wp: (Cin, Cout) projection shortcut (None = identity, Cin == Cout)
    sp/bp: (Cout,)
    packed, vecs: the kernel's copy of the matrices and of the scales and
    shifts, zero-padded to the widths it tiles (``kernel_weights`` sets
    them where the kernel takes the shapes); the plain version ignores
    them.
    """

    w1: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    w3: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    w2: torch.Tensor
    s3: torch.Tensor
    b3: torch.Tensor
    wp: torch.Tensor | None = None
    sp: torch.Tensor | None = None
    bp: torch.Tensor | None = None
    packed: BottleneckPacked | None = None
    vecs: BottleneckVecs | None = None


# The weight tensors of a block (the fields before ``packed``).
_TENSORS = BottleneckWeights._fields[:12]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and hold in f32."""
    return t.to(torch.bfloat16).float()


@torch.no_grad()
def bottleneck_s1_reference(x: torch.Tensor,
                            wts: BottleneckWeights) -> torch.Tensor:
    """Plain stride-1 bottleneck: (N, H, W, Cin) -> (N, H, W, Cout) bf16."""
    return _block_plain(x, wts)


def _block_plain(x: torch.Tensor, wts: BottleneckWeights) -> torch.Tensor:
    """The plain version's arithmetic, differentiable when grad is enabled
    (the card check of the backward compares against its autograd)."""
    n, h, w, cin = x.shape
    cm, cout = wts.w2.shape
    f = lambda t: t.float()  # noqa: E731
    xf = _bf16(x).reshape(-1, cin)
    y1 = torch.relu(xf @ _bf16(wts.w1) * f(wts.s1) + f(wts.b1))
    # The 3x3 as 9 shifted products over the zero-padded y1: plain f32
    # matmuls, where a cuDNN f32 convolution may pick a Winograd or FFT
    # algorithm that rounds differently.
    y1 = F.pad(_bf16(y1).reshape(n, h, w, cm), (0, 0, 1, 1, 1, 1))
    k3 = _bf16(wts.w3)
    y2 = sum(y1[:, dy:dy + h, dx:dx + w].reshape(-1, cm) @ k3[dy, dx]
             for dy in range(3) for dx in range(3))
    y2 = _bf16(torch.relu(y2 * f(wts.s2) + f(wts.b2)))
    y3 = y2 @ _bf16(wts.w2) * f(wts.s3) + f(wts.b3)
    if wts.wp is not None:
        sc = xf @ _bf16(wts.wp) * f(wts.sp) + f(wts.bp)
    else:
        sc = xf
    out = torch.relu(y3 + sc).to(torch.bfloat16)
    return out.reshape(n, h, w, cout)


# Widths of csrc/bottleneck.cu: x is staged in 64-channel chunks (Cin %
# 64), the weights in passes of 128 output columns or one pass of 64 (Cm
# and Cout 64 or a multiple of 128).  Other widths run zero-padded, as the
# TPU kernel pads every width to 128 lanes: ``pad_bottleneck`` pads Cin, Cm
# and Cout to ``padded_width`` (Cin too, so that a block's padded output is
# the next block's padded input and an identity shortcut pads Cin and Cout
# alike).  y1 and y2 of a tile live in shared memory beside a ring of at
# least 2 entries while they fit the 227 KB a block can have on an H100
# (every VGGFace-ResNet50 shape: Cm <= 512); a wider Cm keeps them in a
# global scratch, one region per block of a persistent grid
# (``launch_plan``'s ``global_act``), so every width runs.
_KC = 64


def padded_width(c: int) -> int:
    """The width the kernel runs a channel count at: 64, or the next
    multiple of 128 (a multiple of 64 either way)."""
    return 64 if c <= 64 else -(-c // 128) * 128


def kernel_takes(cin: int, cm: int, cout: int) -> bool:
    """Whether the kernel runs a block of these widths: every positive
    width (zero-padded, y1 and y2 in global scratch past Cm 512)."""
    return min(cin, cm, cout) > 0


def _pass_width(n: int, proj: bool = False) -> int:
    """Columns of a pass: 128, or 64 for a 64-wide matrix and for a
    projection block's W2 and Wp (its stage 3 holds two accumulators)."""
    return 64 if proj else min(n, 128)


def _pack_matrix(m: torch.Tensor, np_: int) -> torch.Tensor:
    """(K, N) -> (N / np, K / 16, np / 8, 2, 8, 8) bf16, the core-matrix
    order of ``BottleneckPacked``."""
    k, n = m.shape
    t = m.to(torch.bfloat16).reshape(k // 16, 2, 8, n // np_, np_ // 8, 8)
    return t.permute(3, 0, 4, 1, 5, 2).contiguous()


def _unpack_matrix(t: torch.Tensor) -> torch.Tensor:
    """``_pack_matrix``'s inverse: (K, N)."""
    passes, slices, groups = t.shape[:3]
    return t.permute(1, 3, 5, 0, 2, 4).reshape(slices * 16,
                                               passes * groups * 8)


@torch.no_grad()
def pack_bottleneck(wts: BottleneckWeights) -> BottleneckPacked:
    """The matrices of ``wts`` in ``csrc/bottleneck.cu``'s staging order
    (``BottleneckPacked``: per pass, K-major core matrices that the
    kernel's wgmma descriptors read as B, 64-row K chunks contiguous), on
    their device.  The JAX-layout matrices stay as they are for the plain
    version and ``BottleneckS1``'s backward."""
    cm, cout = wts.w2.shape
    np12, np3 = _pass_width(cm), _pass_width(cout, wts.wp is not None)
    w3 = torch.stack([_pack_matrix(wts.w3[dy, dx], np12) for dy in range(3)
                      for dx in range(3)], dim=1)
    return BottleneckPacked(
        _pack_matrix(wts.w1, np12), w3.contiguous(),
        _pack_matrix(wts.w2, np3),
        None if wts.wp is None else _pack_matrix(wts.wp, np3))


def unpack_bottleneck(p: BottleneckPacked) -> tuple[torch.Tensor, ...]:
    """``pack_bottleneck``'s inverse: (w1, w3 HWIO, w2, wp or None), bf16."""
    w3 = torch.stack([_unpack_matrix(p.w3[:, t]) for t in range(9)])
    return (_unpack_matrix(p.w1), w3.reshape(3, 3, *w3.shape[1:]),
            _unpack_matrix(p.w2),
            None if p.wp is None else _unpack_matrix(p.wp))


_MATRICES = ("w1", "w3", "w2", "wp")


@torch.no_grad()
def pad_bottleneck(wts: BottleneckWeights) -> BottleneckWeights:
    """``wts`` zero-padded to the widths the kernel runs (``padded_width``
    of Cin, Cm and Cout): zero rows and columns in the matrices, scale and
    shift 0 on every pad channel.  Exact: a pad channel of y1, y2 and the
    output is relu(0) = 0 and meets only zero weights downstream."""
    cin, cm = wts.w1.shape
    cout = wts.w2.shape[1]
    ci, cmp_, co = padded_width(cin), padded_width(cm), padded_width(cout)

    def mat(t, rows, cols):
        return None if t is None else F.pad(
            t, (0, cols - t.shape[-1], 0, rows - t.shape[-2]))

    def vec(t, c):
        return None if t is None else F.pad(t, (0, c - t.shape[0]))

    return BottleneckWeights(
        mat(wts.w1, ci, cmp_), vec(wts.s1, cmp_), vec(wts.b1, cmp_),
        mat(wts.w3, cmp_, cmp_), vec(wts.s2, cmp_), vec(wts.b2, cmp_),
        mat(wts.w2, cmp_, co), vec(wts.s3, co), vec(wts.b3, co),
        mat(wts.wp, ci, co), vec(wts.sp, co), vec(wts.bp, co))


# Tiling of csrc/bottleneck.cu.  A tile is th x tw output pixels of one
# image; y1 is computed on its (th + 2) x (tw + 2) halo in flat row order
# (row stride hs = tw + 2), y2 and the output on the tile's th * hs flat
# rows, the 2 halo columns of each row computed and dropped.  Every stage
# runs on whole 64-row wgmma products: stage 1 on ``mt1`` 64-row tiles
# (<= 3: a warpgroup's accumulators), stages 2 and 3 on ``mt2`` (<= 2).
# Shared memory holds y1 (halo rows) and y2 (64 mt2 rows) of Cm bf16 and a
# ring of 2-4 entries, each one 64-row K chunk of weights (16 KB at most)
# and its x (``xrows`` rows of 64 channels), or up to 4 chunks of weights.
# Where y1 and y2 do not fit beside a 2-entry ring, they live in a global
# scratch of ``act_rows`` x Cm bf16 per block, on one persistent block per
# SM.  ``launch_plan`` decides each launch and the wrapper passes its tile,
# ring depth, cluster size, grid and scratch to the kernel's entry point,
# which checks them.
_B_CHUNK = 128 * _KC * 2
_MAX_CHUNKS = 4
_MAX_MT1, _MAX_MT2 = 3, 2
_MAX_BOX = 256
_MAX_SLOTS = 4
_MAX_SMEM = 232448
_BARS = 8 * (2 * _MAX_SLOTS + 2)
_SMS = 132                     # streaming multiprocessors of an H100 SXM
# What a tile costs beyond its rows: streaming the block's weights once,
# charged as this many rows of every stage.
_TILE_ROWS = 64
# A tile whose y1 and y2 live in global scratch, against one in shared
# memory: its A fragments come back through plain loads from L2.
_GLOBAL_COST = 1.5


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _a(b: int, align: int) -> int:
    return _ceil(b, align) * align


class BottleneckTile(NamedTuple):
    """A tile of ``th`` x ``tw`` outputs (``csrc/bottleneck.cu``'s
    ``Geom``): the halo's row stride ``hs`` = tw + 2 and rows ``halo`` (y1's
    rows), the 64-row tiles of stage 1 (``mt1``, over the halo) and of
    stages 2-3 (``mt2``, over th * hs flat rows), and the rows of x a ring
    entry holds (stage 1 reads 64 mt1, the projection up to 64 mt2 + hs)."""

    th: int
    tw: int
    hs: int
    halo: int
    mt1: int
    mt2: int
    xrows: int


def bottleneck_tile(th: int, tw: int) -> BottleneckTile:
    hs = tw + 2
    halo = (th + 2) * hs
    mt1, mt2 = _ceil(halo, 64), _ceil(th * hs, 64)
    return BottleneckTile(th, tw, hs, halo, mt1, mt2,
                          _a(max(64 * mt1, 64 * mt2 + hs + 1), 8))


def _smem(cm: int, tile: BottleneckTile, slots: int,
          global_act: bool = False) -> tuple[int, int]:
    """(bytes of a ring entry, dynamic shared memory of a block): y1 and
    y2 unless global, the ring, the barriers and 1024 bytes of alignment
    (the kernel's ``smem_plan``)."""
    y2_at = 0 if global_act else _a(tile.halo * cm * 2, 128)
    ring_at = 0 if global_act else _a(y2_at + 64 * tile.mt2 * cm * 2, 1024)
    entry = _a(_B_CHUNK + tile.xrows * 128, 1024)
    return entry, ring_at + slots * entry + _BARS + 1024


@functools.lru_cache(maxsize=256)
def choose_tile(h: int, w: int, cin: int, cm: int, cout: int,
                proj: bool) -> BottleneckTile:
    """The tile with the fewest rows computed over an image, each stage's
    rows weighed by its operations a row and each tile charged
    ``_TILE_ROWS`` more rows for streaming the weights, among those whose
    stages fit ``_MAX_MT1`` and ``_MAX_MT2`` 64-row tiles; balanced (th and
    tw split h and w evenly), the earliest found on a tie.  A tile whose
    y1 and y2 do not fit shared memory beside a 2-entry ring (they go to
    global scratch) is charged ``_GLOBAL_COST`` times its rows: at
    RetinaFace's 20^2, Cm 512, a 5 x 10 tile in shared memory (1.38 times
    the rows) runs faster than 5 x 20 in global scratch; a Cm past 512
    (a shared-memory tile 1.9 to 11 times the rows) keeps the global
    scratch; at VGGFace-ResNet50's shapes the cheapest tile fits."""
    c1 = cin * cm
    c23 = 9 * cm * cm + cm * cout + (cin * cout if proj else 0)
    best = None
    for nx in range(1, w + 1):
        tw = _ceil(w, nx)
        if tw + 2 > _MAX_BOX or nx > 1 and tw == _ceil(w, nx - 1):
            continue
        for ny in range(1, h + 1):
            th = _ceil(h, ny)
            if th + 2 > _MAX_BOX or ny > 1 and th == _ceil(h, ny - 1):
                continue
            t = bottleneck_tile(th, tw)
            if t.mt1 > _MAX_MT1 or t.mt2 > _MAX_MT2:
                continue
            tiles = _ceil(h, th) * _ceil(w, tw)
            cost = tiles * (c1 * (64 * t.mt1 + _TILE_ROWS)
                            + c23 * (64 * t.mt2 + _TILE_ROWS))
            if _smem(cm, t, 2)[1] > _MAX_SMEM:
                cost *= _GLOBAL_COST
            if best is None or cost < best[0]:
                best = (cost, t)
    return best[1]


class BottleneckPlan(NamedTuple):
    """How ``csrc/bottleneck.cu`` runs one launch: the tile, ring depth,
    cluster size and grid its entry point is given, and the ring entries
    its producer fills."""

    tile: BottleneckTile
    tiles_x: int
    tiles_y: int
    tiles: int              # n * tiles_x * tiles_y
    split: int              # blocks per tile (a cluster when > 1)
    blocks: int             # tiles * split, or one per SM (persistent)
    slots: int              # ring entries
    entry: int              # bytes of a ring entry
    smem: int               # dynamic shared memory per block (bytes)
    global_act: bool        # y1 and y2 in global scratch (a wide Cm)
    act_rows: int           # y1 and y2 rows a block (global scratch)
    # The ring entries of the block of each rank in a cluster, each a
    # tuple of 64-row K chunks: (stage, pass, tap, k0, proj, last of its
    # pass).
    schedule: tuple[tuple[tuple[tuple[int, int, int, int, bool, bool], ...],
                          ...], ...]


def _schedule(cin: int, cm: int, cout: int, proj: bool, passes12: range,
              passes3: range, nb12: int, nb3: int) -> tuple:
    entries = []

    def run(chunks, nb):        # a pass's chunks, nb to an entry
        entries.extend(tuple(chunks[i:i + nb])
                       for i in range(0, len(chunks), nb))

    for pas in passes12:
        run([(1, pas, 0, k0, False, k0 + _KC == cin)
             for k0 in range(0, cin, _KC)], 1)
    for pas in passes12:
        run([(2, pas, tap, k0, False, tap == 8 and k0 + _KC == cm)
             for tap in range(9) for k0 in range(0, cm, _KC)], nb12)
    for pas in passes3:
        run([(3, pas, 0, k0, False, not proj and k0 + _KC == cm)
             for k0 in range(0, cm, _KC)], nb3)
        run([(3, pas, 0, k0, True, k0 + _KC == cin)
             for k0 in range(0, cin if proj else 0, _KC)], 1)
    return tuple(entries)


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, h: int, w: int, cin: int, cm: int, cout: int,
                proj: bool, sms: int = _SMS) -> BottleneckPlan:
    """The kernel's tile (``choose_tile``), grid, cluster size, ring depth,
    home of y1 and y2 and ring entries for one launch on a card of ``sms``
    SMs (the wrapper passes the card's count), from the shapes alone.
    Block b walks tiles b, b + blocks / split, ...: one persistent block
    per SM where the tiles outnumber the SMs; a cluster of 4 blocks a tile
    where that many fit the SMs (and divide every stage's passes), else of
    2; else one block a tile.  A Cm whose y1 and y2 do not fit shared
    memory beside a 2-entry ring keeps them in global scratch, without
    clusters."""
    t = choose_tile(h, w, cin, cm, cout, proj)
    global_act = _smem(cm, t, 2)[1] > _MAX_SMEM
    slots = max(s for s in range(2, _MAX_SLOTS + 1)
                if _smem(cm, t, s, global_act)[1] <= _MAX_SMEM)
    entry, smem = _smem(cm, t, slots, global_act)
    tx, ty = _ceil(w, t.tw), _ceil(h, t.th)
    tiles = n * tx * ty
    np12, np3 = _pass_width(cm), _pass_width(cout, proj)
    p12, p3 = cm // np12, cout // np3
    split = 1 if global_act else next(
        (k for k in (4, 2) if p12 % k == 0 and p3 % k == 0
         and tiles * k <= sms), 1)
    per12, per3 = p12 // split, p3 // split
    nb12, nb3 = (min(_MAX_CHUNKS, entry // (np_ * _KC * 2))
                 for np_ in (np12, np3))
    sched = tuple(_schedule(cin, cm, cout, proj,
                            range(r * per12, (r + 1) * per12),
                            range(r * per3, (r + 1) * per3), nb12, nb3)
                  for r in range(split))
    persistent = split == 1 and tiles > sms
    return BottleneckPlan(t, tx, ty, tiles, split,
                          sms if persistent else tiles * split, slots, entry,
                          smem, global_act, t.halo + 64 * t.mt2, sched)


@torch.no_grad()
def kernel_weights(wts: BottleneckWeights, device=None) -> BottleneckWeights:
    """``wts`` in the layout ``bottleneck_s1_kernel`` reads: the weight
    matrices bf16, scale and shift f32, all contiguous on ``device``, and,
    where the kernel takes the shapes, its copy padded to the widths it
    runs (``pad_bottleneck``): the matrices packed as it stages them
    (``pack_bottleneck``) and the scales and shifts (``vecs``).  The plain
    version gives the same result on either form (it rounds the matrices
    to bf16 itself and reads only the unpadded fields)."""
    kw = BottleneckWeights(*(
        None if t is None else t.to(
            device, torch.bfloat16 if name in _MATRICES else torch.float32
        ).contiguous()
        for name, t in zip(_TENSORS, wts[:len(_TENSORS)])))
    cin, cm = kw.w1.shape
    if kernel_takes(cin, cm, kw.w2.shape[1]):
        pw = pad_bottleneck(kw)
        kw = kw._replace(packed=pack_bottleneck(pw), vecs=BottleneckVecs(
            *(None if t is None else t.contiguous() for t in
              (pw.s1, pw.b1, pw.s2, pw.b2, pw.s3, pw.b3, pw.sp, pw.bp))))
    return kw


def _check_kernel_layout(wts: BottleneckWeights, dev) -> None:
    for name, t in zip(_TENSORS, wts[:len(_TENSORS)]):
        want = torch.bfloat16 if name in _MATRICES else torch.float32
        if t is not None and (t.device != dev or t.dtype != want
                              or not t.is_contiguous()):
            raise ValueError(
                f"bottleneck_s1_kernel: {name} is {t.dtype} on {t.device}"
                f"{'' if t.is_contiguous() else ', not contiguous'}; pass "
                f"weights from kernel_weights(wts, {dev}) ({want} contiguous)")


def _check_packed(wts: BottleneckWeights, dev) -> None:
    p, v = wts.packed, wts.vecs
    if p is None or v is None:
        raise ValueError("bottleneck_s1_kernel: no packed weights; pass "
                         f"weights from kernel_weights(wts, {dev})")
    cin, cm = wts.w1.shape
    ci, cmp_, co = (padded_width(c) for c in (cin, cm, wts.w2.shape[1]))
    proj = wts.wp is not None
    sizes = {"w1": ci * cmp_, "w3": 9 * cmp_ * cmp_, "w2": cmp_ * co,
             "wp": ci * co if proj else None}
    for name, t in zip(BottleneckPacked._fields, p):
        if (t is None) != (sizes[name] is None) or t is not None and (
                t.device != dev or t.dtype != torch.bfloat16
                or not t.is_contiguous() or t.numel() != sizes[name]):
            raise ValueError(f"bottleneck_s1_kernel: packed {name} does not "
                             f"match {name}; pass weights from "
                             f"kernel_weights(wts, {dev})")
    widths = (cmp_, cmp_, cmp_, cmp_, co, co, co if proj else None,
              co if proj else None)
    for name, t, c in zip(BottleneckVecs._fields, v, widths):
        if (t is None) != (c is None) or t is not None and (
                t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or t.shape != (c,)):
            raise ValueError(f"bottleneck_s1_kernel: padded {name} does not "
                             f"match {name}; pass weights from "
                             f"kernel_weights(wts, {dev})")


@torch.no_grad()
def bottleneck_s1_kernel(x: torch.Tensor, wts: BottleneckWeights,
                         keep_padded: bool = False) -> torch.Tensor:
    """Launch ``csrc/bottleneck.cu`` on a CUDA tensor (N, H, W, C), with
    ``wts`` from ``kernel_weights`` on the same device.

    Takes any Cin, Cm and Cout, run at their padded widths (y1 and y2 in
    a global scratch this function allocates where they do not fit shared
    memory: a padded Cm past 512 at VGGFace's feature-map sizes); C is
    Cin, or Cin's padded width with zeros in the pad channels (a padded
    output of this function).  The output is
    (N, H, W, Cout) bf16, or (N, H, W, padded Cout) with ``keep_padded``.
    """
    n, h, w, c = x.shape
    cin, cm = wts.w1.shape
    cout = wts.w2.shape[1]
    if tuple(wts.w3.shape) != (3, 3, cm, cm) or wts.w2.shape[0] != cm:
        raise ValueError(f"bottleneck weights do not chain: w1 "
                         f"{tuple(wts.w1.shape)}, w3 {tuple(wts.w3.shape)}, "
                         f"w2 {tuple(wts.w2.shape)}")
    if wts.wp is None and cin != cout:
        raise ValueError("identity shortcut requires Cin == Cout")
    cin_p, cm_p, cout_p = (padded_width(v) for v in (cin, cm, cout))
    if c not in (cin, cin_p):
        raise ValueError(f"bottleneck weights do not chain: x has {c} "
                         f"channels, w1 {tuple(wts.w1.shape)}")
    if not x.is_cuda:
        raise ValueError("bottleneck_s1_kernel needs a CUDA tensor")
    dev = x.device
    _check_kernel_layout(wts, dev)
    _check_packed(wts, dev)
    plan = launch_plan(n, h, w, cin_p, cm_p, cout_p, wts.wp is not None,
                       torch.cuda.get_device_properties(dev)
                       .multi_processor_count)
    x = x.to(torch.bfloat16).contiguous()
    if c < cin_p:
        x = F.pad(x, (0, cin_p - c))
    pk, v = wts.packed, wts.vecs
    out = torch.ops.alink_tpu_torch.bottleneck(
        x, [pk.w1, v.s1, v.b1, pk.w3, v.s2, v.b2, pk.w2, v.s3, v.b3, pk.wp,
            v.sp, v.bp],
        [n, h, w, cin_p, cm_p, cout_p, plan.slots, plan.split, plan.blocks,
         plan.tile.th, plan.tile.tw, plan.act_rows if plan.global_act else 0])
    if keep_padded or cout_p == cout:
        return out
    return out[..., :cout].contiguous()


def _launch(x: torch.Tensor, weights: list[torch.Tensor | None],
            plan: list[int]) -> torch.Tensor:
    """The CUDA implementation of the ``alink_tpu_torch::bottleneck`` op:
    the output (and, where ``act_rows`` > 0, the global y1/y2 scratch of
    ``act_rows`` x Cm a block) allocated here, ``alink_bottleneck``
    launched on the current stream with ``launch_plan``'s choices."""
    n, h, w, cin_p, cm_p, cout_p, slots, split, blocks, th, tw, act_rows = \
        plan
    out = torch.empty((n, h, w, cout_p), dtype=torch.bfloat16,
                      device=x.device)
    act = (torch.empty((blocks, act_rows, cm_p), dtype=torch.bfloat16,
                       device=x.device) if act_rows else None)
    _build.launch("alink_bottleneck", x.device, x.data_ptr(), n, h, w, cin_p,
                  cm_p, cout_p,
                  *(None if t is None else t.data_ptr() for t in weights),
                  out.data_ptr(), None if act is None else act.data_ptr(),
                  slots, split, blocks, th, tw)
    return out


# A dispatcher op of its own, as ``alink_tpu_torch::attention_core``: the
# profiler links a kernel to the op open at its launch, so K3's launches
# count under the program's spans (RetinaFace's ``retina.backbone``).
_OPS = torch.library.Library("alink_tpu_torch", "FRAGMENT")
_OPS.define("bottleneck(Tensor x, Tensor?[] weights, int[] plan) -> Tensor")
_OPS.impl("bottleneck", _launch, "CUDA")


def bottleneck_chain_reference(x: torch.Tensor,
                               blocks: tuple[BottleneckWeights, ...]
                               ) -> torch.Tensor:
    """A chain of plain stride-1 bottlenecks: NHWC in, NHWC bf16 out."""
    for wts in blocks:
        x = bottleneck_s1_reference(x, wts)
    return x


def _laid_out(wts: BottleneckWeights, device) -> BottleneckWeights:
    """``wts`` in the kernel's layout: as given when they carry it (a
    frozen model caches it), else made now (a trainable model's fold)."""
    return wts if wts.packed is not None else kernel_weights(wts, device)


def _block_forward(x: torch.Tensor, wts: BottleneckWeights) -> torch.Tensor:
    """One block without autograd: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.is_cuda:
        return bottleneck_s1_kernel(x, _laid_out(wts, x.device))
    if x.device.type != "cpu":
        raise ValueError(f"no bottleneck for device {x.device}")
    return bottleneck_s1_reference(x, wts)


def _block_recompute(x: torch.Tensor, wts: BottleneckWeights) -> torch.Tensor:
    """The block as differentiable f32 ops on NHWC ``x`` (the backward's
    recompute): the operands and y1, y2 rounded to bf16 as the kernel
    rounds them, so the ReLU masks are the forward's up to the order of
    f32 sums; the rounding passes gradients through unchanged."""
    n, h, w, cin = x.shape
    cm = wts.w1.shape[1]
    f = lambda t: t.float()  # noqa: E731
    y1 = _bf16(torch.relu(x.reshape(-1, cin) @ _bf16(f(wts.w1)) * f(wts.s1)
                          + f(wts.b1)))
    y1 = y1.reshape(n, h, w, cm).permute(0, 3, 1, 2)
    k3 = _bf16(f(wts.w3)).permute(3, 2, 0, 1)        # HWIO -> OIHW
    y2 = F.conv2d(y1, k3, padding=1).permute(0, 2, 3, 1).reshape(-1, cm)
    y2 = _bf16(torch.relu(y2 * f(wts.s2) + f(wts.b2)))
    y3 = y2 @ _bf16(f(wts.w2)) * f(wts.s3) + f(wts.b3)
    xf = x.reshape(-1, cin)
    sc = xf if wts.wp is None else \
        xf @ _bf16(f(wts.wp)) * f(wts.sp) + f(wts.bp)
    return torch.relu(y3 + sc).reshape(n, h, w, -1)


class BottleneckS1(torch.autograd.Function):
    """One stride-1 block with gradients for its input and for each weight
    tensor that requires one.

    Forward: the kernel on a CUDA tensor (its layout made without
    autograd when the weights arrive unpacked: a trainable model passes
    the fold of its parameters), the plain version on a CPU tensor.
    Backward: the block recomputed in f32 from the saved input and weights
    (``_block_recompute``) and differentiated in both; autograd carries the
    weight gradients on through the fold to the convolutions and the BN
    parameters.  The TPU kernel has no backward: the JAX classifier trains
    this backbone through flax's plain forward."""

    @staticmethod
    def forward(ctx, x, *wts):
        wts = BottleneckWeights(*wts)
        ctx.save_for_backward(x, *wts[:len(_TENSORS)])
        return _block_forward(x, wts)

    @staticmethod
    def backward(ctx, grad_out):
        x, *ts = ctx.saved_tensors
        need = ctx.needs_input_grad[:1 + len(_TENSORS)]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip([_bf16(x)] + ts, need)]
            out = _block_recompute(leaves[0], BottleneckWeights(*leaves[1:]))
            wanted = [t for t, n in zip(leaves, need) if n and t is not None]
            grads = iter(torch.autograd.grad(out, wanted, grad_out.float()))
        return tuple(
            next(grads).to(t.dtype) if n and t is not None else None
            for t, n in zip([x] + ts, need)) + (None,) * (
                len(BottleneckWeights._fields) - len(_TENSORS))


def bottleneck_chain(x: torch.Tensor,
                     blocks: tuple[BottleneckWeights, ...]) -> torch.Tensor:
    """A chain of stride-1 bottlenecks: the kernel on a CUDA tensor (the
    weights laid out for it where they are not yet), the plain version on
    a CPU tensor; differentiable (``BottleneckS1``) when grad is enabled
    and ``x`` or a weight requires it.  NHWC in, NHWC bf16 out."""
    grad = torch.is_grad_enabled() and (x.requires_grad or any(
        t is not None and t.requires_grad
        for wts in blocks for t in wts[:len(_TENSORS)]))
    if x.is_cuda and not grad and blocks:
        # The padded width passes from block to block; sliced off once.
        for wts in blocks:
            x = bottleneck_s1_kernel(x, _laid_out(wts, x.device),
                                     keep_padded=True)
        cout = blocks[-1].w2.shape[1]
        return x if x.shape[-1] == cout else x[..., :cout].contiguous()
    for wts in blocks:
        x = BottleneckS1.apply(x, *wts) if grad else _block_forward(x, wts)
    return x
