"""Int8 3x3 stride-1 SAME convolution on a chainable flat layout (kernel K4).

Counterpart of ``alink_tpu/ops/qconv.py``, with its public layout, so that
chains cross between the packages:

- **Flat layout** (``flat_layout``): a batch of zero-padded images lives in
  one 2-D int8 array of ``lead + n * r`` rows.  Row ``lead + i * r +
  (y + 1) * wp + (x + 1)`` holds the channels of pixel (y, x) of image i;
  ``wp >= w + 2`` pad columns absorb the horizontal wrap of a tap, the
  tail of each image's ``r`` rows its vertical halo, and the ``lead`` zero
  rows let the first rows' taps read in bounds.  Every non-pixel row is 0.
- A tap (dy, dx) of the 3x3 is then a shift of the rows by
  ``(dy - 1) * wp + (dx - 1)``: the conv is 9 row-shifted products,
  accumulated in int32.  Output rows are headless (no lead band) and carry
  the same layout: ``add_lead`` feeds one conv's output to the next,
  ``flat_to_nhwc`` leaves the format.
- Input channels are Cin or Cin padded to 128; output columns are Cout
  padded to 128; the output has exactly ``lo.n * lo.r`` rows.
- Epilogues, per output channel: ``affine`` ``z = acc * scale + bias`` (a
  rounded multiply, then a rounded add) to bf16 or f32; ``prelu_quant``
  ``d = z if z >= 0 else alpha * z``, ``clip(round_half_even(d * qscale),
  -127, 127)`` to int8.  Non-pixel output rows are 0.

``conv3x3_s1_int8_flat`` dispatches: the hand-written kernel
``csrc/qconv.cu`` on CUDA tensors (it replaces the TPU kernel
``alink_tpu/ops/qconv.py:_conv_kernel``), the plain version
``conv3x3_s1_int8_flat_reference`` on CPU tensors.  The kernel takes its
weights from ``pack_conv`` (made once per weight set; the op packs on
every call) and reads Cin unpadded: a 64-channel input runs as K = 64.
``launch_plan`` decides how it runs a launch.  The plain version
forms the accumulator as 9 shifted float64 products, exact because
|acc| <= 9 * Cin * 127^2 < 2^53 (PyTorch has no integer matmul on CUDA,
and float32 is not exact once |acc| > 2^24), then casts it to int32 and
float32 before the epilogue, as the JAX reference does.  The TPU tiling
knobs ``vmem_budget_bytes`` and ``interpret`` are accepted and ignored.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from alink_tpu_torch import _build

_EPILOGUES = ("affine", "prelu_quant")


def _rup(x: int, m: int) -> int:
    return -(-x // m) * m


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantisation: round(x / scale) (half to even)
    clipped to [-127, 127]."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


class FlatLayout(NamedTuple):
    """Geometry of the flat activation buffer (see the module doc)."""

    n: int       # images
    h: int       # pixel rows
    w: int       # pixel cols
    wp: int      # padded row width (>= w + 2, multiple of 8)
    r: int       # rows per image (multiple of lcm(32, wp))
    lead: int    # zero rows at the top (multiple of 32, >= wp + 2)

    @property
    def rows(self) -> int:
        return self.lead + self.n * self.r


def flat_layout(n: int, h: int, w: int) -> FlatLayout:
    wp = _rup(w + 2, 8)
    lcm = wp * 32 // math.gcd(wp, 32)
    r = _rup((h + 2) * wp, lcm)
    lead = _rup(wp + 2, 32)
    return FlatLayout(n, h, w, wp, r, lead)


def nhwc_to_flat(x: torch.Tensor, lo: FlatLayout) -> torch.Tensor:
    """(N, H, W, C) -> conv input format: (lead + N * r, C), zeros in every
    non-pixel row."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, lo.wp - w - 1, 1, 1))
    xf = F.pad(xp.reshape(n, (h + 2) * lo.wp, c),
               (0, 0, 0, lo.r - (h + 2) * lo.wp))
    return F.pad(xf.reshape(n * lo.r, c), (0, 0, lo.lead, 0))


def add_lead(f: torch.Tensor, lo: FlatLayout) -> torch.Tensor:
    """Headless conv output -> conv input format (prepend the lead rows)."""
    return F.pad(f[:lo.n * lo.r], (0, 0, lo.lead, 0))


def flat_to_nhwc(f: torch.Tensor, lo: FlatLayout) -> torch.Tensor:
    """Headless flat rows (>= N * r, C) -> (N, H, W, C) pixel rows."""
    c = f.shape[-1]
    body = f[:lo.n * lo.r].reshape(lo.n, lo.r, c)
    body = body[:, lo.wp:(lo.h + 1) * lo.wp].reshape(lo.n, lo.h, lo.wp, c)
    return body[:, :, 1:lo.w + 1]


class _Operands(NamedTuple):
    """One conv's operands in the padded layout both versions take."""

    x: torch.Tensor       # (rows >= lo.rows, cin_p) int8
    w: torch.Tensor       # (9, cin_p, cout_p) int8, tap = dy * 3 + dx
    scale: torch.Tensor   # (cout_p,) f32, and so are the three below
    bias: torch.Tensor
    alpha: torch.Tensor
    qscale: torch.Tensor


def _operands(xf, w, scale, bias, alpha, quant_scale) -> _Operands:
    """Pad the channels to 128 as the JAX function does; alpha and
    quant_scale default to ones."""
    cin, cout = w.shape[2], w.shape[3]
    cin_p, cout_p = _rup(cin, 128), _rup(cout, 128)
    if xf.shape[1] == cin and cin_p != cin:
        xf = F.pad(xf, (0, cin_p - cin))
    elif xf.shape[1] != cin_p:
        raise ValueError(f"xf has {xf.shape[1]} channels; weights expect "
                         f"{cin} (padded {cin_p})")
    dev = xf.device
    wk = F.pad(w.to(dev, torch.int8),
               (0, cout_p - cout, 0, cin_p - cin)).reshape(9, cin_p, cout_p)

    def vec(v):
        v = torch.ones(cout, device=dev) if v is None else v
        return F.pad(v.to(dev, torch.float32), (0, cout_p - cout))

    return _Operands(xf.to(torch.int8), wk, vec(scale), vec(bias), vec(alpha),
                     vec(quant_scale))


def _valid_rows(rows: int, lo: FlatLayout, device) -> torch.Tensor:
    """(rows, 1) bool: which headless rows hold a pixel
    (``_conv_kernel``'s validity mask)."""
    q = torch.arange(rows, device=device)
    rp = q % lo.r
    col = rp % lo.wp
    return ((col >= 1) & (col <= lo.w) & (rp >= lo.wp)
            & (rp < (lo.h + 1) * lo.wp))[:, None]


def _epilogue(acc: torch.Tensor, ops: _Operands, lo: FlatLayout,
              epilogue: str, out_dtype: torch.dtype) -> torch.Tensor:
    z = acc.float() * ops.scale + ops.bias
    valid = _valid_rows(acc.shape[0], lo, acc.device)
    if epilogue == "affine":
        return torch.where(valid, z, 0.0).to(out_dtype)
    d = torch.where(z >= 0, z, ops.alpha * z)
    q8 = torch.clamp(torch.round(d * ops.qscale), -127, 127)
    return torch.where(valid, q8, 0.0).to(torch.int8)


@torch.no_grad()
def conv3x3_s1_int8_flat_reference(ops: _Operands, lo: FlatLayout,
                                   epilogue: str = "affine",
                                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version on padded operands: (lo.n * lo.r, cout_p) headless
    rows.  The accumulator is 9 shifted float64 products (exact)."""
    rows = lo.n * lo.r
    base = lo.lead - lo.wp - 1         # out row q reads q + base + tap shift
    need = rows + base + 2 * lo.wp + 2
    x = ops.x[:need].double()
    if x.shape[0] < need:
        x = F.pad(x, (0, 0, 0, need - x.shape[0]))
    w = ops.w.double()
    acc = sum(x[base + dy * lo.wp + dx:base + dy * lo.wp + dx + rows]
              @ w[3 * dy + dx] for dy in range(3) for dx in range(3))
    return _epilogue(acc.to(torch.int32), ops, lo, epilogue, out_dtype)


class QConvWeights(NamedTuple):
    """One conv's operands in the layout ``csrc/qconv.cu`` reads
    (``pack_conv``): made once per weight set, never inside a launch."""

    w: torch.Tensor       # (cin_k / 32, cout_k / bn, 9, bn / 8, 2, 8, 16) int8
    scale: torch.Tensor   # (cout_k,) f32, and so are the three below
    bias: torch.Tensor
    alpha: torch.Tensor
    qscale: torch.Tensor
    cin: int
    cout: int


_KC = 32           # input channels per stage of the kernel (one mma k-step)
_CK_STEP = 64      # output channels are packed to a multiple of this


def block_cols(cout_k: int) -> int:
    """Output channels per block of ``csrc/qconv.cu`` (its wgmma N)."""
    return 128 if cout_k % 128 == 0 else 64


@torch.no_grad()
def pack_conv(w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              alpha: torch.Tensor | None = None,
              quant_scale: torch.Tensor | None = None,
              device=None) -> QConvWeights:
    """(3, 3, Cin, Cout) HWIO int8 weights and (Cout,) f32 vectors -> the
    kernel's layout on ``device`` (default: the weights' device).

    Cin is padded to a multiple of 32 and Cout to a multiple of 64 with
    zero weights and zero vectors (padded channels compute 0).  For each
    32-channel chunk and each block's ``bn`` output channels, the 9 taps'
    weights are one contiguous run (one bulk copy), each tap in wgmma's
    K-major core-matrix order: 8 channels x 16 input bytes per 128-byte
    core matrix, the two 16-byte halves of the chunk side by side.
    alpha and quant_scale default to ones."""
    dev = w.device if device is None else torch.device(device)
    cin, cout = w.shape[2], w.shape[3]
    cin_k, cout_k = _rup(cin, _KC), _rup(cout, _CK_STEP)
    bn = block_cols(cout_k)
    wk = F.pad(w.to(dev, torch.int8), (0, cout_k - cout, 0, cin_k - cin))
    # (tap, kc, half, byte, col tile, group, row) -> (kc, col tile, tap,
    # group, half, row, byte)
    wk = wk.reshape(9, cin_k // _KC, 2, 16, cout_k // bn, bn // 8, 8)
    wk = wk.permute(1, 4, 0, 5, 2, 6, 3)

    def vec(v):
        v = torch.ones(cout, device=dev) if v is None else v
        return F.pad(v.to(dev, torch.float32), (0, cout_k - cout)).contiguous()

    return QConvWeights(wk.contiguous(), vec(scale), vec(bias), vec(alpha),
                        vec(quant_scale), cin, cout)


def unpack_conv(p: QConvWeights) -> tuple[torch.Tensor, ...]:
    """``pack_conv``'s inverse: (w (3, 3, Cin, Cout), scale, bias, alpha,
    quant_scale)."""
    nkc, cols, _, groups = p.w.shape[:4]
    w = p.w.permute(2, 0, 4, 6, 1, 3, 5).reshape(3, 3, nkc * _KC,
                                                 cols * groups * 8)
    return (w[:, :, :p.cin, :p.cout],
            *(v[:p.cout] for v in (p.scale, p.bias, p.alpha, p.qscale)))


# Tiling of csrc/qconv.cu: 128 consecutive pixels per tile, 64 or 128
# output channels per block, a 2- to 6-deep ring of input windows (and of
# the 9 taps' weights for 32 input channels, unless all of them fit) in the
# 227 KB of shared memory a block can have on an H100.  A window is read as
# TMA boxes of at most 256 rows x 32 bytes.  One persistent block per SM:
# 288 threads of over 150 registers leave no room for a second.
# ``launch_plan`` decides each launch and the wrapper passes its ring,
# boxes and grid to the kernel's entry point, which checks them.
_BM = 128
_MAX_SMEM = 232448
_MAX_STAGES = 6
_MAX_BOX_ROWS = 256
_SMS = 132                     # streaming multiprocessors of an H100 SXM


def _a1024(b: int) -> int:
    return _rup(b, 1024)


class QConvPlan(NamedTuple):
    """How ``csrc/qconv.cu`` runs one launch: what its entry point is
    given (ring, boxes, grid) and what its blocks then compute per tile."""

    tiles: int              # pixel tiles of _BM pixels
    bn: int                 # output channels per block
    col_tiles: int          # cout_k / bn
    resident: bool          # all of the block's weights stay in shared memory
    stages: int             # depth of the ring (windows, and weights unless
    #                         resident)
    wmax: int               # widest input window a tile reads (rows)
    box_rows: int           # rows of one TMA box of the window
    nbox: int               # boxes per window
    smem: int               # dynamic shared memory per block (bytes)
    grid: int               # persistent blocks per column tile
    first_row: torch.Tensor  # (tiles,) headless output row of the first pixel
    window: torch.Tensor    # (tiles, 2): first input row, rows read
    zero: torch.Tensor      # (tiles, 2): rows [z0, z1) whose non-pixel rows
    #                         the tile zero-fills


def pixel_rows(lo: FlatLayout, p: torch.Tensor) -> torch.Tensor:
    """Headless flat row of pixel index ``p`` (image-major, then y, x)."""
    img, rem = p // (lo.h * lo.w), p % (lo.h * lo.w)
    return img * lo.r + (rem // lo.w + 1) * lo.wp + rem % lo.w + 1


def _smem(bn: int, stages: int, resident: bool, nkc: int, box_rows: int,
          nbox: int) -> int:
    """Shared memory of one block (``smem_plan`` in the .cu): the ring,
    resident weights, a full and an empty mbarrier per slot and one for
    the weights."""
    chunk = 9 * bn * _KC
    stage = _a1024(nbox * box_rows * _KC) + (0 if resident else chunk)
    return stages * stage + (nkc * chunk if resident else 0) \
        + 8 * (2 * _MAX_STAGES + 1)


@functools.lru_cache(maxsize=64)
def launch_plan(lo: FlatLayout, cin_k: int, cout_k: int,
                sms: int = _SMS) -> QConvPlan:
    """The kernel's tiles over ``lo``, its shared-memory plan and its grid
    on a card of ``sms`` SMs (the wrapper passes the card's count):
    resident weights with the deepest ring of 3 or more that fits, else the
    deepest ring of 2 or more (window, weights) stages; raises if none
    fits (a padded row width above ~900 columns).  One block per SM over
    the column tiles, at most one per pixel tile."""
    npix = lo.n * lo.h * lo.w
    tiles = -(-npix // _BM)
    t = torch.arange(tiles, dtype=torch.int64)
    q0 = pixel_rows(lo, t * _BM)
    q1 = pixel_rows(lo, torch.clamp((t + 1) * _BM, max=npix) - 1)
    rows = q1 - q0 + 2 * lo.wp + 3
    wmax = int(rows.max()) if tiles else 0
    nbox = -(-wmax // _MAX_BOX_ROWS)
    box_rows = _rup(-(-wmax // nbox), 8) if nbox else 0
    bn, nkc = block_cols(cout_k), cin_k // _KC
    fits = [(r, s) for r in (True, False)
            for s in range(_MAX_STAGES, 2 if r else 1, -1)
            if _smem(bn, s, r, nkc, box_rows, nbox) <= _MAX_SMEM]
    if not fits:
        raise ValueError(f"qconv kernel: a tile's input window ({wmax} rows "
                         f"of a {lo.wp}-wide layout) does not fit shared "
                         "memory")
    resident, stages = fits[0]
    z1 = torch.cat([q0[1:], torch.tensor([lo.n * lo.r])])
    z0 = torch.cat([torch.tensor([0]), q0[1:]])
    cols = cout_k // bn
    return QConvPlan(tiles, bn, cols, resident, stages, wmax, box_rows, nbox,
                     _smem(bn, stages, resident, nkc, box_rows, nbox),
                     max(1, min(tiles, -(-sms // cols))), q0,
                     torch.stack([q0 + lo.lead - lo.wp - 1, rows], 1),
                     torch.stack([z0, z1], 1))


_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_packed(p: QConvWeights, dev) -> None:
    if not isinstance(p, QConvWeights):
        raise ValueError("conv3x3_s1_int8_flat_kernel takes weights from "
                         "pack_conv")
    cout_k = p.scale.shape[0]
    shape = (p.w.shape[0], cout_k // block_cols(cout_k), 9,
             block_cols(cout_k) // 8, 2, 8, 16)
    if tuple(p.w.shape) != shape or cout_k % _CK_STEP \
            or p.w.dtype != torch.int8:
        raise ValueError(f"packed weights {tuple(p.w.shape)} {p.w.dtype} are "
                         f"not pack_conv's {shape} int8")
    for name, t in zip(QConvWeights._fields, p[:5]):
        want = torch.int8 if name == "w" else torch.float32
        if t.device != dev or t.dtype != want or not t.is_contiguous() or (
                name != "w" and tuple(t.shape) != (cout_k,)):
            raise ValueError(
                f"conv3x3_s1_int8_flat_kernel: {name} is {t.dtype} "
                f"{tuple(t.shape)} on {t.device}; pass pack_conv(..., "
                f"device={dev}) ({want} contiguous)")


@torch.no_grad()
def conv3x3_s1_int8_flat_kernel(xf: torch.Tensor, packed: QConvWeights,
                                lo: FlatLayout, epilogue: str = "affine",
                                out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch ``csrc/qconv.cu`` on CUDA flat rows ``xf`` (>= cin_k int8
    columns, row width a multiple of 16; columns past Cin meet zero weights)
    with weights from ``pack_conv`` on the same device; the same result as
    the plain version."""
    if not isinstance(xf, torch.Tensor) or not xf.is_cuda:
        raise ValueError("conv3x3_s1_int8_flat_kernel needs a CUDA tensor")
    if epilogue not in _EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue == "affine" and out_dtype not in _OUT_CODES:
        raise ValueError(f"affine epilogue writes f32 or bf16, not {out_dtype}")
    dev = xf.device
    _check_packed(packed, dev)
    cout_k = packed.scale.shape[0]
    cin_k = packed.w.shape[0] * _KC
    if (xf.dim() != 2 or xf.dtype != torch.int8 or not xf.is_contiguous()
            or xf.shape[1] < cin_k or xf.shape[1] % 16
            or xf.data_ptr() % 16):
        raise ValueError(f"xf {tuple(xf.shape)} {xf.dtype}: the kernel takes "
                         f"contiguous, 16-byte aligned int8 rows of >= "
                         f"{cin_k} columns, a multiple of 16")
    plan = launch_plan(lo, cin_k, cout_k,
                       torch.cuda.get_device_properties(dev)
                       .multi_processor_count)
    rows = lo.n * lo.r
    ldo = _rup(packed.cout, 128)
    if epilogue == "prelu_quant":
        code, dt = 2, torch.int8
    else:
        code, dt = _OUT_CODES[out_dtype], out_dtype
    out = torch.empty((rows, ldo), dtype=dt, device=dev)
    _build.launch(
        "alink_qconv", dev, xf.data_ptr(), xf.shape[0], xf.shape[1], cin_k,
        packed.w.data_ptr(), cout_k, *(v.data_ptr() for v in packed[1:5]),
        out.data_ptr(), ldo, code, lo.n, lo.h, lo.w, lo.wp, lo.r, lo.lead,
        plan.stages, int(plan.resident), plan.box_rows, plan.nbox, plan.grid)
    return out


def conv3x3_s1_int8_flat(
    xf: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    lo: FlatLayout,
    alpha: torch.Tensor | None = None,
    quant_scale: torch.Tensor | None = None,
    epilogue: str = "affine",
    out_dtype=torch.bfloat16,
    vmem_budget_bytes: int = 8 * 1024 * 1024,
    interpret: bool = False,
) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv on the flat layout (chainable).

    Args:
        xf: (>= lo.rows, Cin or Cin_p) int8 flat activations
            (``nhwc_to_flat``, or ``add_lead`` of a conv's output).
        w: (3, 3, Cin, Cout) int8 weights (HWIO).
        scale/bias: (Cout,) f32 dequant scale and bias (BN folded).
        alpha/quant_scale: (Cout,) f32 for ``prelu_quant``.
        vmem_budget_bytes/interpret: TPU knobs, ignored.
    Returns:
        (lo.n * lo.r, Cout_p) headless flat rows: ``out_dtype`` for
        ``affine``, int8 for ``prelu_quant``.  CUDA tensors launch the
        kernel, CPU tensors take the plain version.
    """
    del vmem_budget_bytes, interpret   # TPU tiling knobs
    if epilogue not in _EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    cin = w.shape[2]
    if xf.shape[1] not in (cin, _rup(cin, 128)):
        raise ValueError(f"xf has {xf.shape[1]} channels; weights expect "
                         f"{cin} (padded {_rup(cin, 128)})")
    if xf.is_cuda:
        packed = pack_conv(w, scale, bias, alpha, quant_scale, xf.device)
        cin_k = packed.w.shape[0] * _KC
        if xf.shape[1] < cin_k or xf.shape[1] % 16:
            xf = F.pad(xf, (0, _rup(cin_k, 16) - xf.shape[1]))
        return conv3x3_s1_int8_flat_kernel(xf.to(torch.int8).contiguous(),
                                           packed, lo, epilogue, out_dtype)
    if xf.device.type != "cpu":
        raise ValueError(f"no int8 conv for device {xf.device}")
    ops = _operands(xf, w, scale, bias, alpha, quant_scale)
    return conv3x3_s1_int8_flat_reference(ops, lo, epilogue, out_dtype)


def conv3x3_s1_int8(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, out_dtype=torch.bfloat16,
                    vmem_budget_bytes: int = 8 * 1024 * 1024,
                    interpret: bool = False) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv, NHWC: (N, H, W, Cin) int8 -> (N, H, W,
    Cout) ``out_dtype`` = scale * (x (*) w) + bias."""
    n, h, wd, _ = x.shape
    lo = flat_layout(n, h, wd)
    out = conv3x3_s1_int8_flat(nhwc_to_flat(x, lo), w, scale, bias, lo,
                               out_dtype=out_dtype,
                               vmem_budget_bytes=vmem_budget_bytes,
                               interpret=interpret)
    return flat_to_nhwc(out, lo)[..., :w.shape[3]]


@torch.no_grad()
def conv3x3_s1_int8_reference(x: torch.Tensor, w: torch.Tensor,
                              scale: torch.Tensor, bias: torch.Tensor,
                              out_dtype=torch.bfloat16) -> torch.Tensor:
    """Direct reference of ``conv3x3_s1_int8`` (no flat layout): an exact
    float64 convolution, cast to int32, then ``acc * scale + bias``."""
    y = F.conv2d(x.double().permute(0, 3, 1, 2),
                 w.double().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1).to(torch.int32)
    return (y.float() * scale.float() + bias.float()).to(out_dtype)
