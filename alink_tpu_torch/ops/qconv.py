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
``conv3x3_s1_int8_flat_reference`` on CPU tensors.  The plain version
forms the accumulator as 9 shifted float64 products, exact because
|acc| <= 9 * Cin * 127^2 < 2^53 (PyTorch has no integer matmul on CUDA,
and float32 is not exact once |acc| > 2^24), then casts it to int32 and
float32 before the epilogue, as the JAX reference does.  The TPU tiling
knobs ``vmem_budget_bytes`` and ``interpret`` are accepted and ignored.
"""

from __future__ import annotations

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


_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


@torch.no_grad()
def conv3x3_s1_int8_flat_kernel(ops: _Operands, lo: FlatLayout,
                                epilogue: str = "affine",
                                out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch ``csrc/qconv.cu`` on padded CUDA operands; the same result as
    the plain version.  ``conv3x3_s1_int8_flat_kernel.launches`` counts the
    launches."""
    x = ops.x
    if not x.is_cuda:
        raise ValueError("conv3x3_s1_int8_flat_kernel needs a CUDA tensor")
    if epilogue == "affine" and out_dtype not in _OUT_CODES:
        raise ValueError(f"affine epilogue writes f32 or bf16, not {out_dtype}")
    cin_p, cout_p = ops.w.shape[1:]
    if x.dim() != 2 or x.shape[1] != cin_p or cin_p % 128 or cout_p % 128:
        raise ValueError(f"bad operands: x {tuple(x.shape)}, w "
                         f"{tuple(ops.w.shape)}")
    dev = x.device
    x = x.contiguous()
    # The kernel reads each tap's weights as (cout_p, cin_p) rows.
    wt = ops.w.to(dev).transpose(1, 2).contiguous()
    vecs = [v.to(dev, torch.float32).contiguous()
            for v in (ops.scale, ops.bias, ops.alpha, ops.qscale)]
    rows = lo.n * lo.r
    if epilogue == "prelu_quant":
        code, dt = 2, torch.int8
    else:
        code, dt = _OUT_CODES[out_dtype], out_dtype
    out = torch.empty((rows, cout_p), dtype=dt, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.alink_qconv(
            x.data_ptr(), x.shape[0], wt.data_ptr(),
            *(v.data_ptr() for v in vecs), out.data_ptr(), rows, cin_p,
            cout_p, lo.lead, lo.wp, lo.r, lo.h, lo.w, code, stream)
    conv3x3_s1_int8_flat_kernel.launches += 1
    _build.check(status, "qconv")
    return out


conv3x3_s1_int8_flat_kernel.launches = 0


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
    ops = _operands(xf, w, scale, bias, alpha, quant_scale)
    if xf.is_cuda:
        return conv3x3_s1_int8_flat_kernel(ops, lo, epilogue, out_dtype)
    if xf.device.type != "cpu":
        raise ValueError(f"no int8 conv for device {xf.device}")
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
