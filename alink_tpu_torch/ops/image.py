"""Batched image geometry: resize, affine warp, crop-and-resize.

Counterpart of ``alink_tpu/ops/image.py``.  Layouts are NHWC (or HWC) as
there.  ``affine_warp_batch`` (and ``affine_warp``, one image) dispatches
on the device of its input: a CPU tensor takes
``affine_warp_batch_reference`` (plain PyTorch), a CUDA tensor launches
the hand-written kernel ``csrc/affine_warp.cu`` (which replaces the TPU
kernel ``alink_tpu/ops/image.py:_warp_kernel``).  The crops are plain
PyTorch products on every device, as they are XLA einsums in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from alink_tpu_torch import _build


def resize(images: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC (or HWC) images to ``size = (h, w)``.

    Half-pixel sampling without antialiasing (cv2.INTER_LINEAR, and
    ``jax.image.resize(..., antialias=False)``).  Integer inputs are
    promoted to float32, as ``jax.image.resize`` does.
    """
    single = images.dim() == 3
    if single:
        images = images[None]
    if not images.is_floating_point():
        images = images.float()
    out = F.interpolate(images.permute(0, 3, 1, 2), size=tuple(size),
                        mode="bilinear", align_corners=False, antialias=False)
    out = out.permute(0, 2, 3, 1)
    return out[0] if single else out


def _cast_like(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast a float interpolation result back to ``dtype``: integer types
    round (half to even) and saturate before the cast; a bare cast would
    truncate toward zero.  NaN becomes 0, as XLA's cast makes it."""
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        out = torch.clamp(torch.round(out), info.min, info.max)
        out = torch.nan_to_num(out, nan=0.0)
    return out.to(dtype)


def _inv2x2(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 2, 2) matrices (adjugate / det), all
    elementwise: these hold pixel-coordinate transforms."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    inv = torch.stack([torch.stack([d, -b], dim=-1),
                       torch.stack([-c, a], dim=-1)], dim=-2)
    return inv / det[..., None, None]


def _warp_params(Ms: torch.Tensor) -> torch.Tensor:
    """(n, 2, 3) forward affines -> (n, 6) f32 [a00 a01 a10 a11 bx by] of
    the inverse map src = Ainv . (dst - b)."""
    Ainv = _inv2x2(Ms[:, :, :2].float())
    return torch.cat([Ainv.reshape(-1, 4), Ms[:, :, 2].float()], dim=1)


def affine_warp_batch_reference(
    imgs: torch.Tensor, Ms: torch.Tensor, out_size: tuple[int, int],
    border: str = "zero", interp: str = "linear",
) -> torch.Tensor:
    """Plain PyTorch warp: four-tap gather bilinear, f32 taps.

    Output pixel (x, y) samples image i at ``Ainv_i . ((x, y) - b_i)``;
    ``border="zero"`` reads zeros outside the image, ``"nearest"`` clamps
    the coordinate to the edge first; ``interp="nearest"`` rounds the
    coordinate half up (scipy.ndimage order 0).  The coordinate transform
    is elementwise f32, never a matrix product.  A singular transform gives
    NaN or infinite coordinates: as in the JAX warp, a NaN coordinate makes
    the pixel NaN (0 in an integer dtype), an infinite one lies outside the
    image.
    """
    n, h, w, c = imgs.shape
    oh, ow = out_size
    s = _warp_params(Ms)
    ys, xs = torch.meshgrid(
        torch.arange(oh, dtype=torch.float32, device=imgs.device),
        torch.arange(ow, dtype=torch.float32, device=imgs.device),
        indexing="ij")
    rx = xs[None] - s[:, 4, None, None]
    ry = ys[None] - s[:, 5, None, None]
    X = s[:, 0, None, None] * rx + s[:, 1, None, None] * ry
    Y = s[:, 2, None, None] * rx + s[:, 3, None, None] * ry
    if interp == "nearest":
        X = torch.floor(X + 0.5)
        Y = torch.floor(Y + 0.5)
    nan_coord = (torch.isnan(X) | torch.isnan(Y))[..., None]
    X = torch.nan_to_num(X, nan=0.0, posinf=w + 1.0, neginf=-2.0)
    Y = torch.nan_to_num(Y, nan=0.0, posinf=h + 1.0, neginf=-2.0)
    if border == "nearest":
        X = X.clamp(0.0, w - 1.0)
        Y = Y.clamp(0.0, h - 1.0)
    else:
        # Beyond one pixel outside the image every tap is outside, so the
        # bound leaves the result (zero) unchanged and keeps the int
        # conversion exact.
        X = X.clamp(-2.0, w + 1.0)
        Y = Y.clamp(-2.0, h + 1.0)
    x0 = torch.floor(X)
    y0 = torch.floor(Y)
    wx = (X - x0)[..., None]
    wy = (Y - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    flat = imgs.reshape(n, h * w, c).float()

    def tap(yi, xi):
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, -1, 1)
        v = torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(n, oh, ow, c)
        if border == "nearest":
            return v
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        return torch.where(inside[..., None], v, 0.0)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    out = torch.where(nan_coord, torch.nan, top * (1 - wy) + bot * wy)
    return _cast_like(out, imgs.dtype)


# The kernel's dtype codes (``alink_affine_warp``).
_WARP_DTYPES = {torch.float32: 0, torch.uint8: 1, torch.bfloat16: 2}


def affine_warp_batch_kernel(
    imgs: torch.Tensor, Ms: torch.Tensor, out_size: tuple[int, int],
    border: str = "zero", interp: str = "linear",
) -> torch.Tensor:
    """Launch ``csrc/affine_warp.cu`` on CUDA tensors (f32, uint8 or bf16
    NHWC; taps and blend in f32, the result rounded to the input's type).

    The kernel inverts the forward affines itself (rounded as
    ``_warp_params`` rounds them), so a call launches nothing else when
    ``imgs`` is contiguous and ``Ms`` is contiguous f32 on its device.
    """
    if not imgs.is_cuda:
        raise ValueError("affine_warp_batch_kernel needs a CUDA tensor")
    if imgs.dtype not in _WARP_DTYPES:
        raise TypeError(f"warp kernel takes float32, uint8 or bfloat16, not "
                        f"{imgs.dtype}")
    if border not in ("zero", "nearest") or interp not in ("linear",
                                                           "nearest"):
        raise ValueError(f"unknown border={border!r} or interp={interp!r}")
    n, h, w, c = imgs.shape
    if Ms.shape != (n, 2, 3):
        raise ValueError(f"Ms must be ({n}, 2, 3), got {tuple(Ms.shape)}")
    oh, ow = out_size
    dev = imgs.device
    imgs = imgs.contiguous()
    Ms = Ms.to(dev, torch.float32).contiguous()
    out = torch.empty((n, oh, ow, c), dtype=imgs.dtype, device=dev)
    _build.launch("alink_affine_warp", dev, imgs.data_ptr(),
                  _WARP_DTYPES[imgs.dtype], Ms.data_ptr(), out.data_ptr(), n,
                  h, w, c, oh, ow, int(border == "nearest"),
                  int(interp == "nearest"))
    return out


def affine_warp_batch(
    imgs: torch.Tensor, Ms: torch.Tensor, out_size: tuple[int, int],
    border: str = "zero", interp: str = "linear",
) -> torch.Tensor:
    """Warp a batch of NHWC images by forward 2x3 affines (cv2 semantics).

    CPU tensors take the plain version; CUDA tensors the kernel.
    """
    if imgs.is_cuda:
        return affine_warp_batch_kernel(imgs, Ms, out_size, border, interp)
    if imgs.device.type != "cpu":
        raise ValueError(f"no warp for device {imgs.device}")
    return affine_warp_batch_reference(imgs, Ms, out_size, border, interp)


def affine_warp(img: torch.Tensor, M: torch.Tensor, out_size: tuple[int, int],
                border: str = "zero") -> torch.Tensor:
    """One HWC image through ``affine_warp_batch`` (cv2.warpAffine)."""
    return affine_warp_batch(img[None], M[None], out_size, border=border)[0]


def _crop_weights(boxes: torch.Tensor, out_size: tuple[int, int], h: int,
                  w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Separable bilinear tap weights for (..., K, 4) boxes: wy (..., K,
    out_h, H) and wx (..., K, out_w, W), half-pixel grids clamped into the
    box; out-of-image taps get zero weight (the zero border)."""
    out_h, out_w = out_size
    x1, y1, x2, y2 = boxes.unbind(-1)
    dev = boxes.device
    sx = (x2 - x1 + 1.0) / out_w
    sy = (y2 - y1 + 1.0) / out_h
    src_y = ((torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5)
             * sy[..., None] - 0.5 + y1[..., None])
    src_x = ((torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5)
             * sx[..., None] - 0.5 + x1[..., None])
    src_y = torch.minimum(torch.maximum(src_y, y1[..., None]), y2[..., None])
    src_x = torch.minimum(torch.maximum(src_x, x1[..., None]), x2[..., None])
    hy = torch.arange(h, dtype=torch.float32, device=dev)
    wx_ = torch.arange(w, dtype=torch.float32, device=dev)
    wy = torch.clamp(1.0 - torch.abs(src_y[..., None] - hy), min=0.0)
    wx = torch.clamp(1.0 - torch.abs(src_x[..., None] - wx_), min=0.0)
    return wy, wx


def _as(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (None: f32) and held in f32, so that the
    products that follow accumulate in f32 as XLA's
    ``preferred_element_type=float32`` makes them."""
    return x.float() if dtype is None else x.to(dtype).float()


def _crop_epilogue(out: torch.Tensor, offset: float | None,
                   scale: float | None, out_dtype: torch.dtype | None,
                   in_dtype: torch.dtype) -> torch.Tensor:
    """``(out - offset) * scale`` on the f32 result, then the cast: to
    ``out_dtype`` where given; an integer input whose values the fold moved
    out of its range stays f32; otherwise back to the input's dtype."""
    if offset is not None:
        out = out - offset
    if scale is not None:
        out = out * scale
    if out_dtype is not None:
        return out.to(out_dtype)
    if (offset is not None or scale is not None) and \
            not in_dtype.is_floating_point:
        return out
    return _cast_like(out, in_dtype)


def crop_and_resize(
    img: torch.Tensor,
    boxes: torch.Tensor,
    out_size: tuple[int, int],
    compute_dtype: torch.dtype | None = None,
    out_dtype: torch.dtype | None = None,
    offset: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Crop inclusive integer boxes [x1, y1, x2, y2] and resize each to
    ``out_size`` (zero outside the image; "zero-pad crop then
    cv2.resize(INTER_LINEAR)").

    ``img`` (..., H, W, C) with ``boxes`` (..., K, 4) -> (..., K, oh, ow,
    C): the leading dims are the batch (the reference's single image is
    the case with none).  The two separable passes round their operands
    to ``compute_dtype`` (f32 if None) and accumulate in f32;
    ``offset``/``scale`` fold the mtcnn centering into the f32 result
    before the cast to ``out_dtype`` (``_crop_epilogue``).
    """
    h, w = img.shape[-3], img.shape[-2]
    wy, wx = _crop_weights(boxes, out_size, h, w)
    cdt = compute_dtype
    rows = torch.einsum("...koh,...hwc->...kowc", _as(wy, cdt), _as(img, cdt))
    out = torch.einsum("...kpw,...kowc->...kopc", _as(wx, cdt),
                       _as(rows, cdt))
    return _crop_epilogue(out, offset, scale, out_dtype, img.dtype)


# Bytes of gathered source images per y-pass chunk of
# ``crop_and_resize_gather``: the whole gather at the crowd defaults (4,096
# candidates of 160x160x3) would hold 1.26 GB in f32.
_GATHER_BYTES = 64 << 20


def crop_and_resize_gather(
    images: torch.Tensor,
    boxes: torch.Tensor,
    img_ids: torch.Tensor,
    out_size: tuple[int, int],
    compute_dtype: torch.dtype | None = None,
    out_dtype: torch.dtype | None = None,
    offset: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Crops of candidates pooled across a batch: ``images`` (N, H, W, C),
    ``boxes`` (T, 4), ``img_ids`` (T,) -> (T, oh, ow, C), candidate t
    cropped from image ``img_ids[t]``.  Same numerics as
    ``crop_and_resize``.  Ids past the batch read its last image (a JAX
    gather clamps; the cascade gives them to invalid candidates only).

    The y-pass multiplies each candidate's row weights into its source
    image, gathered a chunk of candidates at a time (``_GATHER_BYTES``), so
    the gathered copy never holds more than one chunk.
    """
    n, h, w, c = images.shape
    t = boxes.shape[0]
    wy, wx = _crop_weights(boxes, out_size, h, w)
    cdt = compute_dtype
    flat = _as(images, cdt).reshape(n, h, w * c)
    ids = img_ids.clamp(0, n - 1)
    step = max(1, _GATHER_BYTES // (h * w * c * 4))
    rows = torch.cat([torch.bmm(_as(wy[i:i + step], cdt),
                                flat[ids[i:i + step]])
                      for i in range(0, max(t, 1), step)])
    rows = rows.reshape(t, out_size[0], w, c)
    out = torch.einsum("tpw,towc->topc", _as(wx, cdt), _as(rows, cdt))
    return _crop_epilogue(out, offset, scale, out_dtype, images.dtype)
