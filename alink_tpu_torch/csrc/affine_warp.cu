// Batched affine warp with cv2.warpAffine semantics, for Hopper (sm_90a).
//
// Replaces the TPU kernel alink_tpu/ops/image.py:_warp_kernel (reached
// through affine_warp_batch_pallas).  Output pixel (x, y) of image i samples
// the source at Ainv_i . ((x, y) - b_i) with four bilinear taps and a zero
// or nearest (edge-clamp) border, where M_i = [A_i | b_i] is the forward
// affine the caller passes, (n, 2, 3) f32.
//
// Bound: memory.  Each output pixel reads at most four source pixels and
// writes one; a 64-image 160x160x3 -> 112x112x3 alignment batch moves about
// 29 MB.  The TPU kernel's banded, lane-windowed matrix form exists only
// because gathers are slow there; here the design is the direct one:
//   - the inverse is derived in the kernel, once per block, from the
//     forward affine, rounded op by op as ops/image.py:_inv2x2 and
//     _warp_params round it on the card (det = a*d - b*c as two rounded
//     products and a rounded difference, then an IEEE division for each
//     entry), so the wrapper launches nothing but this kernel;
//   - a block owns a tile of whole output rows of one image (about 1,000
//     pixels): its source footprint is a band of a few source rows that
//     stays in L1, and neighbouring threads take neighbouring output
//     pixels, so a warp's taps fall on a few cache lines;
//   - coordinates are f32 elementwise arithmetic, never a matrix product
//     (pixel coordinates must not pass through a reduced-precision
//     multiply).  Multiplies and adds are rounded one by one (__fmul_rn,
//     __fadd_rn: no contraction into FMAs), the roundings of the plain
//     PyTorch version, so both sample at the same coordinates: one ulp of
//     coordinate moves a pixel of a high-contrast image by ~1e-3;
//   - the taps and the blend are f32 with the same roundings, whatever the
//     image type (f32, uint8 or bf16: the plain version promotes to f32
//     too); integer outputs round half to even and saturate, like
//     _cast_like, bf16 outputs are rounded once, on the store;
//   - a NaN sample coordinate (singular transform) gives a NaN pixel (0 in
//     uint8), an infinite one lies outside the image, as in the JAX warp;
//   - the tile's pixels are gathered into shared memory and leave in
//     16-byte stores: its rows are one contiguous run of the output, so
//     the 12-byte (f32), 6-byte (bf16) and 3-byte (uint8) pixels need no
//     scattered store.
// 32-bit index arithmetic throughout: the entry point refuses an image or
// output of 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTilePixels = 1024;     // output pixels a block aims to own
constexpr int kMaxStage = 32 * 1024;  // shared-memory bytes of one tile

template <typename T>
__device__ __forceinline__ T to_out(float v);

template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }

template <>
__device__ __forceinline__ uint8_t to_out<uint8_t>(float v) {
  // fmaxf returns 0 for a NaN v: XLA's NaN -> integer cast gives 0 too.
  v = fminf(fmaxf(rintf(v), 0.0f), 255.0f);
  return static_cast<uint8_t>(v);
}

template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);   // round to nearest even; NaN stays NaN
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Output pixel (x, y) of an image into c channels at dst, from the inverse
// map s = [a00 a01 a10 a11 bx by].  C is the channel count when known at
// compile time (3), else 0 and c holds it.
template <typename T, int C>
__device__ __forceinline__ void warp_pixel(const T* __restrict__ base,
                                           const float* s, int x, int y,
                                           int h, int w, int c,
                                           int border_nearest,
                                           int interp_nearest, T* dst) {
  const int nc = C > 0 ? C : c;
  const float rx = __fsub_rn(static_cast<float>(x), s[4]);
  const float ry = __fsub_rn(static_cast<float>(y), s[5]);
  float X = __fadd_rn(__fmul_rn(s[0], rx), __fmul_rn(s[1], ry));
  float Y = __fadd_rn(__fmul_rn(s[2], rx), __fmul_rn(s[3], ry));
  if (interp_nearest) {  // round half up to the nearest grid point
    X = floorf(__fadd_rn(X, 0.5f));
    Y = floorf(__fadd_rn(Y, 0.5f));
  }
  // A singular transform (det 0, e.g. all landmarks at one point) gives NaN
  // or infinite coordinates; the clamps below map NaN to a bound, so test
  // for it first.
  const bool nan_coord = isnan(X) || isnan(Y);
  if (border_nearest) {
    X = fminf(fmaxf(X, 0.0f), w - 1.0f);
    Y = fminf(fmaxf(Y, 0.0f), h - 1.0f);
  } else {
    // Beyond one pixel outside the image every tap is outside, so the
    // clamp leaves the result (zero) unchanged and keeps the int
    // conversion below in range.
    X = fminf(fmaxf(X, -2.0f), w + 1.0f);
    Y = fminf(fmaxf(Y, -2.0f), h + 1.0f);
  }
  const float x0f = floorf(X);
  const float y0f = floorf(Y);
  const float wx = __fsub_rn(X, x0f);
  const float wy = __fsub_rn(Y, y0f);
  const float ux = __fsub_rn(1.0f, wx);
  const float uy = __fsub_rn(1.0f, wy);
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const int x1 = x0 + 1;
  const int y1 = y0 + 1;

  // Tap validity (zero border) and clamped addresses (nearest border reads
  // the clamped pixel, which is where the clamped coordinate already is).
  const bool vx0 = border_nearest || (x0 >= 0 && x0 < w);
  const bool vx1 = border_nearest || (x1 >= 0 && x1 < w);
  const bool vy0 = border_nearest || (y0 >= 0 && y0 < h);
  const bool vy1 = border_nearest || (y1 >= 0 && y1 < h);
  const int cx0 = min(max(x0, 0), w - 1);
  const int cx1 = min(max(x1, 0), w - 1);
  const int cy0 = min(max(y0, 0), h - 1);
  const int cy1 = min(max(y1, 0), h - 1);

  const T* p00 = base + (cy0 * w + cx0) * nc;
  const T* p01 = base + (cy0 * w + cx1) * nc;
  const T* p10 = base + (cy1 * w + cx0) * nc;
  const T* p11 = base + (cy1 * w + cx1) * nc;
#pragma unroll
  for (int ch = 0; ch < nc; ++ch) {
    const float v00 = (vy0 && vx0) ? to_f32(p00[ch]) : 0.0f;
    const float v01 = (vy0 && vx1) ? to_f32(p01[ch]) : 0.0f;
    const float v10 = (vy1 && vx0) ? to_f32(p10[ch]) : 0.0f;
    const float v11 = (vy1 && vx1) ? to_f32(p11[ch]) : 0.0f;
    const float top = __fadd_rn(__fmul_rn(v00, ux), __fmul_rn(v01, wx));
    const float bot = __fadd_rn(__fmul_rn(v10, ux), __fmul_rn(v11, wx));
    const float v = __fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, wy));
    dst[ch] = to_out<T>(nan_coord ? __int_as_float(0x7fc00000) : v);
  }
}

// Block (image i, tile t) writes output rows [t * rows, t * rows + rows) of
// image i.  With `staged`, the tile is gathered in shared memory and stored
// in 16-byte runs; otherwise (a row wider than the stage, or an unaligned
// run) each pixel is stored where it is computed.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
affine_warp_kernel(const T* __restrict__ img, const float* __restrict__ M,
                   T* __restrict__ out, int h, int w, int c, int oh, int ow,
                   int rows, int staged, int border_nearest,
                   int interp_nearest) {
  extern __shared__ __align__(16) unsigned char stage_raw[];
  __shared__ float s[6];
  const int i = blockIdx.x;
  const int y0 = blockIdx.y * rows;
  const int nrows = min(rows, oh - y0);
  const int nc = C > 0 ? C : c;
  if (threadIdx.x == 0) {
    // The inverse of [a b; c d], rounded as _inv2x2 rounds it.
    const float* m = M + 6 * i;
    const float a = m[0], b = m[1], cc = m[3], d = m[4];
    const float det = __fsub_rn(__fmul_rn(a, d), __fmul_rn(b, cc));
    s[0] = __fdiv_rn(d, det);
    s[1] = __fdiv_rn(-b, det);
    s[2] = __fdiv_rn(-cc, det);
    s[3] = __fdiv_rn(a, det);
    s[4] = m[2];
    s[5] = m[5];
  }
  __syncthreads();
  const float inv[6] = {s[0], s[1], s[2], s[3], s[4], s[5]};
  const T* base = img + static_cast<long long>(i) * h * w * nc;
  const int npix = nrows * ow;
  const long long first = (static_cast<long long>(i) * oh + y0) * ow * nc;
  T* stage = reinterpret_cast<T*>(stage_raw);
  for (int p = threadIdx.x; p < npix; p += kThreads) {
    const int yy = p / ow;
    const int x = p - yy * ow;
    T* dst = staged ? stage + p * nc : out + first + p * nc;
    warp_pixel<T, C>(base, inv, x, y0 + yy, h, w, nc, border_nearest,
                     interp_nearest, dst);
  }
  if (!staged) return;
  __syncthreads();
  // The tile is out[first, first + npix * nc): 16-byte runs, then the
  // last few elements one by one.
  const int bytes = npix * nc * static_cast<int>(sizeof(T));
  const int nvec = bytes / 16;
  uint4* dv = reinterpret_cast<uint4*>(out + first);
  const uint4* sv = reinterpret_cast<const uint4*>(stage);
  for (int v = threadIdx.x; v < nvec; v += kThreads) dv[v] = sv[v];
  for (int e = nvec * 16 / static_cast<int>(sizeof(T)) + threadIdx.x;
       e < npix * nc; e += kThreads) {
    out[first + e] = stage[e];
  }
}

template <typename T>
int launch(const void* img, const float* M, void* out, int n, int h, int w,
           int c, int oh, int ow, int border_nearest, int interp_nearest,
           cudaStream_t st) {
  const int row_bytes = ow * c * static_cast<int>(sizeof(T));
  int rows = kTilePixels / ow;
  rows = max(1, min(oh, min(rows, kMaxStage / max(row_bytes, 1))));
  // Staged tiles start on 16-byte boundaries when a tile's bytes (and the
  // output's base, from the allocator) are multiples of 16.
  const bool staged = row_bytes <= kMaxStage &&
                      (static_cast<long long>(rows) * row_bytes) % 16 == 0 &&
                      (static_cast<long long>(oh) * row_bytes) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const size_t smem = staged ? static_cast<size_t>(rows) * row_bytes : 0;
  const dim3 grid(n, (oh + rows - 1) / rows);
  const T* src = static_cast<const T*>(img);
  T* dst = static_cast<T*>(out);
  if (c == 3) {
    affine_warp_kernel<T, 3><<<grid, kThreads, smem, st>>>(
        src, M, dst, h, w, c, oh, ow, rows, staged, border_nearest,
        interp_nearest);
  } else {
    affine_warp_kernel<T, 0><<<grid, kThreads, smem, st>>>(
        src, M, dst, h, w, c, oh, ow, rows, staged, border_nearest,
        interp_nearest);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img (n, h, w, c) and out (n, oh, ow, c) of one type: float32 (dtype 0),
// uint8 (1) or bfloat16 (2); M (n, 2, 3) f32 forward affines.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for another
// dtype code or sizes past 32-bit indexing.
extern "C" int alink_affine_warp(const void* img, int dtype, const void* M,
                                 void* out, int n, int h, int w, int c, int oh,
                                 int ow, int border_nearest,
                                 int interp_nearest, void* stream) {
  if (n < 0 || h <= 0 || w <= 0 || c <= 0 || oh < 0 || ow < 0 ||
      dtype < 0 || dtype > 2 ||
      static_cast<long long>(h) * w * c >= (1LL << 31) ||
      static_cast<long long>(oh) * ow * c >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || oh == 0 || ow == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const float* mf = static_cast<const float*>(M);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch<uint8_t>(img, mf, out, n, h, w, c, oh, ow, border_nearest,
                           interp_nearest, st);
  }
  if (dtype == 2) {
    return launch<__nv_bfloat16>(img, mf, out, n, h, w, c, oh, ow,
                                 border_nearest, interp_nearest, st);
  }
  return launch<float>(img, mf, out, n, h, w, c, oh, ow, border_nearest,
                       interp_nearest, st);
}

extern "C" const char* alink_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
