// Batched affine warp with cv2.warpAffine semantics, for Hopper (sm_90a).
//
// Replaces the TPU kernel alink_tpu/ops/image.py:_warp_kernel (reached
// through affine_warp_batch_pallas).  Output pixel (x, y) of image i samples
// the source at Ainv_i . ((x, y) - b_i) with four bilinear taps and a zero
// or nearest (edge-clamp) border.  Ainv and b are computed by the wrapper in
// f32 with the closed-form 2x2 inverse and passed as six floats per image.
//
// Bound: memory.  Each output pixel reads at most four source pixels and
// writes one; a 64-image 160x160x3 -> 112x112x3 alignment batch moves about
// 20 MB.  The TPU kernel's banded, lane-windowed matrix form exists only
// because gathers are slow there; here the design is the direct one:
//   - one thread per output pixel, looping over the c channels, so the
//     coordinate transform and the tap weights are computed once per pixel;
//   - coordinates are f32 elementwise arithmetic, never a matrix product
//     (pixel coordinates must not pass through a reduced-precision
//     multiply).  Multiplies and adds are rounded one by one (__fmul_rn,
//     __fadd_rn: no contraction into FMAs), the roundings of the plain
//     PyTorch version, so both sample at the same coordinates: one ulp of
//     coordinate moves a pixel of a high-contrast image by ~1e-3;
//   - the taps and the blend are f32 with the same roundings; integer
//     outputs round half to even and saturate, like _cast_like;
//   - a NaN sample coordinate (singular transform) gives a NaN pixel (0 in
//     uint8), an infinite one lies outside the image, as in the JAX warp.
// Neighbouring threads take neighbouring output pixels, so stores coalesce
// and the taps of a warp hit a few source rows that stay in L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T>
__global__ void affine_warp_kernel(const T* __restrict__ img,
                                   const float* __restrict__ xform,
                                   T* __restrict__ out, int n, int h, int w,
                                   int c, int oh, int ow, int border_nearest,
                                   int interp_nearest) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(n) * oh * ow;
  if (idx >= total) return;
  const int x = static_cast<int>(idx % ow);
  const long long t = idx / ow;
  const int y = static_cast<int>(t % oh);
  const int i = static_cast<int>(t / oh);

  const float* s = xform + 6 * i;  // a00 a01 a10 a11 bx by
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

  const T* base = img + static_cast<long long>(i) * h * w * c;
  const T* p00 = base + (static_cast<long long>(cy0) * w + cx0) * c;
  const T* p01 = base + (static_cast<long long>(cy0) * w + cx1) * c;
  const T* p10 = base + (static_cast<long long>(cy1) * w + cx0) * c;
  const T* p11 = base + (static_cast<long long>(cy1) * w + cx1) * c;
  T* dst = out + idx * c;
  for (int ch = 0; ch < c; ++ch) {
    const float v00 = (vy0 && vx0) ? static_cast<float>(p00[ch]) : 0.0f;
    const float v01 = (vy0 && vx1) ? static_cast<float>(p01[ch]) : 0.0f;
    const float v10 = (vy1 && vx0) ? static_cast<float>(p10[ch]) : 0.0f;
    const float v11 = (vy1 && vx1) ? static_cast<float>(p11[ch]) : 0.0f;
    const float top = __fadd_rn(__fmul_rn(v00, ux), __fmul_rn(v01, wx));
    const float bot = __fadd_rn(__fmul_rn(v10, ux), __fmul_rn(v11, wx));
    const float v = __fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, wy));
    dst[ch] = to_out<T>(nan_coord ? __int_as_float(0x7fc00000) : v);
  }
}

}  // namespace

// is_u8: 0 = float32 pixels, 1 = uint8 pixels (output in the input type).
// Returns cudaGetLastError() after the launch.
extern "C" int alink_affine_warp(const void* img, int is_u8, const void* xform,
                                 void* out, int n, int h, int w, int c, int oh,
                                 int ow, int border_nearest,
                                 int interp_nearest, void* stream) {
  const long long total = static_cast<long long>(n) * oh * ow;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(xform);
  if (is_u8) {
    affine_warp_kernel<uint8_t><<<blocks, threads, 0, st>>>(
        static_cast<const uint8_t*>(img), xf, static_cast<uint8_t*>(out), n,
        h, w, c, oh, ow, border_nearest, interp_nearest);
  } else {
    affine_warp_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(img), xf, static_cast<float*>(out), n, h, w,
        c, oh, ow, border_nearest, interp_nearest);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* alink_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
