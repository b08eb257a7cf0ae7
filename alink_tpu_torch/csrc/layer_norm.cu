// LayerNorm over the last axis of a row-major (rows, C) tensor that writes
// its output in the dtype the next operation takes, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no transformer.  The port's
// Swin-S and ViT-L embedders (models/swin.py, models/vit.py) normalise the
// float32 residual stream before every bf16 product.  PyTorch's own
// sequence, F.layer_norm in float32 and then .to(bf16), reads the row, writes
// it in float32, reads that again and writes bf16: 16 bytes an element where
// the work needs 6.  This kernel reads each row once and writes it once:
//   y = round_out((x - mean) * rsqrt(var + eps) * gamma + beta)
// with mean and var = mean((x - mean)^2) in float32 (two passes over the row
// held in registers), the affine in float32 and one rounding at the store,
// where .to(bf16) rounds (to nearest even).  Input float32 or bf16 (Swin's
// patch norm reads the convolution's bf16), output float32 or bf16.
//
// Bound: memory.  At a few operations an element it sits far below the
// card's ridge, so the only gain is fewer bytes at full bandwidth.  A Swin-S
// forward at 112^2 moves 33.3 MB a chip through its 53 norms (10.2 ms at
// 3.35 TB/s for 1,024 chips: bench_torch/roofline_ln.py).  What the design
// does about that:
//   - rows are 32-2,048 floats (Swin's 96-1,536), too narrow for a block
//     each.  A row is held in registers by a group of G lanes of one warp:
//     8 lanes below C = 192, 16 below 384, the whole warp from 384 up, so
//     no lane idles on the narrowest rows.  A lane owns the 4-element
//     vectors sub, sub + G, sub + 2G, ... of every row it takes (16-byte
//     loads of float32, 8 of bf16; 16- or 8-byte stores), so for each of
//     its vectors a warp touches 32/G rows' contiguous runs;
//   - a lane always owns the same columns, so it loads its gamma and beta
//     once, before its first row, and keeps them in registers;
//   - blocks are persistent (as many as fit the SMs at once) and each warp
//     walks the rows in steps of 32/G x R rows: every lane issues the loads
//     of its R rows before it reduces any, so an SM keeps tens of KB of
//     reads in flight even at C = 96 (R = 4 where a lane holds at most 4
//     vectors a row, 2 up to 8, 1 up to 16);
//   - the statistics are sums over the group by __shfl_xor_sync: no shared
//     memory, no barrier, no atomics.
// chip_smoke.py phase s holds the kernel to F.layer_norm + .to at Swin's
// shapes and times it against the bytes bound; PERF.md's kernel table keeps
// the figures.  64-bit element offsets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWidth = 2048;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&a);
  t.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

template <int G>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// G lanes a row, at most NV 4-element vectors a lane, R rows a group in
// flight.  A warp's step covers 32/G x R rows: group grp of the warp takes
// rows base + j (32/G) + grp, j < R.  Rows past the end load nothing and
// store nothing but still take part in the shuffles.
template <typename TIn, typename TOut, int G, int NV, int R>
__global__ void __launch_bounds__(kThreads)
    layer_norm_kernel(const TIn* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      TOut* __restrict__ out, int rows, int c, float eps) {
  constexpr int kGroups = 32 / G;
  constexpr int kStep = kGroups * R;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;
  const int grp = lane / G;
  const int c4 = c / 4;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;

  float g[NV][4], b[NV][4];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int col = (sub + k * G) * 4;
    if (sub + k * G < c4) {
      load4(gamma + col, g[k]);
      load4(beta + col, b[k]);
    }
  }

  for (long long base = warp * kStep; base < rows; base += warps * kStep) {
    float v[R][NV][4];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const long long row = base + j * kGroups + grp;
      const TIn* src = x + row * c;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (row < rows && sub + k * G < c4) {
          load4(src + (sub + k * G) * 4, v[j][k]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[j][k][e] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) s += v[j][k][e];
      const float mean = group_sum<G>(s) / c;
      float q = 0.0f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (sub + k * G < c4) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float d = v[j][k][e] - mean;
            q += d * d;
          }
        }
      }
      const float rstd = rsqrtf(group_sum<G>(q) / c + eps);
      const long long row = base + j * kGroups + grp;
      if (row < rows) {
        TOut* dst = out + row * c;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          if (sub + k * G < c4) {
            float y[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              y[e] = (v[j][k][e] - mean) * rstd * g[k][e] + b[k][e];
            }
            store4(dst + (sub + k * G) * 4, y);
          }
        }
      }
    }
  }
}

template <typename TIn, typename TOut, int G, int NV>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   void* out, int rows, int c, float eps,
                   cudaStream_t stream) {
  constexpr int R = NV <= 4 ? 4 : NV <= 8 ? 2 : 1;
  constexpr int kRowsPerBlock = (kThreads / 32) * (32 / G) * R;
  auto kernel = layer_norm_kernel<TIn, TOut, G, NV, R>;
  static int per_sm = 0;
  if (per_sm == 0) {
    int n = 0;
    cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    per_sm = n > 0 ? n : 1;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return e;
  const long long need =
      (static_cast<long long>(rows) + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long most = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(need < most ? need : most);
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<TOut*>(out), rows, c, eps);
  return cudaGetLastError();
}

// The group width and the vectors a lane holds: G 8 below C = 192, 16
// below 384, 32 from 384; NV the next of 4, 8, 16 at or above
// ceil(C / 4 / G).
template <typename TIn, typename TOut>
cudaError_t dispatch(const void* x, const void* gamma, const void* beta,
                     void* out, int rows, int c, float eps,
                     cudaStream_t stream) {
  const int c4 = c / 4;
  if (c < 192) {
    return (c4 + 7) / 8 <= 4
               ? launch<TIn, TOut, 8, 4>(x, gamma, beta, out, rows, c, eps,
                                         stream)
               : launch<TIn, TOut, 8, 8>(x, gamma, beta, out, rows, c, eps,
                                         stream);
  }
  if (c < 384) {
    return (c4 + 15) / 16 <= 4
               ? launch<TIn, TOut, 16, 4>(x, gamma, beta, out, rows, c, eps,
                                          stream)
               : launch<TIn, TOut, 16, 8>(x, gamma, beta, out, rows, c, eps,
                                          stream);
  }
  const int nv = (c4 + 31) / 32;
  if (nv <= 4) {
    return launch<TIn, TOut, 32, 4>(x, gamma, beta, out, rows, c, eps,
                                    stream);
  }
  if (nv <= 8) {
    return launch<TIn, TOut, 32, 8>(x, gamma, beta, out, rows, c, eps,
                                    stream);
  }
  return launch<TIn, TOut, 32, 16>(x, gamma, beta, out, rows, c, eps, stream);
}

}  // namespace

// in_dtype, out_dtype: 0 f32, 1 bf16.  x (rows, c) row-major in in_dtype,
// gamma and beta f32 (c,), out (rows, c) row-major in out_dtype; c a
// multiple of 32 up to 2,048; every pointer on a 16-byte boundary.
extern "C" int alink_layer_norm(int in_dtype, int out_dtype, const void* x,
                                const void* gamma, const void* beta,
                                void* out, int rows, int c, float eps,
                                void* stream) {
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gamma) |
      reinterpret_cast<uintptr_t>(beta) | reinterpret_cast<uintptr_t>(out);
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1 ||
      rows < 0 || c <= 0 || c % 32 || c > kMaxWidth || !x || !gamma ||
      !beta || !out || addr % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (in_dtype == 0) {
    e = out_dtype == 0
            ? dispatch<float, float>(x, gamma, beta, out, rows, c, eps, st)
            : dispatch<float, __nv_bfloat16>(x, gamma, beta, out, rows, c,
                                             eps, st);
  } else {
    e = out_dtype == 0
            ? dispatch<__nv_bfloat16, float>(x, gamma, beta, out, rows, c,
                                             eps, st)
            : dispatch<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, out,
                                                     rows, c, eps, st);
  }
  return static_cast<int>(e);
}
