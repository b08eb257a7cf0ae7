// Frozen batch norm, PReLU and residual add of an ArcFace improved-residual
// unit, and frozen batch norm, residual add and ReLU of a keras ResNet-50's
// stem and strided bottlenecks, fused into one pass over the activation,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package (alink_tpu/models/arcface.py,
// resnet.py) leaves BN, PReLU and ReLU to XLA, which fuses them into the
// convolutions' neighbours.  The port's plain chain
// (ops/bn_act.py:bn_act_reference, the _FrozenBN, _PReLU, + and torch.relu
// of models/) rebuilds each BN's scale and shift in ~8 launches on
// C-element vectors and then makes two to three full passes over the bf16
// activation per operation: ~11 passes and ~39 launches an ArcFace unit.
// This kernel makes one pass per mode:
//   mode 0, bn:        y = round(round(x * s) + b)
//   mode 1, bn_prelu:  bn, then y >= 0 ? y : round(round(alpha) * y)
//   mode 2, bn_add:    round(bn(x) + r)
//   mode 3, bn_add_bn: round(bn(x) + bn'(r)), bn' the shortcut's own BN
//   mode 4, bn_relu:   relu(bn(x))
//   mode 5, bn_add_bn_relu: relu(round(bn(x) + bn'(r)))
// where round() rounds to the working type T (bf16 or f32) and relu() is
// torch.relu's clamp_min: NaN stays, else fmaxf(y, 0) (the same
// instruction, so the same sign of a zero).  Where a gradient is wanted,
// alink_bn_act_backward gives the gradients of the activations in one pass
// too, the plain path's own backward operations: dx = round(g' * s), g' =
// g, or through the PReLU g where bn(x) >= 0 (bn recomputed from x) else
// round(g * round(alpha)), or through the ReLU 0 where the forward's
// output is <= 0 (threshold_backward on the saved output, one read where
// recomputing mode 5's would take two) else g; the shortcut's gradient is
// g, or round(g' * s') through its BN.
//
// Bound: memory.  Each mode reads its one or two activations once and
// writes one; the statistics are a few hundred bytes a block, read from L2.
// At r100's shapes, batch 256, one forward moves ~15.3 GB through this
// kernel, 4.6 ms at 3.35 TB/s.  What the design does about that:
//   - the (N, C, H, W) activation is channels-last in memory, so it is an
//     (N*H*W, C) matrix of contiguous rows.  A thread owns V channels of a
//     row (V * sizeof(T) = 16 bytes: 8 bf16, 4 f32) and moves them in one
//     16-byte load per input and one 16-byte store; a block is R rows x ct
//     such vectors of one tile of at most kTileChannels channels (~128
//     threads) and owns kRowsInFlight * R rows of it, each thread's
//     kRowsInFlight loads issued together.  The grid covers the tensor once
//     (rows x channel tiles), so short blocks ramp up and drain fast even
//     on r100's small 7x7 and 14x14 tensors;
//   - the statistics are folded in the kernel: each thread of a block
//     loads one channel's gamma, beta, mean and var (and slope) before the
//     block's rows, folds them into shared memory while the rows are in
//     flight, and after one barrier keeps its V channels' scale, shift and
//     slope in registers.  No launch and no pass is spent on C-element
//     vectors, and the channel tile caps a block's fold at one channel a
//     thread whatever C is;
//   - a row width that is not a multiple of V, or a misaligned pointer
//     (tensor-parallel padded widths such as 171), takes the same kernel
//     with V = 1: one element a thread, still coalesced across a warp.
// chip_smoke.py phase p times the kernel against this bound at every r100
// shape; PERF.md's kernel table keeps the figures.
// Rounding is the plain path's, bit for bit: the fold is
// root = sqrt(var + eps), s = gamma / root, b = beta - (mean * gamma) / root
// with IEEE intrinsics (__fadd_rn, __fsqrt_rn, __fdiv_rn, __fmul_rn,
// __fsub_rn: nvcc cannot contract them into FMAs or approximate them), s
// and b rounded to T; every multiply and add is computed in f32 and
// rounded to T where the plain path rounds (__float2bfloat16_rn, to
// nearest even, as PyTorch's bf16 operators round their f32 results).
// 64-bit element offsets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileChannels = 128;
constexpr int kTargetThreads = 128;
constexpr int kRowsInFlight = 2;
// A block has a thread for each channel of its tile: its R * ct threads
// (R = kTargetThreads / ct) hold the tile's ct * V channels, since
// ct * V <= kTileChannels <= kTargetThreads makes V <= R.
static_assert(kTileChannels <= kTargetThreads, "one fold a thread");

struct BnStats {
  const float* gamma;
  const float* beta;
  const float* mean;
  const float* var;
  float eps;
};

template <typename T>
__device__ __forceinline__ float round_to(float v);

template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V channels of one row: one 16-byte access when V * sizeof(T) == 16.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// One channel's frozen-BN statistics, loaded ahead of their fold.
struct BnChannel {
  float gamma, beta, mean, var;
};

__device__ __forceinline__ BnChannel load_channel(const BnStats& p, int i) {
  return {p.gamma[i], p.beta[i], p.mean[i], p.var[i]};
}

// _FrozenBN's scale and shift of one channel, rounded to T.
template <typename T>
__device__ __forceinline__ void fold(const BnChannel& k, float eps, float* s,
                                     float* b) {
  const float root = __fsqrt_rn(__fadd_rn(k.var, eps));
  *s = round_to<T>(__fdiv_rn(k.gamma, root));
  *b = round_to<T>(__fsub_rn(k.beta,
                             __fdiv_rn(__fmul_rn(k.mean, k.gamma), root)));
}

template <typename T>
__device__ __forceinline__ float apply_bn(float x, float s, float b) {
  return round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(x, s)), b));
}

// torch.relu on the card (clamp_min's kernel): NaN passes, else fmaxf.
__device__ __forceinline__ float relu(float y) {
  return isnan(y) ? y : fmaxf(y, 0.0f);
}

// Vectors of V channels a block spans: at most kTileChannels channels, so a
// block folds at most that many statistics whatever C is.
template <int V>
__host__ __device__ __forceinline__ int tile_vectors(int c) {
  return c / V < kTileChannels / V ? c / V : kTileChannels / V;
}

// One launch of mode MODE over rows x c elements of type T, V channels a
// thread.  A block is R rows x ct vectors (ct = tile_vectors, R =
// kTargetThreads / ct) and owns kRowsInFlight * R rows of the channel tile
// blockIdx.y.
template <typename T, int V, int MODE>
__global__ void bn_act_kernel(const T* __restrict__ x,
                              const T* __restrict__ r, T* __restrict__ out,
                              int rows, int c, BnStats p, BnStats q,
                              const float* __restrict__ alpha) {
  using P = Pack<T, V>;
  const int ct = tile_vectors<V>(c);
  const int rows_per_step = blockDim.x / ct;
  const int lane = threadIdx.x % ct;
  const int col = blockIdx.y * ct + lane;
  const bool active = col < c / V;
  const long long first =
      static_cast<long long>(blockIdx.x) * kRowsInFlight * rows_per_step +
      threadIdx.x / ct;
  // Thread i folds channel i of the tile (the tile has at most blockDim.x
  // channels).  Its statistics (L2) are asked for first, then the block's
  // rows (device memory), so the fold runs while the rows are in flight.
  const int c0 = blockIdx.y * ct * V;
  const int i = threadIdx.x;
  const bool folds = i < min(ct * V, c - c0);
  BnChannel k, k2;
  float a = 0.0f;
  if (folds) {
    k = load_channel(p, c0 + i);
    if (MODE == 1) a = alpha[c0 + i];
    if (MODE == 3 || MODE == 5) k2 = load_channel(q, c0 + i);
  }
  P xv[kRowsInFlight], rv[kRowsInFlight];
#pragma unroll
  for (int u = 0; u < kRowsInFlight; ++u) {
    const long long at = first + u * rows_per_step;
    if (active && at < rows) {
      const long long off = at * c + col * V;
      xv[u] = *reinterpret_cast<const P*>(x + off);
      if (MODE >= 2 && MODE != 4) {
        rv[u] = *reinterpret_cast<const P*>(r + off);
      }
    }
  }

  extern __shared__ float smem[];  // s, b, then the slope or s', b'
  float* s = smem;
  float* b = smem + ct * V;
  float* s2 = smem + 2 * ct * V;
  float* b2 = smem + 3 * ct * V;
  if (folds) {
    fold<T>(k, p.eps, &s[i], &b[i]);
    if (MODE == 1) s2[i] = round_to<T>(a);
    if (MODE == 3 || MODE == 5) fold<T>(k2, q.eps, &s2[i], &b2[i]);
  }
  __syncthreads();
  if (!active) return;
  float rs[V], rb[V], rs2[V], rb2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = lane * V + v;
    rs[v] = s[j];
    rb[v] = b[j];
    rs2[v] = MODE == 1 || MODE == 3 || MODE == 5 ? s2[j] : 0.0f;
    rb2[v] = MODE == 3 || MODE == 5 ? b2[j] : 0.0f;
  }

#pragma unroll
  for (int u = 0; u < kRowsInFlight; ++u) {
    const long long at = first + u * rows_per_step;
    if (at < rows) {
      P o;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float y = apply_bn<T>(to_f32(xv[u].v[v]), rs[v], rb[v]);
        if (MODE == 1 && !(y >= 0.0f)) {
          y = round_to<T>(__fmul_rn(rs2[v], y));
        } else if (MODE == 2) {
          y = __fadd_rn(y, to_f32(rv[u].v[v]));
        } else if (MODE == 3 || MODE == 5) {
          y = __fadd_rn(y, apply_bn<T>(to_f32(rv[u].v[v]), rs2[v], rb2[v]));
        }
        if (MODE >= 4) y = relu(round_to<T>(y));
        o.v[v] = from_f32<T>(y);
      }
      *reinterpret_cast<P*>(out + at * c + col * V) = o;
    }
  }
}

// The backward of mode MODE with respect to the activations, the plain
// path's own operations (autograd through bn_act_reference), one pass:
//   modes 0 and 2: dx = round(g * s)   (mode 2's shortcut gradient is g)
//   mode 1:        y = bn(x) recomputed; dx = round(gy * s), gy = g where
//                  y >= 0, else round(g * round(alpha))
//   mode 3:        dx = round(g * s), dr = round(g * s')
//   modes 4 and 5: g' = 0 where the saved output (passed as x) is <= 0,
//                  else g; dx = round(g' * s) (mode 5: dr = round(g' * s'))
// Same tiling and in-kernel fold as bn_act_kernel; g and x are read once,
// dx (and dr) written once.
template <typename T, int V, int MODE>
__global__ void bn_act_backward_kernel(const T* __restrict__ g,
                                       const T* __restrict__ x,
                                       T* __restrict__ dx, T* __restrict__ dr,
                                       int rows, int c, BnStats p, BnStats q,
                                       const float* __restrict__ alpha) {
  using P = Pack<T, V>;
  const int ct = tile_vectors<V>(c);
  const int rows_per_step = blockDim.x / ct;
  const int lane = threadIdx.x % ct;
  const int col = blockIdx.y * ct + lane;
  const bool active = col < c / V;
  const long long first =
      static_cast<long long>(blockIdx.x) * kRowsInFlight * rows_per_step +
      threadIdx.x / ct;
  const int c0 = blockIdx.y * ct * V;
  const int i = threadIdx.x;
  const bool folds = i < min(ct * V, c - c0);
  BnChannel k, k2;
  float a = 0.0f;
  if (folds) {
    k = load_channel(p, c0 + i);
    if (MODE == 1) a = alpha[c0 + i];
    if (MODE == 3 || MODE == 5) k2 = load_channel(q, c0 + i);
  }
  P gv[kRowsInFlight], xv[kRowsInFlight];
#pragma unroll
  for (int u = 0; u < kRowsInFlight; ++u) {
    const long long at = first + u * rows_per_step;
    if (active && at < rows) {
      const long long off = at * c + col * V;
      gv[u] = *reinterpret_cast<const P*>(g + off);
      if (MODE == 1 || MODE >= 4) xv[u] = *reinterpret_cast<const P*>(x + off);
    }
  }

  extern __shared__ float smem[];  // s, b, then the slope or s', b'
  float* s = smem;
  float* b = smem + ct * V;
  float* s2 = smem + 2 * ct * V;
  float* b2 = smem + 3 * ct * V;
  if (folds) {
    fold<T>(k, p.eps, &s[i], &b[i]);
    if (MODE == 1) s2[i] = round_to<T>(a);
    if (MODE == 3 || MODE == 5) fold<T>(k2, q.eps, &s2[i], &b2[i]);
  }
  __syncthreads();
  if (!active) return;
  float rs[V], rb[V], rs2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = lane * V + v;
    rs[v] = s[j];
    rb[v] = MODE == 1 ? b[j] : 0.0f;
    rs2[v] = MODE == 1 || MODE == 3 || MODE == 5 ? s2[j] : 0.0f;
  }

#pragma unroll
  for (int u = 0; u < kRowsInFlight; ++u) {
    const long long at = first + u * rows_per_step;
    if (at < rows) {
      P o, o2;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float gg = to_f32(gv[u].v[v]);
        float gy = gg;
        if (MODE == 1) {
          const float y = apply_bn<T>(to_f32(xv[u].v[v]), rs[v], rb[v]);
          if (!(y >= 0.0f)) gy = round_to<T>(__fmul_rn(gg, rs2[v]));
        }
        if (MODE >= 4 && to_f32(xv[u].v[v]) <= 0.0f) gy = 0.0f;
        o.v[v] = from_f32<T>(__fmul_rn(gy, rs[v]));
        if (MODE == 3) o2.v[v] = from_f32<T>(__fmul_rn(gg, rs2[v]));
        if (MODE == 5) o2.v[v] = from_f32<T>(__fmul_rn(gy, rs2[v]));
      }
      const long long off = at * c + col * V;
      *reinterpret_cast<P*>(dx + off) = o;
      if (MODE == 3 || MODE == 5) *reinterpret_cast<P*>(dr + off) = o2;
    }
  }
}

// A launch's grid, block and shared memory for rows x c elements, V
// channels a thread: blocks of R rows x ct vectors of one channel tile,
// kRowsInFlight * R rows a block.
struct Shape {
  dim3 grid;
  int threads;
  size_t smem;
};

template <int V>
Shape shape_of(int rows, int c, int tables) {
  const int ct = tile_vectors<V>(c);
  const int rows_per_step = kTargetThreads / ct;
  const int rows_per_block = rows_per_step * kRowsInFlight;
  return {dim3((rows + rows_per_block - 1) / rows_per_block,
               (c / V + ct - 1) / ct),
          rows_per_step * ct, sizeof(float) * tables * ct * V};
}

template <typename T, int V, int MODE>
cudaError_t launch(const void* x, const void* r, void* out, int rows, int c,
                   BnStats p, BnStats q, const float* alpha,
                   cudaStream_t stream) {
  const Shape sh = shape_of<V>(rows, c, MODE == 0 || MODE == 4 ? 2 : 4);
  bn_act_kernel<T, V, MODE><<<sh.grid, sh.threads, sh.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<T*>(out),
      rows, c, p, q, alpha);
  return cudaGetLastError();
}

template <typename T, int V, int MODE>
cudaError_t launch_backward(const void* g, const void* x, void* dx, void* dr,
                            int rows, int c, BnStats p, BnStats q,
                            const float* alpha, cudaStream_t stream) {
  const Shape sh = shape_of<V>(rows, c, 4);
  bn_act_backward_kernel<T, V, MODE><<<sh.grid, sh.threads, sh.smem,
                                       stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<T*>(dx),
      static_cast<T*>(dr), rows, c, p, q, alpha);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t dispatch_mode(int mode, const void* x, const void* r, void* out,
                          int rows, int c, BnStats p, BnStats q,
                          const float* alpha, cudaStream_t stream) {
  switch (mode) {
    case 0:
      return launch<T, V, 0>(x, r, out, rows, c, p, q, alpha, stream);
    case 1:
      return launch<T, V, 1>(x, r, out, rows, c, p, q, alpha, stream);
    case 2:
      return launch<T, V, 2>(x, r, out, rows, c, p, q, alpha, stream);
    case 4:
      return launch<T, V, 4>(x, r, out, rows, c, p, q, alpha, stream);
    case 5:
      return launch<T, V, 5>(x, r, out, rows, c, p, q, alpha, stream);
    default:
      return launch<T, V, 3>(x, r, out, rows, c, p, q, alpha, stream);
  }
}

template <typename T, int V>
cudaError_t dispatch_backward_mode(int mode, const void* g, const void* x,
                                   void* dx, void* dr, int rows, int c,
                                   BnStats p, BnStats q, const float* alpha,
                                   cudaStream_t stream) {
  switch (mode) {
    case 0:
    case 2:
      return launch_backward<T, V, 0>(g, x, dx, dr, rows, c, p, q, alpha,
                                      stream);
    case 1:
      return launch_backward<T, V, 1>(g, x, dx, dr, rows, c, p, q, alpha,
                                      stream);
    case 4:
      return launch_backward<T, V, 4>(g, x, dx, dr, rows, c, p, q, alpha,
                                      stream);
    case 5:
      return launch_backward<T, V, 5>(g, x, dx, dr, rows, c, p, q, alpha,
                                      stream);
    default:
      return launch_backward<T, V, 3>(g, x, dx, dr, rows, c, p, q, alpha,
                                      stream);
  }
}

// 16-byte vectors where the row width and every pointer allow them.
template <typename T>
bool vectorised(int c, uintptr_t addr) {
  return c % (16 / sizeof(T)) == 0 && addr % 16 == 0;
}

template <typename T>
cudaError_t dispatch(int mode, const void* x, const void* r, void* out,
                     int rows, int c, BnStats p, BnStats q,
                     const float* alpha, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(r) |
                         reinterpret_cast<uintptr_t>(out);
  if (vectorised<T>(c, addr)) {
    return dispatch_mode<T, kV>(mode, x, r, out, rows, c, p, q, alpha, stream);
  }
  return dispatch_mode<T, 1>(mode, x, r, out, rows, c, p, q, alpha, stream);
}

template <typename T>
cudaError_t dispatch_backward(int mode, const void* g, const void* x,
                              void* dx, void* dr, int rows, int c, BnStats p,
                              BnStats q, const float* alpha,
                              cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(x) |
      reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(dr);
  if (vectorised<T>(c, addr)) {
    return dispatch_backward_mode<T, kV>(mode, g, x, dx, dr, rows, c, p, q,
                                         alpha, stream);
  }
  return dispatch_backward_mode<T, 1>(mode, g, x, dx, dr, rows, c, p, q,
                                      alpha, stream);
}

BnStats stats_of(const void* gamma, const void* beta, const void* mean,
                 const void* var, float eps) {
  return {static_cast<const float*>(gamma), static_cast<const float*>(beta),
          static_cast<const float*>(mean), static_cast<const float*>(var),
          eps};
}

}  // namespace

// mode: 0 bn, 1 bn_prelu, 2 bn_add, 3 bn_add_bn, 4 bn_relu, 5
// bn_add_bn_relu; dtype: 0 f32, 1 bf16.  x, r (modes 2, 3 and 5) and out
// are (rows, c) row-major in the working type; the statistics f32 (c,);
// alpha (mode 1) f32 (c,); the shortcut's statistics (modes 3 and 5).
extern "C" int alink_bn_act(int mode, int dtype, const void* x, const void* r,
                            void* out, int rows, int c, const void* gamma,
                            const void* beta, const void* mean,
                            const void* var, float eps, const void* gamma2,
                            const void* beta2, const void* mean2,
                            const void* var2, float eps2, const void* alpha,
                            void* stream) {
  const bool bad_stats = !gamma || !beta || !mean || !var;
  const bool bn2 = mode == 3 || mode == 5;
  const bool bad_mode = mode < 0 || mode > 5 || (mode == 1 && !alpha) ||
                        (mode >= 2 && mode != 4 && !r) ||
                        (bn2 && (!gamma2 || !beta2 || !mean2 || !var2));
  if (dtype < 0 || dtype > 1 || rows < 0 || c <= 0 || !x || !out ||
      bad_stats || bad_mode) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const BnStats p = stats_of(gamma, beta, mean, var, eps);
  const BnStats q = stats_of(gamma2, beta2, mean2, var2, eps2);
  const float* a = static_cast<const float*>(alpha);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 0
          ? dispatch<float>(mode, x, r, out, rows, c, p, q, a, st)
          : dispatch<__nv_bfloat16>(mode, x, r, out, rows, c, p, q, a, st);
  return static_cast<int>(e);
}

// The backward of alink_bn_act's mode with respect to the activations: g
// (the output's gradient) and, for mode 1, x (for modes 4 and 5 the
// forward's output) in; dx and, for modes 3 and 5, dr (the shortcut's
// gradient) out; all (rows, c) row-major in the working type.  Mode 2's
// shortcut gradient is g itself: nothing is written for it.
extern "C" int alink_bn_act_backward(int mode, int dtype, const void* g,
                                     const void* x, void* dx, void* dr,
                                     int rows, int c, const void* gamma,
                                     const void* beta, const void* mean,
                                     const void* var, float eps,
                                     const void* gamma2, const void* beta2,
                                     const void* mean2, const void* var2,
                                     float eps2, const void* alpha,
                                     void* stream) {
  const bool bad_stats = !gamma || !beta || !mean || !var;
  const bool bn2 = mode == 3 || mode == 5;
  const bool bad_mode = mode < 0 || mode > 5 ||
                        (mode == 1 && (!alpha || !x)) || (mode >= 4 && !x) ||
                        (bn2 && (!dr || !gamma2 || !beta2 || !mean2 ||
                                 !var2));
  if (dtype < 0 || dtype > 1 || rows < 0 || c <= 0 || !g || !dx ||
      bad_stats || bad_mode) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const BnStats p = stats_of(gamma, beta, mean, var, eps);
  const BnStats q = stats_of(gamma2, beta2, mean2, var2, eps2);
  const float* a = static_cast<const float*>(alpha);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 0
          ? dispatch_backward<float>(mode, g, x, dx, dr, rows, c, p, q, a, st)
          : dispatch_backward<__nv_bfloat16>(mode, g, x, dx, dr, rows, c, p,
                                             q, a, st);
  return static_cast<int>(e);
}
