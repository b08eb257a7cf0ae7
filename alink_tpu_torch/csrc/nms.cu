// Greedy non-max suppression over a fixed budget of candidates a photo, all
// on the device, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's NMS (alink_tpu/ops/nms.py) is
// masked array arithmetic on K x K overlaps, which ops/nms.py:nms ports for
// the cascade's budgets of 32.  At RetinaFace's published budget (5,000
// candidates a photo, 256 photos) one K x K float32 array is 25.6 GB, so
// this kernel never holds an overlap: it keeps one bit a pair.
//
// The candidates arrive in visit order (descending score, ties to the lower
// index; ops/nms.py sorts them), with a validity flag each.  Two kernels:
//   - nms_mask: for each photo, row block rb and column block cb >= rb of 64
//     candidates, one thread a row i computes the word of 64 bits "i
//     suppresses j" for the columns j > i of block cb: the overlap of i and
//     j above the threshold.  The overlap is ops/nms.py:iou_matrix's
//     arithmetic in its order, each operation rounded on its own (no FMA
//     contraction: __fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn), with
//     torch's NaN propagation in max, min and clamp: inclusive-pixel areas
//     (x2 - x1 + 1) * (y2 - y1 + 1), the intersection's sides clamped at 0,
//     the union area_i + area_j - inter clamped at 1e-12, then the
//     quotient.  A pair with no intersection skips the division (its
//     overlap is 0, suppressing nothing at a threshold >= 0).  The grid
//     holds only the upper triangle of blocks; the mask has room for K x
//     ceil(K / 64) words a photo (809 MB at 256 x 5,000);
//   - nms_sweep: one block a photo walks the column blocks in order.  The
//     removed bits of block b are final once the blocks before it are
//     done; warp 0 resolves block b's 64 candidates one after another from
//     those bits and the block's own diagonal words (a candidate is kept
//     if valid and not removed; a kept candidate removes its diagonal
//     bits), then every thread ORs the words of block b's kept rows into
//     the removed bits of the later blocks (shared memory, 64-bit
//     atomics).  No host synchronisation anywhere.
// The keep flags are the fixed point ops/nms.py:nms iterates to: greedy
// NMS in visit order, bit for bit.
//
// Bound: at 256 x 5,000 the K (K - 1) / 2 overlaps a photo (16 operations
// each, bench_torch/roofline_retina.py) are 51.2 GFLOP, 0.76 ms at the
// card's 67 TFLOP/s of float32 outside the tensor cores; the upper
// triangle of mask words, written once and read once, is 0.83 GB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;          // candidates a mask word covers
constexpr int kSweepThreads = 256;

// torch.maximum, torch.minimum and torch.clamp(x, min=lo): a NaN operand
// gives NaN (PTX max.NaN / min.NaN, one instruction each).
__device__ __forceinline__ float tmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float tmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// Whether the earlier candidate a suppresses the later b: iou_matrix's
// overlap, strictly above the threshold.
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b,
                                           float area_b, float threshold) {
  const float xx1 = tmax(a.x, b.x), yy1 = tmax(a.y, b.y);
  const float xx2 = tmin(a.z, b.z), yy2 = tmin(a.w, b.w);
  const float w = tmax(__fadd_rn(__fsub_rn(xx2, xx1), 1.0f), 0.0f);
  const float h = tmax(__fadd_rn(__fsub_rn(yy2, yy1), 1.0f), 0.0f);
  const float inter = __fmul_rn(w, h);
  if (inter == 0.0f && threshold >= 0.0f) return false;
  const float denom =
      tmax(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-12f);
  return __fdiv_rn(inter, denom) > threshold;
}

// Blocks (row block rb, column block cb >= rb) before row block rb.
__device__ __forceinline__ int row_start(int rb, int words) {
  return rb * words - rb * (rb - 1) / 2;
}

// One block per (rb, cb >= rb) of a photo: block x of the grid is the
// x-th of them in row order (rb from the quadratic's root, then settled
// exactly), block y the photo.
__global__ void __launch_bounds__(kBlock)
    nms_mask(const float4* __restrict__ boxes, int k, int words,
             float threshold, unsigned long long* __restrict__ mask) {
  const int idx = blockIdx.x;
  const float b2 = 2.0f * words + 1.0f;
  int rb = static_cast<int>(0.5f * (b2 - sqrtf(b2 * b2 - 8.0f * idx)));
  rb = max(0, min(rb, words - 1));
  while (rb > 0 && row_start(rb, words) > idx) --rb;
  while (rb + 1 < words && row_start(rb + 1, words) <= idx) ++rb;
  const int cb = rb + idx - row_start(rb, words);
  __shared__ float4 cbox[kBlock];
  __shared__ float carea[kBlock];
  const int tid = threadIdx.x;
  const long long photo = blockIdx.y;
  const float4* b = boxes + photo * k;
  const int rows = min(k - rb * kBlock, kBlock);
  const int cols = min(k - cb * kBlock, kBlock);
  if (tid < cols) {
    const float4 c = b[cb * kBlock + tid];
    cbox[tid] = c;
    carea[tid] = area(c);
  }
  __syncthreads();
  if (tid >= rows) return;
  const int i = rb * kBlock + tid;
  const float4 a = b[i];
  const float aa = area(a);
  unsigned long long bits = 0;
  for (int j = cb == rb ? tid + 1 : 0; j < cols; ++j) {
    if (suppresses(a, aa, cbox[j], carea[j], threshold)) bits |= 1ULL << j;
  }
  mask[(photo * k + i) * words + cb] = bits;
}

__global__ void __launch_bounds__(kSweepThreads)
    nms_sweep(const unsigned long long* __restrict__ mask,
              const bool* __restrict__ valid, int k, int words,
              bool* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];   // words of them
  __shared__ unsigned long long kept_word;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long photo = blockIdx.x;
  const unsigned long long* m = mask + photo * k * words;
  const bool* v = valid + photo * k;
  bool* out = keep + photo * k;
  for (int c = tid; c < words; c += kSweepThreads) removed[c] = 0;
  __syncthreads();
  for (int b = 0; b < words; ++b) {
    const int base = b * kBlock;
    const int rows = min(k - base, kBlock);
    if (warp == 0) {
      // Lane t holds the diagonal words and validity of rows t and t + 32.
      const bool in_lo = lane < rows, in_hi = lane + 32 < rows;
      const unsigned long long dlo =
          in_lo ? m[static_cast<long long>(base + lane) * words + b] : 0;
      const unsigned long long dhi =
          in_hi ? m[static_cast<long long>(base + lane + 32) * words + b] : 0;
      const unsigned long long vbits =
          static_cast<unsigned long long>(
              __ballot_sync(0xffffffffu, in_lo && v[base + lane])) |
          (static_cast<unsigned long long>(
               __ballot_sync(0xffffffffu, in_hi && v[base + lane + 32]))
           << 32);
      unsigned long long rem = removed[b], kw = 0;
      for (int t = 0; t < rows; ++t) {
        const unsigned long long d =
            __shfl_sync(0xffffffffu, t < 32 ? dlo : dhi, t & 31);
        if (((vbits & ~rem) >> t) & 1ULL) {
          kw |= 1ULL << t;
          rem |= d;
        }
      }
      if (in_lo) out[base + lane] = (kw >> lane) & 1ULL;
      if (in_hi) out[base + lane + 32] = (kw >> (lane + 32)) & 1ULL;
      if (lane == 0) kept_word = kw;
    }
    __syncthreads();
    const unsigned long long kw = kept_word;
    if (kw != 0) {
      // Thread (word c0 + tid % 64, rows tid / 64, + 4, ...): the kept
      // rows' words, 64 columns of words at a time.
      for (int c0 = b + 1; c0 < words; c0 += kBlock) {
        const int c = c0 + (tid & (kBlock - 1));
        if (c < words) {
          unsigned long long acc = 0;
          for (int t = tid / kBlock; t < rows; t += kSweepThreads / kBlock) {
            if ((kw >> t) & 1ULL)
              acc |= m[static_cast<long long>(base + t) * words + c];
          }
          if (acc) atomicOr(&removed[c], acc);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// boxes: (n, k, 4) float32 [x1, y1, x2, y2], contiguous, in visit order;
// valid, keep: (n, k) bool; mask: n * k * ceil(k / 64) 64-bit words of
// scratch (nothing of it need be initialised).  Returns
// cudaGetLastError() after the two launches.
extern "C" int alink_nms(const void* boxes, const void* valid, void* mask,
                         void* keep, int n, int k, float threshold,
                         void* stream) {
  if (!boxes || !valid || !mask || !keep || n < 0 || k < 0 ||
      reinterpret_cast<uintptr_t>(boxes) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  const int words = (k + kBlock - 1) / kBlock;
  const size_t smem = static_cast<size_t>(words) * 8;
  if (words > 25600 || n > 65535 || smem > 200 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* words_out = static_cast<unsigned long long*>(mask);
  const int pairs = words * (words + 1) / 2;
  nms_mask<<<dim3(pairs, n), kBlock, 0, s>>>(
      static_cast<const float4*>(boxes), k, words, threshold, words_out);
  cudaError_t st = cudaGetLastError();
  if (st != cudaSuccess) return static_cast<int>(st);
  if (smem > 48 * 1024) {
    st = cudaFuncSetAttribute(nms_sweep,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (st != cudaSuccess) return static_cast<int>(st);
  }
  nms_sweep<<<n, kSweepThreads, smem, s>>>(
      words_out, static_cast<const bool*>(valid), k, words,
      static_cast<bool*>(keep));
  return static_cast<int>(cudaGetLastError());
}
