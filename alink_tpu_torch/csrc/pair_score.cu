// Fused all-pairs siamese scorer for Hopper (sm_90a).
//
// Replaces the TPU kernel alink_tpu/ops/pairwise.py:_fused_kernel (reached
// through score_matrix_pallas / score_matrix).  For row features L (N, D),
// column features R (M, D) and the two-hidden-layer head
//   |l_i - r_j| -> Dense(H1) relu -> Dense(H2) relu -> Dense(2)
// it writes P(genuine) = sigmoid(logit_1 - logit_0) for every pair (i, j).
// Only the (N, M) f32 score leaves the chip: the (N*M, D) difference tensor
// and both hidden activations live in shared memory and registers.
//
// Bound: the tensor cores.  The work is O(N*M*D*H1) multiply-adds (0.26
// T multiply-adds for a 1000 x 1000 grid at D = H1 = 512) against O((N + M)*D)
// bytes read, far above the card's ~295 FLOP/byte ridge.  The design:
//   - a block owns 32 pairs (4 rows x 8 columns) and walks D in chunks of
//     64: it builds the |l - r| chunk in shared memory in bf16 and multiplies
//     it by the W1 chunk on the tensor cores (nvcuda::wmma bf16 16x16x16,
//     f32 accumulation), keeping the 32 x H1 accumulator in registers
//     across chunks (8 warps x up to 8 fragments: H1 <= 512);
//   - bias + relu round the hidden layer to bf16 in shared memory, the
//     H1 x H2 layer runs on the tensor cores the same way, and the H2 x 2
//     layer plus the sigmoid are plain FMAs, one thread per pair;
//   - W1 and W2 fragments are read straight from global memory: every block
//     reads the same weights, so they stay in L2.
// Ragged N, M and D are masked in the kernel (zero differences).  wgmma,
// TMA and larger pair tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kTI = 4;            // rows per block
constexpr int kTJ = 8;            // columns per block
constexpr int kP = kTI * kTJ;     // pairs per block (two 16-row fragments)
constexpr int kDC = 64;           // D chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxFrags = 8;      // accumulator fragments per warp
constexpr int kMaxH1 = 16 * (kWarps / 2) * kMaxFrags;  // 512
constexpr int kMaxH2 = 256;

__global__ void __launch_bounds__(kThreads)
pair_score_kernel(const float* __restrict__ rows,
                  const float* __restrict__ cols, int n, int m, int d,
                  int dp, int tiles_j, const __nv_bfloat16* __restrict__ w1,
                  const float* __restrict__ b1, int h1p,
                  const __nv_bfloat16* __restrict__ w2,
                  const float* __restrict__ b2, int h2p,
                  const float* __restrict__ wo, const float* __restrict__ bo,
                  float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* diff = reinterpret_cast<__nv_bfloat16*>(smem);
  float* scratch = reinterpret_cast<float*>(smem + kP * kDC * 2);
  __nv_bfloat16* hid1 = reinterpret_cast<__nv_bfloat16*>(
      smem + kP * kDC * 2 + kWarps * 256 * 4);
  float* hid2 = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(hid1) + kP * h1p * 2);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int i0 = (blockIdx.x / tiles_j) * kTI;
  const int j0 = (blockIdx.x % tiles_j) * kTJ;
  const int rf = warp & 1;      // which 16-pair fragment row this warp owns
  const int cf0 = warp >> 1;    // first H1 fragment column; stride 4
  const int ncf1 = h1p / 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxFrags];
#pragma unroll
  for (int f = 0; f < kMaxFrags; ++f) wmma::fill_fragment(acc[f], 0.0f);

  // ---- layer 1: sum over D chunks of |l - r| (bf16) @ W1 (bf16) --------
  for (int d0 = 0; d0 < dp; d0 += kDC) {
    for (int e = tid; e < kP * kDC; e += kThreads) {
      const int p = e / kDC;
      const int k = d0 + e % kDC;
      const int i = i0 + p / kTJ;
      const int j = j0 + p % kTJ;
      float v = 0.0f;
      if (i < n && j < m && k < d) {
        v = fabsf(rows[static_cast<long long>(i) * d + k] -
                  cols[static_cast<long long>(j) * d + k]);
      }
      diff[e] = __float2bfloat16(v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, diff + rf * 16 * kDC + kk, kDC);
#pragma unroll
      for (int f = 0; f < kMaxFrags; ++f) {
        const int cf = cf0 + 4 * f;
        if (cf < ncf1) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b;
          wmma::load_matrix_sync(
              b, w1 + static_cast<long long>(d0 + kk) * h1p + cf * 16, h1p);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
    __syncthreads();
  }

  // ---- bias + relu -> bf16 hidden 1 in shared memory -------------------
  float* sc = scratch + warp * 256;
#pragma unroll
  for (int f = 0; f < kMaxFrags; ++f) {
    const int cf = cf0 + 4 * f;
    if (cf < ncf1) {
      wmma::store_matrix_sync(sc, acc[f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4;
        const int col = cf * 16 + (e & 15);
        const float v = fmaxf(sc[e] + b1[col], 0.0f);
        hid1[(rf * 16 + r) * h1p + col] = __float2bfloat16(v);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- layer 2: hidden 1 (bf16) @ W2 (bf16), bias + relu ---------------
  const int ncf2 = h2p / 16;
  for (int f = warp; f < 2 * ncf2; f += kWarps) {
    const int r2 = f & 1;
    const int cf = f >> 1;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc2;
    wmma::fill_fragment(acc2, 0.0f);
    for (int kk = 0; kk < h1p; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(a, hid1 + r2 * 16 * h1p + kk, h1p);
      wmma::load_matrix_sync(b, w2 + static_cast<long long>(kk) * h2p + cf * 16,
                             h2p);
      wmma::mma_sync(acc2, a, b, acc2);
    }
    wmma::store_matrix_sync(sc, acc2, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4;
      const int col = cf * 16 + (e & 15);
      const float v = fmaxf(sc[e] + b2[col], 0.0f);
      // The output layer takes bf16 operands: round here, keep f32 storage.
      hid2[(r2 * 16 + r) * h2p + col] =
          __bfloat162float(__float2bfloat16(v));
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- output layer (H2 x 2) and sigmoid, one thread per pair ----------
  if (tid < kP) {
    const int i = i0 + tid / kTJ;
    const int j = j0 + tid % kTJ;
    if (i < n && j < m) {
      float l0 = 0.0f;
      float l1 = 0.0f;
      const float* hrow = hid2 + tid * h2p;
      for (int k = 0; k < h2p; ++k) {
        l0 = fmaf(hrow[k], wo[2 * k], l0);
        l1 = fmaf(hrow[k], wo[2 * k + 1], l1);
      }
      l0 += bo[0];
      l1 += bo[1];
      out[static_cast<long long>(i) * m + j] = 1.0f / (1.0f + expf(l0 - l1));
    }
  }
}

}  // namespace

// rows (n, d), cols (m, d): f32.  w1 (dp, h1p), w2 (h1p, h2p): bf16,
// zero-padded.  b1 (h1p), b2 (h2p), wo (h2p, 2) bf16-rounded, bo (2): f32.
// out (n, m) f32.  Returns cudaGetLastError() after the launch.  The
// wrapper (ops/pairwise.py) pads to kDC and 16 and raises past kMaxH1 and
// kMaxH2; the check here only keeps a bad call from reading out of bounds.
extern "C" int alink_pair_score(const void* rows, const void* cols, int n,
                                int m, int d, int dp, const void* w1,
                                const void* b1, int h1p, const void* w2,
                                const void* b2, int h2p, const void* wo,
                                const void* bo, void* out, void* stream) {
  if (h1p > kMaxH1 || h2p > kMaxH2 || h1p % 16 || h2p % 16 || dp % kDC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_i = (n + kTI - 1) / kTI;
  const int tiles_j = (m + kTJ - 1) / kTJ;
  const long long blocks = static_cast<long long>(tiles_i) * tiles_j;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(kP) * kDC * 2 + kWarps * 256 * 4 +
                      static_cast<size_t>(kP) * h1p * 2 +
                      static_cast<size_t>(kP) * h2p * 4;
  if (smem > 48 * 1024) {
    cudaError_t st = cudaFuncSetAttribute(
        pair_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (st != cudaSuccess) return static_cast<int>(st);
  }
  pair_score_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(cols), n, m,
      d, dp, tiles_j, static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), h1p,
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      h2p, static_cast<const float*>(wo), static_cast<const float*>(bo),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
