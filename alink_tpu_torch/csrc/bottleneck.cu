// Fused stride-1 ResNet bottleneck for Hopper (sm_90a).
//
// Replaces the TPU kernel alink_tpu/ops/resblock.py:_block_kernel (reached
// through bottleneck_s1_flat / bottleneck_chain).  For x (N, H, W, Cin) bf16
// NHWC and BN folded to f32 scale/shift it writes, in bf16,
//   y1  = bf16(relu(x . W1 * s1 + b1))                 1x1 reduce, Cin -> Cm
//   y2  = bf16(relu(conv3x3_SAME(y1, W3) * s2 + b2))   Cm -> Cm, zero padding
//   y3  = y2 . W2 * s3 + b3                            1x1 expand, Cm -> Cout
//   sc  = x . Wp * sp + bp   (projection)   or   x   (identity, Cin == Cout)
//   out = bf16(relu(y3 + sc))
// with every product on the tensor cores (nvcuda::wmma bf16 16x16x16, f32
// accumulation) and each scale/shift applied as a rounded multiply then a
// rounded add, so the plain version (ops/resblock.py) rounds at the same
// points.  Only x is read and out written: y1 and y2 live in shared memory.
//
// Bound: the tensor cores.  A block does 2 * (100 * Cin * Cm + 80 * 9 * Cm^2
// + 64 * Cm * Cout [+ 64 * Cin * Cout]) FLOP for 64 output pixels while it
// reads 100 * Cin + 64 * Cout bf16 activations; the weights are shared by
// every block and stay in L2.  The design:
//   - a block owns an 8x8 tile of output pixels of one image and computes y1
//     on its 10x10 halo (112 rows with padding); halo pixels outside the
//     image are set to 0 after the epilogue, which is SAME zero padding (the
//     TPU kernel's valid_mask);
//   - y1 is kept in the halo's flat row order (row stride 10) behind one
//     guard row, so each 3x3 tap is a constant row offset: the 3x3 runs as 9
//     shifted products over 80 flat rows (8 tile rows x 10 halo columns; the
//     2 halo columns per row are computed and dropped), the TPU kernel's
//     sublane-shift trick done with wmma row offsets;
//   - output columns are walked in passes of 128 (one 16-column fragment per
//     warp, or several warps per column when Cm < 128), x is staged through
//     shared memory in chunks of 32 channels, and W1, W3, W2 and Wp
//     fragments are read straight from global memory (L2-resident).
// Shared memory is (113 + 64) * Cm * 2 + 23.5 KB: 200 KB at Cm = 512, one
// block per SM; Cm <= 576 fits the 227 KB a block can have on an H100
// (ops/resblock.py raises past it).  wgmma, TMA, weight staging and a
// persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kTH = 8;                       // output tile rows
constexpr int kTW = 8;                       // output tile columns
constexpr int kHW = kTW + 2;                 // halo width
constexpr int kHalo = (kTH + 2) * kHW;       // 100 halo pixels
constexpr int kMF1 = (kHalo + 15) / 16;      // 7 row fragments of y1
constexpr int kQ = kTH * kHW;                // 80 flat rows of the 3x3
constexpr int kMF2 = kQ / 16;                // 5
constexpr int kP = kTH * kTW;                // 64 output pixels
constexpr int kMF3 = kP / 16;                // 4
constexpr int kKC = 32;                      // x channels staged per chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kNC = 16 * kWarps;             // output columns per pass
constexpr int kY1Rows = 1 + kMF1 * 16;       // guard row + 112
constexpr int kMaxSmem = 232448;             // per block on H100
static_assert(kQ % 16 == 0 && kP % 16 == 0, "tile must fill fragments");
static_assert(1 + kHW + kQ - 1 + kHW + 1 < kY1Rows, "3x3 reads past y1");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

size_t smem_bytes(int cm) {
  return align128(static_cast<size_t>(kY1Rows) * cm * 2) +
         align128(static_cast<size_t>(kP) * cm * 2) +
         align128(static_cast<size_t>(kMF1) * 16 * kKC * 2) +
         static_cast<size_t>(kWarps) * 2 * 256 * 4;
}

// scale * v + shift, rounded after the multiply and after the add.
__device__ __forceinline__ float affine(float v, float s, float b) {
  return __fadd_rn(__fmul_rn(v, s), b);
}

// Which fragments a warp owns in a pass of `ncols` output columns: column
// fragment `nf`, and row fragments grp, grp + groups, ... (< mf).
struct Split {
  int nf, grp, groups;
  bool active;
  __device__ Split(int ncols, int warp) {
    const int nnf = ncols / 16;
    groups = kWarps / nnf;
    grp = warp / nnf;
    nf = warp % nnf;
    active = grp < groups;
  }
};

__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const __nv_bfloat16* __restrict__ x, int h, int w, int cin,
                  int cm, int cout, int tiles_x, int tiles_per_img,
                  const __nv_bfloat16* __restrict__ w1,
                  const float* __restrict__ s1, const float* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w3,
                  const float* __restrict__ s2, const float* __restrict__ b2,
                  const __nv_bfloat16* __restrict__ w2,
                  const float* __restrict__ s3, const float* __restrict__ b3,
                  const __nv_bfloat16* __restrict__ wp,
                  const float* __restrict__ sp, const float* __restrict__ bp,
                  __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(smem);
  size_t off = align128(static_cast<size_t>(kY1Rows) * cm * 2);
  __nv_bfloat16* y2s = reinterpret_cast<__nv_bfloat16*>(smem + off);
  off += align128(static_cast<size_t>(kP) * cm * 2);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + off);
  off += align128(static_cast<size_t>(kMF1) * 16 * kKC * 2);
  float* scratch = reinterpret_cast<float*>(smem + off);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int img = blockIdx.x / tiles_per_img;
  const int t = blockIdx.x % tiles_per_img;
  const int ty0 = (t / tiles_x) * kTH;
  const int tx0 = (t % tiles_x) * kTW;
  const long long img_px = static_cast<long long>(img) * h * w;
  float* sc0 = scratch + warp * 512;
  float* sc1 = sc0 + 256;

  for (int c = tid; c < cm; c += kThreads) y1s[c] = __float2bfloat16(0.0f);

  // ---- stage 1: y1 on the 10x10 halo ------------------------------------
  for (int n0 = 0; n0 < cm; n0 += kNC) {
    const Split sp1(min(kNC, cm - n0), warp);
    FragC acc[kMF1];
#pragma unroll
    for (int i = 0; i < kMF1; ++i) wmma::fill_fragment(acc[i], 0.0f);
    for (int k0 = 0; k0 < cin; k0 += kKC) {
      __syncthreads();
      for (int e = tid; e < kMF1 * 16 * (kKC / 8); e += kThreads) {
        const int r = e / (kKC / 8);
        const int v = e % (kKC / 8);
        const int hy = ty0 - 1 + r / kHW;
        const int hx = tx0 - 1 + r % kHW;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (r < kHalo && hy >= 0 && hy < h && hx >= 0 && hx < w) {
          val = *reinterpret_cast<const uint4*>(
              x + (img_px + static_cast<long long>(hy) * w + hx) * cin + k0 +
              v * 8);
        }
        *reinterpret_cast<uint4*>(xs + r * kKC + v * 8) = val;
      }
      __syncthreads();
      if (sp1.active) {
#pragma unroll
        for (int kk = 0; kk < kKC; kk += 16) {
          FragB b;
          wmma::load_matrix_sync(
              b, w1 + static_cast<long long>(k0 + kk) * cm + n0 + sp1.nf * 16,
              cm);
#pragma unroll
          for (int i = 0; i < kMF1; ++i) {
            const int m = sp1.grp + i * sp1.groups;
            if (m < kMF1) {
              FragA a;
              wmma::load_matrix_sync(a, xs + m * 16 * kKC + kk, kKC);
              wmma::mma_sync(acc[i], a, b, acc[i]);
            }
          }
        }
      }
    }
    if (sp1.active) {
#pragma unroll
      for (int i = 0; i < kMF1; ++i) {
        const int m = sp1.grp + i * sp1.groups;
        if (m < kMF1) {
          wmma::store_matrix_sync(sc0, acc[i], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int r = m * 16 + (e >> 4);
            const int col = n0 + sp1.nf * 16 + (e & 15);
            const int hy = ty0 - 1 + r / kHW;
            const int hx = tx0 - 1 + r % kHW;
            const bool valid =
                r < kHalo && hy >= 0 && hy < h && hx >= 0 && hx < w;
            const float v =
                valid ? fmaxf(affine(sc0[e], s1[col], b1[col]), 0.0f) : 0.0f;
            y1s[(1 + r) * cm + col] = __float2bfloat16(v);
          }
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();

  // ---- stage 2: the 3x3 as 9 row-shifted products over y1 ----------------
  for (int n0 = 0; n0 < cm; n0 += kNC) {
    const Split sp2(min(kNC, cm - n0), warp);
    if (!sp2.active) continue;
    FragC acc[kMF2];
#pragma unroll
    for (int i = 0; i < kMF2; ++i) wmma::fill_fragment(acc[i], 0.0f);
    for (int tap = 0; tap < 9; ++tap) {
      // y1s row of flat output row 0 under this tap (guard row included).
      const int base = 1 + kHW + (tap / 3 - 1) * kHW + (tap % 3 - 1);
      const __nv_bfloat16* wt =
          w3 + static_cast<long long>(tap) * cm * cm + n0 + sp2.nf * 16;
      for (int k = 0; k < cm; k += 16) {
        FragB b;
        wmma::load_matrix_sync(b, wt + static_cast<long long>(k) * cm, cm);
#pragma unroll
        for (int i = 0; i < kMF2; ++i) {
          const int m = sp2.grp + i * sp2.groups;
          if (m < kMF2) {
            FragA a;
            wmma::load_matrix_sync(a, y1s + (base + m * 16) * cm + k, cm);
            wmma::mma_sync(acc[i], a, b, acc[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMF2; ++i) {
      const int m = sp2.grp + i * sp2.groups;
      if (m < kMF2) {
        wmma::store_matrix_sync(sc0, acc[i], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = m * 16 + (e >> 4);   // flat row: halo row 1 + r / kHW
          const int hc = r % kHW;
          if (hc >= 1 && hc <= kTW) {
            const int p = (r / kHW) * kTW + hc - 1;
            const int col = n0 + sp2.nf * 16 + (e & 15);
            const float v = fmaxf(affine(sc0[e], s2[col], b2[col]), 0.0f);
            y2s[p * cm + col] = __float2bfloat16(v);
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // ---- stage 3: 1x1 expand + shortcut + relu ------------------------------
  for (int n0 = 0; n0 < cout; n0 += kNC) {
    const Split sp3(min(kNC, cout - n0), warp);
    FragC acc[kMF3];
    FragC accp[kMF3];
#pragma unroll
    for (int i = 0; i < kMF3; ++i) {
      wmma::fill_fragment(acc[i], 0.0f);
      wmma::fill_fragment(accp[i], 0.0f);
    }
    if (sp3.active) {
      for (int k = 0; k < cm; k += 16) {
        FragB b;
        wmma::load_matrix_sync(
            b, w2 + static_cast<long long>(k) * cout + n0 + sp3.nf * 16, cout);
#pragma unroll
        for (int i = 0; i < kMF3; ++i) {
          const int m = sp3.grp + i * sp3.groups;
          if (m < kMF3) {
            FragA a;
            wmma::load_matrix_sync(a, y2s + m * 16 * cm + k, cm);
            wmma::mma_sync(acc[i], a, b, acc[i]);
          }
        }
      }
    }
    if (wp != nullptr) {
      for (int k0 = 0; k0 < cin; k0 += kKC) {
        __syncthreads();
        for (int e = tid; e < kP * (kKC / 8); e += kThreads) {
          const int r = e / (kKC / 8);
          const int v = e % (kKC / 8);
          const int oy = ty0 + r / kTW;
          const int ox = tx0 + r % kTW;
          uint4 val = make_uint4(0, 0, 0, 0);
          if (oy < h && ox < w) {
            val = *reinterpret_cast<const uint4*>(
                x + (img_px + static_cast<long long>(oy) * w + ox) * cin + k0 +
                v * 8);
          }
          *reinterpret_cast<uint4*>(xs + r * kKC + v * 8) = val;
        }
        __syncthreads();
        if (sp3.active) {
#pragma unroll
          for (int kk = 0; kk < kKC; kk += 16) {
            FragB b;
            wmma::load_matrix_sync(
                b,
                wp + static_cast<long long>(k0 + kk) * cout + n0 +
                    sp3.nf * 16,
                cout);
#pragma unroll
            for (int i = 0; i < kMF3; ++i) {
              const int m = sp3.grp + i * sp3.groups;
              if (m < kMF3) {
                FragA a;
                wmma::load_matrix_sync(a, xs + m * 16 * kKC + kk, kKC);
                wmma::mma_sync(accp[i], a, b, accp[i]);
              }
            }
          }
        }
      }
    }
    if (!sp3.active) continue;
#pragma unroll
    for (int i = 0; i < kMF3; ++i) {
      const int m = sp3.grp + i * sp3.groups;
      if (m < kMF3) {
        wmma::store_matrix_sync(sc0, acc[i], 16, wmma::mem_row_major);
        if (wp != nullptr) {
          wmma::store_matrix_sync(sc1, accp[i], 16, wmma::mem_row_major);
        }
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = m * 16 + (e >> 4);
          const int oy = ty0 + r / kTW;
          const int ox = tx0 + r % kTW;
          if (oy < h && ox < w) {
            const int col = n0 + sp3.nf * 16 + (e & 15);
            const long long px = img_px + static_cast<long long>(oy) * w + ox;
            const float y3 = affine(sc0[e], s3[col], b3[col]);
            const float sc = wp != nullptr
                                 ? affine(sc1[e], sp[col], bp[col])
                                 : __bfloat162float(x[px * cin + col]);
            out[px * cout + col] =
                __float2bfloat16(fmaxf(__fadd_rn(y3, sc), 0.0f));
          }
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace

// x (n, h, w, cin) and out (n, h, w, cout): bf16 NHWC, contiguous.
// w1 (cin, cm), w3 (9, cm, cm) = HWIO, w2 (cm, cout), wp (cin, cout) or
// null for the identity shortcut: bf16.  s*/b*: f32 folded BN.  Returns
// cudaGetLastError() after the launch.  The wrapper (ops/resblock.py) holds
// the limits (cin % 32, cm % 16, cout % 16, cm <= 576, identity needs
// cin == cout) and raises first; the check here only keeps a bad call from
// reading out of bounds.
extern "C" int alink_bottleneck(const void* x, int n, int h, int w, int cin,
                                int cm, int cout, const void* w1,
                                const void* s1, const void* b1, const void* w3,
                                const void* s2, const void* b2, const void* w2,
                                const void* s3, const void* b3, const void* wp,
                                const void* sp, const void* bp, void* out,
                                void* stream) {
  const size_t smem = smem_bytes(cm);
  if (n < 0 || h <= 0 || w <= 0 || cin % kKC || cm % 16 || cout % 16 ||
      cin <= 0 || cm <= 0 || cout <= 0 || smem > kMaxSmem ||
      (wp == nullptr && cin != cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_x = (w + kTW - 1) / kTW;
  const int tiles_per_img = tiles_x * ((h + kTH - 1) / kTH);
  const long long blocks = static_cast<long long>(n) * tiles_per_img;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (smem > 48 * 1024) {
    cudaError_t st = cudaFuncSetAttribute(
        bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (st != cudaSuccess) return static_cast<int>(st);
  }
  bottleneck_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), h, w, cin, cm, cout, tiles_x,
      tiles_per_img, static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w3), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(s3), static_cast<const float*>(b3),
      static_cast<const __nv_bfloat16*>(wp), static_cast<const float*>(sp),
      static_cast<const float*>(bp), static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
