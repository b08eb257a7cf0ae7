// Int8 3x3 stride-1 SAME convolution on the flat layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel alink_tpu/ops/qconv.py:_conv_kernel (reached
// through conv3x3_s1_int8_flat / conv3x3_s1_int8).  Flat layout (see
// ops/qconv.py): input row lead + i * r + (y + 1) * wp + (x + 1) holds pixel
// (y, x) of image i, every other row is 0, and a 3x3 tap (dy, dx) is a shift
// of the rows by (dy - 1) * wp + (dx - 1).  For headless output row q
//   acc[q, n] = sum_{tap, k} x[q + lead - wp - 1 + dy * wp + dx, k]
//                            * w[tap, k, n]                    (int32)
//   z = (float)acc * scale[n] + bias[n]     (rounded multiply, rounded add)
//   affine:      out = z                    (f32, or bf16 round to nearest)
//   prelu_quant: d = z >= 0 ? z : alpha[n] * z;
//                out = clip(rint(d * qscale[n]), -127, 127)   (int8)
// and out = 0 on every row that is not a pixel (the next conv reads those
// rows as its zero padding).
//
// Bound: the tensor cores at the shapes of LResNet100E-II's stages
// (2 * 9 * Cin * Cout operations per output row against Cin + Cout * size
// bytes of activations), the bytes below Cin = Cout = 64.  The design:
//   - a block owns 64 output rows x 64 output channels, 4 warps of 32 x 32;
//   - for each chunk of 64 input channels it stages in shared memory the
//     input row window [q0 + lead - wp - 1, q0 + 64 + lead + wp + 1) that
//     the tile's taps read, and the 9 taps' 64 x 64 weights; rows past the
//     end of x read as 0;
//   - the 3x3 runs as 9 row-shifted products over that window with
//     mma.sync m16n8k32 s8.s8.s32 (the TPU kernel's shifted-slice trick:
//     a shift is a row offset of the A fragments), accumulating in int32
//     registers; no im2col reaches device memory;
//   - the fragments are loaded 4 bytes at a time, so a shift of one row
//     needs only 4-byte alignment; rows are 80 bytes apart in shared memory
//     (64 + 16), which keeps the 8 rows x 4 threads of a fragment load on 32
//     different banks.
// cp.async/TMA staging, wgmma and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 64;                  // output rows per block
constexpr int kTN = 64;                  // output channels per block
constexpr int kKC = 64;                  // input channels per staged chunk
constexpr int kLd = kKC + 16;            // shared row stride in bytes
constexpr int kThreads = 128;            // 4 warps: 2 (rows) x 2 (channels)
constexpr int kMaxSmem = 232448;         // per block on H100

size_t smem_bytes(int wp) {
  const size_t win = kTM + 2 * static_cast<size_t>(wp) + 2;
  return (win + 9 * static_cast<size_t>(kTN)) * kLd;
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
qconv_kernel(const int8_t* __restrict__ x, long long x_rows,
             const int8_t* __restrict__ wt, const float* __restrict__ scale,
             const float* __restrict__ bias, const float* __restrict__ alpha,
             const float* __restrict__ qscale, void* __restrict__ out,
             long long out_rows, int cin, int cout, int lead, int wp, int r,
             int h, int w, int mode) {
  extern __shared__ __align__(16) int8_t smem[];
  const int win = kTM + 2 * wp + 2;
  int8_t* xs = smem;                       // win rows x kLd
  int8_t* ws = smem + win * kLd;           // 9 taps x kTN rows x kLd

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;                 // fragment row / column group
  const int t = lane & 3;                  // thread in group
  const int wm = (warp >> 1) * 32;         // warp's first row in the tile
  const int wn = (warp & 1) * 32;          // warp's first channel
  const long long q0 = static_cast<long long>(blockIdx.x) * kTM;
  const int n0 = blockIdx.y * kTN;
  const long long s0 = q0 + lead - wp - 1; // input row of window row 0

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < cin; k0 += kKC) {
    __syncthreads();
    for (int e = tid; e < win * (kKC / 16); e += kThreads) {
      const int row = e / (kKC / 16);
      const int v = e % (kKC / 16);
      const long long src = s0 + row;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (src < x_rows) {
        val = *reinterpret_cast<const uint4*>(x + src * cin + k0 + v * 16);
      }
      *reinterpret_cast<uint4*>(xs + row * kLd + v * 16) = val;
    }
    for (int e = tid; e < 9 * kTN * (kKC / 16); e += kThreads) {
      const int row = e / (kKC / 16);      // tap * kTN + channel
      const int v = e % (kKC / 16);
      const int tap = row / kTN;
      const int n = row % kTN;
      *reinterpret_cast<uint4*>(ws + row * kLd + v * 16) =
          *reinterpret_cast<const uint4*>(
              wt + (static_cast<long long>(tap) * cout + n0 + n) * cin + k0 +
              v * 16);
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * wp + tap % 3;
      const int8_t* wtap = ws + tap * kTN * kLd;
#pragma unroll
      for (int ks = 0; ks < kKC; ks += 32) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int8_t* pa = xs + (shift + wm + i * 16 + g) * kLd + ks + t * 4;
          a[i][0] = ld32(pa);
          a[i][1] = ld32(pa + 8 * kLd);
          a[i][2] = ld32(pa + 16);
          a[i][3] = ld32(pa + 8 * kLd + 16);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int8_t* pb = wtap + (wn + j * 8 + g) * kLd + ks + t * 4;
          const uint32_t b0 = ld32(pb);
          const uint32_t b1 = ld32(pb + 16);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_s8(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b0, b1);
          }
        }
      }
    }
  }

  // Epilogue: c0, c1 at fragment row g, channels 2t and 2t + 1; c2, c3 at
  // row g + 8.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long q = q0 + wm + i * 16 + g + half * 8;
      if (q >= out_rows) continue;
      const int rp = static_cast<int>(q % r);
      const int col = rp % wp;
      const bool valid = col >= 1 && col <= w && rp >= wp && rp < (h + 1) * wp;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + 2 * t + e;
          const float z = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[i][j][half * 2 + e]), scale[n]),
              bias[n]);
          const long long o = q * cout + n;
          if (mode == 0) {
            static_cast<float*>(out)[o] = valid ? z : 0.0f;
          } else if (mode == 1) {
            static_cast<__nv_bfloat16*>(out)[o] =
                __float2bfloat16_rn(valid ? z : 0.0f);
          } else {
            const float d = z >= 0.0f ? z : __fmul_rn(alpha[n], z);
            const float qv =
                fminf(fmaxf(rintf(__fmul_rn(d, qscale[n])), -127.0f), 127.0f);
            static_cast<int8_t*>(out)[o] =
                valid ? static_cast<int8_t>(qv) : static_cast<int8_t>(0);
          }
        }
      }
    }
  }
}

}  // namespace

// x (x_rows, cin) int8 flat rows (lead band included); wt (9, cout, cin)
// int8, tap = dy * 3 + dx, each tap's weights transposed; scale, bias,
// alpha, qscale (cout,) f32; out (out_rows, cout) f32 (mode 0), bf16
// (mode 1) or int8 (mode 2, prelu_quant).  cin and cout are multiples of
// 128 (the wrapper pads).  Returns cudaGetLastError() after the launch.
extern "C" int alink_qconv(const void* x, int x_rows, const void* wt,
                           const void* scale, const void* bias,
                           const void* alpha, const void* qscale, void* out,
                           int out_rows, int cin, int cout, int lead, int wp,
                           int r, int h, int w, int mode, void* stream) {
  const size_t smem = smem_bytes(wp);
  if (x_rows < 0 || out_rows < 0 || cin <= 0 || cout <= 0 || cin % kKC ||
      cout % kTN || wp < w + 2 || lead < wp + 2 || r <= 0 || mode < 0 ||
      mode > 2 || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (out_rows == 0) return static_cast<int>(cudaGetLastError());
  if (smem > 48 * 1024) {
    cudaError_t st = cudaFuncSetAttribute(
        qconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (st != cudaSuccess) return static_cast<int>(st);
  }
  const dim3 grid((out_rows + kTM - 1) / kTM, cout / kTN);
  qconv_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), x_rows, static_cast<const int8_t*>(wt),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(alpha), static_cast<const float*>(qscale), out,
      out_rows, cin, cout, lead, wp, r, h, w, mode);
  return static_cast<int>(cudaGetLastError());
}
