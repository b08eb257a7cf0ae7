// The attention core of insightface's ViT face embedder,
// softmax(q k^T d^-1/2) v for every (face, head) of a block in one launch,
// float32-accurate on bf16 tensor cores, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no ViT (the port's
// models/vit.py has no JAX counterpart).  It takes the place of four
// library passes a block: three strided float32 upcasts of q, k and v,
// PyTorch's float32 memory-efficient attention (3xTF32 products) and the
// copy that merged the heads.
//
// Why bf16 tensor cores give the float32 result.  q, k and v are the qkv
// product's bf16 outputs, so their float32 upcasts are exact.  The product
// of two bf16 values (8 significant bits each) is exact in float32 (24), so
// S = q k^T by mma.sync on bf16 operands with float32 accumulation is the
// float32 product of the upcast values up to the order of the sums.  Only
// the probabilities are float32 values bf16 cannot hold: each is split as
// P = p1 + p2 + p3, p1 = bf16(P), p2 = bf16(P - p1), p3 = bf16(P - p1 - p2)
// (each residual exact in float32, the last one fits bf16 whole), so the
// three terms carry P's 24 bits and each p_i v is again exact.  The core
// is one bf16 pass for S and three for P v, all accumulated in float32;
// the scale and the softmax are float32 on the CUDA cores: s = S * scale
// rounded to float32 as the reference rounds it, e = exp(s - max), and
// P = e * (1 / sum e) with one correctly rounded reciprocal a row (48
// divisions a thread at the store cost ~15 % of its time on an H100).  No
// TF32 anywhere.
//
// Bound: memory.  A (face, head) problem reads its q, k and v once
// (3 x T x d bf16) and writes its output once (T x d float32).  At ViT-L's
// T 144, d 96, batch 256 and 8 heads a block moves 170 MB in and 113 MB
// out, 84.5 us at 3.35 TB/s, against 8 T^2 d bf16 operations a problem
// (32.6 GFLOP a block, ~33 us at 989 TFLOP/s).  What the design does
// about that:
//   - q, k and v are read where the qkv product left them: strided views
//     of its (N, T, 3, H, d) output, each row d contiguous bf16 values, by
//     16-byte cp.async copies; the output is written in merged-head layout
//     (N, T, H * d) from the accumulators, 32-byte runs of full sectors.
//     No upcast pass and no merge copy;
//   - a problem's q, k and v fit shared memory together (T <= 144:
//     3 x 144 rows of 96 + 8 padding bf16, 89,856 bytes), so the softmax
//     runs over whole rows and nothing is rescaled; the padding puts the
//     eight rows of an ldmatrix phase on distinct banks;
//   - persistent blocks, one an SM (288 threads, registers for the whole
//     score row of 16 queries), walk problems blockIdx.x, + gridDim.x, ...;
//     with two stages in shared memory the next problem's copies are in
//     flight while the current one computes;
//   - a warp owns 16 query rows: S (16 x T) stays in registers; the
//     accumulator layout of two neighbouring n8 tiles is the A operand of
//     the next m16n8k16 product, so P never leaves registers (split there,
//     three A fragments a 16-key step), and V's B fragments come from
//     ldmatrix.trans.  mma.sync rather than wgmma: the tensor work sits
//     under the bytes bound, and 144 rows are nine 16-row warp tiles with
//     no padded 64-row tile;
//   - T up to 256 and d a multiple of 16 up to 128: rows past T are zero
//     in shared memory (zeroed once; the copies never touch them) and their
//     keys are masked to -inf, columns past d are zero.  Two key capacities
//     (9 and 16 tiles of 16) and four widths (32, 64, 96, 128 held) are
//     built; a problem that fits one stage twice takes two stages.
// chip_smoke.py phase q holds it to the plain float32 reference and times
// it against this bound; PERF.md's kernel table keeps the figures.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 9;               // 144 query rows = 9 warp tiles of 16
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSmem = 232448;        // a block's dynamic shared memory
constexpr int kMaxTokens = 256;
constexpr int kMaxWidth = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* src[3];  // q, k, v
  long long stride[3][3];       // [q, k, v][n, h, t], elements
  float* out;                   // (N, T, H * d) float32
  int h, t, d, problems, stages;
  float scale;
};

// A row of DT 16-wide tiles plus 8 bf16 of padding: 32 DT + 16 bytes, so
// the 16-byte chunks of eight consecutive rows fall on distinct banks.
__host__ __device__ constexpr int pitch_bytes(int dt) { return 32 * dt + 16; }
__host__ __device__ constexpr int tile_bytes(int kt, int dt) {
  return 16 * kt * pitch_bytes(dt);
}
__host__ __device__ constexpr int stage_bytes(int kt, int dt) {
  return 3 * tile_bytes(kt, dt);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b for one m16n8k16 tile: bf16 operands, float32 accumulators.
// Registers only: the compiler may schedule it among the fragment loads.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x and y (float32) as three packed bf16 pairs whose sums are x and y:
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each
// difference exact in float32.  The low half of each word holds x's term.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = __fsub_rn(x, hf.x), ry = __fsub_rn(y, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(__fsub_rn(rx, mf.x), __fsub_rn(ry, mf.y)));
}

// Copy problem `prob`'s q, k and v rows (t rows of d bf16 each) into the
// stage at shared address `stage` as one cp.async group.
template <int KT, int DT>
__device__ __forceinline__ void load_problem(const Params& p, int prob,
                                             uint32_t stage, int tid) {
  constexpr int kChunks = 2 * DT;  // 16-byte chunks of a held row
  constexpr int kPitch = pitch_bytes(DT);
  const int ni = prob / p.h, hi = prob - ni * p.h;
  const int real = p.d / 8, per = p.t * kChunks;
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    const __nv_bfloat16* base =
        p.src[w] + ni * p.stride[w][0] + hi * p.stride[w][1];
    const uint32_t dst = stage + w * tile_bytes(KT, DT);
    for (int i = tid; i < per; i += kThreads) {
      const int row = i / kChunks, c = i - row * kChunks;
      if (c < real) {
        cp_async16(dst + row * kPitch + c * 16,
                   base + row * p.stride[w][2] + c * 8);
      }
    }
  }
  cp_async_commit();
}

// Query rows 16 rt .. 16 rt + 15 of problem `prob`, from the stage at
// `stage`, by one warp.  Fragment layouts (PTX m16n8k16, g = lane / 4,
// c = lane % 4): A holds rows g and g + 8 at columns 2c, 2c + 1 (+ 8); B
// columns g at rows 2c, 2c + 1 (+ 8); the accumulator rows g and g + 8 at
// columns 2c, 2c + 1.
template <int KT, int DT>
__device__ __forceinline__ void core_rows(const Params& p, int prob,
                                          uint32_t stage, int rt, int lane) {
  constexpr int kPitch = pitch_bytes(DT);
  const uint32_t qs = stage, ks = stage + tile_bytes(KT, DT),
                 vs = stage + 2 * tile_bytes(KT, DT);
  const int g = lane >> 2, c = lane & 3;

  // S = q k^T: for each 16-deep slice of d, one A fragment of q and, per
  // 16 keys, one x4 load of k giving the B fragments of two n8 tiles.
  float s[2 * KT][4];
#pragma unroll
  for (int i = 0; i < 2 * KT; ++i) {
    s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    uint32_t a[4];
    ldsm_x4(qs + (rt * 16 + (lane & 15)) * kPitch + kk * 32 + (lane >> 4) * 16,
            a);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      uint32_t b[4];
      ldsm_x4(ks + (j * 16 + (lane >> 4) * 8 + (lane & 7)) * kPitch +
                  kk * 32 + ((lane >> 3) & 1) * 16,
              b);
      mma_bf16(s[2 * j], a, b);
      mma_bf16(s[2 * j + 1], a, b + 2);
    }
  }

  // The softmax over whole rows: s = S * scale (float32), keys past t at
  // -inf, e = exp(s - max), P = e * (1 / sum e); the row's max and sum
  // across the quad that holds it.
#pragma unroll
  for (int i = 0; i < 2 * KT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = __fmul_rn(s[i][e], p.scale);
  }
  if (p.t < 16 * KT) {
#pragma unroll
    for (int i = 0; i < 2 * KT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i * 8 + 2 * c + (e & 1) >= p.t) s[i][e] = -INFINITY;
      }
    }
  }
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 2 * KT; ++i) {
    m0 = fmaxf(m0, fmaxf(s[i][0], s[i][1]));
    m1 = fmaxf(m1, fmaxf(s[i][2], s[i][3]));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int i = 0; i < 2 * KT; ++i) {
    s[i][0] = exp2f(__fmul_rn(__fsub_rn(s[i][0], m0), kLog2e));
    s[i][1] = exp2f(__fmul_rn(__fsub_rn(s[i][1], m0), kLog2e));
    s[i][2] = exp2f(__fmul_rn(__fsub_rn(s[i][2], m1), kLog2e));
    s[i][3] = exp2f(__fmul_rn(__fsub_rn(s[i][3], m1), kLog2e));
    l0 += s[i][0] + s[i][1];
    l1 += s[i][2] + s[i][3];
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);

  // P v: per 16 keys, the probabilities of n8 tiles 2j and 2j + 1 are the
  // A fragment; split in three bf16 terms, each against every B fragment
  // of v (ldmatrix.trans: v's rows are keys), all into one accumulator.
  float acc[2 * DT][4];
#pragma unroll
  for (int i = 0; i < 2 * DT; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    uint32_t terms[3][4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      // Fragment word f: tile 2j + f / 2, row g (f even) or g + 8.
      const float* e = s[2 * j + f / 2] + 2 * (f & 1);
      const float r = f & 1 ? r1 : r0;
      split3(__fmul_rn(e[0], r), __fmul_rn(e[1], r), terms[0][f],
             terms[1][f], terms[2][f]);
    }
    uint32_t b[DT][4];
#pragma unroll
    for (int nd = 0; nd < DT; ++nd) {
      ldsm_x4_trans(vs + (j * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kPitch +
                        nd * 32 + (lane >> 4) * 16,
                    b[nd]);
    }
#pragma unroll
    for (int term = 0; term < 3; ++term) {
#pragma unroll
      for (int nd = 0; nd < DT; ++nd) {
        mma_bf16(acc[2 * nd], terms[term], b[nd]);
        mma_bf16(acc[2 * nd + 1], terms[term], b[nd] + 2);
      }
    }
  }

  // out[n, row, h * d + col] = acc, float32, rows below t and columns
  // below d only.
  const int ni = prob / p.h, hi = prob - ni * p.h;
  const int row0 = rt * 16 + g, row1 = row0 + 8;
  const long long width = static_cast<long long>(p.h) * p.d;
  float* out0 = p.out + (static_cast<long long>(ni) * p.t + row0) * width +
                static_cast<long long>(hi) * p.d + 2 * c;
  float* out1 = out0 + 8 * width;
#pragma unroll
  for (int i = 0; i < 2 * DT; ++i) {
    if (i * 8 < p.d) {
      if (row0 < p.t) {
        *reinterpret_cast<float2*>(out0 + i * 8) =
            make_float2(acc[i][0], acc[i][1]);
      }
      if (row1 < p.t) {
        *reinterpret_cast<float2*>(out1 + i * 8) =
            make_float2(acc[i][2], acc[i][3]);
      }
    }
  }
}

// KT: 16-key tiles held (t <= 16 KT); DT: 16-wide tiles of d held
// (d <= 16 DT).  One block an SM walks problems blockIdx.x, + gridDim.x,
// ...; with two stages the next problem loads while this one computes.
template <int KT, int DT>
__global__ void __launch_bounds__(kThreads, 1)
    attention_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kStage = stage_bytes(KT, DT);
  // Rows past t and columns past d stay zero: no copy writes them.
  for (int i = tid * 16; i < p.stages * kStage; i += kThreads * 16) {
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  const uint32_t base = smem_u32(smem);
  int prob = blockIdx.x;
  load_problem<KT, DT>(p, prob, base, tid);
  for (int it = 0; prob < p.problems; ++it, prob += gridDim.x) {
    const int next = prob + gridDim.x;
    const uint32_t stage = base + (p.stages == 2 ? (it & 1) : 0) * kStage;
    if (p.stages == 2 && next < p.problems) {
      load_problem<KT, DT>(p, next, base + ((it + 1) & 1) * kStage, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int rt = warp; rt * 16 < p.t; rt += kWarps) {
      core_rows<KT, DT>(p, prob, stage, rt, lane);
    }
    __syncthreads();  // the stage is read: it may be loaded again
    if (p.stages == 1 && next < p.problems) {
      load_problem<KT, DT>(p, next, base, tid);
    }
  }
}

template <int KT, int DT>
cudaError_t launch(Params p, int grid, cudaStream_t stream) {
  constexpr int kStage = stage_bytes(KT, DT);
  p.stages = 2 * kStage <= kMaxSmem ? 2 : 1;
  const int smem = p.stages * kStage;
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<KT, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  attention_kernel<KT, DT><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int KT>
cudaError_t by_width(const Params& p, int grid, cudaStream_t stream) {
  switch ((p.d + 31) / 32) {
    case 1:
      return launch<KT, 2>(p, grid, stream);
    case 2:
      return launch<KT, 4>(p, grid, stream);
    case 3:
      return launch<KT, 6>(p, grid, stream);
    default:
      return launch<KT, 8>(p, grid, stream);
  }
}

}  // namespace

// q, k, v: bf16 (N, H, T, d) with unit stride along d and the given
// strides (elements) along N, H and T, each a multiple of 8 and each
// pointer 16-byte aligned (the views of the qkv product's (N, T, 3, H, d)
// output qualify); out: (N, T, H * d) float32, contiguous.  1 <= T <= 256,
// d a multiple of 16 up to 128; grid: persistent blocks, at most N * H.
extern "C" int alink_attention(const void* q, const void* k, const void* v,
                               void* out, int n, int h, int t, int d,
                               int sqn, int sqh, int sqt, int skn, int skh,
                               int skt, int svn, int svh, int svt,
                               float scale, int grid, void* stream) {
  const int strides[9] = {sqn, sqh, sqt, skn, skh, skt, svn, svh, svt};
  bool bad = !q || !k || !v || !out || n < 0 || h < 1 || t < 1 ||
             t > kMaxTokens || d < 16 || d > kMaxWidth || d % 16 ||
             static_cast<long long>(n) * h > (1LL << 30);
  for (int i = 0; i < 9; ++i) bad = bad || strides[i] < 0 || strides[i] % 8;
  const void* ptrs[4] = {q, k, v, out};
  for (int i = 0; i < 4; ++i) {
    bad = bad || reinterpret_cast<uintptr_t>(ptrs[i]) % 16;
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (grid < 1 || grid > n * h) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.src[0] = static_cast<const __nv_bfloat16*>(q);
  p.src[1] = static_cast<const __nv_bfloat16*>(k);
  p.src[2] = static_cast<const __nv_bfloat16*>(v);
  for (int w = 0; w < 3; ++w) {
    for (int a = 0; a < 3; ++a) p.stride[w][a] = strides[3 * w + a];
  }
  p.out = static_cast<float*>(out);
  p.h = h;
  p.t = t;
  p.d = d;
  p.problems = n * h;
  p.stages = 1;
  p.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = t <= 144 ? by_width<9>(p, grid, st)
                                 : by_width<16>(p, grid, st);
  return static_cast<int>(e);
}

// ---------------------------------------------------------------------------
// The windowed core of the Swin face embedder (models/swin.py): for every
// 7 x 7 window and head of a block, in one launch,
//   softmax(q k^T 32^-1/2 + B + M) v,
// with B the head's learned relative position bias, B[i, j] =
// table[(dy + 6) 13 + (dx + 6), h] for the offset (dy, dx) of token i from
// token j inside the window, and M the shifted blocks' -100 between tokens
// whose regions of the shifted frame differ (Swin, arXiv:2103.14030).
//
// Replaces no TPU kernel: the JAX package has no Swin.  It takes the place
// of the published sequence a block: torch.roll, the window partition copy,
// two batched products with a float32 score tensor (49 x 49 a window and
// head: 1.9 GB at stage 1 and 1,024 chips), the bias gather and add, the
// mask add, the softmax, the reverse partition and the reverse roll.
//
// Arithmetic, as Swin runs under autocast with bf16 for fp16: q, k and v are
// the qkv product's bf16 outputs; S = q k^T on bf16 tensor cores with
// float32 sums (exact products), then s = S * scale + B (+ M) in float32,
// e = exp(s - max), P = e * (1 / sum e) in float32; P enters P v rounded to
// bf16, as autocast's matmul takes it, with float32 sums; the output is
// rounded to bf16, the dtype proj takes.
//
// Bound: memory.  A block of the model reads q, k and v (6 C bytes a
// token) and writes the output (2 C bytes a token) against 4 x 49 x C
// operations a token: 49 operations a byte, far under the card's 295.
// What the design does about that:
//   - the shift and the window partition are folded into the addressing:
//     a thread block takes one window of one image and a group of up to
//     four heads, and copies each token's q, k and v rows for those heads
//     (64 contiguous bytes a head and part) from wherever the qkv product
//     left them in grid order, by 16-byte cp.async copies, into rows of 80
//     bytes (32 bf16 + 8 padding: the eight rows of an ldmatrix phase on
//     distinct banks); the output goes back through shared memory, the
//     reverse shift folded into the stores, 64 contiguous bytes a head;
//   - no score tensor: a warp owns 16 query rows of a head; S (16 x 64)
//     stays in registers, the bias and the mask are added there (the bias
//     column of the group's heads in shared memory, its index and the
//     regions from the tokens' coordinates), and the accumulator layout of
//     two n8 tiles is the A operand of the next m16n8k16 product, so P
//     never leaves registers;
//   - the window's 49 tokens pad to 64 rows (4 warp tiles); rows past 49
//     are zero in shared memory and their keys are set to -inf;
//   - 4 warps a block and 46-63 KB of shared memory, so 3-4 blocks an SM
//     keep ~110 KB of copies in flight while other blocks compute.
// chip_smoke.py phase s holds it to the plain float32 roll-partition path
// and times it against this bound; PERF.md's kernel table keeps the
// figures.

namespace {

constexpr int kWinWarps = 4;
constexpr int kWinThreads = 32 * kWinWarps;
constexpr int kWinRows = 64;          // 4 warp tiles of 16 rows
constexpr int kWinHead = 32;          // a head's width
constexpr int kWinPitch = 80;         // bytes: 32 bf16 + 8 padding a row
constexpr int kWinTile = kWinRows * kWinPitch;
constexpr int kWinMaxGroup = 4;

struct WinParams {
  const __nv_bfloat16* qkv;  // (N, S, S, 3, H, 32) bf16
  const float* table;        // ((2W - 1)^2, H) float32
  __nv_bfloat16* out;        // (N, S, S, H * 32) bf16
  int s, shift, h, group, groups, side;  // side: windows along an axis
  float scale;
};

// The region of a shifted-frame row or column inside its window's axis
// (0, S - W), (S - W, S - shift), (S - shift, S): only the last window
// along an axis holds more than one.
template <int W>
__device__ __forceinline__ int region(int win, int local, const WinParams& p) {
  return win < p.side - 1 ? 0 : (local < W - p.shift ? 1 : 2);
}

template <int W>
__global__ void __launch_bounds__(kWinThreads)
    window_attention_kernel(const WinParams p) {
  constexpr int T = W * W;
  constexpr int R = 2 * W - 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int b = blockIdx.x;
  const int grp = b % p.groups;
  b /= p.groups;
  const int wx = b % p.side;
  b /= p.side;
  const int wy = b % p.side;
  const long long n = b / p.side;
  const int h0 = grp * p.group;
  const int width = p.h * kWinHead;        // C
  const uint32_t base = smem_u32(smem);
  // Tiles [part][head of the group], then the group's bias columns.
  float* bias = reinterpret_cast<float*>(smem + 3 * p.group * kWinTile);

  // Copies: per token, per part (q, k, v), per head, four 16-byte chunks;
  // consecutive threads take consecutive chunks of a token's part.
  const int per_token = 3 * p.group * 4;
  for (int k = tid; k < T * per_token; k += kWinThreads) {
    const int i = k / per_token;
    const int rest = k - i * per_token;
    const int part = rest / (4 * p.group);
    const int hc = rest - part * 4 * p.group;   // head * 4 + chunk
    const int ly = i / W, lx = i - ly * W;
    int y = wy * W + ly + p.shift, x = wx * W + lx + p.shift;
    if (y >= p.s) y -= p.s;
    if (x >= p.s) x -= p.s;
    const __nv_bfloat16* src =
        p.qkv + ((n * p.s + y) * p.s + x) * 3 * width + part * width +
        h0 * kWinHead + hc * 8;
    cp_async16(base + (part * p.group + (hc >> 2)) * kWinTile +
                   i * kWinPitch + (hc & 3) * 16,
               src);
  }
  cp_async_commit();
  // Rows past T stay zero: their keys are masked, their values meet P = 0.
  constexpr int kPad = (kWinRows - T) * kWinPitch / 16;
  for (int k = tid; k < 3 * p.group * kPad; k += kWinThreads) {
    const int tile = k / kPad;
    *reinterpret_cast<uint4*>(smem + tile * kWinTile + T * kWinPitch +
                              (k - tile * kPad) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  for (int k = tid; k < p.group * R * R; k += kWinThreads) {
    const int hh = k / (R * R), r = k - hh * R * R;
    bias[k] = p.table[r * p.h + h0 + hh];
  }
  cp_async_wait<0>();
  __syncthreads();

  const int rt = warp;                      // query rows 16 rt .. 16 rt + 15
  if (rt * 16 < T) {
    const int g = lane >> 2, c = lane & 3;
    // Rows past T compute on row T - 1's coordinates; they are dropped.
    const int i0 = min(rt * 16 + g, T - 1), i1 = min(rt * 16 + g + 8, T - 1);
    // The bias index is a(i) - b(j): a(i) = R yi + xi + (W - 1)(R + 1),
    // b(j) = R yj + xj.
    const int a0 = R * (i0 / W) + i0 % W + (W - 1) * (R + 1);
    const int a1 = R * (i1 / W) + i1 % W + (W - 1) * (R + 1);
    const bool masked = p.shift > 0;
    const int l0 = 3 * region<W>(wy, i0 / W, p) + region<W>(wx, i0 % W, p);
    const int l1 = 3 * region<W>(wy, i1 / W, p) + region<W>(wx, i1 % W, p);
    for (int hh = 0; hh < p.group; ++hh) {
      const uint32_t qs = base + hh * kWinTile;
      const uint32_t ks = base + (p.group + hh) * kWinTile;
      const uint32_t vs = base + (2 * p.group + hh) * kWinTile;
      const float* bh = bias + hh * R * R;

      float s[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[4];
        ldsm_x4(qs + (rt * 16 + (lane & 15)) * kWinPitch + kk * 32 +
                    (lane >> 4) * 16,
                a);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bk[4];
          ldsm_x4(ks + (j * 16 + (lane >> 4) * 8 + (lane & 7)) * kWinPitch +
                      kk * 32 + ((lane >> 3) & 1) * 16,
                  bk);
          mma_bf16(s[2 * j], a, bk);
          mma_bf16(s[2 * j + 1], a, bk + 2);
        }
      }

      // s = S * scale + B (+ M), keys past T at -inf; then the softmax
      // over the row, its max and sum across the quad that holds it.
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = t * 8 + 2 * c + (e & 1);
          if (j >= T) {
            s[t][e] = -INFINITY;
          } else {
            const int yj = j / W, xj = j - (j / W) * W;
            float v = __fadd_rn(__fmul_rn(s[t][e], p.scale),
                                bh[(e < 2 ? a0 : a1) - (R * yj + xj)]);
            if (masked && (e < 2 ? l0 : l1) !=
                              3 * region<W>(wy, yj, p) + region<W>(wx, xj, p)) {
              v = __fadd_rn(v, -100.f);
            }
            s[t][e] = v;
          }
        }
      }
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        m0 = fmaxf(m0, fmaxf(s[t][0], s[t][1]));
        m1 = fmaxf(m1, fmaxf(s[t][2], s[t][3]));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
      }
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        s[t][0] = exp2f(__fmul_rn(__fsub_rn(s[t][0], m0), kLog2e));
        s[t][1] = exp2f(__fmul_rn(__fsub_rn(s[t][1], m0), kLog2e));
        s[t][2] = exp2f(__fmul_rn(__fsub_rn(s[t][2], m1), kLog2e));
        s[t][3] = exp2f(__fmul_rn(__fsub_rn(s[t][3], m1), kLog2e));
        sum0 += s[t][0] + s[t][1];
        sum1 += s[t][2] + s[t][3];
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
      }
      const float r0 = __frcp_rn(sum0), r1 = __frcp_rn(sum1);

      // P v: per 16 keys, the bf16 probabilities of n8 tiles 2j and 2j + 1
      // are the A fragment; v's B fragments by ldmatrix.trans.
      float acc[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t pa[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          // Fragment word f: tile 2j + f / 2, row g (f even) or g + 8.
          const float* e = s[2 * j + f / 2] + 2 * (f & 1);
          const float r = f & 1 ? r1 : r0;
          pa[f] = bits(__floats2bfloat162_rn(__fmul_rn(e[0], r),
                                             __fmul_rn(e[1], r)));
        }
#pragma unroll
        for (int nd = 0; nd < 2; ++nd) {
          uint32_t bv[4];
          ldsm_x4_trans(vs + (j * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                 kWinPitch +
                            nd * 32 + (lane >> 4) * 16,
                        bv);
          mma_bf16(acc[2 * nd], pa, bv);
          mma_bf16(acc[2 * nd + 1], pa, bv + 2);
        }
      }

      // The output in bf16 over this warp's own q rows (read only by it).
      __syncwarp();
      unsigned char* o0 = smem + hh * kWinTile + (rt * 16 + g) * kWinPitch;
      unsigned char* o1 = o0 + 8 * kWinPitch;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        *reinterpret_cast<__nv_bfloat162*>(o0 + (t * 8 + 2 * c) * 2) =
            __floats2bfloat162_rn(acc[t][0], acc[t][1]);
        *reinterpret_cast<__nv_bfloat162*>(o1 + (t * 8 + 2 * c) * 2) =
            __floats2bfloat162_rn(acc[t][2], acc[t][3]);
      }
    }
  }
  __syncthreads();

  // Stores: each token's heads of the group back to its grid position.
  const int out_token = p.group * 4;
  for (int k = tid; k < T * out_token; k += kWinThreads) {
    const int i = k / out_token;
    const int hc = k - i * out_token;
    const int ly = i / W, lx = i - ly * W;
    int y = wy * W + ly + p.shift, x = wx * W + lx + p.shift;
    if (y >= p.s) y -= p.s;
    if (x >= p.s) x -= p.s;
    *reinterpret_cast<uint4*>(p.out + ((n * p.s + y) * p.s + x) * width +
                              h0 * kWinHead + hc * 8) =
        *reinterpret_cast<const uint4*>(smem + (hc >> 2) * kWinTile +
                                        i * kWinPitch + (hc & 3) * 16);
  }
}

}  // namespace

// qkv: bf16 (N, S, S, 3 * H * 32), contiguous (the qkv Linear's output in
// grid order, each token's row (3, H, 32)); table: float32 ((2W - 1)^2, H),
// contiguous; out: bf16 (N, S, S, H * 32), contiguous.  W 7, S a multiple
// of W, 0 <= shift < W, group (heads a thread block) 1 to 4 dividing H;
// qkv and out 16-byte aligned.
extern "C" int alink_window_attention(const void* qkv, const void* table,
                                      void* out, int n, int s, int h,
                                      int window, int shift, int group,
                                      float scale, void* stream) {
  const long long blocks =
      static_cast<long long>(n) * (s / 7) * (s / 7) * (group > 0 ? h / group : 0);
  const bool bad =
      !qkv || !table || !out || n < 0 || window != 7 || s < 7 || s % 7 ||
      shift < 0 || shift >= window || h < 1 || group < 1 ||
      group > kWinMaxGroup || h % group ||
      reinterpret_cast<uintptr_t>(qkv) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(table) % 4 || blocks >= (1LL << 31);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  WinParams p;
  p.qkv = static_cast<const __nv_bfloat16*>(qkv);
  p.table = static_cast<const float*>(table);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.s = s;
  p.shift = shift;
  p.h = h;
  p.group = group;
  p.groups = h / group;
  p.side = s / 7;
  p.scale = scale;
  const int smem = 3 * group * kWinTile + group * 13 * 13 * 4;
  cudaError_t e = cudaFuncSetAttribute(
      window_attention_kernel<7>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  window_attention_kernel<7><<<static_cast<unsigned>(blocks), kWinThreads,
                               smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
