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
// and out = 0 on every row that is not a pixel and in every column past
// Cout (the next conv reads those rows as its zero padding).
//
// Bound: the tensor cores at 28^2-14^2 (2 * 9 * Cin * Cout operations per
// pixel against Cin + Cout * size bytes), the bytes at 56^2 (Cin = Cout =
// 64, whose output is padded to 128 columns) and the operations of the
// pixel rows only at 7^2, where 69 % of the flat rows are halo.  The design:
//   - M runs over pixels, not flat rows: a tile is 128 consecutive pixels
//     (image-major), so no halo or pad-column row is ever multiplied.  Each
//     lane hands ldmatrix the address of its own pixel's row, shifted by
//     the tap: the TPU kernel's shifted-slice trick with a gather, which
//     ldmatrix allows at any 16-byte aligned row (a wgmma shared-memory
//     descriptor does not);
//   - a tile's input window (the flat rows its pixels' taps reach) and,
//     unless all of the block's weights stay in shared memory, the 9 taps'
//     weights for one 32-channel chunk form one stage of a 2- to 6-deep
//     ring on full/empty mbarriers.  One producer warp fills it: the window
//     by TMA tensor copies of up to 256 rows x 32 bytes (x is a 2-D tensor
//     map; rows past its end arrive as zeros), the weights by one bulk
//     copy.  The two consumer warpgroups only wait, multiply and store, so
//     loads run ahead of the products and under each tile's epilogue;
//   - the products are wgmma m64nNk32 s8.s8.s32 (N = 128, or 64 when Cout
//     packs to 64: Cout = 64 runs as N = 64 and Cin = 64 as K = 64) by two
//     warpgroups of 64 pixels: A (the gathered, shifted input rows) goes
//     from ldmatrix into registers in the mma.sync m16n8k32 A layout that
//     wgmma takes, B (the tap's weights) through a shared-memory
//     descriptor over 8 x 16-byte core matrices; 9 products per chunk are
//     issued back to back and waited for once;
//   - blocks are persistent: block (bx, by) walks tiles bx, bx + gridDim.x,
//     ... of column tile by, so its weights stay hot in L2 and the next
//     tile's first chunks load during this tile's epilogue.  The grid, the
//     ring's depth and the window's TMA boxes come from ops/qconv.py's
//     launch_plan, which the entry point checks;
//   - each tile also zero-fills the non-pixel rows between its first pixel
//     and the next tile's (walking only the runs between image rows), and
//     the last column tile the padded columns, so every output element is
//     written exactly once;
//   - window rows are 32 bytes in shared memory with the two 16-byte halves
//     swapped on every other group of 4 rows (the tensor map's 32-byte
//     swizzle): any 8 consecutive rows hit distinct banks for ldmatrix;
//   - wgmma reads its A registers until a wait retires it, so a chunk's
//     fragments are loaded only after the previous chunk's products are
//     waited for, and kept live until then (keep()).

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                 // pixels per tile
constexpr int kKC = 32;                  // input channels (bytes) per stage
constexpr int kConsumers = 256;          // two warpgroups of 64 pixels each
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxStages = 6;
constexpr int kMaxBoxRows = 256;         // a TMA box's rows at most
constexpr int kMaxSmem = 232448;         // per block on H100

// Ring stages start on 1024-byte boundaries (the 32-byte swizzle repeats
// every 256 bytes of shared address).
__host__ __device__ constexpr int align1024(int b) {
  return (b + 1023) / 1024 * 1024;
}

// Headless flat row of pixel p (image-major, then y, x); 32-bit: the
// entry point refuses layouts of 2^31 rows or more.
__host__ __device__ __forceinline__ int pix_row(int p, int hw, int w, int wp,
                                                int r) {
  const int img = p / hw;
  const int rem = p - img * hw;
  const int y = rem / w;
  return img * r + (y + 1) * wp + (rem - y * w) + 1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// One arrival that also expects `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// TMA tensor copy of the box at (byte column c0, row c1) of `map` (rows
// outside the tensor arrive as zeros), completion counted on `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// TMA bulk copy of `bytes` contiguous bytes, completion counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders the compiler's accesses to an accumulator register after the
// asynchronous products that write it.
__device__ __forceinline__ void fence_reg(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Shared-memory descriptor of a K-major B operand without swizzle: 8-row x
// 16-byte core matrices of 128 contiguous bytes, the two 16-byte halves of
// the 32-byte K chunk 128 bytes apart (leading offset), consecutive 8-row
// groups 256 bytes apart (stride offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// wgmma m64nNk32 s8 x s8 -> s32, A from registers (the mma.sync m16n8k32
// A fragment of each warp's 16 rows), B through a descriptor; d += a * b.
__device__ __forceinline__ void wgmma_n64(int* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Byte offset of 16-byte half `c` of 32-byte row `row` (swizzled).
__device__ __forceinline__ uint32_t swz(int row, int c) {
  return static_cast<uint32_t>(row * 32 + ((c ^ ((row >> 2) & 1)) << 4));
}

// A fragments of the 9 taps of one chunk: each lane's ldmatrix row is its
// pixel's window row shifted by the tap.
__device__ __forceinline__ void load_taps(uint32_t (&a)[9][4], uint32_t sa,
                                          int row_a, int wp, int a_half) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    ldsm_x4(sa + swz(row_a + (tap / 3) * wp + tap % 3, a_half), a[tap][0],
            a[tap][1], a[tap][2], a[tap][3]);
  }
}

// The 9 taps' products of one chunk, back to back: d += a[tap] * B[tap].
template <int BN>
__device__ __forceinline__ void issue_taps(int* acc, const uint32_t (&a)[9][4],
                                           uint32_t sb) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    if constexpr (BN == 128) {
      wgmma_n128(acc, a[tap], b_desc(sb + tap * BN * kKC));
    } else {
      wgmma_n64(acc, a[tap], b_desc(sb + tap * BN * kKC));
    }
  }
}

// wgmma reads its A registers after it is issued, until a wait retires
// it; the compiler knows nothing of that.  Placed after that wait, this
// keeps the registers the fragments' own from their ldmatrix to there.
__device__ __forceinline__ void keep(uint32_t (&a)[9][4]) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    asm volatile("" : "+r"(a[tap][0]), "+r"(a[tap][1]), "+r"(a[tap][2]),
                 "+r"(a[tap][3])::"memory");
  }
}

// 4 x 4 transpose across the 4 lanes of a quad: on entry lane q holds
// v[j] = element (q, j); on exit v[j] = element (j, q).
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
  const bool hi2 = q & 2, hi1 = q & 1;
  uint32_t s0 = hi2 ? v[0] : v[2], s1 = hi2 ? v[1] : v[3];
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (hi2) {
    v[0] = r0;
    v[1] = r1;
  } else {
    v[2] = r0;
    v[3] = r1;
  }
  s0 = hi1 ? v[0] : v[1];
  s1 = hi1 ? v[2] : v[3];
  r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (hi1) {
    v[0] = r0;
    v[2] = r1;
  } else {
    v[1] = r0;
    v[3] = r1;
  }
}

struct Geometry {
  int n, h, w, wp, r, lead;
  int tiles;
  int npix;
};

// Write zeros over columns [c0, c0 + width) of rows [a, b) of `out`
// (element size es): 16 bytes per consumer thread, consecutive threads on
// consecutive chunks of a row.
__device__ void zero_run(char* out, int ldo, int es, int a, int b, int c0,
                         int width) {
  const int chunks = width * es / 16;        // 4 to 32 per row
  for (int e = threadIdx.x; e < (b - a) * chunks; e += kConsumers) {
    const int q = a + e / chunks;
    *reinterpret_cast<uint4*>(out + (static_cast<long long>(q) * ldo + c0) * es +
                              (e - (q - a) * chunks) * 16) =
        make_uint4(0, 0, 0, 0);
  }
}

// The rows without a pixel from tile t's first pixel p0 to the next
// tile's (from row 0 for the first tile, to the end for the last): the
// run after each pixel that ends an image row, up to the next pixel's row
// (and the rows before pixel 0).  Pixel rows are never visited.
__device__ void zero_gaps(char* out, int ldo, int es, int t, int p0, int p1,
                          int c0, int width, const Geometry& g) {
  const int hw = g.h * g.w;
  if (t == 0) zero_run(out, ldo, es, 0, pix_row(0, hw, g.w, g.wp, g.r), c0, width);
  for (int pe = p0 + g.w - 1 - p0 % g.w; pe < p1; pe += g.w) {
    const int b = pe + 1 < g.npix ? pix_row(pe + 1, hw, g.w, g.wp, g.r)
                                  : g.n * g.r;
    zero_run(out, ldo, es, pix_row(pe, hw, g.w, g.wp, g.r) + 1, b, c0, width);
  }
}

// Shared memory: with resident weights, a ring of S input windows, then
// all nkc chunks of the block's weights; otherwise a ring of S (window,
// one chunk of weights) stages.  Then a full and an empty mbarrier per
// slot and one for the resident weights.  A window is nbox TMA boxes of
// box_rows rows x 32 bytes.
struct Smem {
  int win_bytes, stage_bytes, weights_at, bars_at, total;
};

__host__ __device__ inline Smem smem_plan(int bn, int s, bool resident,
                                          int nkc, int box_rows, int nbox) {
  Smem m;
  const int w_chunk = 9 * bn * kKC;
  m.win_bytes = align1024(nbox * box_rows * kKC);
  m.stage_bytes = m.win_bytes + (resident ? 0 : w_chunk);
  m.weights_at = s * m.stage_bytes;
  m.bars_at = m.weights_at + (resident ? nkc * w_chunk : 0);
  m.total = m.bars_at + 8 * (2 * kMaxStages + 1);
  return m;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
qconv_kernel(const __grid_constant__ CUtensorMap xmap, int nkc,
             const int8_t* __restrict__ wk, int cout_k,
             const float* __restrict__ scale, const float* __restrict__ bias,
             const float* __restrict__ alpha, const float* __restrict__ qscale,
             void* __restrict__ out, int ldo, int mode, Geometry g,
             int box_rows, int nbox, int S, bool resident) {
  constexpr int kWBytes = 9 * BN * kKC;  // one chunk of the 9 taps' weights
  constexpr int kAcc = BN / 2;           // accumulator registers per thread
  extern __shared__ __align__(1024) int8_t smem[];
  const Smem sp = smem_plan(BN, S, resident, nkc, box_rows, nbox);
  const int win_bytes = sp.win_bytes;
  const int stage_bytes = sp.stage_bytes;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;               // fragment row / column group
  const int tq = lane & 3;                // thread in group
  const int wm = warp * 16;               // warp's first pixel in the tile
  const int n0 = blockIdx.y * BN;
  const int hw = g.h * g.w;
  const uint32_t sbase = smem_u32(smem);

  auto first_row = [&](int t) { return pix_row(t * kBM, hw, g.w, g.wp, g.r); };

  // full[s] (the producer's expect-tx arrival), empty[s] (one arrival per
  // consumer warp), and the resident weights' barrier.
  const uint32_t full = sbase + sp.bars_at;
  const uint32_t empty = full + 8 * kMaxStages;
  const uint32_t bar_res = empty + 8 * kMaxStages;
  if (tid == 0) {
    for (int i = 0; i < kMaxStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers / 32);
    }
    mbar_init(bar_res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // Producer: for each of the block's tiles and chunks, once the
    // consumers have released the slot's previous chunk, the window (nbox
    // boxes from the tile's first input row) and, unless resident, the
    // chunk's weights for this column tile (packed in the order the
    // descriptors read: one bulk copy).
    if (lane != 0) return;
    const int8_t* wcol = wk + static_cast<long long>(blockIdx.y) * kWBytes;
    const long long wstride = static_cast<long long>(gridDim.y) * kWBytes;
    if (resident) {
      mbar_expect(bar_res, nkc * kWBytes);
      for (int kc = 0; kc < nkc; ++kc)
        bulk_copy(sbase + sp.weights_at + kc * kWBytes, wcol + kc * wstride,
                  kWBytes, bar_res);
    }
    const uint32_t bytes =
        nbox * box_rows * kKC + (resident ? 0 : kWBytes);
    int slot = 0, phase = 0, i = 0;
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      const int s0 = first_row(t) + g.lead - g.wp - 1;
      for (int kc = 0; kc < nkc; ++kc, ++i) {
        if (i >= S) mbar_wait(empty + 8 * slot, phase ^ 1);
        const uint32_t st = sbase + slot * stage_bytes;
        mbar_expect(full + 8 * slot, bytes);
        for (int b = 0; b < nbox; ++b)
          tma_box(st + b * box_rows * kKC, &xmap, kc * kKC, s0 + b * box_rows,
                  full + 8 * slot);
        if (!resident)
          bulk_copy(st + win_bytes, wcol + kc * wstride, kWBytes,
                    full + 8 * slot);
        if (++slot == S) slot = 0, phase ^= 1;
      }
    }
    return;
  }

  int acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0;

  // Window row (relative to the tile's first pixel row) of the pixel whose
  // A row this lane addresses: ldmatrix.x4 lanes 0-15 give rows 0-15 of
  // the warp's 16 pixels at bytes 0-15, lanes 16-31 the same rows at bytes
  // 16-31, which is the A fragment a0..a3.
  int row_a = 0;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_half = lane >> 4;
  // A fragments of one chunk (the 9 taps), read by its products until the
  // next chunk's first wait retires them.
  uint32_t a[9][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[tap][e] = 0;

  // Tile t of this block (first pixel p0, first output row q0); cs is the
  // ring slot of the next chunk and cphase its full barrier's phase, held
  // the slot of the chunk whose products may still run (-1: none).
  int cs = 0, cphase = 0, held = -1;
  auto release = [&]() {     // that chunk's products are done
    if (held >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * held);
      held = -1;
    }
  };
  if (resident) mbar_wait(bar_res, 0);
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const int p0 = t * kBM, q0 = first_row(t);
    {
      const int p = p0 + wm + a_row;
      row_a = p < g.npix ? pix_row(p, hw, g.w, g.wp, g.r) - q0 : 0;
    }
    for (int kc = 0; kc < nkc; ++kc) {
      // The last chunk's products are done: they have read the A registers
      // this chunk reloads, and their slot goes back to the producer.
      wgmma_wait<0>();
      keep(a);
      release();
      mbar_wait(full + 8 * cs, cphase);
      const uint32_t sa = sbase + cs * stage_bytes;
      const uint32_t sb =
          resident ? sbase + sp.weights_at + kc * kWBytes : sa + win_bytes;
      load_taps(a, sa, row_a, g.wp, a_half);
      wgmma_fence();
      issue_taps<BN>(acc, a, sb);
      wgmma_commit();
      // These products run on while the next chunk's slot is awaited.
      held = cs;
      if (++cs == S) cs = 0, cphase ^= 1;
    }
    wgmma_wait<0>();
    keep(a);
    release();
#pragma unroll
    for (int j = 0; j < kAcc; ++j) fence_reg(acc[j]);

    // Epilogue of tile t: for n-block j, acc[4j], acc[4j + 1] at fragment
    // row gq, channels 8j + 2tq and 8j + 2tq + 1; acc[4j + 2], acc[4j + 3]
    // at row gq + 8.
    // The last column tile also zero-fills columns [cout_k, ldo); as wide
    // as the tile (ldo - cout_k is 0 or 64, and 64 only when BN is 64), so
    // the bf16 and f32 stores below cover it row by row.
    const bool pad = blockIdx.y == gridDim.y - 1 && ldo > cout_k;
    int orow[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + wm + gq + half * 8;
      orow[half] = p < g.npix ? pix_row(p, hw, g.w, g.wp, g.r) : -1;
    }
    // z for n-block j (channels n0 + 8 j + 2 tq, + 1) of fragment row
    // gq + 8 half.
    auto affine2 = [&](int j, int half) {
      const int n = n0 + j * 8 + 2 * tq;
      const float2 sc = __ldg(reinterpret_cast<const float2*>(scale + n));
      const float2 bi = __ldg(reinterpret_cast<const float2*>(bias + n));
      return make_float2(
          __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + half * 2]), sc.x),
                    bi.x),
          __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + half * 2 + 1]), sc.y),
                    bi.y));
    };
    if (mode == 2) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + j * 8 + 2 * tq;
        const float2 al = __ldg(reinterpret_cast<const float2*>(alpha + n));
        const float2 qs = __ldg(reinterpret_cast<const float2*>(qscale + n));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (orow[half] < 0) continue;
          const float2 z = affine2(j, half);
          const float d0 = z.x >= 0.0f ? z.x : __fmul_rn(al.x, z.x);
          const float d1 = z.y >= 0.0f ? z.y : __fmul_rn(al.y, z.y);
          *reinterpret_cast<char2*>(static_cast<int8_t*>(out) +
                                    static_cast<long long>(orow[half]) * ldo +
                                    n) =
              make_char2(static_cast<signed char>(fminf(
                             fmaxf(rintf(__fmul_rn(d0, qs.x)), -127.0f),
                             127.0f)),
                         static_cast<signed char>(fminf(
                             fmaxf(rintf(__fmul_rn(d1, qs.y)), -127.0f),
                             127.0f)));
        }
      }
    } else {
      // bf16 and f32: the quad's 4 x 4 bytes (bf16) or 4 x 8 bytes (f32) of
      // n-blocks 4k..4k+3 are transposed so that each lane stores whole
      // 16-byte runs of one n-block.
#pragma unroll
      for (int k = 0; k < BN / 32; ++k) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float2 z = affine2(4 * k + jj, half);
            if (mode == 1) {
              __nv_bfloat162 v;
              v.x = __float2bfloat16_rn(z.x);
              v.y = __float2bfloat16_rn(z.y);
              lo[jj] = *reinterpret_cast<uint32_t*>(&v);
            } else {
              lo[jj] = __float_as_uint(z.x);
              hi[jj] = __float_as_uint(z.y);
            }
          }
          quad_transpose(lo, tq);
          if (mode == 0) quad_transpose(hi, tq);
          if (orow[half] < 0) continue;
          // This lane now holds n-block 4k + tq, channels from lane 0's
          // pair to lane 3's.
          const long long o = static_cast<long long>(orow[half]) * ldo + n0 +
                              (4 * k + tq) * 8;
          if (mode == 1) {
            *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + o) =
                make_uint4(lo[0], lo[1], lo[2], lo[3]);
          } else {
            float* f = static_cast<float*>(out) + o;
            *reinterpret_cast<uint4*>(f) = make_uint4(lo[0], hi[0], lo[1], hi[1]);
            *reinterpret_cast<uint4*>(f + 4) =
                make_uint4(lo[2], hi[2], lo[3], hi[3]);
          }
          if (pad) {   // the same 8 channels of the padded columns: zeros
            const long long oz = o - n0 + cout_k;
            if (mode == 1) {
              *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) +
                                        oz) = make_uint4(0, 0, 0, 0);
            } else {
              float* f = static_cast<float*>(out) + oz;
              *reinterpret_cast<uint4*>(f) = make_uint4(0, 0, 0, 0);
              *reinterpret_cast<uint4*>(f + 4) = make_uint4(0, 0, 0, 0);
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = 0;
    // Rows without a pixel between this tile's first pixel and the next
    // tile's (from row 0 for the first tile, to the end for the last).
    const int es = mode == 0 ? 4 : (mode == 1 ? 2 : 1);
    // Non-pixel rows: the tile's columns (and the padded ones); for int8,
    // whose epilogue above does not write them, the padded columns of all
    // rows instead.
    zero_gaps(static_cast<char*>(out), ldo, es, t, p0, min(p0 + kBM, g.npix),
              n0, BN + (pad && mode != 2 ? ldo - cout_k : 0), g);
    if (pad && mode == 2) {
      zero_run(static_cast<char*>(out), ldo, es, t == 0 ? 0 : q0,
               t == g.tiles - 1 ? g.n * g.r : first_row(t + 1), cout_k,
               ldo - cout_k);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against the driver library).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t st = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t st = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (st == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int BN>
int launch(const int8_t* x, int x_rows, int ldx, int nkc, const int8_t* wk,
           int cout_k, const float* scale, const float* bias,
           const float* alpha, const float* qscale, void* out, int ldo,
           int mode, const Geometry& g, int box_rows, int nbox, int stages,
           bool resident, int grid_x, cudaStream_t stream) {
  const int smem = smem_plan(BN, stages, resident, nkc, box_rows, nbox).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = qconv_kernel<BN>;
  cudaError_t st = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (st != cudaSuccess) return static_cast<int>(st);
  // x as a 2-D tensor of x_rows rows of ldx bytes, read in boxes of
  // box_rows rows x 32 bytes with the 32-byte swizzle swz() reads.
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ldx),
                              static_cast<cuuint64_t>(x_rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldx)};
  const cuuint32_t box[2] = {kKC, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(x),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(grid_x, cout_k / BN);
  kernel<<<grid, kThreads, smem, stream>>>(xmap, nkc, wk, cout_k, scale, bias,
                                           alpha, qscale, out, ldo, mode, g,
                                           box_rows, nbox, stages, resident);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (x_rows, ldx) int8 flat rows (lead band included; 16-byte aligned),
// channels [0, cin_k) used; wk from ops/qconv.py:pack_conv: for each
// 32-channel chunk and each column tile of BN channels, the 9 taps'
// (BN, 32) weights in wgmma's K-major core-matrix order; scale, bias,
// alpha, qscale (cout_k,) f32; out (n * r, ldo) f32 (mode 0), bf16 (mode
// 1) or int8 (mode 2, prelu_quant).  stages, resident, box_rows, nbox and
// grid_x (blocks per column tile) are ops/qconv.py:launch_plan's: the
// wrapper decides the launch; this checks that the plan's windows hold
// every tile's rows and that its ring fits.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments the kernel does
// not take (the wrapper raises first).
extern "C" int alink_qconv(const void* x, int x_rows, int ldx, int cin_k,
                           const void* wk, int cout_k, const void* scale,
                           const void* bias, const void* alpha,
                           const void* qscale, void* out, int ldo, int mode,
                           int n, int h, int w, int wp, int r, int lead,
                           int stages, int resident, int box_rows, int nbox,
                           int grid_x, void* stream) {
  if (x_rows <= 0 || reinterpret_cast<uintptr_t>(x) % 16 || cin_k <= 0 ||
      cin_k % kKC || ldx < cin_k || ldx % 16 ||
      cout_k <= 0 || cout_k % 64 || ldo < cout_k || ldo % 64 || mode < 0 ||
      mode > 2 || n < 0 || h <= 0 || w <= 0 || wp < w + 2 ||
      r < (h + 2) * wp || lead < wp + 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(n) * r + lead >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g{n, h, w, wp, r, lead, 0, n * h * w};
  if (g.npix == 0) return static_cast<int>(cudaGetLastError());
  g.tiles = (g.npix + kBM - 1) / kBM;
  int wmax = 0;   // the widest window a tile reads
  for (int t = 0; t < g.tiles; ++t) {
    const int p1 = ((t + 1) * kBM < g.npix ? (t + 1) * kBM : g.npix) - 1;
    const int rows = pix_row(p1, h * w, w, wp, r) -
                     pix_row(t * kBM, h * w, w, wp, r) + 2 * wp + 3;
    wmax = rows > wmax ? rows : wmax;
  }
  if (box_rows < 8 || box_rows > kMaxBoxRows || box_rows % 8 || nbox < 1 ||
      static_cast<long long>(nbox) * box_rows < wmax || stages < 2 ||
      stages > kMaxStages || grid_x < 1 || grid_x > g.tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* ws = static_cast<const int8_t*>(wk);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto s = static_cast<cudaStream_t>(stream);
  const int nkc = cin_k / kKC;
  if (cout_k % 128 == 0)
    return launch<128>(xs, x_rows, ldx, nkc, ws, cout_k, f(scale), f(bias),
                       f(alpha), f(qscale), out, ldo, mode, g, box_rows, nbox,
                       stages, resident != 0, grid_x, s);
  return launch<64>(xs, x_rows, ldx, nkc, ws, cout_k, f(scale), f(bias),
                    f(alpha), f(qscale), out, ldo, mode, g, box_rows, nbox,
                    stages, resident != 0, grid_x, s);
}
