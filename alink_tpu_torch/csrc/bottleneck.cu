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
// with every product on the tensor cores (bf16 operands, f32 accumulation)
// and each scale/shift applied as a rounded multiply then a rounded add, so
// the plain version (ops/resblock.py) rounds at the same points.  Only x is
// read and out written: y1 and y2 live in shared memory.
//
// Bound: the tensor cores.  A block does 2 * (100 * Cin * Cm + 80 * 9 * Cm^2
// + 64 * Cm * Cout [+ 64 * Cin * Cout]) FLOP for 64 output pixels while it
// reads 100 * Cin + 64 * Cout bf16 activations; every block streams all the
// weights from L2.  The design:
//   - a block computes an 8x8 tile of output pixels of one image at a time,
//     y1 on its 10x10 halo; halo pixels outside the image are set to 0
//     after the epilogue, which is SAME zero padding (the TPU kernel's
//     valid_mask).  Where the tiles are short (Cm <= 128) and outnumber
//     the SMs, blocks are persistent, one per SM, each walking tiles b,
//     b + gridDim.x, ...: the ring below runs on from one tile to the
//     next, so the next tile's first loads overlap this tile's epilogues
//     (at Cm >= 256 one block per tile balances the SMs better);
//   - y1 is kept in the halo's flat row order (row stride 10) behind one
//     guard row, so each 3x3 tap is a constant row offset: the 3x3 runs as 9
//     shifted products over 80 flat rows (8 tile rows x 10 halo columns; the
//     2 halo columns per row are computed and dropped), the TPU kernel's
//     sublane-shift trick done with ldmatrix row addresses, which any row
//     may start;
//   - the weights are read from the packed copy ops/resblock.py makes once
//     (pack_bottleneck): each 32-row K-slab of a 128-column (or 64) pass of
//     W1, W3 (per tap), W2 and Wp is one contiguous 8 KB run in the order
//     the warps read it.  A producer warpgroup brings two consecutive slabs
//     at a time into one entry of a ring of 2-4 entries on mbarriers, the
//     B slabs by one TMA bulk copy and, for stage 1 and the projection, the
//     x slabs by cp.async; the ring runs ahead across passes and stages,
//     and all 8 consumer warps share each entry;
//   - mma.sync m16n8k16 bf16 with A and B from ldmatrix; each consumer warp
//     owns up to 4 row fragments x 32 (or 16) columns of a pass: 2 warps
//     split the rows, 4 the columns;
//   - every shared row is swizzled in 16-byte chunks, so the 8 rows of an
//     ldmatrix phase fall on distinct banks;
//   - where the tiles are fewer than half the SMs (7x7 at batch 32: 32
//     tiles), a cluster of 2 or 4 blocks shares one tile: each block
//     computes its share of the passes of every stage and writes its y1
//     and y2 columns into the shared memory of every block of the cluster
//     (distributed shared memory), which then wait on an mbarrier that
//     every consumer thread of the cluster arrives on.
// Shared memory is (102 + 64) * Cm * 2 bytes plus the ring: 226 KB at
// Cm = 512 with 2 entries.  A wider Cm (the TPU kernel takes any width its
// VMEM holds) keeps y1 and y2 in global memory instead, in a scratch
// region of (102 + 64) * Cm bf16 per block that the wrapper allocates:
// each block of a persistent grid (one per SM, split 1) writes its tile's
// y1 and y2 there and reads its stage-2 and stage-3 A fragments back with
// plain 4-byte loads (the rows were just written by this block, so they
// are in L1 or L2; the barrier between the stages orders the writes before
// the reads), and shared memory holds only the ring.  Any Cm runs so, at
// the cost of those reads; the shapes of VGGFace-ResNet50 (Cm <= 512) never
// take this path.  ops/resblock.py holds the limits and decides each
// launch (launch_plan: ring entries, cluster size, grid, which of the two
// homes of y1 and y2); the entry point below checks and follows it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8;                       // output tile rows
constexpr int kTW = 8;                       // output tile columns
constexpr int kHW = kTW + 2;                 // halo width
constexpr int kHalo = (kTH + 2) * kHW;       // 100 halo pixels
constexpr int kMF1 = (kHalo + 15) / 16;      // 7 row fragments of y1
constexpr int kQ = kTH * kHW;                // 80 flat rows of the 3x3
constexpr int kP = kTH * kTW;                // 64 output pixels
constexpr int kY1Rows = 2 + kHalo;           // guard row, halo, one row past
constexpr int kKS = 32;                      // K rows per slab
constexpr int kSlabB = 128 * kKS * 2;        // B slab bytes (128 columns)
constexpr int kSlabA = kMF1 * 16 * kKS * 2;  // A slab bytes (112 x rows)
// A ring entry holds two consecutive slabs: their B slabs are adjacent in
// the packed weights (one bulk copy), their x slabs follow.
constexpr int kEntry = 2 * (kSlabB + kSlabA);
constexpr int kWarps = 8;                    // consumer warps
constexpr int kProducers = 4;                // producer warps (a warpgroup)
constexpr int kThreads = 32 * (kWarps + kProducers);
constexpr int kMaxSlots = 4;                 // ring entries
constexpr int kMaxSmem = 232448;             // per block on H100
static_assert(kQ % 16 == 0 && kP % 16 == 0, "tile must fill fragments");
static_assert(kHW + kQ - 1 + kHW + 1 < kY1Rows, "3x3 reads past y1");
constexpr int kActRows = kY1Rows + kP;       // a block's y1 and y2 rows
                                             // in global scratch

__host__ __device__ constexpr int align128(int b) { return (b + 127) / 128 * 128; }

struct Smem {
  int y2_at, ring_at, bars_at, total;   // full, empty, then y1/y2 ready
};

// `global_act`: y1 and y2 live in global scratch, shared memory holds the
// ring and the barriers only.
__host__ __device__ inline Smem smem_plan(int cm, int slots, bool global_act) {
  Smem m;
  m.y2_at = global_act ? 0 : align128(kY1Rows * cm * 2);
  m.ring_at = global_act ? 0 : m.y2_at + align128(kP * cm * 2);
  m.bars_at = m.ring_at + slots * kEntry;
  m.total = m.bars_at + 16 * kMaxSlots + 16;
  return m;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; zero-fills the destination when !pred.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
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

// An arrival on `bar` when this thread's earlier cp.async copies land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Barrier among the consumer warps only (the producer runs ahead).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kWarps) : "memory");
}

// The block's rank in its cluster, and the address of shared-memory
// address `addr` in the block of rank `rank`.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.b32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

// An arrival on another block's mbarrier that releases this thread's
// earlier writes to the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_CLUSTER:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_CLUSTER;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// All threads of all blocks of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::
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

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Registers only: the compiler may schedule it among the fragment loads.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte offset of 16-byte chunk c of row `row` in a 64-byte-row slab (x or
// packed weights: chunk c ^ ((row >> 1) & 3)), and in a Cm-wide y1/y2 row
// (chunk c ^ (row & 7)).
__device__ __forceinline__ uint32_t slab_off(int row, int c) {
  return static_cast<uint32_t>(row * 64 + ((c ^ ((row >> 1) & 3)) << 4));
}

__device__ __forceinline__ uint32_t act_off(int row, int c, int pitch) {
  return static_cast<uint32_t>(row * pitch + ((c ^ (row & 7)) << 4));
}

// scale * v + shift, rounded after the multiply and after the add.
__device__ __forceinline__ float affine(float v, float s, float b) {
  return __fadd_rn(__fmul_rn(v, s), b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16(lo);
  v.y = __float2bfloat16(hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Where a slab's A operand rows come from: the ring slot (x, 64-byte rows),
// y1 / y2 in shared memory (Cm-wide rows; `shift` is the tap's row offset)
// or y1 / y2 in the block's global scratch (Cm-wide rows, unswizzled).
enum ASource { kFromSlab, kFromAct, kFromGlobal };

// Two bf16 of the global scratch.  A plain load, not __ldg: this block
// wrote the rows during this launch.
__device__ __forceinline__ uint32_t ld_act(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[m][j] += A rows [row0 + 16 m, +16) x B columns [wn + 8 j, +8) over
// the 32 K rows of one slab, for m < MN, j < NF: no branch around a
// product, so the warp issues them back to back.
template <int MN, int NF, ASource SRC>
__device__ __forceinline__ void slab_mma(float (*acc)[4][4], uint32_t a_base,
                                         int row0, int shift, int pitch,
                                         int kc0, uint32_t b_base, int wn,
                                         int lane,
                                         const __nv_bfloat16* ga = nullptr,
                                         int cm = 0) {
  // All of the slab's fragments first (two k16 steps), then the products.
  uint32_t b[2][NF][2];
  uint32_t a[2][MN][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int jj = 0; jj < NF / 2; ++jj) {
      const int n = wn + jj * 16 + (lane >> 4) * 8 + (lane & 7);
      uint32_t r[4];
      ldsm_x4(b_base + slab_off(n, kk * 2 + ((lane >> 3) & 1)), r);
      b[kk][2 * jj][0] = r[0];
      b[kk][2 * jj][1] = r[1];
      b[kk][2 * jj + 1][0] = r[2];
      b[kk][2 * jj + 1][1] = r[3];
    }
#pragma unroll
    for (int m = 0; m < MN; ++m) {
      const int row = row0 + m * 16 + (lane & 15);
      const int c = kk * 2 + (lane >> 4);
      if constexpr (SRC == kFromSlab) {
        ldsm_x4(a_base + slab_off(row, c), a[kk][m]);
      } else if constexpr (SRC == kFromAct) {
        ldsm_x4(a_base + act_off(row + shift, kc0 + c, pitch), a[kk][m]);
      } else {
        // The fragment ldmatrix would give: rows g and g + 8 of the 16,
        // columns 2 t4, + 1 of the slice's two 8-column halves.
        const int r0 = row0 + m * 16 + (lane >> 2) + shift;
        const int k = (kc0 + kk * 2) * 8 + 2 * (lane & 3);
        const __nv_bfloat16* lo = ga + static_cast<long long>(r0) * cm + k;
        const __nv_bfloat16* hi = lo + 8LL * cm;
        a[kk][m][0] = ld_act(lo);
        a[kk][m][1] = ld_act(hi);
        a[kk][m][2] = ld_act(lo + 8);
        a[kk][m][3] = ld_act(hi + 8);
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int m = 0; m < MN; ++m)
#pragma unroll
      for (int j = 0; j < NF; ++j) mma_bf16(acc[m][j], a[kk][m], b[kk][j]);
}

struct Params {
  const __nv_bfloat16* x;
  int h, w, cin, cm, cout, tiles_x, tiles_per_img, tiles;
  const __nv_bfloat16 *w1, *w3, *w2, *wp;    // packed (pack_bottleneck)
  const float *s1, *b1, *s2, *b2, *s3, *b3, *sp, *bp;
  __nv_bfloat16* out;
  __nv_bfloat16* act;   // global y1/y2 scratch, kActRows x cm a block
  int slots, split;                          // ring entries, cluster size
};

// The slab sequence of a block: stage 1 (y1) passes x K-slabs of x . W1,
// stage 2 (y2) passes x 9 taps x K-slabs of y1 . W3[tap], stage 3 passes x
// (K-slabs of y2 . W2, then K-slabs of x . Wp), over the block's passes
// [lo12, hi12) of stages 1 and 2 and from lo3 on of stage 3 (all of them
// unless a cluster shares the tile), walked by a cursor that advances one
// slab at a time (no division per slab).
struct Cursor {
  int stage = 1, pass = 0, tap = 0, k0 = 0;   // k0: first K row of the slab
  bool proj = false;                          // stage 3's x . Wp part

  __device__ void advance(const Params& p, int lo12, int hi12, int lo3) {
    k0 += kKS;
    if (stage == 1) {
      if (k0 == p.cin) {
        k0 = 0;
        if (++pass == hi12) pass = lo12, stage = 2;
      }
    } else if (stage == 2) {
      if (k0 == p.cm) {
        k0 = 0;
        if (++tap == 9) {
          tap = 0;
          if (++pass == hi12) pass = lo3, stage = 3;
        }
      }
    } else if (!proj && k0 == p.cm) {
      k0 = 0;
      if (p.wp != nullptr) {
        proj = true;
      } else {
        ++pass;
      }
    } else if (proj && k0 == p.cin) {
      k0 = 0;
      proj = false;
      ++pass;
    }
  }
  // Pass width and the packed B slab: passes x (taps x) slabs x np x 32.
  __device__ int np(const Params& p) const {
    const int n = stage == 3 ? p.cout : p.cm;
    return n < 128 ? n : 128;
  }
  __device__ const __nv_bfloat16* b_slab(const Params& p) const {
    const long long slab = k0 / kKS;
    const long long run = static_cast<long long>(np(p)) * kKS;
    if (stage == 1) return p.w1 + (pass * (p.cin / kKS) + slab) * run;
    if (stage == 2)
      return p.w3 + ((pass * 9LL + tap) * (p.cm / kKS) + slab) * run;
    if (!proj) return p.w2 + (pass * (p.cm / kKS) + slab) * run;
    return p.wp + (pass * (p.cin / kKS) + slab) * run;
  }
};

// A consumer warp's view of the block: addresses, its place, its passes,
// and where it is in the ring (entry, phase, and which slab of the entry's
// pair).
struct Ctx {
  const Params& p;
  uint32_t y1s, y2s, ring, full, empty, ready;
  __nv_bfloat16* gy1;   // this block's y1 rows in global scratch (or null)
  int pitch, slots, lane, gq, tq, wc, ty0, tx0;
  long long img_px;
  int lo12, hi12, lo3, hi3;
  int slot, phase, u;

  // Wait for the next slab; its B slab and x slab addresses.
  __device__ void acquire(uint32_t& b, uint32_t& x, int np) {
    if (u == 0) mbar_wait(full + 8 * slot, phase);
    b = ring + slot * kEntry + u * np * kKS * 2;
    x = ring + slot * kEntry + 2 * kSlabB + u * kSlabA;
  }
  // Done with the slab: after the pair's second, free the entry.
  __device__ void release() {
    if (u == 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * slot);
      if (++slot == slots) slot = 0, phase ^= 1;
    }
    u ^= 1;
  }
  // Store 2 bf16 of y1 or y2 at byte `off` of `base` in every block that
  // shares the tile.
  __device__ void put(uint32_t base, uint32_t off, uint32_t v) const {
    if (p.split == 1) {
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(base + off), "r"(v));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < p.split) st_cluster(map_rank(base + off, q), v);
    }
  }
  // Store 2 bf16 at element `e` of this block's global y1/y2 scratch.
  __device__ void put_global(long long e, uint32_t v) const {
    *reinterpret_cast<uint32_t*>(gy1 + e) = v;
  }
  // y1 (which 0) or y2 (1) complete in every consumer warp of the block,
  // or of the cluster that shares the tile (bar.sync also orders the
  // block's global y1/y2 writes before its reads).
  __device__ void stage_done(int which) const {
    if (p.split == 1) {
      consumers_sync();
      return;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < p.split) mbar_arrive_cluster(map_rank(ready + 8 * which, q));
    mbar_wait_cluster(ready + 8 * which, 0);
  }
};

__device__ __forceinline__ void zero_acc(float (&acc)[4][4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.0f;
}

// Epilogue of one pass of STAGE: element e of fragment (m, j) sits at row
// (m_lo + m) * 16 + gq + 8 * (e >> 1), column col0 + 8 j + 2 tq + (e & 1).
// Stage 3 finds the projection's sums in row fragments 2 + m.
// 4 x 4 transpose across the 4 lanes of a quad (as in qconv.cu): on entry
// lane q holds v[j] = element (q, j); on exit v[j] = element (j, q).  With
// v[j] the 2 bf16 of n-block j at the lane's column pair, a lane ends up
// with 8 consecutive channels (16 bytes) of n-block q, and back.
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

// Stage 3's output pixel of fragment row r (tile row r / 8, column r % 8)
// in the block's tile: its index in x and out, or -1 outside the image.
__device__ __forceinline__ long long out_pixel(const Ctx& c, int r) {
  const int oy = c.ty0 + r / kTW;
  const int ox = c.tx0 + r % kTW;
  if (oy >= c.p.h || ox >= c.p.w) return -1;
  return c.img_px + static_cast<long long>(oy) * c.p.w + ox;
}

// The identity shortcut (2 bf16 of x) at every output element of one pass
// of stage 3, loaded before the pass's products so that their latency is
// hidden under them (0 outside the image).
template <int NF>
__device__ __forceinline__ void load_shortcut(const Ctx& c,
                                              uint32_t (&xs)[2][4][2],
                                              int col0, int m_lo) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long px = out_pixel(c, (m_lo + m) * 16 + c.gq + half * 8);
      if constexpr (NF == 4) {
        // 16 bytes of n-block tq, then transposed to the fragment layout.
        uint4 v4 = make_uint4(0, 0, 0, 0);
        if (px >= 0)
          v4 = __ldg(reinterpret_cast<const uint4*>(c.p.x + px * c.p.cin +
                                                    col0 + 8 * c.tq));
        uint32_t v[4] = {v4.x, v4.y, v4.z, v4.w};
        quad_transpose(v, c.tq);
#pragma unroll
        for (int j = 0; j < 4; ++j) xs[m][j][half] = v[j];
      } else {
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int col = col0 + j * 8 + 2 * c.tq;
          xs[m][j][half] =
              px < 0 ? 0u
                     : __ldg(reinterpret_cast<const unsigned int*>(
                           c.p.x + px * c.p.cin + col));
        }
      }
    }
}

template <int STAGE, int MN, int NF, bool PROJ, bool GACT>
__device__ __forceinline__ void epilogue(const Ctx& c,
                                         const float (&acc)[4][4][4],
                                         int col0, int m_lo,
                                         const uint32_t (&xs)[2][4][2]) {
  const Params& p = c.p;
  uint32_t o3[STAGE == 3 ? MN : 1][2][NF];   // stage 3's packed outputs
  const float* sv = STAGE == 1 ? p.s1 : (STAGE == 2 ? p.s2 : p.s3);
  const float* bv = STAGE == 1 ? p.b1 : (STAGE == 2 ? p.b2 : p.b3);
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int col = col0 + j * 8 + 2 * c.tq;
    const float2 sc = __ldg(reinterpret_cast<const float2*>(sv + col));
    const float2 sh = __ldg(reinterpret_cast<const float2*>(bv + col));
    float2 pk = make_float2(0.0f, 0.0f), pb = pk;   // the projection's BN
    if constexpr (STAGE == 3 && PROJ) {
      pk = __ldg(reinterpret_cast<const float2*>(p.sp + col));
      pb = __ldg(reinterpret_cast<const float2*>(p.bp + col));
    }
#pragma unroll
    for (int m = 0; m < MN; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = (m_lo + m) * 16 + c.gq + half * 8;
        const float v0 = acc[m][j][half * 2];
        const float v1 = acc[m][j][half * 2 + 1];
        if constexpr (STAGE == 1) {
          if (r >= kHalo) continue;
          const int hy = c.ty0 - 1 + r / kHW;
          const int hx = c.tx0 - 1 + r % kHW;
          const bool valid = hy >= 0 && hy < p.h && hx >= 0 && hx < p.w;
          const float o0 = valid ? fmaxf(affine(v0, sc.x, sh.x), 0.0f) : 0.0f;
          const float o1 = valid ? fmaxf(affine(v1, sc.y, sh.y), 0.0f) : 0.0f;
          if constexpr (GACT) {
            c.put_global(static_cast<long long>(1 + r) * p.cm + col,
                         pack_bf16(o0, o1));
          } else {
            c.put(c.y1s, act_off(1 + r, col / 8, c.pitch) + (col % 8) * 2,
                  pack_bf16(o0, o1));
          }
        } else if constexpr (STAGE == 2) {
          const int hc = r % kHW;            // flat row: halo row 1 + r / kHW
          if (hc < 1 || hc > kTW) continue;
          const int px = (r / kHW) * kTW + hc - 1;
          const float o0 = fmaxf(affine(v0, sc.x, sh.x), 0.0f);
          const float o1 = fmaxf(affine(v1, sc.y, sh.y), 0.0f);
          if constexpr (GACT) {
            c.put_global(static_cast<long long>(kY1Rows + px) * p.cm + col,
                         pack_bf16(o0, o1));
          } else {
            c.put(c.y2s, act_off(px, col / 8, c.pitch) + (col % 8) * 2,
                  pack_bf16(o0, o1));
          }
        } else {
          const float y0 = affine(v0, sc.x, sh.x);
          const float y1 = affine(v1, sc.y, sh.y);
          float c0, c1;
          if constexpr (PROJ) {
            c0 = affine(acc[2 + m][j][half * 2], pk.x, pb.x);
            c1 = affine(acc[2 + m][j][half * 2 + 1], pk.y, pb.y);
          } else {
            __nv_bfloat162 xv;
            *reinterpret_cast<uint32_t*>(&xv) = xs[m][j][half];
            c0 = __bfloat162float(xv.x);
            c1 = __bfloat162float(xv.y);
          }
          o3[m][half][j] = pack_bf16(fmaxf(__fadd_rn(y0, c0), 0.0f),
                                     fmaxf(__fadd_rn(y1, c1), 0.0f));
        }
      }
    }
  }
  if constexpr (STAGE == 3) {
    // Each output row's NF n-blocks: as 16-byte runs after a transpose
    // (NF == 4), else 2 channels at a time.
#pragma unroll
    for (int m = 0; m < MN; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long px =
            out_pixel(c, (m_lo + m) * 16 + c.gq + half * 8);
        if constexpr (NF == 4) {
          uint32_t v[4] = {o3[m][half][0], o3[m][half][1], o3[m][half][2],
                           o3[m][half][3]};
          quad_transpose(v, c.tq);
          if (px >= 0)
            *reinterpret_cast<uint4*>(p.out + px * p.cout + col0 + 8 * c.tq) =
                make_uint4(v[0], v[1], v[2], v[3]);
        } else if (px >= 0) {
#pragma unroll
          for (int j = 0; j < NF; ++j)
            *reinterpret_cast<uint32_t*>(p.out + px * p.cout + col0 + j * 8 +
                                         2 * c.tq) = o3[m][half][j];
        }
      }
  }
}

// A consumer warp's whole slab sequence, in the producer's order, with
// its row fragments (MN1, MN2 from m_lo1, m_lo2; 2 from m_lo3) and the
// pass widths (NF12 * 32, NF3 * 32) fixed: each stage is one straight
// loop of products.  GACT: y1 and y2 in global scratch.
template <int MN1, int MN2, int NF12, int NF3, bool PROJ, bool GACT>
__device__ __forceinline__ void consume(Ctx& c, float (&acc)[4][4][4],
                                        int m_lo1, int m_lo2, int m_lo3) {
  const Params& p = c.p;
  constexpr ASource kAct = GACT ? kFromGlobal : kFromAct;
  const __nv_bfloat16* gy2 =
      GACT ? c.gy1 + static_cast<long long>(kY1Rows) * p.cm : nullptr;
  constexpr int np12 = NF12 * 32, np3 = NF3 * 32;
  const int wn12 = c.wc * (np12 / 4), wn3 = c.wc * (np3 / 4);
  uint32_t b, x;
  uint32_t xs[2][4][2] = {};   // stage 3's identity shortcut, one pass
  // Stage 1: y1 on the halo, A = the x slabs.
  for (int pass = c.lo12; pass < c.hi12; ++pass) {
    for (int k0 = 0; k0 < p.cin; k0 += kKS) {
      c.acquire(b, x, np12);
      slab_mma<MN1, NF12, kFromSlab>(acc, x, m_lo1 * 16, 0, c.pitch, 0, b,
                                     wn12, c.lane);
      c.release();
    }
    epilogue<1, MN1, NF12, PROJ, GACT>(c, acc, pass * np12 + wn12, m_lo1,
                                       xs);
    zero_acc(acc);
  }
  c.stage_done(0);
  // Stage 2: the 3x3 as 9 shifted products over y1.
  for (int pass = c.lo12; pass < c.hi12; ++pass) {
    for (int tap = 0; tap < 9; ++tap) {
      // y1 row of flat row r under the tap (guard row included):
      // r + dy * kHW + dx.
      const int shift = (tap / 3) * kHW + tap % 3;
      for (int k0 = 0; k0 < p.cm; k0 += kKS) {
        c.acquire(b, x, np12);
        slab_mma<MN2, NF12, kAct>(acc, c.y1s, m_lo2 * 16, shift, c.pitch,
                                  k0 / 8, b, wn12, c.lane, c.gy1, p.cm);
        c.release();
      }
    }
    epilogue<2, MN2, NF12, PROJ, GACT>(c, acc, pass * np12 + wn12, m_lo2,
                                       xs);
    zero_acc(acc);
  }
  c.stage_done(1);
  // Stage 3: the 1x1 expand over y2, then the projection over x.
  for (int pass = c.lo3; pass < c.hi3; ++pass) {
    if constexpr (!PROJ) load_shortcut<NF3>(c, xs, pass * np3 + wn3, m_lo3);
    for (int k0 = 0; k0 < p.cm; k0 += kKS) {
      c.acquire(b, x, np3);
      slab_mma<2, NF3, kAct>(acc, c.y2s, m_lo3 * 16, 0, c.pitch, k0 / 8,
                             b, wn3, c.lane, gy2, p.cm);
      c.release();
    }
    if constexpr (PROJ) {
      for (int k0 = 0; k0 < p.cin; k0 += kKS) {
        c.acquire(b, x, np3);
        slab_mma<2, NF3, kFromSlab>(acc + 2, x, m_lo3 * 16, 0, c.pitch, 0, b,
                                    wn3, c.lane);
        c.release();
      }
    }
    epilogue<3, 2, NF3, PROJ, GACT>(c, acc, pass * np3 + wn3, m_lo3, xs);
    zero_acc(acc);
  }
}

// Where tile `tile` (image-major) starts: its first output row and column
// and its image's first pixel.
struct Tile {
  int ty0, tx0;
  long long img_px;
};

__device__ __forceinline__ Tile tile_at(const Params& p, int tile) {
  const int img = tile / p.tiles_per_img;
  const int t = tile - img * p.tiles_per_img;
  return Tile{(t / p.tiles_x) * kTH, (t % p.tiles_x) * kTW,
              static_cast<long long>(img) * p.h * p.w};
}

// GACT: y1 and y2 in the global scratch p.act (a Cm too wide for shared
// memory); otherwise in shared memory.
template <bool PROJ, int NF12, int NF3, bool GACT>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = smem_plan(p.cm, p.slots, GACT);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t y1s = sbase;
  const uint32_t y2s = sbase + sm.y2_at;
  const uint32_t ring = sbase + sm.ring_at;
  const uint32_t bars = sbase + sm.bars_at;
  const int pitch = p.cm * 2;                // y1/y2 row bytes
  const int S = p.slots;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int wr = warp >> 2;                  // row half of the warp
  const int wc = warp & 3;                   // column quarter of the warp
  // Block b walks tiles b, b + gridDim.x, ... (one of them unless the
  // launch is persistent).  A cluster of split blocks shares one tile (and
  // then there is one tile per cluster).
  const int rank = p.split > 1 ? cluster_rank() : 0;
  const int tile0 = blockIdx.x / p.split;
  const int tile_step = gridDim.x / p.split;
  const int np1 = p.cm < 128 ? p.cm : 128;
  const int np3 = p.cout < 128 ? p.cout : 128;
  const int per12 = p.cm / np1 / p.split;      // this block's passes
  const int per3 = p.cout / np3 / p.split;
  const int lo12 = rank * per12, hi12 = lo12 + per12;
  const int lo3 = rank * per3, hi3 = lo3 + per3;
  const int total = per12 * (p.cin / kKS) + per12 * 9 * (p.cm / kKS) +
                    per3 * (p.cm / kKS + (PROJ ? p.cin / kKS : 0));

  // Guard rows of y1 (read only by dropped halo columns; kept finite).
  __nv_bfloat16* gy1 =
      GACT ? p.act + static_cast<long long>(blockIdx.x) * kActRows * p.cm
           : nullptr;
  for (int e = tid; e < p.cm / 8; e += kThreads) {
    if constexpr (GACT) {
      *reinterpret_cast<uint4*>(gy1 + e * 8) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(gy1 + (kY1Rows - 1LL) * p.cm + e * 8) =
          make_uint4(0, 0, 0, 0);
    } else {
      *reinterpret_cast<uint4*>(smem + e * 16) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(smem + (kY1Rows - 1) * pitch + e * 16) =
          make_uint4(0, 0, 0, 0);
    }
  }
  // full[s]: the first producer thread's expect-tx arrival plus one
  // cp.async arrival per producer thread; empty[s]: one arrival per
  // consumer warp; ready[0], ready[1] (y1, y2 complete; clusters only):
  // one arrival per consumer thread of the cluster.
  const uint32_t full = bars;
  const uint32_t empty = bars + 8 * kMaxSlots;
  const uint32_t ready = bars + 16 * kMaxSlots;
  if (tid == 0) {
    for (int i = 0; i < kMaxSlots; ++i) {
      mbar_init(full + 8 * i, 1 + 32 * kProducers);
      mbar_init(empty + 8 * i, kWarps);
    }
    mbar_init(ready, p.split * 32 * kWarps);
    mbar_init(ready + 8, p.split * 32 * kWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // No block of a cluster writes another's shared memory before all have
  // set up their barriers.
  if (p.split > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }

  if (warp >= kWarps) {
    // Producers: the slab pair (2e, 2e + 1) goes to entry e % S once the
    // consumers have released the pair S entries before it; both B slabs
    // by one bulk copy, and for stage 1 and the projection the two x slabs
    // by cp.async from the 128 producer threads, whose rows' global
    // offsets are computed once here (-1: outside the image, zero-filled).
    const int pt = tid - 32 * kWarps;
    constexpr int kPer1 = (kHalo * 8 + 32 * kProducers - 1) / (32 * kProducers);
    constexpr int kPerP = kP * 8 / (32 * kProducers);
    int slot = 0, phase = 0, i = 0;       // i: slabs issued over all tiles
    for (int tile = tile0; tile < p.tiles; tile += tile_step) {
      const Tile tl = tile_at(p, tile);
      long long off1[kPer1], offp[kPerP];
#pragma unroll
      for (int q = 0; q < kPer1; ++q) {
        const int r = (pt + 32 * kProducers * q) >> 3;
        const int py = tl.ty0 - 1 + r / kHW, px = tl.tx0 - 1 + r % kHW;
        off1[q] = r < kHalo && py >= 0 && py < p.h && px >= 0 && px < p.w
                      ? (tl.img_px + static_cast<long long>(py) * p.w + px) *
                            p.cin
                      : -1;
      }
#pragma unroll
      for (int q = 0; q < kPerP; ++q) {
        const int r = (pt + 32 * kProducers * q) >> 3;
        const int py = tl.ty0 + r / kTW, px = tl.tx0 + r % kTW;
        offp[q] = py < p.h && px < p.w
                      ? (tl.img_px + static_cast<long long>(py) * p.w + px) *
                            p.cin
                      : -1;
      }
      Cursor ld;
      ld.pass = lo12;
      for (int k = 0; k < total; k += 2, i += 2) {
        if (i >= 2 * S) mbar_wait(empty + 8 * slot, phase ^ 1);
        const uint32_t dst = ring + slot * kEntry;
        if (pt == 0) {
          const uint32_t bytes = 2 * ld.np(p) * kKS * 2;
          mbar_expect(full + 8 * slot, bytes);
          bulk_copy(dst, ld.b_slab(p), bytes, full + 8 * slot);
        }
        if (ld.stage == 1 || ld.proj) {
          // Element e of the pair: row e >> 3, slab (e >> 2) & 1, chunk e & 3.
          const uint32_t a = dst + 2 * kSlabB;
          const bool halo = ld.stage == 1;
#pragma unroll
          for (int q = 0; q < kPer1; ++q) {
            if (!halo && q >= kPerP) break;
            const int e = pt + 32 * kProducers * q;
            const int r = e >> 3;
            if (halo && r >= kHalo) break;
            const long long off = halo ? off1[q] : offp[q < kPerP ? q : 0];
            const int u = (e >> 2) & 1, c = e & 3;
            cp_async16(a + u * kSlabA + slab_off(r, c),
                       p.x + (off < 0 ? 0 : off) + ld.k0 + u * kKS + c * 8,
                       off >= 0);
          }
        }
        cp_async_arrive(full + 8 * slot);
        ld.advance(p, lo12, hi12, lo3);
        ld.advance(p, lo12, hi12, lo3);
        if (++slot == S) slot = 0, phase ^= 1;
      }
    }
    return;
  }

  // [row fragment][column fragment][element]; stage 3 uses row fragments
  // 0-1 for y3 and 2-3 for the projection's x . Wp.
  float acc[4][4][4];
  zero_acc(acc);
  Ctx c{p,   y1s,  y2s,  ring, full, empty, ready, gy1,  pitch,
        S,   lane, gq,   tq,   wc,   0,     0,     0,
        lo12, hi12, lo3, hi3, 0,    0,     0};
  // The ring runs on from one tile to the next.  y1 and y2 are rewritten
  // only after a barrier that every warp passes once done reading them:
  // y1 (read in stage 2) after the stage 2/3 barrier, y2 (read in stage
  // 3) after the next tile's stage 1/2 barrier.
  for (int tile = tile0; tile < p.tiles; tile += tile_step) {
    const Tile tl = tile_at(p, tile);
    c.ty0 = tl.ty0;
    c.tx0 = tl.tx0;
    c.img_px = tl.img_px;
    // Row fragments: stage 1 rows 0-3 / 4-6, stage 2 0-2 / 3-4, stage 3
    // 0-1 / 2-3 for the two warp rows.
    if (wr == 0) {
      consume<4, 3, NF12, NF3, PROJ, GACT>(c, acc, 0, 0, 0);
    } else {
      consume<3, 2, NF12, NF3, PROJ, GACT>(c, acc, 4, 3, 2);
    }
  }
}

}  // namespace

// x (n, h, w, cin) and out (n, h, w, cout): bf16 NHWC, contiguous.  w1, w3,
// w2 and wp (null for the identity shortcut) are the packed copies of
// ops/resblock.py:pack_bottleneck; s*/b*: f32 folded BN.  act: null (y1
// and y2 in shared memory), or a bf16 scratch of blocks x (102 + 64) x cm
// for y1 and y2 (split 1).  slots (ring entries), split (blocks per tile, a
// cluster when > 1), blocks (the grid) and act's use are
// ops/resblock.py:launch_plan's: the wrapper decides the launch and holds
// the limits (cin % 64, cm and cout 64 or a multiple of 128, identity
// needs cin == cout) and raises first; the checks here only keep a call
// that breaks them from reading or writing out of bounds.  Returns
// cudaGetLastError() after the launch.
extern "C" int alink_bottleneck(const void* x, int n, int h, int w, int cin,
                                int cm, int cout, const void* w1,
                                const void* s1, const void* b1, const void* w3,
                                const void* s2, const void* b2, const void* w2,
                                const void* s3, const void* b3, const void* wp,
                                const void* sp, const void* bp, void* out,
                                void* act, int slots, int split, int blocks,
                                void* stream) {
  auto width_ok = [](int c) { return c == 64 || (c > 0 && c % 128 == 0); };
  if (n < 0 || h <= 0 || w <= 0 || cin <= 0 || cin % (2 * kKS) || !width_ok(cm) ||
      !width_ok(cout) || (wp == nullptr && cin != cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool gact = act != nullptr;
  if (slots < 2 || slots > kMaxSlots ||
      smem_plan(cm, slots, gact).total > kMaxSmem ||
      (gact && split != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_plan(cm, slots, gact).total;
  const int tiles_x = (w + kTW - 1) / kTW;
  const int tiles_per_img = tiles_x * ((h + kTH - 1) / kTH);
  const long long tiles = static_cast<long long>(n) * tiles_per_img;
  if (tiles == 0) return static_cast<int>(cudaGetLastError());
  // A cluster divides the passes of every stage among its blocks and
  // shares exactly one tile (its y1/y2 barriers complete once); a block of
  // its own walks tiles blockIdx.x, + blocks, ...
  const int passes12 = cm / (cm < 128 ? cm : 128);
  const int passes3 = cout / (cout < 128 ? cout : 128);
  if (tiles > (1LL << 30) ||
      !(split == 1 || split == 2 || split == 4) || passes12 % split ||
      passes3 % split || blocks < 1 ||
      (split > 1 && blocks != tiles * split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Pass widths: 64 (2 fragments per warp) or 128 (4).
  void (*kernel)(Params) = nullptr;
  const bool wide12 = cm >= 128, wide3 = cout >= 128;
  if (gact) {
    // Only a Cm past what shared memory holds takes global y1/y2: 128-wide
    // passes in stages 1 and 2.
    if (!wide12) return static_cast<int>(cudaErrorInvalidValue);
    if (wp != nullptr) {
      kernel = wide3 ? bottleneck_kernel<true, 4, 4, true>
                     : bottleneck_kernel<true, 4, 2, true>;
    } else {
      kernel = wide3 ? bottleneck_kernel<false, 4, 4, true>
                     : bottleneck_kernel<false, 4, 2, true>;
    }
  } else if (wp != nullptr) {
    kernel = wide12 ? (wide3 ? bottleneck_kernel<true, 4, 4, false>
                             : bottleneck_kernel<true, 4, 2, false>)
                    : (wide3 ? bottleneck_kernel<true, 2, 4, false>
                             : bottleneck_kernel<true, 2, 2, false>);
  } else {
    kernel = wide12 ? (wide3 ? bottleneck_kernel<false, 4, 4, false>
                             : bottleneck_kernel<false, 4, 2, false>)
                    : (wide3 ? bottleneck_kernel<false, 2, 4, false>
                             : bottleneck_kernel<false, 2, 2, false>);
  }
  cudaError_t st = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (st != cudaSuccess) return static_cast<int>(st);
  auto bf = [](const void* v) { return static_cast<const __nv_bfloat16*>(v); };
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  Params p{bf(x), h, w, cin, cm, cout, tiles_x, tiles_per_img,
           static_cast<int>(tiles),
           bf(w1), bf(w3), bf(w2), bf(wp),
           f(s1), f(b1), f(s2), f(b2), f(s3), f(b3), f(sp), f(bp),
           static_cast<__nv_bfloat16*>(out),
           static_cast<__nv_bfloat16*>(act), slots, split};
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  st = cudaLaunchKernelEx(&cfg, kernel, p);
  if (st != cudaSuccess) return static_cast<int>(st);
  return static_cast<int>(cudaGetLastError());
}
