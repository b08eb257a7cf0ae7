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
// read and out written: y1 and y2 stay on chip.
//
// Bound: the tensor cores at 14^2 and 7^2, the bytes of x and out at 55^2
// and 28^2 (roofline.bound_s); in practice the weights every tile streams
// from L2 (all of the block's weights a tile) and the epilogues.  The
// design:
//   - a tile is th x tw output pixels of one image.  y1 is computed on the
//     tile's (th + 2) x (tw + 2) halo and kept in the halo's flat row order
//     (row stride hs = tw + 2), so each 3x3 tap (dy, dx) is the constant
//     row offset dy * hs + dx: the 3x3 runs as 9 shifted products over the
//     th * hs flat rows of the tile (the 2 halo columns of each row are
//     computed and dropped), the TPU kernel's sublane-shift trick.  Halo
//     pixels outside the image are set to 0 after the epilogue: SAME zero
//     padding;
//   - every stage runs on whole 64-row products: stage 1 (y1) on mt1 64-row
//     tiles (the halo's rows rounded up), stages 2 (y2) and 3 (out) on mt2
//     (the tile's flat rows rounded up).  ops/resblock.py:launch_plan picks
//     th and tw from the shapes, with mt1 <= 3 and mt2 <= 2, for the fewest
//     rows computed over the image and the fewest tiles (each tile streams
//     the weights once): 4 x 28 at 55^2 and 28^2 (192 / 128 / 128 rows for
//     112 outputs), 7 x 14 at 14^2, the whole image at 7^2.  A row past the
//     halo or the tile is computed from whatever its A row holds, and never
//     stored or read by a kept output: a product row depends on its own A
//     row only;
//   - the products are wgmma m64nNk16 bf16 -> f32 by two consumer
//     warpgroups, each owning half the columns of a pass (N = 64 of 128, or
//     32 of 64) over all of the stage's 64-row tiles.  A comes from
//     registers, loaded by ldmatrix at each row's tap-shifted address (any
//     row may start an ldmatrix; a wgmma descriptor may not), as in
//     csrc/qconv.cu; B through a shared-memory descriptor over the packed
//     weights' 8-row x 16-byte core matrices.  A commit group is two k16
//     steps (2 x the stage's 64-row tiles products); a warpgroup loads a
//     group's A registers once its last group is done (ptxas serializes
//     every product if an A register is written while one runs), and the
//     other warpgroup's products fill the tensor cores meanwhile.  A
//     projection block's stage 3 holds two accumulators (y3 and the
//     projection), so its passes are 64 wide;
//   - the weights are the packed copy ops/resblock.py makes once
//     (pack_bottleneck): per pass of 128 (or 64) columns, each 16-row K
//     slice is one contiguous run in the descriptors' order, so a pass's
//     64-row K chunks follow one another in memory.  One producer thread
//     (of a producer warpgroup that hands its registers to the consumers:
//     see kThreads) fills a ring of 2-4 entries on full/empty mbarriers.
//     In stage 1 and the projection an entry holds one chunk of weights (a
//     bulk copy) and the chunk's 64 channels of x on the tile's halo: one
//     TMA tensor copy whose pixels outside the image arrive as zeros, in
//     the 128-byte swizzle that puts the 8 rows of an ldmatrix phase on
//     distinct banks.  In the 3x3 and the expand an entry holds up to 4
//     chunks of weights, one bulk copy.  The ring runs ahead across passes,
//     stages and tiles;
//   - y1 and y2 rows of Cm bf16 are swizzled in 16-byte chunks (chunk c of
//     row r at c ^ (r & 7)) for the same reason;
//   - where the tiles outnumber the SMs, blocks are persistent, one per SM,
//     each walking tiles b, b + gridDim.x, ...: the ring runs on from one
//     tile to the next, so the next tile's first loads overlap this tile's
//     epilogues.  Where 4 (or 2) blocks a tile fit the SMs (7^2 and 14^2
//     at batch 32), a cluster of that many blocks shares one tile: each
//     block computes its share of the passes of every stage and writes its
//     y1 and y2 columns into the shared memory of every block of the
//     cluster (distributed shared memory), which then wait on an mbarrier
//     that every consumer thread of the cluster arrives on.
// Shared memory is (halo + 64 mt2) rows of Cm bf16 plus the ring.  A Cm too
// wide for that beside a 2-entry ring (the TPU kernel takes any width its
// VMEM holds) keeps y1 and y2 in global memory instead, in a scratch region
// of (halo + 64 mt2) x Cm bf16 per block that the wrapper allocates: each
// block of a persistent grid (one per SM, split 1) writes its tile's y1 and
// y2 there and loads its stage-2 and stage-3 A fragments back with plain
// 4-byte loads (the rows were just written by this block, so they are in L1
// or L2; the barrier between the stages orders the writes before the
// reads), and shared memory holds only the ring.  The shapes of
// VGGFace-ResNet50 (Cm <= 512) never take this path.  ops/resblock.py holds
// the limits and decides each launch (launch_plan: tile, ring entries,
// cluster size, grid, home of y1 and y2); the entry point below checks and
// follows it.

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKC = 64;                      // K rows of a chunk: 4 k16 steps
constexpr int kBChunk = 128 * kKC * 2;       // a chunk of a 128-column pass
constexpr int kMaxChunks = 4;                // weight chunks in one entry
constexpr int kMaxMT1 = 3;                   // 64-row tiles of stage 1
constexpr int kMaxMT2 = 2;                   // and of stages 2 and 3
constexpr int kMaxBox = 256;                 // a TMA box's extent
// Two consumer warpgroups and a producer warpgroup.  Three warps share
// each of the SM's four register files, which caps a thread at 168
// registers at launch (ptxas then serializes the products for want of
// registers); the producer hands its registers to the consumers
// (setmaxnreg: 24 a producer thread, 240 a consumer thread; 128 x 24 +
// 256 x 240 = 384 x 168).
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kMaxSlots = 4;                 // ring entries
constexpr int kMaxSmem = 232448;             // per block on H100

__host__ __device__ constexpr int align_up(int b, int a) {
  return (b + a - 1) / a * a;
}

// A tile of th x tw outputs: its halo row stride, halo rows (y1's rows),
// 64-row tiles of stage 1 and of stages 2-3, and the rows of x an entry
// holds (stage 1 reads 64 mt1, the projection up to 64 mt2 + hs).
struct Geom {
  int th, tw, hs, halo, mt1, mt2, xrows;
};

__host__ __device__ inline Geom geom(int th, int tw) {
  Geom g;
  g.th = th;
  g.tw = tw;
  g.hs = tw + 2;
  g.halo = (th + 2) * g.hs;
  g.mt1 = (g.halo + 63) / 64;
  g.mt2 = (th * g.hs + 63) / 64;
  const int proj_rows = 64 * g.mt2 + g.hs + 1;
  g.xrows = align_up(64 * g.mt1 > proj_rows ? 64 * g.mt1 : proj_rows, 8);
  return g;
}

// Shared memory from a 1024-byte aligned base: y1 (halo rows) and y2 (64
// mt2 rows) of Cm bf16 unless they are in global scratch, then the ring
// (an entry: one chunk of weights at 0 and its x at kBChunk, or up to
// kMaxChunks chunks of weights), then the barriers; 1024 bytes more for
// the alignment.  A 3x3 row past the tile's reads y1 rows past the halo:
// they lie in y2, which follows, and feed dropped rows only.
struct Smem {
  int y2_at, ring_at, entry, bars_at, total;
};

__host__ __device__ inline Smem smem_plan(int cm, const Geom& g, int slots,
                                          bool global_act) {
  Smem m;
  m.y2_at = global_act ? 0 : align_up(g.halo * cm * 2, 128);
  m.ring_at = global_act ? 0 : align_up(m.y2_at + 64 * g.mt2 * cm * 2, 1024);
  m.entry = align_up(kBChunk + g.xrows * 128, 1024);
  m.bars_at = m.ring_at + slots * m.entry;
  m.total = m.bars_at + 8 * (2 * kMaxSlots + 2) + 1024;
  return m;
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

// Barrier among the consumer warps only (the producer runs ahead).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
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

// TMA tensor copy of x's box at (channel c, column px, row py, image img):
// 64 channels of the tile's halo, pixels outside the image as zeros.
__device__ __forceinline__ void tma_halo(uint32_t dst, const CUtensorMap* map,
                                         int c, int px, int py, int img,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(px), "r"(py),
      "r"(img), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Shared-memory descriptor of a K-major B operand without swizzle: 8-row x
// 16-byte core matrices of 128 contiguous bytes, the two 8-element halves
// of the 16-deep K slice 128 bytes apart (leading offset), consecutive
// 8-row groups 256 bytes apart (stride offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// wgmma m64nNk16 bf16 x bf16 -> f32, A from registers (the mma.sync
// m16n8k16 A fragment of each warp's 16 rows), B through a descriptor:
// d += a * b.
__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Byte offset of 16-byte chunk c of row `row`: in a Cm-wide y1/y2 row
// (chunk c ^ (row & 7)), and in a 128-byte x row as the TMA's 128-byte
// swizzle lays it out from a 1024-byte aligned base (the same pattern).
__device__ __forceinline__ uint32_t act_off(int row, int c, int pitch) {
  return static_cast<uint32_t>(row * pitch + ((c ^ (row & 7)) << 4));
}

// scale * v + shift, rounded after the multiply and after the add.
__device__ __forceinline__ float affine(float v, float s, float b) {
  return __fadd_rn(__fmul_rn(v, s), b);
}

// Both rounded to nearest (one instruction).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 4 x 4 transpose across the 4 lanes of a quad (as in qconv.cu): on entry
// lane q holds v[j] = element (q, j); on exit v[j] = element (j, q).  With
// v[j] 8 consecutive channels' (16 bytes') pair j of n-block q, a lane ends
// up with its column pair of each of the 4 n-blocks.
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

struct Params {
  const __nv_bfloat16* x;
  int h, w, cin, cm, cout, tiles_x, tiles_per_img, tiles;
  Geom g;
  Smem sm;
  const __nv_bfloat16 *w1, *w3, *w2, *wp;    // packed (pack_bottleneck)
  const float *s1, *b1, *s2, *b2, *s3, *b3, *sp, *bp;
  __nv_bfloat16* out;
  __nv_bfloat16* act;   // global y1/y2 scratch, halo + 64 mt2 rows a block
  int slots, split;     // ring entries, cluster size
  int nb12, nb3;        // weight chunks an entry holds in stage 2, stage 3
};

// Where tile `tile` (image-major) starts.
struct Tile {
  int ty0, tx0, img;
  long long img_px;
};

__device__ __forceinline__ Tile tile_at(const Params& p, int tile) {
  const int img = tile / p.tiles_per_img;
  const int t = tile - img * p.tiles_per_img;
  return Tile{(t / p.tiles_x) * p.g.th, (t % p.tiles_x) * p.g.tw, img,
              static_cast<long long>(img) * p.h * p.w};
}

// Where a chunk's A rows come from: the ring entry's x (128-byte rows), y1
// / y2 in shared memory (Cm-wide rows) or in the block's global scratch.
enum ASource { kFromRing, kFromAct, kFromGlobal };

// k16 steps a commit group (a chunk's 4 in one group make ptxas serialize
// every product for want of registers, C7512, at any tile count).
constexpr int kGroupSteps = 2;

// A fragments of one commit group: [step][64-row tile][register].
template <int MT>
using AFrag = uint32_t[kGroupSteps][MT][4];

// wgmma reads its A registers after it is issued, until a wait retires
// it; the compiler knows nothing of that.  Placed after that wait, this
// keeps the registers the fragments' own from their loads to there.
template <int MT>
__device__ __forceinline__ void keep(AFrag<MT>& a) {
#pragma unroll
  for (int b = 0; b < kGroupSteps; ++b)
#pragma unroll
    for (int m = 0; m < MT; ++m)
      asm volatile("" : "+r"(a[b][m][0]), "+r"(a[b][m][1]), "+r"(a[b][m][2]),
                   "+r"(a[b][m][3])::"memory");
}

// A consumer thread's view of the block: addresses, its place, its passes,
// the tile, and where it is in the ring (entry, phase, the chunk within the
// entry and the entry's chunk count; held: the entry whose last products
// may still run, -1 if none).
struct Ctx {
  const Params& p;
  uint32_t y1s, y2s, ring, full, empty, ready;
  __nv_bfloat16 *gy1, *gy2;   // this block's y1 / y2 rows in global scratch
  int pitch, lane, wg, wq, gq, tq;
  int lo12, hi12, lo3, hi3;
  Tile tl;
  int slot, phase, u, cap, held;

  // Free the held entry (its products are done).
  __device__ void release() {
    if (held >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * held);
      held = -1;
    }
  }
  // Before a chunk's products: the chunk's entry has landed; `left` chunks
  // of the run remain, `nb` an entry.
  __device__ void begin(int left, int nb) {
    if (u == 0) {
      mbar_wait(full + 8 * slot, phase);
      cap = left < nb ? left : nb;
    }
  }
  // This warpgroup's products are all done: their A registers may be
  // reloaded (no A register is written while a product runs, which would
  // serialize them), the held entry freed.
  template <int MT>
  __device__ void retire(AFrag<MT>& a) {
    wgmma_wait<0>();
    keep(a);
    release();
  }
  __device__ uint32_t entry() const { return ring + slot * p.sm.entry; }
  __device__ void end() {
    if (++u == cap) {
      held = slot;
      u = 0;
      if (++slot == p.slots) slot = 0, phase ^= 1;
    }
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

// Two bf16 of the global scratch.  A plain load, not __ldg: this block
// wrote the rows during this launch.
__device__ __forceinline__ uint32_t ld_act(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One k16 step's A fragments: rows 64 m + 16 wq + (0..15) + shift of the
// source, K columns kcol + (0..15) (of the entry's 64 for the ring's x).
template <int MT, ASource SRC>
__device__ __forceinline__ void load_a(const Ctx& c, uint32_t (&a)[MT][4],
                                       uint32_t base,
                                       const __nv_bfloat16* g, int shift,
                                       int kcol) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if constexpr (SRC == kFromGlobal) {
      // The fragment ldmatrix would give: rows g and g + 8 of the 16,
      // columns 2 t4, + 1 of the slice's two 8-column halves.
      const int r0 = 64 * m + 16 * c.wq + c.gq + shift;
      const int k = kcol + 2 * c.tq;
      const __nv_bfloat16* lo = g + static_cast<long long>(r0) * c.p.cm + k;
      const __nv_bfloat16* hi = lo + 8LL * c.p.cm;
      a[m][0] = ld_act(lo);
      a[m][1] = ld_act(hi);
      a[m][2] = ld_act(lo + 8);
      a[m][3] = ld_act(hi + 8);
    } else {
      const int row = 64 * m + 16 * c.wq + (c.lane & 15) + shift;
      const int ch = kcol / 8 + (c.lane >> 4);
      ldsm_x4(base + act_off(row, ch, SRC == kFromRing ? 128 : c.pitch),
              a[m]);
    }
  }
}

// One chunk: acc[m] += A rows of 64-row tile m x this warpgroup's NW
// columns of the entry's weights, over its 64 K rows: commit groups of
// kGroupSteps k16 steps, the A registers of a group loaded once the last
// group is done.  The chunk's weights are 4 k16 slices of 2 NW columns,
// NW * 64 bytes apart; this warpgroup's columns start wg * NW * 32 bytes
// in.
template <int MT, int NW, ASource SRC>
__device__ __forceinline__ void chunk(Ctx& c, float (&acc)[MT][NW / 2],
                                      AFrag<MT>& a, int left, int nb,
                                      uint32_t abase,
                                      const __nv_bfloat16* g, int shift,
                                      int kcol) {
  c.begin(left, SRC == kFromRing ? 1 : nb);
  const uint32_t e = c.entry();
  const uint32_t b = e + c.u * (NW * 2) * kKC * 2 + c.wg * NW * 32;
  constexpr int kG = kGroupSteps;
#pragma unroll
  for (int s0 = 0; s0 < 4; s0 += kG) {
    c.retire<MT>(a);
#pragma unroll
    for (int s = s0; s < s0 + kG; ++s)
      load_a<MT, SRC>(c, a[s - s0], SRC == kFromRing ? e + kBChunk : abase,
                      g, shift, SRC == kFromRing ? 16 * s : kcol + 16 * s);
    wgmma_fence();
#pragma unroll
    for (int s = s0; s < s0 + kG; ++s)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if constexpr (NW == 64) {
          wgmma_n64(acc[m], a[s - s0][m], b_desc(b + s * NW * 64));
        } else {
          wgmma_n32(acc[m], a[s - s0][m], b_desc(b + s * NW * 64));
        }
      }
    wgmma_commit();
  }
  c.end();
}

template <int MT, int NW>
__device__ __forceinline__ void fence_acc(float (&acc)[MT][NW / 2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) fence_reg(acc[m][j]);
}

// The zeros stay before every product that follows: the compiler may not
// sink them among running products (which would serialize them).
template <int MT, int NW>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NW / 2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) acc[m][j] = 0.0f;
  fence_acc<MT, NW>(acc);
}

// Element (m, 4 j + 2 half + e) of a thread's accumulators sits at row
// 64 m + 16 wq + gq + 8 half, column 8 j + 2 tq + e of its warpgroup's NW.
__device__ __forceinline__ int acc_row(const Ctx& c, int m, int half) {
  return 64 * m + 16 * c.wq + c.gq + 8 * half;
}

// Stage 3's output pixel of flat row q of the tile (row q / hs, column
// q % hs): its index in x and out, or -1 if dropped or outside the image.
__device__ __forceinline__ long long out_pixel(const Ctx& c, int q) {
  const Geom& g = c.p.g;
  const int oy = q / g.hs, ox = q - oy * g.hs;
  if (oy >= g.th || ox >= g.tw || c.tl.ty0 + oy >= c.p.h ||
      c.tl.tx0 + ox >= c.p.w)
    return -1;
  return c.tl.img_px + static_cast<long long>(c.tl.ty0 + oy) * c.p.w +
         c.tl.tx0 + ox;
}

// Stage 1: y1 on the halo, A = the ring's x.
template <int MT, int NW, bool GACT>
__device__ __forceinline__ void stage1(Ctx& c) {
  const Params& p = c.p;
  float acc[MT][NW / 2];
  AFrag<MT> a;
  const int chunks = p.cin / kKC;
  for (int pass = c.lo12; pass < c.hi12; ++pass) {
    zero_acc<MT, NW>(acc);
    for (int k = 0; k < chunks; ++k)
      chunk<MT, NW, kFromRing>(c, acc, a, chunks - k, 1, 0, nullptr, 0, 0);
    c.retire<MT>(a);
    fence_acc<MT, NW>(acc);
    const int col0 = pass * 2 * NW + c.wg * NW;
    // This thread's rows: inside the halo, and their pixels in the image.
    bool stored[MT][2], inside[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = acc_row(c, m, half);
        const int hy = r / p.g.hs, hx = r - hy * p.g.hs;
        const int py = c.tl.ty0 - 1 + hy, px = c.tl.tx0 - 1 + hx;
        stored[m][half] = r < p.g.halo;
        inside[m][half] = py >= 0 && py < p.h && px >= 0 && px < p.w;
      }
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = col0 + 8 * j + 2 * c.tq;
      const float2 sc = __ldg(reinterpret_cast<const float2*>(p.s1 + col));
      const float2 sh = __ldg(reinterpret_cast<const float2*>(p.b1 + col));
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (!stored[m][half]) continue;
          const int r = acc_row(c, m, half);
          const bool valid = inside[m][half];
          const float v0 = acc[m][4 * j + 2 * half];
          const float v1 = acc[m][4 * j + 2 * half + 1];
          const uint32_t o = pack_bf16(
              valid ? fmaxf(affine(v0, sc.x, sh.x), 0.0f) : 0.0f,
              valid ? fmaxf(affine(v1, sc.y, sh.y), 0.0f) : 0.0f);
          if constexpr (GACT) {
            *reinterpret_cast<uint32_t*>(
                c.gy1 + static_cast<long long>(r) * p.cm + col) = o;
          } else {
            c.put(c.y1s, act_off(r, col / 8, c.pitch) + (col % 8) * 2, o);
          }
        }
    }
  }
}

// Stage 2: the 3x3 as 9 shifted products over y1, y2 on the tile's flat
// rows (a dropped row's y2 is stored too and read by no kept output).
template <int MT, int NW, bool GACT>
__device__ __forceinline__ void stage2(Ctx& c) {
  const Params& p = c.p;
  constexpr ASource kSrc = GACT ? kFromGlobal : kFromAct;
  float acc[MT][NW / 2];
  AFrag<MT> a;
  const int per_tap = p.cm / kKC, chunks = 9 * per_tap;
  for (int pass = c.lo12; pass < c.hi12; ++pass) {
    const int col0 = pass * 2 * NW + c.wg * NW;
    // The epilogue's scales and shifts, loaded under the products.
    float2 sc[NW / 8], sh[NW / 8];
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = col0 + 8 * j + 2 * c.tq;
      sc[j] = __ldg(reinterpret_cast<const float2*>(p.s2 + col));
      sh[j] = __ldg(reinterpret_cast<const float2*>(p.b2 + col));
    }
    zero_acc<MT, NW>(acc);
    int k = 0;
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * p.g.hs + tap % 3;
      for (int kc = 0; kc < per_tap; ++kc, ++k)
        chunk<MT, NW, kSrc>(c, acc, a, chunks - k, p.nb12, c.y1s, c.gy1,
                            shift, kc * kKC);
    }
    c.retire<MT>(a);
    fence_acc<MT, NW>(acc);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = col0 + 8 * j + 2 * c.tq;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = acc_row(c, m, half);
          const uint32_t o = pack_bf16(
              fmaxf(affine(acc[m][4 * j + 2 * half], sc[j].x, sh[j].x), 0.0f),
              fmaxf(affine(acc[m][4 * j + 2 * half + 1], sc[j].y, sh[j].y),
                    0.0f));
          if constexpr (GACT) {
            *reinterpret_cast<uint32_t*>(
                c.gy2 + static_cast<long long>(q) * p.cm + col) = o;
          } else {
            c.put(c.y2s, act_off(q, col / 8, c.pitch) + (col % 8) * 2, o);
          }
        }
    }
  }
}

// Stage 3: the 1x1 expand over y2, then the projection over the ring's x
// at the tap-centre offset hs + 1 (or the identity shortcut, read from x
// into registers as 16-byte runs before the pass's products), the sum and
// its ReLU stored as 16-byte runs after a quad transpose; a projection
// block stores 2 bf16 a thread and column block (measured faster there).
template <int MT, int NW, bool PROJ, bool GACT>
__device__ __forceinline__ void stage3(Ctx& c) {
  const Params& p = c.p;
  constexpr ASource kSrc = GACT ? kFromGlobal : kFromAct;
  constexpr int kNB = NW / 8;                 // n-blocks of 8 columns
  float acc[MT][NW / 2];
  float accp[PROJ ? MT : 1][NW / 2];          // the projection's x . Wp
  uint32_t xs[PROJ ? 1 : MT][2][kNB];         // the identity shortcut
  AFrag<MT> a;
  const int chunks = p.cm / kKC, pchunks = p.cin / kKC;
  for (int pass = c.lo3; pass < c.hi3; ++pass) {
    const int col0 = pass * 2 * NW + c.wg * NW;
    zero_acc<MT, NW>(acc);
    if constexpr (PROJ) {
      zero_acc<MT, NW>(accp);
    } else {
      // x at this thread's output rows, loaded before the products so that
      // their latency hides under them (0 where dropped): 16 bytes of
      // n-block 4 grp + tq a lane, moved to the accumulators' layout (a
      // column pair of each n-block) after the products.
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long px = out_pixel(c, acc_row(c, m, half));
#pragma unroll
          for (int grp = 0; grp < kNB / 4; ++grp) {
            uint4 v4 = make_uint4(0, 0, 0, 0);
            if (px >= 0)
              v4 = __ldg(reinterpret_cast<const uint4*>(
                  p.x + px * p.cin + col0 + (4 * grp + c.tq) * 8));
            xs[m][half][4 * grp] = v4.x;
            xs[m][half][4 * grp + 1] = v4.y;
            xs[m][half][4 * grp + 2] = v4.z;
            xs[m][half][4 * grp + 3] = v4.w;
          }
        }
    }
    for (int k = 0; k < chunks; ++k)
      chunk<MT, NW, kSrc>(c, acc, a, chunks - k, p.nb3, c.y2s, c.gy2, 0,
                          k * kKC);
    if constexpr (PROJ) {
      for (int k = 0; k < pchunks; ++k)
        chunk<MT, NW, kFromRing>(c, accp, a, pchunks - k, 1, 0, nullptr,
                                 p.g.hs + 1, 0);
    }
    c.retire<MT>(a);
    fence_acc<MT, NW>(acc);
    if constexpr (PROJ) fence_acc<MT, NW>(accp);
    long long px[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        px[m][half] = out_pixel(c, acc_row(c, m, half));
    if constexpr (!PROJ) {
      // Each 4 n-blocks: the shortcut to the accumulators' layout, the sum,
      // and back to 16-byte runs of one n-block a lane for the stores.
#pragma unroll
      for (int grp = 0; grp < kNB / 4; ++grp) {
        float2 sc[4], sh[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int col = col0 + 8 * (4 * grp + jj) + 2 * c.tq;
          sc[jj] = __ldg(reinterpret_cast<const float2*>(p.s3 + col));
          sh[jj] = __ldg(reinterpret_cast<const float2*>(p.b3 + col));
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t v[4] = {xs[m][half][4 * grp], xs[m][half][4 * grp + 1],
                             xs[m][half][4 * grp + 2],
                             xs[m][half][4 * grp + 3]};
            quad_transpose(v, c.tq);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = 4 * grp + jj;
              __nv_bfloat162 xv;
              *reinterpret_cast<uint32_t*>(&xv) = v[jj];
              const float y0 =
                  affine(acc[m][4 * j + 2 * half], sc[jj].x, sh[jj].x);
              const float y1 =
                  affine(acc[m][4 * j + 2 * half + 1], sc[jj].y, sh[jj].y);
              v[jj] = pack_bf16(
                  fmaxf(__fadd_rn(y0, __bfloat162float(xv.x)), 0.0f),
                  fmaxf(__fadd_rn(y1, __bfloat162float(xv.y)), 0.0f));
            }
            quad_transpose(v, c.tq);
            if (px[m][half] >= 0)
              *reinterpret_cast<uint4*>(p.out + px[m][half] * p.cout +
                                        col0 + (4 * grp + c.tq) * 8) =
                  make_uint4(v[0], v[1], v[2], v[3]);
          }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const int col = col0 + 8 * j + 2 * c.tq;
        const float2 sc = __ldg(reinterpret_cast<const float2*>(p.s3 + col));
        const float2 sh = __ldg(reinterpret_cast<const float2*>(p.b3 + col));
        const float2 pk = __ldg(reinterpret_cast<const float2*>(p.sp + col));
        const float2 pb = __ldg(reinterpret_cast<const float2*>(p.bp + col));
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float y0 = affine(acc[m][4 * j + 2 * half], sc.x, sh.x);
            const float y1 =
                affine(acc[m][4 * j + 2 * half + 1], sc.y, sh.y);
            const float c0 = affine(accp[m][4 * j + 2 * half], pk.x, pb.x);
            const float c1 =
                affine(accp[m][4 * j + 2 * half + 1], pk.y, pb.y);
            if (px[m][half] >= 0)
              *reinterpret_cast<uint32_t*>(p.out + px[m][half] * p.cout +
                                           col) =
                  pack_bf16(fmaxf(__fadd_rn(y0, c0), 0.0f),
                            fmaxf(__fadd_rn(y1, c1), 0.0f));
          }
      }
    }
  }
}

// Stages 2 and 3 of one tile on MT2 64-row tiles.
template <int MT2, int NW12, int NW3, bool PROJ, bool GACT>
__device__ __forceinline__ void stages23(Ctx& c) {
  stage2<MT2, NW12, GACT>(c);
  c.stage_done(1);
  stage3<MT2, NW3, PROJ, GACT>(c);
}

// NW12, NW3: a warpgroup's columns of a pass in stages 1-2 and in stage 3
// (64, or 32 for a 64-wide matrix and for a projection block's stage 3,
// whose two accumulators would not fit the registers at 64).  GACT: y1 and y2 in the global scratch
// p.act (a Cm too wide for shared memory); otherwise in shared memory.
template <bool PROJ, int NW12, int NW3, bool GACT>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = sbase + p.sm.ring_at;
  const uint32_t bars = sbase + p.sm.bars_at;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // Block b walks tiles b, b + gridDim.x, ... (one of them unless the
  // launch is persistent).  A cluster of split blocks shares one tile (and
  // then there is one tile per cluster).
  const int rank = p.split > 1 ? cluster_rank() : 0;
  const int tile0 = blockIdx.x / p.split;
  const int tile_step = gridDim.x / p.split;
  const int np12 = 2 * NW12, np3 = 2 * NW3;
  const int per12 = p.cm / np12 / p.split;   // this block's passes
  const int per3 = p.cout / np3 / p.split;
  const int lo12 = rank * per12, hi12 = lo12 + per12;
  const int lo3 = rank * per3, hi3 = lo3 + per3;

  // full[s]: the producer's expect-tx arrival; empty[s]: one arrival per
  // consumer warp; ready[0], ready[1] (y1, y2 complete; clusters only):
  // one arrival per consumer thread of the cluster.
  const uint32_t full = bars;
  const uint32_t empty = bars + 8 * kMaxSlots;
  const uint32_t ready = bars + 16 * kMaxSlots;
  if (tid == 0) {
    for (int i = 0; i < kMaxSlots; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers / 32);
    }
    mbar_init(ready, p.split * kConsumers);
    mbar_init(ready + 8, p.split * kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // No block of a cluster writes another's shared memory before all have
  // set up their barriers.
  if (p.split > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }

  if (warp >= kConsumers / 32) {
    // Producer: the chunks of each tile in the consumers' order, each run
    // (a pass of a stage) cut into entries: one chunk and its x (stage 1,
    // the projection), else up to nb chunks, one bulk copy; an entry goes
    // to slot i % S once the consumers have freed the entry S before it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kConsumers / 32 || lane != 0) return;
    const int S = p.slots;
    const uint32_t xbytes = p.g.halo * 128;
    int slot = 0, phase = 0, i = 0;
    auto run = [&](const __nv_bfloat16* wts, int chunks, int np, bool with_x,
                   int nb, const Tile& tl) {
      const int cbytes = np * kKC * 2;
      for (int k = 0; k < chunks;) {
        const int m = with_x ? 1 : (chunks - k < nb ? chunks - k : nb);
        if (i >= S) mbar_wait(empty + 8 * slot, phase ^ 1);
        const uint32_t dst = ring + slot * p.sm.entry;
        mbar_expect(full + 8 * slot, m * cbytes + (with_x ? xbytes : 0));
        bulk_copy(dst, wts + static_cast<long long>(k) * (cbytes / 2),
                  m * cbytes, full + 8 * slot);
        if (with_x)
          tma_halo(dst + kBChunk, &xmap, k * kKC, tl.tx0 - 1, tl.ty0 - 1,
                   tl.img, full + 8 * slot);
        k += m;
        ++i;
        if (++slot == S) slot = 0, phase ^= 1;
      }
    };
    for (int tile = tile0; tile < p.tiles; tile += tile_step) {
      const Tile tl = tile_at(p, tile);
      for (int pass = lo12; pass < hi12; ++pass)
        run(p.w1 + static_cast<long long>(pass) * p.cin * np12,
            p.cin / kKC, np12, true, 1, tl);
      for (int pass = lo12; pass < hi12; ++pass)
        run(p.w3 + static_cast<long long>(pass) * 9 * p.cm * np12,
            9 * p.cm / kKC, np12, false, p.nb12, tl);
      for (int pass = lo3; pass < hi3; ++pass) {
        run(p.w2 + static_cast<long long>(pass) * p.cm * np3, p.cm / kKC,
            np3, false, p.nb3, tl);
        if constexpr (PROJ)
          run(p.wp + static_cast<long long>(pass) * p.cin * np3,
              p.cin / kKC, np3, true, 1, tl);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  __nv_bfloat16* gy1 =
      GACT ? p.act + static_cast<long long>(blockIdx.x) *
                         (p.g.halo + 64 * p.g.mt2) * p.cm
           : nullptr;
  Ctx c{p,
        sbase,
        sbase + p.sm.y2_at,
        ring,
        full,
        empty,
        ready,
        gy1,
        GACT ? gy1 + static_cast<long long>(p.g.halo) * p.cm : nullptr,
        p.cm * 2,
        lane,
        warp >> 2,
        warp & 3,
        lane >> 2,
        lane & 3,
        lo12,
        hi12,
        lo3,
        hi3,
        Tile{0, 0, 0, 0},
        0,
        0,
        0,
        0,
        -1};
  // The ring runs on from one tile to the next.  y1 and y2 are rewritten
  // only after a barrier that every warp passes once done reading them:
  // y1 (read in stage 2) after the stage 2/3 barrier, y2 (read in stage
  // 3) after the next tile's stage 1/2 barrier.
  for (int tile = tile0; tile < p.tiles; tile += tile_step) {
    c.tl = tile_at(p, tile);
    if (p.g.mt1 == 1) {
      stage1<1, NW12, GACT>(c);
    } else if (p.g.mt1 == 2) {
      stage1<2, NW12, GACT>(c);
    } else {
      stage1<3, NW12, GACT>(c);
    }
    c.stage_done(0);
    if (p.g.mt2 == 1) {
      stages23<1, NW12, NW3, PROJ, GACT>(c);
    } else {
      stages23<2, NW12, NW3, PROJ, GACT>(c);
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
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t st = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t st = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (st == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

}  // namespace

// x (n, h, w, cin) and out (n, h, w, cout): bf16 NHWC, contiguous.  w1, w3,
// w2 and wp (null for the identity shortcut) are the packed copies of
// ops/resblock.py:pack_bottleneck; s*/b*: f32 folded BN.  act: null (y1
// and y2 in shared memory), or a bf16 scratch of blocks x (halo + 64 mt2)
// x cm for y1 and y2 (split 1).  slots (ring entries), split (blocks per
// tile, a cluster when > 1), blocks (the grid), th x tw (the tile) and
// act's use are ops/resblock.py:launch_plan's: the wrapper decides the
// launch and holds the limits (cin % 64, cm and cout 64 or a multiple of
// 128, identity needs cin == cout) and raises first; the checks here only
// keep a call that breaks them from reading or writing out of bounds.
// Returns cudaGetLastError() after the launch.
extern "C" int alink_bottleneck(const void* x, int n, int h, int w, int cin,
                                int cm, int cout, const void* w1,
                                const void* s1, const void* b1, const void* w3,
                                const void* s2, const void* b2, const void* w2,
                                const void* s3, const void* b3, const void* wp,
                                const void* sp, const void* bp, void* out,
                                void* act, int slots, int split, int blocks,
                                int th, int tw, void* stream) {
  auto width_ok = [](int c) { return c == 64 || (c > 0 && c % 128 == 0); };
  if (n < 0 || h <= 0 || w <= 0 || cin <= 0 || cin % kKC || !width_ok(cm) ||
      !width_ok(cout) || (wp == nullptr && cin != cout) || th < 1 ||
      tw < 1 || th > h || tw > w || th + 2 > kMaxBox || tw + 2 > kMaxBox) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geom g = geom(th, tw);
  const bool gact = act != nullptr;
  const Smem sm = smem_plan(cm, g, slots, gact);
  if (g.mt1 > kMaxMT1 || g.mt2 > kMaxMT2 || slots < 2 || slots > kMaxSlots ||
      sm.total > kMaxSmem || (gact && split != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_x = (w + tw - 1) / tw;
  const int tiles_per_img = tiles_x * ((h + th - 1) / th);
  const long long tiles = static_cast<long long>(n) * tiles_per_img;
  if (tiles == 0) return static_cast<int>(cudaGetLastError());
  // A cluster divides the passes of every stage among its blocks and
  // shares exactly one tile (its y1/y2 barriers complete once); a block of
  // its own walks tiles blockIdx.x, + blocks, ...
  // Pass widths: 128 (64 columns a warpgroup) or 64 (32): a 64-wide
  // matrix, and a projection block's stage 3.
  const int np12 = cm < 128 ? cm : 128;
  const int np3 = cout < 128 || wp != nullptr ? 64 : 128;
  const int passes12 = cm / np12, passes3 = cout / np3;
  if (tiles > (1LL << 30) ||
      !(split == 1 || split == 2 || split == 4) || passes12 % split ||
      passes3 % split || blocks < 1 ||
      (split > 1 && blocks != tiles * split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto chunks_per_entry = [&](int np) {
    const int k = sm.entry / (np * kKC * 2);
    return k < kMaxChunks ? k : kMaxChunks;
  };
  void (*kernel)(CUtensorMap, Params) = nullptr;
  const bool wide12 = np12 == 128, wide3 = np3 == 128;
  if (gact) {
    // Only a Cm past what shared memory holds takes global y1/y2: 128-wide
    // passes in stages 1 and 2.
    if (!wide12) return static_cast<int>(cudaErrorInvalidValue);
    if (wp != nullptr) {
      kernel = bottleneck_kernel<true, 64, 32, true>;
    } else {
      kernel = wide3 ? bottleneck_kernel<false, 64, 64, true>
                     : bottleneck_kernel<false, 64, 32, true>;
    }
  } else if (wp != nullptr) {
    kernel = wide12 ? bottleneck_kernel<true, 64, 32, false>
                    : bottleneck_kernel<true, 32, 32, false>;
  } else {
    kernel = wide12 ? (wide3 ? bottleneck_kernel<false, 64, 64, false>
                             : bottleneck_kernel<false, 64, 32, false>)
                    : (wide3 ? bottleneck_kernel<false, 32, 64, false>
                             : bottleneck_kernel<false, 32, 32, false>);
  }
  cudaError_t st = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm.total);
  if (st != cudaSuccess) return static_cast<int>(st);
  // x as a 4-D tensor (channel, column, row, image), read in boxes of 64
  // channels x the tile's halo with the 128-byte swizzle act_off reads.
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap xmap;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cin),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(cin) * 2,
                                 static_cast<cuuint64_t>(cin) * 2 * w,
                                 static_cast<cuuint64_t>(cin) * 2 * w * h};
  const cuuint32_t box[4] = {kKC, static_cast<cuuint32_t>(g.hs),
                             static_cast<cuuint32_t>(th + 2), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(x), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto bf = [](const void* v) { return static_cast<const __nv_bfloat16*>(v); };
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  Params p{bf(x), h, w, cin, cm, cout, tiles_x, tiles_per_img,
           static_cast<int>(tiles), g, sm,
           bf(w1), bf(w3), bf(w2), bf(wp),
           f(s1), f(b1), f(s2), f(b2), f(s3), f(b3), f(sp), f(bp),
           static_cast<__nv_bfloat16*>(out),
           static_cast<__nv_bfloat16*>(act), slots, split,
           chunks_per_entry(np12), chunks_per_entry(np3)};
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sm.total;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  st = cudaLaunchKernelEx(&cfg, kernel, xmap, p);
  if (st != cudaSuccess) return static_cast<int>(st);
  return static_cast<int>(cudaGetLastError());
}
