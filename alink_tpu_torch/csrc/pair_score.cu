// Fused all-pairs siamese scorer for Hopper (sm_90a).
//
// Replaces the TPU kernel alink_tpu/ops/pairwise.py:_fused_kernel (reached
// through score_matrix_pallas / score_matrix).  For row features L (N, D),
// column features R (M, D) and the two-hidden-layer head
//   |l_i - r_j| -> Dense(H1) relu -> Dense(H2) relu -> Dense(2)
// it writes P(genuine) = sigmoid(logit_1 - logit_0) for every pair (i, j),
// with the plain version's numerics (ops/pairwise.py:score_matrix_reference):
// |l - r| in f32 rounded to bf16, bf16 operands, f32 accumulation, the
// hidden layers rounded to bf16 after bias + relu.  Only the (N, M) f32
// scores leave the chip: the (N*M, D) differences and both hidden layers
// live in registers.
//
// Bound: the tensor cores.  The work is ~2*N*M*D*H1 operations (0.59 T for a
// 1000 x 1000 grid at D = H1 = 512) against ~4*(N + M)*D bytes read, far
// above the card's ~295 operations-per-byte ridge.  The design:
//   - a tile is 8 rows x 16 columns of pairs, 64 for each of two consumer
//     warpgroups, one wgmma m64nNk16 bf16 -> f32 product per 16 of D.  The
//     A operand (64 pairs x 16 of |l - r|) is built in registers by the
//     consumers from the f32 feature slabs in shared memory: each thread
//     owns 2 pairs that share a column, so 3 16-byte loads give its 8
//     differences (W1's rows are packed in the order that makes them one
//     fragment, ops/pairwise.py:_K_PERM), and the column rows a load phase
//     reads lie 4 rows apart, which the 128-byte swizzle puts in distinct
//     banks;
//   - one producer thread fills a ring of 2-8 stages on full/empty mbarriers:
//     per 64-deep D slab, the two feature tiles by TMA tensor copies (rows
//     past N or M and columns past D arrive as zeros: the ragged edges are
//     masked for free) and the slab of the pass's W1 columns by one bulk
//     copy (packed once per head, pack_head); per H1 pass, W2's rows of the
//     pass.  The consumers only wait, multiply and release, so copies run
//     ahead of the products.  The producer's warpgroup hands its registers
//     to the consumers (setmaxnreg: 232 a consumer thread, whose two
//     accumulators take up to 160);
//   - H1 runs in passes of np1 <= 256 columns (one warpgroup's accumulator
//     is np1 / 2 registers a thread).  A pass's relu(acc + b1), rounded to
//     bf16, is already in the register layout of wgmma's A operand: it is
//     multiplied by the pass's W2 rows without leaving registers, into a
//     layer-2 accumulator carried across passes (see below).  So H1 has
//     no limit; a wide H2 narrows the pass instead (ops/pairwise.py:
//     head_tiling);
//   - the epilogue adds b2, applies relu and the bf16 rounding, then does
//     the H2 x 2 output layer and the sigmoid in registers (a quad's lanes
//     hold a pair's columns: two shuffles), stages the tile's 128 scores in
//     shared memory and stores its rows as 64-byte runs;
//   - blocks are persistent (one per SM) and walk the tiles in bands of 8
//     row tiles, column by column, so the tiles in flight share a few
//     feature rows in L2.  The grid, ring depth and pass width come from
//     ops/pairwise.py:launch_plan, which the entry point checks;
//   - a head wider than 256 in H2 runs as chunks of at most 256 H2 columns,
//     one launch each (ops/pairwise.py:head_chunks): the output layer is
//     linear after the relu, so the logit difference is a sum over the
//     chunks.  `mode` says which chunk a launch is: 0 the only one (the
//     sigmoid in place), 1 the first (its logit difference, output bias
//     included, stored as is), 2 a middle one (added to what `out` holds),
//     3 the last (added, then the sigmoid).  Each chunk redoes layer 1;
//   - wgmma reads its A registers until a wait retires it: each product is
//     waited for (wait_group 1) before its registers are rebuilt, and kept
//     live until then (keep4());
//   - ptxas gives a thread 168 registers here, and serializes a wgmma
//     whose accumulator does not fit.  So each pass's first product writes
//     its accumulator without reading it (wgmma_first: acc1 is dead during
//     layer 2), and with 256-wide passes acc2 waits out each later pass's
//     layer 1 in shared memory: acc1 (128), the A fragments and their
//     addresses fit.

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTI = 8;                    // rows per tile
constexpr int kTJ = 16;                   // columns per tile
constexpr int kKS = 64;                   // D slab per ring stage
constexpr int kBoxCols = 32;              // f32 per TMA box row: 128 bytes
constexpr int kLBox = kTI * kBoxCols * 4;
constexpr int kRBox = kTJ * kBoxCols * 4;
constexpr int kFeatBytes = 2 * (kLBox + kRBox);
constexpr int kConsumers = 256;           // two warpgroups of 64 pairs
constexpr int kThreads = kConsumers + 128; // and a producer warpgroup
// Registers a thread after setmaxnreg.  The launch gives every thread 168
// (65,536 / 384, rounded down to 8), and setmaxnreg.inc waits for
// registers that the block's own setmaxnreg.dec released: 256 x 232 +
// 128 x 40 = 384 x 168.  Asking for more never returns.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;          // per block on H100
constexpr int kScoreBytes = kTI * kTJ * 4;
constexpr int kBarBytes = 2 * 8 * kMaxStages;

// One ring stage: a D slab of both feature tiles and of W1's pass columns,
// or one pass of W2; 1024-byte aligned (the features' 128-byte swizzle).
__host__ __device__ constexpr int stage_bytes(int np1, int h2p) {
  return ((kFeatBytes + np1 * kKS * 2 > np1 * h2p * 2
               ? kFeatBytes + np1 * kKS * 2
               : np1 * h2p * 2) +
          1023) / 1024 * 1024;
}

// acc2's shared-memory stash between passes: with 256-wide passes only.
__host__ __device__ constexpr int stash_bytes(int np1, int h2p) {
  return np1 == 256 ? kConsumers * (h2p / 2) * 4 : 0;
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Walk position t -> (row tile, column tile): bands of `group` row tiles,
// column by column within a band (ops/pairwise.py:tile_coords).
__host__ __device__ inline void tile_coords(int t, int tiles_i, int tiles_j,
                                            int group, int& ti, int& tj) {
  const int per_band = group * tiles_j;
  const int band = t / per_band;
  const int rows = min(group, tiles_i - band * group);
  const int local = t - band * per_band;
  ti = band * group + local % rows;
  tj = local / rows;
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

// TMA tensor copy of the box at (column c0, row c1) of `map` (elements
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

// wgmma reads its A registers after it starts, until a wait retires
// it; the compiler knows nothing of that.  Placed after that wait, this
// keeps the registers the fragment's own from its writes to there.
__device__ __forceinline__ void keep4(uint32_t* a) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])::"memory");
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
// d = a * b + (scale_d ? d : 0); d is read, so it stays live before.
__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t* a,
                                          uint64_t desc, int scale_d) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
                                          uint64_t desc, int scale_d) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a,
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(float* d, const uint32_t* a,
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The same product with d written, not read (d = a * b): the accumulator is
// dead before it, so the compiler need not keep it live across other work.
__device__ __forceinline__ void wgmma_n32_first(float* d, const uint32_t* a,
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
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

__device__ __forceinline__ void wgmma_n64_first(float* d, const uint32_t* a,
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
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

__device__ __forceinline__ void wgmma_n128_first(float* d, const uint32_t* a,
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

__device__ __forceinline__ void wgmma_n256_first(float* d, const uint32_t* a,
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63]),
        "=f"(d[64]), "=f"(d[65]), "=f"(d[66]), "=f"(d[67]), "=f"(d[68]), "=f"(d[69]), "=f"(d[70]), "=f"(d[71]),
        "=f"(d[72]), "=f"(d[73]), "=f"(d[74]), "=f"(d[75]), "=f"(d[76]), "=f"(d[77]), "=f"(d[78]), "=f"(d[79]),
        "=f"(d[80]), "=f"(d[81]), "=f"(d[82]), "=f"(d[83]), "=f"(d[84]), "=f"(d[85]), "=f"(d[86]), "=f"(d[87]),
        "=f"(d[88]), "=f"(d[89]), "=f"(d[90]), "=f"(d[91]), "=f"(d[92]), "=f"(d[93]), "=f"(d[94]), "=f"(d[95]),
        "=f"(d[96]), "=f"(d[97]), "=f"(d[98]), "=f"(d[99]), "=f"(d[100]), "=f"(d[101]), "=f"(d[102]), "=f"(d[103]),
        "=f"(d[104]), "=f"(d[105]), "=f"(d[106]), "=f"(d[107]), "=f"(d[108]), "=f"(d[109]), "=f"(d[110]), "=f"(d[111]),
        "=f"(d[112]), "=f"(d[113]), "=f"(d[114]), "=f"(d[115]), "=f"(d[116]), "=f"(d[117]), "=f"(d[118]), "=f"(d[119]),
        "=f"(d[120]), "=f"(d[121]), "=f"(d[122]), "=f"(d[123]), "=f"(d[124]), "=f"(d[125]), "=f"(d[126]), "=f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc, int scale_d) {
  if constexpr (N == 256) {
    wgmma_n256(d, a, desc, scale_d);
  } else if constexpr (N == 128) {
    wgmma_n128(d, a, desc, scale_d);
  } else if constexpr (N == 64) {
    wgmma_n64(d, a, desc, scale_d);
  } else {
    wgmma_n32(d, a, desc, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_first(float* d, const uint32_t* a,
                                            uint64_t desc) {
  if constexpr (N == 256) {
    wgmma_n256_first(d, a, desc);
  } else if constexpr (N == 128) {
    wgmma_n128_first(d, a, desc);
  } else if constexpr (N == 64) {
    wgmma_n64_first(d, a, desc);
  } else {
    wgmma_n32_first(d, a, desc);
  }
}

// bf16x2 of |l0 - r0| (low half) and |l1 - r1|: differences in f32, each
// rounded to bf16.
__device__ __forceinline__ uint32_t absdiff2(float l0, float r0, float l1,
                                             float r1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(fabsf(__fsub_rn(l0, r0)),
                                           fabsf(__fsub_rn(l1, r1)));
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16x2 of relu(x) (low half) and relu(y).
__device__ __forceinline__ uint32_t relu2(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(x, 0.0f), fmaxf(y, 0.0f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of 16-byte chunk c of row `row` in a TMA box of 128-byte rows
// with the 128-byte swizzle.
__device__ __forceinline__ int swz(int row, int c) {
  return row * 128 + ((c ^ (row & 7)) << 4);
}

template <int NP1, int H2P>
__global__ void __launch_bounds__(kThreads, 1)
pair_score_kernel(const __grid_constant__ CUtensorMap lmap,
                  const __grid_constant__ CUtensorMap rmap, int n, int m,
                  int nslab, int passes, int tiles_i, int tiles_j, int group,
                  int stages, const __nv_bfloat16* __restrict__ w1,
                  const float* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ wo,
                  const float* __restrict__ bo, float* __restrict__ out,
                  int mode) {
  constexpr int kW1 = NP1 * kKS * 2;     // bytes of one slab of W1's pass
  constexpr int kW2 = NP1 * H2P * 2;     // bytes of one pass of W2
  constexpr int kStage = stage_bytes(NP1, H2P);
  constexpr bool kStash = stash_bytes(NP1, H2P) > 0;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  float* scores = reinterpret_cast<float*>(smem + stages * kStage);
  // full[s] (the producer's expect-tx arrival), empty[s] (one arrival per
  // consumer warp).
  const uint32_t full = sbase + stages * kStage + kScoreBytes;
  const uint32_t empty = full + 8 * kMaxStages;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tiles = tiles_i * tiles_j;

  if (tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // Producer: for each tile, pass and slab, once the consumers released
    // the slot: the slab of both feature tiles (two 32-column boxes each)
    // and of the pass's W1 columns; after a pass's slabs, its W2 rows.
    // One thread starts every copy; its warpgroup gives up its registers
    // to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kConsumers / 32 || lane != 0) return;
    int slot = 0, phase = 0, i = 0;
    auto acquire = [&]() {
      if (i >= stages) mbar_wait(empty + 8 * slot, phase ^ 1);
      return sbase + slot * kStage;
    };
    auto advance = [&]() {
      ++i;
      if (++slot == stages) slot = 0, phase ^= 1;
    };
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int ti, tj;
      tile_coords(t, tiles_i, tiles_j, group, ti, tj);
      for (int p = 0; p < passes; ++p) {
        for (int k = 0; k < nslab; ++k) {
          const uint32_t st = acquire();
          const uint32_t bar = full + 8 * slot;
          mbar_expect(bar, kFeatBytes + kW1);
          for (int b = 0; b < 2; ++b) {
            tma_box(st + b * kLBox, &lmap, k * kKS + b * kBoxCols, ti * kTI,
                    bar);
            tma_box(st + 2 * kLBox + b * kRBox, &rmap,
                    k * kKS + b * kBoxCols, tj * kTJ, bar);
          }
          bulk_copy(st + kFeatBytes,
                    w1 + (static_cast<long long>(p) * nslab + k) * (kW1 / 2),
                    kW1, bar);
          advance();
        }
        const uint32_t st = acquire();
        mbar_expect(full + 8 * slot, kW2);
        bulk_copy(st, w2 + static_cast<long long>(p) * (kW2 / 2), kW2,
                  full + 8 * slot);
        advance();
      }
    }
    return;
  }

  // Consumer warpgroup wg owns tile rows 4 wg .. 4 wg + 3; warp q of it
  // columns q, q + 4, q + 8, q + 12.  Fragment row f of the warp is pair
  // (4 wg + f / 4, q + 4 (f % 4)): lane (g, t4) holds rows g and g + 8,
  // which share column jr, at tile rows il1 and il1 + 2.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int q = warp & 3;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int il1 = 4 * wg + (g >> 2);
  const int il2 = il1 + 2;
  const int jr = q + 4 * (g & 3);

  float acc1[NP1 / 2];
  float acc2[H2P / 2];
  uint32_t a[2][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) a[0][e] = a[1][e] = 0;
  // With 256-wide passes, acc2 waits out each later pass's layer 1 in
  // shared memory ([register][thread]), so that acc1, the A fragments and
  // their addresses alone fill the registers there.
  float* stash = reinterpret_cast<float*>(smem + stages * kStage +
                                          kScoreBytes + kBarBytes);
  int cs = 0, cphase = 0;
  auto next_slot = [&]() {
    if (++cs == stages) cs = 0, cphase ^= 1;
  };
  auto release = [&](int slot) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
  };

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int ti, tj;
    tile_coords(t, tiles_i, tiles_j, group, ti, tj);
    for (int p = 0; p < passes; ++p) {
      // ---- layer 1 over D: acc1 = |l - r| (bf16) . W1[:, pass] --------
      int held = -1;   // the slot whose products may still run
      // One 64-deep slab; the pass's first product writes acc1 (FIRST).
      auto slab = [&](auto first) {
        mbar_wait(full + 8 * cs, cphase);
        const unsigned char* st = smem + cs * kStage;
        const uint32_t wb = sbase + cs * kStage + kFeatBytes;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          // k16 slice s: box s / 2, chunks 4 (s % 2) .. + 3; this lane's
          // chunk holds its 4 features of the slice.
          const int c = 4 * (s & 1) + t4;
          const unsigned char* lb = st + (s >> 1) * kLBox;
          const unsigned char* rb = st + 2 * kLBox + (s >> 1) * kRBox;
          const float4 l1 = *reinterpret_cast<const float4*>(lb + swz(il1, c));
          const float4 l2 = *reinterpret_cast<const float4*>(lb + swz(il2, c));
          const float4 r = *reinterpret_cast<const float4*>(rb + swz(jr, c));
          uint32_t* A = a[s & 1];
          A[0] = absdiff2(l1.x, r.x, l1.y, r.y);
          A[1] = absdiff2(l2.x, r.x, l2.y, r.y);
          A[2] = absdiff2(l1.z, r.z, l1.w, r.w);
          A[3] = absdiff2(l2.z, r.z, l2.w, r.w);
          wgmma_fence();
          if (decltype(first)::value && s == 0) {
            wgmma_first<NP1>(acc1, A, b_desc(wb));
          } else {
            wgmma_rs<NP1>(acc1, A, b_desc(wb + s * NP1 * 32), 1);
          }
          wgmma_commit();
          // The previous product is done: its registers may be rebuilt,
          // and after the first slice the previous slab's slot is free.
          wgmma_wait<1>();
          keep4(a[(s + 1) & 1]);
          if (s == 0 && held >= 0) {
            release(held);
            held = -1;
          }
        }
        held = cs;
        next_slot();
      };
      slab(Flag<true>{});
      for (int k = 1; k < nslab; ++k) slab(Flag<false>{});
      wgmma_wait<0>();
      keep4(a[0]);
      keep4(a[1]);
      release(held);
#pragma unroll
      for (int j = 0; j < NP1 / 2; ++j) fence_reg(acc1[j]);

      // ---- bias + relu -> bf16: already the A fragments of layer 2 -----
      // n-block nb of acc1 holds rows g / g + 8, columns 8 nb + 2 t4, + 1;
      // k16 slice s2 of layer 2 takes n-blocks 2 s2 and 2 s2 + 1.
      uint32_t h[NP1 / 4];
#pragma unroll
      for (int nb = 0; nb < NP1 / 8; ++nb) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(
            b1 + p * NP1 + nb * 8 + 2 * t4));
        h[2 * nb] = relu2(__fadd_rn(acc1[4 * nb], bb.x),
                          __fadd_rn(acc1[4 * nb + 1], bb.y));
        h[2 * nb + 1] = relu2(__fadd_rn(acc1[4 * nb + 2], bb.x),
                              __fadd_rn(acc1[4 * nb + 3], bb.y));
      }

      // ---- layer 2: acc2 (+)= hidden 1 (bf16) . W2[pass rows, :] -------
      mbar_wait(full + 8 * cs, cphase);
      const uint32_t w2b = sbase + cs * kStage;
      if (p == 0) {
        wgmma_fence();
        wgmma_first<H2P>(acc2, &h[0], b_desc(w2b));
      } else {
        if constexpr (kStash) {
#pragma unroll
          for (int j = 0; j < H2P / 2; ++j) {
            acc2[j] = stash[j * kConsumers + tid];
          }
        }
        wgmma_fence();
        wgmma_rs<H2P>(acc2, &h[0], b_desc(w2b), 1);
      }
#pragma unroll
      for (int s2 = 1; s2 < NP1 / 16; ++s2) {
        wgmma_rs<H2P>(acc2, &h[4 * s2], b_desc(w2b + s2 * H2P * 32), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int s2 = 0; s2 < NP1 / 16; ++s2) keep4(&h[4 * s2]);
      release(cs);
      next_slot();
      if constexpr (kStash) {
        if (p + 1 < passes) {
#pragma unroll
          for (int j = 0; j < H2P / 2; ++j) {
            fence_reg(acc2[j]);
            stash[j * kConsumers + tid] = acc2[j];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < H2P / 2; ++j) fence_reg(acc2[j]);

    // ---- bias + relu -> bf16, output layer, sigmoid -------------------
    float lg[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};   // [row g / g + 8][logit]
#pragma unroll
    for (int nb = 0; nb < H2P / 8; ++nb) {
      const int col = nb * 8 + 2 * t4;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + col));
      // wo[col][0], wo[col][1], wo[col + 1][0], wo[col + 1][1]
      const float4 w = __ldg(reinterpret_cast<const float4*>(wo + 2 * col));
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float h0 = __bfloat162float(__float2bfloat16_rn(
            fmaxf(__fadd_rn(acc2[4 * nb + 2 * hf], bb.x), 0.0f)));
        const float h1 = __bfloat162float(__float2bfloat16_rn(
            fmaxf(__fadd_rn(acc2[4 * nb + 2 * hf + 1], bb.y), 0.0f)));
        lg[hf][0] = fmaf(h1, w.z, fmaf(h0, w.x, lg[hf][0]));
        lg[hf][1] = fmaf(h1, w.w, fmaf(h0, w.y, lg[hf][1]));
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        lg[hf][o] += __shfl_xor_sync(0xffffffffu, lg[hf][o], 1);
        lg[hf][o] += __shfl_xor_sync(0xffffffffu, lg[hf][o], 2);
      }
    }
    if (t4 == 0) {
      const float bo0 = __ldg(bo), bo1 = __ldg(bo + 1);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float z = (lg[hf][0] + bo0) - (lg[hf][1] + bo1);
        scores[(hf ? il2 : il1) * kTJ + jr] =
            mode == 0 ? 1.0f / (1.0f + expf(z)) : z;
      }
    }
    // The warpgroup's 4 x 16 scores leave as rows of 64 bytes.
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    const int e = tid - 128 * wg;
    if (e < 4 * kTJ) {
      const int il = 4 * wg + e / kTJ, jl = e % kTJ;
      const int i = ti * kTI + il, j = tj * kTJ + jl;
      if (i < n && j < m) {
        const long long o = static_cast<long long>(i) * m + j;
        float v = scores[il * kTJ + jl];
        if (mode >= 2) v += out[o];   // the earlier chunks' logit difference
        if (mode == 3) v = 1.0f / (1.0f + expf(v));
        out[o] = v;
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (no link against libcuda).
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

// A (rows, d) f32 feature matrix read in boxes of `box_rows` rows x 32
// columns (128 bytes) with the 128-byte swizzle swz() reads.
bool feature_map(CUtensorMap* map, EncodeTiled encode, const void* x,
                 int rows, int d, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 4};
  const cuuint32_t box[2] = {kBoxCols, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(x),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NP1, int H2P>
int launch(const void* rows, const void* cols, int n, int m, int d,
           const void* w1, const void* b1, int h1p, const void* w2,
           const void* b2, const void* wo, const void* bo, void* out,
           int stages, int grid, int group, int tiles_i, int tiles_j,
           int mode, cudaStream_t stream) {
  const int smem = stages * stage_bytes(NP1, H2P) + kScoreBytes + kBarBytes +
                   stash_bytes(NP1, H2P);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pair_score_kernel<NP1, H2P>;
  cudaError_t st = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (st != cudaSuccess) return static_cast<int>(st);
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap lmap, rmap;
  if (!feature_map(&lmap, encode, rows, n, d, kTI) ||
      !feature_map(&rmap, encode, cols, m, d, kTJ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      lmap, rmap, n, m, (d + kKS - 1) / kKS, h1p / NP1, tiles_i, tiles_j,
      group, stages, static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(wo),
      static_cast<const float*>(bo), static_cast<float*>(out), mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows (n, d), cols (m, d): f32, 16-byte aligned, d % 4 == 0 (TMA rows).
// From ops/pairwise.py:pack_head: w1 (h1p / np1, ceil(d / 64), 4, np1 / 8,
// 2, 8, 8) and w2 (h1p / np1, np1 / 16, h2p / 8, 2, 8, 8) bf16, b1 (h1p),
// b2 (h2p), wo (h2p, 2) bf16-rounded, bo (2): f32.  out (n, m) f32.  np1,
// stages, grid and group are ops/pairwise.py:launch_plan's: the wrapper
// decides the launch; this checks that the pass and H2 widths are ones the
// kernel is built for, that the ring fits and that the grid walks every
// tile.  mode: 0 a whole head, 1-3 the first, a middle and the last chunk
// of a head split in H2 (ops/pairwise.py:head_chunks; modes 2 and 3 read
// `out` as the earlier chunks left it).  Returns cudaGetLastError() after
// the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take (the
// wrapper raises first).
extern "C" int alink_pair_score(const void* rows, const void* cols, int n,
                                int m, int d, const void* w1, const void* b1,
                                int h1p, const void* w2, const void* b2,
                                int h2p, const void* wo, const void* bo,
                                void* out, int np1, int stages, int grid,
                                int group, int mode, void* stream) {
  if (n < 0 || m < 0 || d <= 0 || d % 4 || mode < 0 || mode > 3 ||
      reinterpret_cast<uintptr_t>(rows) % 16 ||
      reinterpret_cast<uintptr_t>(cols) % 16 || np1 <= 0 || h1p <= 0 ||
      h1p % np1 || stages < 2 || stages > kMaxStages || group < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || m == 0) return static_cast<int>(cudaGetLastError());
  const long long tiles_i = (n + kTI - 1) / kTI;
  const long long tiles_j = (m + kTJ - 1) / kTJ;
  if (tiles_i * tiles_j >= (1LL << 31) || grid < 1 || grid > tiles_i * tiles_j) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int ti = static_cast<int>(tiles_i), tj = static_cast<int>(tiles_j);
#define ALINK_PAIR_LAUNCH(NP, HP)                                            \
  if (np1 == NP && h2p == HP)                                                \
    return launch<NP, HP>(rows, cols, n, m, d, w1, b1, h1p, w2, b2, wo, bo,  \
                          out, stages, grid, group, ti, tj, mode, s);
  ALINK_PAIR_LAUNCH(256, 32)
  ALINK_PAIR_LAUNCH(256, 64)
  ALINK_PAIR_LAUNCH(128, 32)
  ALINK_PAIR_LAUNCH(128, 64)
  ALINK_PAIR_LAUNCH(128, 128)
  ALINK_PAIR_LAUNCH(64, 256)
#undef ALINK_PAIR_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
