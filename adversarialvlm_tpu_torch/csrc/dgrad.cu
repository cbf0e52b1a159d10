// Input gradient of a frozen linear y = x · Wᵀ: dx (T, I) = dy (T, O) · W (O, I), bf16 in and
// out, f32 accumulation, for Hopper (sm_90a).
//
// Replaces: adversarialvlm_tpu/ops/pallas/matmul.py::dgrad_matmul (pallas_call at :163), the
// backward of models/layers.py::_linear_pdx. As there, the weight cotangent is not computed and x
// is not needed. W is read in its stored (O, I) layout: no transposed copy is made.
//
// What bounds it on the H100: at the attack's shapes (T = 577-641 rows at batch 1, 2308-2708 at
// batch 4, 1440 and 16384 at Gemma-3's batch 4; O, I in {1024, 1152, 2048, 2560, 4096, 10240,
// 11008}) the product does 2·T·O·I operations on 2·(T·O + O·I + T·I) bytes, several hundred to
// a few thousand operations per byte, above the card's ~295 operations/byte ridge: the tensor
// cores bound it (989 TFLOP/s dense bf16 at 700 W). At batch 1 the outputs are small (the CLIP
// tower's 577 × 1024 is 20 tiles of 128 × 256 for 132 SMs), so filling the card bounds it first.
//
// Design (every product is wgmma m64n256k16, bf16 in, f32 accumulators in registers):
//  - A block owns a 128-row × 256-column tile of dx: two consumer warpgroups of 64 rows each, and
//    one producer warpgroup whose single thread issues the loads. setmaxnreg moves registers from
//    the producer (40) to the consumers (232): a 64 × 256 f32 accumulator is 128 registers a
//    thread. (Narrower tiles of 128 and 192 columns were tried on the card and ran slower.)
//  - Loads: TMA (cp.async.bulk.tensor) into a ring of 4 stages of BK = 64 columns of O (48 KiB
//    each), with a full and an empty mbarrier per stage. TMA fits here (unlike flash_full.cu's
//    144-byte rows): every row is 2·O or 2·I bytes, a multiple of 16; a 64-column box is exactly
//    one 128-byte swizzle span; and TMA zero-fills the rows past T and the columns past O or I
//    itself, so the ragged edges need no code in the mainloop. The tensor maps are encoded on the
//    host at each call (cuTensorMapEncodeTiled, reached through the runtime's driver entry point,
//    so nothing links libcuda) and passed as __grid_constant__ parameters.
//  - Operands: the dy tile (128 rows × 64, rows of 128 bytes, 128-byte swizzle) is the K-major A
//    operand, advanced by 32 bytes per k-step inside the swizzle span. W's tile is 64 rows of O ×
//    256 columns of I, N-contiguous: the MN-major B operand (transpose bit set), stored as four
//    boxes of 64 columns × 64 rows (8 KiB each). In the MN-major swizzled descriptor the leading
//    byte offset steps from one 64-column box to the next along N (8 KiB) and the stride byte offset
//    from one 8-row group to the next along K (1 KiB); a k-step of 16 rows advances the start
//    address by 2 KiB.
//  - Each consumer keeps one wgmma group in flight: it waits for the previous stage's products
//    and then releases that stage to the producer.
//  - Feeding the SMs from L2: a block reads 48 KiB per k-block for 4.2 MFLOP, so at full rate the
//    card would pull about 11 TB/s from L2. At T = 641 the 7B decoder's products ran no faster on
//    132 blocks of 192 columns than on 96 of 256, so the L2 rather than the idle SMs held them.
//    Two blocks on neighbouring row tiles form a cluster and share each W tile: each issues two of
//    its four boxes as a TMA multicast to both, so a block reads 32 KiB per k-block. A stage is
//    refilled only when the consumers of both blocks have released it (every consumer warp arrives
//    on both blocks' empty barriers), and neither block exits before the other is done with its
//    barriers. Pairs paid only at few row tiles (the 7B decoder at batch 1) and lost at many, so
//    the C entry pairs an even count of at most 8 row tiles (paired below).
//  - The row tiles vary fastest in the grid, so the blocks in flight share W's column tiles: W
//    (up to 90 MB) is read from device memory about once, dy (at most 22 MB) stays in the 50 MB
//    L2. (Walking the columns first re-read W once per row tile, from device memory.)
//  - Filling the card: a grid of fewer than 66 blocks (the batch-1 CLIP tower's (577, ·, 1024)
//    products: 20) splits O over a cluster of 2-4 blocks instead of pairing. The cluster adds its
//    partial tiles through distributed shared memory: each block writes its f32 accumulators to
//    its own shared memory, and block r sums register pairs r, r + s, ... over the cluster's
//    blocks in rank order, loading them all before the first sum. The sum is deterministic: no
//    atomics, no workspace.
//  - Epilogue: the accumulators are converted to bf16 in registers and stored directly, two
//    columns (4 bytes) a store; rows past T and columns past I are masked.
// O and I must be multiples of 8 (TMA's 16-byte row stride). Measured times: PERF.md §6.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;                   // rows of dx per block: two consumer warpgroups of 64
constexpr int BN = 256;                   // columns of dx per block
constexpr int BK = 64;                    // columns of O per stage: one 128-byte swizzle span
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int A_BYTES = BM * BK * 2;      // 16 KiB
constexpr int BOX_BYTES = BK * 64 * 2;    // one 64-column box of W: 8 KiB
constexpr int BOXES = BN / 64;            // four boxes of W per stage
constexpr int STAGE = A_BYTES + BN * BK * 2;  // 48 KiB
constexpr int STAGES = 4;
constexpr int NACC = BN / 2;              // f32 accumulator registers per consumer thread: 128
constexpr int RING = STAGES * STAGE;
constexpr int SMEM = 1024 + RING + 16 * STAGES;  // 1024: slack to align the ring
constexpr int MAX_SPLIT = 4;
static_assert(NACC * 128 * CONSUMERS * 4 <= RING, "the split partials reuse the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand (layout type 1 in bits 62-63).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One 2-D TMA box (c0: the inner, contiguous coordinate) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The same box into the shared memory of every block of the cluster in `mask`, at the same offset,
// completing on each one's barrier at `bar`.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "h"(mask)
      : "memory");
}

// Arrives on the barrier at `bar` in the shared memory of cluster block `rank` (possibly this one).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from touching an accumulator between a wgmma's issue and its wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

// D (64 × 256, f32) += A (64 × 16, shared, K-major) · B (16 × 256, shared, MN-major).
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// The epilogue of a split cluster of S blocks: every block has written its partial tile to its own
// shared memory, pair p of consumer thread ct at part[p · 256 + ct] (pair p: accumulator registers
// 2p and 2p + 1). Block `split` sums pairs split, split + S, ... over the S blocks in rank order
// (deterministic) and stores them. All loads are issued before the first sum, so the distributed
// shared memory's latency is paid about once.
template <int S>
__device__ __forceinline__ void reduce_store(const float2* part, bf16* __restrict__ dx, int split, int ct, int row0,
                                             int n0, int quad, int T, int I) {
  constexpr int PAIRS = BN / 4, MINE = (PAIRS + S - 1) / S;
  cg::cluster_group cluster = cg::this_cluster();
  const float2* peer[S];
#pragma unroll
  for (int j = 0; j < S; ++j) peer[j] = cluster.map_shared_rank(part, j);
  float2 v[MINE][S];
#pragma unroll
  for (int m = 0; m < MINE; ++m) {
    const int p = split + S * m;
#pragma unroll
    for (int j = 0; j < S; ++j) v[m][j] = p < PAIRS ? peer[j][p * 128 * CONSUMERS + ct] : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int m = 0; m < MINE; ++m) {
    const int p = split + S * m;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      s0 += v[m][j].x;
      s1 += v[m][j].y;
    }
    const int r = row0 + 8 * (p % 2), c = n0 + 8 * (p / 2) + 2 * quad;
    if (p < PAIRS && r < T && c < I) *reinterpret_cast<uint32_t*>(dx + (size_t)r * I + c) = pack_bf16(s0, s1);
  }
}

// dy (T, O) and w (O, I) through their tensor maps; dx (T, I) contiguous. Grid (T/BM rounded up to
// `pair`, I/BN · splits). The row tiles vary fastest, so the blocks in flight share W's column
// tiles. Clusters: `pair` = 2 blocks along x (two row tiles that share each W tile, multicast), or
// `splits` blocks along y (block rank r takes the r-th share of O's k-blocks); never both.
__global__ void __launch_bounds__(THREADS, 1)
    dgrad_kernel(const __grid_constant__ CUtensorMap map_dy, const __grid_constant__ CUtensorMap map_w,
                 bf16* __restrict__ dx, int T, int O, int I, int splits, int pair) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // 128-byte swizzle atoms are 1 KiB aligned
  unsigned char* smem = smem_raw + (ring - raw);
  const uint32_t full = ring + RING, empty = full + 8 * STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int split = splits > 1 ? (int)(blockIdx.y % splits) : 0;
  const int rank = pair > 1 ? (int)(blockIdx.x % pair) : 0;  // in a multicast pair
  const int n0 = (blockIdx.y / splits) * BN, m0 = blockIdx.x * BM;
  const int nk = (O + BK - 1) / BK;
  const int kb0 = split * nk / splits, kb1 = (split + 1) * nk / splits;

  if (tid == 0) {
#pragma unroll 1
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * CONSUMERS * pair);  // one arrival per consumer warp of the pair
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (pair > 1) {
    cluster_sync();  // the peer's barriers are initialized before any multicast reaches them
  } else {
    __syncthreads();
  }

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
#pragma unroll 1
      for (int kb = kb0, i = 0; kb < kb1; ++kb, ++i) {
        const int s = i % STAGES;
        // a multicast stage is free once the consumers of both blocks have released it
        if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
        const uint32_t st = ring + s * STAGE, bar = full + 8 * s;
        mbar_expect_tx(bar, STAGE);  // the whole stage lands here, part of it sent by the peer
        tma_load(st, &map_dy, kb * BK, m0, bar);
#pragma unroll
        for (int j = 0; j < BOXES; ++j) {
          const uint32_t box = st + A_BYTES + j * BOX_BYTES;
          if (pair == 1) {
            tma_load(box, &map_w, n0 + 64 * j, kb * BK, bar);
          } else if (j % 2 == rank) {
            tma_load_multicast(box, &map_w, n0 + 64 * j, kb * BK, bar, 0x3);
          }
        }
      }
    }
    if (pair > 1 || splits > 1) {  // the consumers' cluster barriers
      cluster_sync();
      if (splits > 1) cluster_sync();
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1, ct = tid - 128, warp = (tid / 32) % 4, lane = tid % 32, quad = lane % 4;
  float acc[NACC];
#pragma unroll
  for (int x = 0; x < NACC; ++x) acc[x] = 0.f;

#pragma unroll 1
  for (int kb = kb0, i = 0; kb < kb1; ++kb, ++i) {
    const int s = i % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    const uint32_t a = ring + s * STAGE + cw * 64 * 128, b = ring + s * STAGE + A_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_n256(acc, desc_sw128(a + 32 * kk, 16, 1024), desc_sw128(b + 2048 * kk, BOX_BYTES, 1024), 1);
    wg_commit();
    wg_wait<1>();  // the previous stage's products are done: release it, in both blocks of a pair
    if (i > 0 && lane == 0) {
      const uint32_t bar = empty + 8 * ((i - 1) % STAGES);
      if (pair == 1) {
        mbar_arrive(bar);
      } else {
        mbar_arrive_cluster(bar, 0);
        mbar_arrive_cluster(bar, 1);
      }
    }
  }
  wg_wait<0>();
  reg_fence(acc);

  // element x of a thread's accumulator: row 16·warp + lane/4 + 8·((x/2)%2) of its warpgroup's 64,
  // column 8·(x/4) + 2·quad + x%2 of the tile
  const int row0 = m0 + cw * 64 + warp * 16 + lane / 4;
  if (splits == 1) {
#pragma unroll
    for (int x = 0; x < NACC; x += 2) {
      const int r = row0 + 8 * ((x / 2) % 2), c = n0 + 8 * (x / 4) + 2 * quad;
      if (r < T && c < I) *reinterpret_cast<uint32_t*>(dx + (size_t)r * I + c) = pack_bf16(acc[x], acc[x + 1]);
    }
    if (pair > 1) cluster_sync();  // no block exits while its peer may still arrive on its barriers
    return;
  }

  // split cluster: partials through distributed shared memory, summed in rank order
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory");  // both consumers are done with the ring
  float2* part = reinterpret_cast<float2*>(smem);
#pragma unroll
  for (int x = 0; x < NACC; x += 2) part[(x / 2) * 128 * CONSUMERS + ct] = make_float2(acc[x], acc[x + 1]);
  cluster_sync();
  switch (splits) {
    case 2: reduce_store<2>(part, dx, split, ct, row0, n0, quad, T, I); break;
    case 3: reduce_store<3>(part, dx, split, ct, row0, n0, quad, T, I); break;
    default: reduce_store<4>(part, dx, split, ct, row0, n0, quad, T, I); break;
  }
  cluster_sync();  // every peer has read this block's partials
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major bf16 (rows, cols) matrix read in boxes of box_rows × 64 columns, 128-byte swizzled;
// out-of-range rows and columns read as zero.
bool encode(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether the row tiles go in multicast pairs: only an even count of at most 8 row tiles, such as
// the 7B decoder's 6 at batch 1, where cli/bench_dgrad.py found pairs faster on the H100; at 12 or
// more row tiles, and where an odd count needs an all-zero tile, they were slower (PERF.md §6).
bool paired(int mt, int splits) { return splits == 1 && mt % 2 == 0 && mt <= 8; }

bool shape_ok(int T, int O, int I) {
  return T > 0 && O > 0 && I > 0 && O % 8 == 0 && I % 8 == 0 && (I + BN - 1) / BN * MAX_SPLIT <= 65535;
}

int launch(const void* dy, const void* w, void* dx, int T, int O, int I, int splits, int pair, cudaStream_t stream) {
  CUtensorMap map_dy, map_w;
  if (!encode(&map_dy, dy, T, O, BM) || !encode(&map_w, w, O, I, BK)) return (int)cudaErrorInvalidValue;
  static int smem_set_on = -1;  // the shared-memory limit is set once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != smem_set_on) {
    err = cudaFuncSetAttribute(dgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err == cudaSuccess) smem_set_on = dev;
  }
  if (err != cudaSuccess) return (int)err;
  const int mt = (T + BM - 1) / BM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((mt + pair - 1) / pair * pair), (unsigned)(((I + BN - 1) / BN) * splits));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pair;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dgrad_kernel, map_dy, map_w, static_cast<bf16*>(dx), T, O, I, splits, pair);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The split of O for a shape. One block runs per SM, so a grid of fewer blocks than the 132 SMs
// leaves SMs idle for the whole launch. cli/bench_dgrad.py times splits of 1-4 at every shape of
// the three steps on the H100 (PERF.md §6): unsplit was fastest wherever the grid held at least
// half as many blocks as SMs, and a split filling the card was fastest below that (the batch-1
// CLIP tower's (577, ·, 1024) products: 20 blocks). A split keeps at least 4 k-blocks a block.
int splits_for(int T, int O, int I) {
  const int sms = 132, nk = (O + BK - 1) / BK;
  const long long blocks = (long long)((T + BM - 1) / BM) * ((I + BN - 1) / BN);
  if (2 * blocks >= sms) return 1;
  return (int)std::max(1LL, std::min({(long long)MAX_SPLIT, sms / blocks, (long long)nk / 4}));
}

}  // namespace

// dy (T, O), w (O, I) and dx (T, I): contiguous bf16 on one device, 16-byte aligned; O % 8 == 0
// and I % 8 == 0. Launches on `stream` and returns the CUDA error (0 on success).
extern "C" int dgrad_bf16(const void* dy, const void* w, void* dx, int T, int O, int I, void* stream) {
  if (!shape_ok(T, O, I)) return (int)cudaErrorInvalidValue;
  const int splits = splits_for(T, O, I);
  return launch(dy, w, dx, T, O, I, splits, paired((T + BM - 1) / BM, splits) ? 2 : 1,
                static_cast<cudaStream_t>(stream));
}

// dgrad_bf16 with the cluster given: a split of O over 1-4 blocks, or (split 1) pairs of row tiles
// (pair 2) or none (pair 1). For cli/bench_dgrad.py, which times every plan against the one
// dgrad_bf16 takes; the result is the same product, summed in another order.
extern "C" int dgrad_bf16_plan(const void* dy, const void* w, void* dx, int T, int O, int I, int splits, int pair,
                               void* stream) {
  if (!shape_ok(T, O, I) || splits < 1 || splits > MAX_SPLIT || (O + BK - 1) / BK < splits || pair < 1 ||
      pair > 2 || (pair == 2 && splits > 1))
    return (int)cudaErrorInvalidValue;
  return launch(dy, w, dx, T, O, I, splits, pair, static_cast<cudaStream_t>(stream));
}

// The cluster dgrad_bf16 takes at a shape, for the record: split · 10 + pair.
extern "C" int dgrad_plan(int T, int O, int I) {
  const int splits = splits_for(T, O, I);
  return splits * 10 + (paired((T + BM - 1) / BM, splits) ? 2 : 1);
}
