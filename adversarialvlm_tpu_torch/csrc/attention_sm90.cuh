// Building blocks shared by the wgmma attention kernels of causal_fwd.cu and causal_bwd.cu (sm_90a):
// the mask modes, operand layouts, wgmma's no-swizzle canonical tile layout at head dim D, cp.async
// loads into it, the wgmma products and the accumulator fragment's row stores.
//
// A tile of R rows × D columns (D in {32, 64, 96, 128}) is (R/8) × (D/8) core matrices of 8 rows ×
// 16 bytes, each 128 contiguous bytes: 8-row groups D·16 bytes apart, core columns 128 bytes apart.
// That one layout is the K-major operand of the products over the head dim and the MN-major operand
// of those over rows (the same core matrices, read with the descriptor's two strides swapped), so a
// tile of q, k, v or dO is stored once and serves both. cp.async puts each 16-byte chunk where the
// layout wants it, from any row stride, and zero-fills rows past T.
//
// Head dim 256 uses the 128-byte-swizzled layout instead (Swz below): D/64 panels of 64 columns, each
// row of a panel 128 bytes. It too is both operands' layout at once (K-major for the products over
// the head dim, MN-major for those over rows), and its rows load from device memory as 512
// contiguous bytes (PERF.md §6 has what it gained over the no-swizzle layout at head dim 256).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

typedef __nv_bfloat16 bf16;

constexpr int BT = 64;  // rows of a tile of the other side, and of a warpgroup's own rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The mask modes: query row i may attend key j when
//  - CAUSAL_SEG: j <= i and seg[i] == seg[j] (left pads carry segment 0, so a pad row attends
//    earlier pads and a real row earlier real tokens; every row attends at least itself);
//  - SEG: seg[i] == seg[j] (every row attends at least itself).
enum Mask { CAUSAL_SEG = 0, SEG = 1 };

// Element strides of a (B, T, heads, D) operand viewed in any layout: batch, row (token), head. The
// head dim itself is contiguous and every row starts on a 16-byte boundary.
struct Layout {
  long long b, r, h;
};

// The projections' contiguous (B, T, heads, D) layout.
inline Layout bthd(int T, int heads, int D) {
  return Layout{(long long)T * heads * D, (long long)heads * D, (long long)D};
}

// The canonical layout of a tile at head dim D.
template <int D>
struct Head {
  static_assert(D % 16 == 0 && D >= 32 && D <= 256, "head dim");
  static constexpr int CP = D / 8;                  // core columns
  static constexpr uint32_t C_STRIDE = 128;         // bytes from one core column to the next
  static constexpr uint32_t G_STRIDE = CP * 128;    // bytes from one 8-row group to the next
  static constexpr int TILE = BT * D * 2;           // bytes of a tile of BT rows
  static __device__ __forceinline__ uint32_t core_off(int g, int c) { return (uint32_t)(g * CP + c) * 128u; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor, no swizzle: start address, leading-dimension byte offset (between
// core matrices along K), stride-dimension byte offset (between core matrices along M or N).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// K-major operand (tile rows are M or N, columns K = the head dim): the 16 columns of k-step kk, from
// row group g0.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int g0, int kk) {
  return make_desc(tile + Head<D>::core_off(g0, 2 * kk), Head<D>::C_STRIDE, Head<D>::G_STRIDE);
}

// MN-major operand (tile rows are K, columns N = the head dim): the 16 rows of k-step kk.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + Head<D>::core_off(2 * kk, 0), Head<D>::G_STRIDE, Head<D>::C_STRIDE);
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand (layout type 1 in bits 62-63).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return make_desc(addr, lbo, sbo) | (1ull << 62);
}

// The 128-byte-swizzled layout of a tile of R rows at head dim D: D/64 panels of R rows × 64 columns,
// one after the other; a panel row is 128 bytes, and its 16-byte chunk c sits at chunk c ^ (row % 8),
// so each 8-row group is a 1 KiB swizzle atom (a tile starts 1 KiB aligned).
template <int D, int R>
struct Swz {
  static_assert(D % 64 == 0 && R % 8 == 0, "swizzled tile");
  static constexpr uint32_t PANEL = R * 128;  // bytes of one 64-column panel
  static constexpr int TILE = R * D * 2;
  // byte offset of row r's 16-byte chunk c (columns 8c .. 8c + 7)
  static __device__ __forceinline__ uint32_t off(int r, int c) {
    return (uint32_t)(c / 8) * PANEL + r * 128 + (((c % 8) ^ (r % 8)) << 4);
  }
};

// K-major operand of a swizzled tile of R rows (rows are M or N, columns K = the head dim): the 16
// columns of k-step kk, from row row0 (a multiple of 8): 32 bytes a k-step inside a panel.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k_sw(uint32_t tile, int row0, int kk) {
  return desc_sw128(tile + (kk / 4) * Swz<D, R>::PANEL + row0 * 128 + (kk % 4) * 32, 16, 1024);
}

// MN-major operand of a swizzled tile of R rows (rows are K, columns N): the 16 rows of k-step kk;
// the leading offset steps from one 64-column panel to the next along N, the stride offset from one
// 8-row group to the next along K.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn_sw(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 2048, Swz<D, R>::PANEL, 1024);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait for this thread's copies but the newest PENDING groups, make them visible to wgmma's async
// proxy, then to the block.
template <int PENDING = 0>
__device__ __forceinline__ void arrive_tile() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from touching an accumulator between a wgmma's issue and its wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [r0, r0 + ROWS) of one head (src: its row 0; rows `stride` elements apart) into a tile;
// rows at or past T are zero-filled by the copy. NT threads share the copies.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* __restrict__ src, long long stride, int r0,
                                          int T, int tid) {
  constexpr int CP = Head<D>::CP;
#pragma unroll
  for (int i = tid; i < ROWS * CP; i += NT) {
    const int r8 = i & 7, rest = i >> 3, c = rest % CP, g = rest / CP;
    const int gr = r0 + g * 8 + r8;
    const bool ok = gr < T;
    cp_async16(tile + Head<D>::core_off(g, c) + r8 * 16, src + (size_t)(ok ? gr : 0) * stride + c * 8, ok);
  }
}

// load_tile into the swizzled layout: a thread's consecutive chunks walk a row, so a warp reads 512
// contiguous bytes of device memory.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_sw(uint32_t tile, const bf16* __restrict__ src, long long stride, int r0,
                                             int T, int tid) {
  constexpr int CP = D / 8;
#pragma unroll
  for (int i = tid; i < ROWS * CP; i += NT) {
    const int c = i % CP, r = i / CP, gr = r0 + r;
    const bool ok = gr < T;
    cp_async16(tile + Swz<D, ROWS>::off(r, c), src + (size_t)(ok ? gr : 0) * stride + c * 8, ok);
  }
}

// The dynamic shared memory of a kernel that holds swizzled tiles, rounded up to a 1 KiB boundary (the
// launch asks for 1 KiB more).
__device__ __forceinline__ unsigned char* align_1k(unsigned char* smem) {
  return smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
}

// Stages a warpgroup's 64 × N accumulator as bf16 into rows [row0, row0 + 64) and 16-byte chunks
// [c0, c0 + N/8) of a swizzled tile of R rows at `tile` (a generic pointer to shared memory), for
// store_tile to write out whole rows. The swizzle spreads the fragment's 8 rows over all banks.
template <int D, int R, int N>
__device__ __forceinline__ void stage_rows(unsigned char* tile, const float (&acc)[N / 2], int row0, int c0, int warp,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 16 * warp + lane / 4 + 8 * i;
#pragma unroll
    for (int c = 0; c < N / 8; ++c)
      *reinterpret_cast<uint32_t*>(tile + Swz<D, R>::off(r, c0 + c) + 4 * (lane % 4)) =
          pack_bf16(acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1]);
  }
}

// Rows [row0, row0 + ROWS) of a swizzled tile of R rows at `tile` to rows g0.. of dst (rows `stride`
// elements apart), skipping rows at or past T: 16 bytes a thread, NT threads numbered from tid 0, so a
// warp writes whole rows of device memory rather than a fragment's 4-byte pieces of 8 rows.
template <int D, int R, int ROWS, int NT>
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst, long long stride, const unsigned char* tile,
                                           int row0, int g0, int T, int tid) {
  constexpr int CP = D / 8;
#pragma unroll
  for (int i = tid; i < ROWS * CP; i += NT) {
    const int c = i % CP, r = i / CP;
    if (g0 + r < T)
      *reinterpret_cast<uint4*>(dst + (size_t)(g0 + r) * stride + 8 * c) =
          *reinterpret_cast<const uint4*>(tile + Swz<D, R>::off(row0 + r, c));
  }
}

// A barrier of the 128 threads of one warpgroup (ids from 1; 0 is __syncthreads').
__device__ __forceinline__ void wg_barrier(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }

// Entry t of rows [r0, r0 + BT) of a length-T vector of 4-byte values; threads [0, BT) each copy one.
__device__ __forceinline__ void load_rowval(uint32_t dst, const void* __restrict__ src, int r0, int T, int t) {
  const int r = r0 + t;
  cp_async4(dst + 4 * t, static_cast<const uint32_t*>(src) + (r < T ? r : 0), r < T);
}

// The accumulator fragment of m64nNk16: element x of a thread's registers sits at row
// 16·warp + lane/4 + 8·((x/2)%2) and column 8·(x/4) + 2·(lane%4) + x%2 of the warpgroup's tile.
// Packing pairs (2i, 2i+1) to bf16 gives the register A operand of the k-steps that follow.
template <int N>
__device__ __forceinline__ void to_operand(const float (&s)[N], uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// D (64 × 32, f32) (+)= A (64 × 16, shared, K-major) · B (16 × 32, shared, K-major).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 × 64, f32) (+)= A (64 × 16, shared, K-major) · B (16 × 64, shared, K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 × 128, f32) += A (64 × 16, shared, K-major) · B (16 × 128, shared, MN-major).
__device__ __forceinline__ void wgmma_ss_n128_tb(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 × N, f32) += A (64 × 16, bf16 registers) · B (16 × N, shared, MN-major), N = the head dim.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S (64 × 64) = A · Bᵀ over the head dim: D/16 k-steps, both operands K-major tiles (A from row
// group g0 of its tile).
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a_tile, int g0, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(s, desc_k<D>(a_tile, g0, kk), desc_k<D>(b_tile, 0, kk), kk);
}

// S (64 × N, N = 32 or 64) = A · Bᵀ over the head dim, both swizzled K-major tiles: A from row a0 of a
// tile of RA rows, B from row b0 of a tile of RB rows.
template <int D, int RA, int RB, int N>
__device__ __forceinline__ void scores_sw(float (&s)[N / 2], uint32_t a_tile, int a0, uint32_t b_tile, int b0) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = desc_k_sw<D, RA>(a_tile, a0, kk), db = desc_k_sw<D, RB>(b_tile, b0, kk);
    if constexpr (N == 64)
      wgmma_ss_n64(s, da, db, kk);
    else
      wgmma_ss_n32(s, da, db, kk);
  }
}

// acc (64 × D) += A (64 × K, registers) · B (K × D, a swizzled tile of K rows as an MN-major operand).
template <int D, int K>
__device__ __forceinline__ void accumulate_sw(float (&acc)[D / 2], const uint32_t (&a)[K / 4], uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) wgmma_rs<D>(acc, a + 4 * kk, desc_mn_sw<D, K>(b_tile, kk));
}

// acc (64 × D) += A (64 × 64, registers) · B (64 × D, a tile as an MN-major operand).
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2], const uint32_t (&a)[16], uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) wgmma_rs<D>(acc, a + 4 * kk, desc_mn<D>(b_tile, kk));
}

// Writes a warpgroup's 64 × D accumulator as bf16 rows r0 + (fragment row) of one head (dst: its
// row 0; rows `stride` elements apart), skipping rows at or past T.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[D / 2], int r0, int T,
                                           long long stride, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + lane / 4 + 8 * i;
    if (r >= T) continue;
    bf16* row = dst + (size_t)r * stride + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < Head<D>::CP; ++c)
      *reinterpret_cast<uint32_t*>(row + 8 * c) = pack_bf16(acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1]);
  }
}

}  // namespace attn
