// Non-causal attention at head_dim 72 or 80 for Hopper (sm_90a): forward; dq, which writes δ; dk/dv.
//
// Replaces adversarialvlm_tpu/ops/pallas/attention.py::flash_sdpa_full (:214), which runs the stock
// TPU flash_attention kernels (forward, dkv, dq) through _flash_call (:97) with causal=False, T
// right-padded to its block with segment 0 and head_dim zero-padded to 128 lanes. Its semantics are
// those of _ref_attention(..., causal=False) (:160): every query attends every key, scores and
// softmax in f32, output in q's dtype. Here T is not padded: the ragged tile is masked in
// registers, and only the D real columns are read from and written to device memory. Every kernel
// is a template on the head dim D: 72 (the SigLIP towers, 1152 / 16) and 80 (Qwen2-VL's tower,
// 1280 / 16); the two share one shared-memory layout of 80 columns.
//
// What bounds it on the H100: at Gemma-3's SigLIP tower (B = 4 images, T = 4096 patches, 16 heads
// of 72) the forward is 4·B·T²·H·D = 309 GFLOP on 151 MB of q/k/v/o (about 2000 operations per
// byte), dq 464 GFLOP and dk/dv 618 GFLOP: the tensor cores bound all three (0.31, 0.47 and 0.63 ms
// at the H100 SXM's published dense bf16 rate, 989 TFLOP/s at 700 W). Beside the products, every
// score costs an exp2 on the 16-a-clock special-function unit; at D = 72 that is about as many
// cycles as its two products take on the tensor cores, so the design keeps the scores in registers
// and puts three or four warpgroups on each SM, which hide each other's softmax behind their
// products. Qwen2-VL's tower at a 1024² source (B = 1, T = 4900, 16 heads of 80) is the same
// regime: the forward 123 GFLOP on 50 MB. Measured times: PERF.md §6.
//
// Design (all products are wgmma, bf16 in, f32 accumulate):
//  - A block has three or four warpgroups (the plan of each kernel and head dim: Plan below), one
//    block per SM, and owns 64 rows
//    of one (b, h) per warpgroup: query rows in the forward and dq, key rows in dk/dv. Each
//    warpgroup keeps its accumulators in registers for the whole walk over the other side's tiles
//    of 64 rows, which all warpgroups of the block share.
//  - Forward: S = Q·Kᵀ is wgmma m64n64k16 over five k-steps (D = 72 zero-filled to 80 in shared
//    memory; D = 80 fills them). The online softmax runs on the accumulator registers (row max and sum with quad
//    shuffles, exp2 with the scale folded into log2 units). P is converted to bf16 in registers,
//    where the accumulator's fragment layout is already the register A operand's, and
//    O += P·V is wgmma m64nDk16 (m64n72k16 or m64n80k16) with V read from shared memory as an
//    MN-major B operand: N = D needs no padding. O and the row max and sum stay in registers; the
//    block writes o (D bf16 columns) and lse (f32), the one extra residual the backward uses.
//  - dq: recomputes S and dP = dO·Vᵀ per key tile (two m64n64k16 chains), P = exp2(S·scale·log2e
//    − lse·log2e), dS = P ⊙ (dP − δ)·scale in registers, and dQ += dS·K (K as an MN-major operand).
//    δ = rowsum(dO ⊙ O) is computed once per row and written out for dk/dv, which runs second.
//  - dk/dv: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ per query tile of 64, Pᵀ and dSᵀ formed in registers, then
//    dV += Pᵀ·dO and dK += dSᵀ·Q with Q and dO as MN-major operands, dK and dV in f32 registers.
//    Each key row is owned by one warpgroup, so the backward is deterministic: no atomics.
//  - Loads: the other side's tiles stream through a two-stage ring filled by cp.async, issued by
//    the consumer threads one tile ahead, so tile j+1 is in flight while tile j's products run.
//    cp.async rather than TMA: a 72- or 80-column row is 144 or 160 bytes, wider than the 128-byte
//    swizzle span
//    and not a multiple of wgmma's k-step, so no single TMA box and swizzle mode matches both
//    uses of a tile; cp.async writes each 16-byte chunk where wgmma's no-swizzle ("interleaved")
//    canonical layout wants it, and zero-fills out-of-range rows (source size 0) by itself.
//  - Shared-memory layout: a tile of R rows × 80 columns is (R/8) × 10 core matrices of 8 rows ×
//    16 bytes, each 128 contiguous bytes (conflict-free for wgmma), 8-row groups 1280 bytes apart
//    and core columns 128 bytes apart. That one layout is K-major for the products that contract
//    over the head dim and MN-major for those that contract over rows (the same core matrices,
//    read with the descriptor's two strides swapped), so Q, K, V and dO are stored once and serve
//    both. At D = 72 core column 9 (head columns 72-79) is zeroed once and never loaded; at D = 80
//    every core column is loaded and nothing is zeroed.
//  - Ragged T: a key column past T scores −inf before the max and sum (forward) or gets P = 0
//    (dq); a query column past T gets Pᵀ = 0 in dk/dv and a query row past T gets lse = +inf in
//    dq, so garbage residuals make no inf or NaN. Out-of-range rows are never written.
// Every entry checks cudaGetLastError() after its launch and returns it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int FULL_DP = 80;           // head dims 72 and 80, padded to wgmma's k-step of 16 in shared memory only
constexpr int CP = FULL_DP / 8;       // core columns of a shared-memory tile: 10
constexpr uint32_t C_STRIDE = 128;    // bytes from one core column to the next
constexpr uint32_t G_STRIDE = CP * 128;  // bytes from one 8-row group to the next
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ constexpr int tile_bytes(int rows) { return rows * FULL_DP * 2; }

__device__ __forceinline__ uint32_t core_off(int g, int c) { return (uint32_t)(g * CP + c) * 128u; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor, no swizzle: start address, leading-dimension byte offset (between
// core matrices along K), stride-dimension byte offset (between core matrices along M or N).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// K-major operand (tile rows are M or N, columns K): the 16 columns of k-step kk, from row group g0.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int g0, int kk) {
  return make_desc(tile + core_off(g0, 2 * kk), C_STRIDE, G_STRIDE);
}

// MN-major operand (tile rows are K, columns N): the 16 rows of k-step kk, all D columns.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + core_off(2 * kk, 0), G_STRIDE, C_STRIDE);
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

// Wait for this thread's copies, make them (and its plain shared stores) visible to wgmma's async
// proxy, then to the whole block.
__device__ __forceinline__ void arrive_tile() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// Rows [r0, r0 + ROWS) of one head (src: its row 0; rows `stride` elements apart) into the tile at
// `tile`, core columns 0 to D/8 - 1; rows at or past T are zero-filled by the copy.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* __restrict__ src, long long stride, int r0,
                                          int T, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks of a row in device memory
#pragma unroll 1
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r8 = i & 7, rest = i >> 3, c = rest % CH, g = rest / CH;
    const int gr = r0 + g * 8 + r8;
    const bool ok = gr < T;
    cp_async16(tile + core_off(g, c) + r8 * 16, src + (size_t)(ok ? gr : 0) * stride + c * 8, ok);
  }
}

// The core columns past D/8 of a tile (at D = 72, column 9: head columns 72-79): zero, so the fifth
// k-step over the head dim adds nothing. Never overwritten by a load. At D = 80 there are none.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void zero_pad(unsigned char* tile, int tid) {
  if constexpr (D / 8 < CP) {
    for (int i = tid; i < ROWS; i += NT)
      *reinterpret_cast<uint4*>(tile + core_off(i / 8, D / 8) + (i % 8) * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The accumulator fragment of m64nNk16: element x of a thread's registers sits at row
// 16·warp + lane/4 + 8·((x/2)%2) and column 8·(x/4) + 2·(lane%4) + x%2 of the warpgroup's tile.
// Packing pairs (2i, 2i+1) to bf16 gives the register A operand of the k-steps that follow.
template <int N>
__device__ __forceinline__ void to_operand(const float (&s)[N], uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
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

// D (64 × 72, f32) += A (64 × 16, bf16 registers) · B (16 × 72, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n72(float (&d)[36], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 × 80, f32) += A (64 × 16, bf16 registers) · B (16 × 80, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The other side's tiles are BT = 64 rows (keys in the forward and dq, queries in dk/dv): one
// m64n64k16 score tile per warpgroup and tile.
constexpr int BT = 64;

// S (64 × 64) = A · Bᵀ over the padded head dim: five k-steps, both operands K-major tiles (A from
// row group g0 of its tile).
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a_tile, int g0, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < FULL_DP / 16; ++kk) wgmma_ss_n64(s, desc_k(a_tile, g0, kk), desc_k(b_tile, 0, kk), kk);
}

// acc (64 × D) += A (64 × 64, registers) · B (64 × D, a tile as an MN-major operand).
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2], const uint32_t (&a)[16], uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    if constexpr (D == 72)
      wgmma_rs_n72(acc, a + 4 * kk, desc_mn(b_tile, kk));
    else
      wgmma_rs_n80(acc, a + 4 * kk, desc_mn(b_tile, kk));
  }
}

// Writes a warpgroup's 64 × D accumulator as bf16 rows r0 + (fragment row) of one head (dst: its row
// 0; rows `stride` elements apart), skipping rows at or past T, each scaled by mul[i] (i: the thread's
// upper or lower row).
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[D / 2], const float (&mul)[2],
                                           int r0, int T, long long stride, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + lane / 4 + 8 * i;
    if (r >= T) continue;
    bf16* row = dst + (size_t)r * stride + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(row + 8 * c) = pack_bf16(acc[4 * c + 2 * i] * mul[i], acc[4 * c + 2 * i + 1] * mul[i]);
  }
}

// Warpgroups per block, per kernel and head dim: each owns 64 rows of its side (queries in the
// forward and dq, keys in dk/dv), and one block per SM takes as many as the register file holds, so
// every warpgroup of an SM shares each tile the block loads. At D = 72 (forward 110 and dq 126
// registers a thread: four; dk/dv 164: three) these ran faster on the H100 than two warpgroups at
// two blocks per SM, and 64-row tiles of the other side faster than 128-row ones. At D = 80 each
// accumulator holds 4 more registers a thread (8 in dk/dv, which keeps two): the forward keeps four
// warpgroups (114 registers of at most 128), dq takes three (130 of 168) and dk/dv two (178 of 255).
// On the H100 dq at four warpgroups and dk/dv at three spilled and ran slower (PERF.md §6).
template <int D>
struct Plan;
template <>
struct Plan<72> {
  static constexpr int FWD = 4, DQ = 4, KV = 3;
};
template <>
struct Plan<80> {
  static constexpr int FWD = 4, DQ = 3, KV = 2;
};

// Shared memory, in bytes from the start: the block's own rows (64 a warpgroup), then a two-stage
// ring of the other side's tiles (and, for dk/dv, of their lse and δ).
template <int WGS>
struct FwdSmem {  // Q at 0
  static constexpr int K = tile_bytes(64 * WGS), V = K + 2 * tile_bytes(BT), bytes = V + 2 * tile_bytes(BT);
};

template <int WGS>
struct DqSmem {  // Q at 0
  static constexpr int DO = tile_bytes(64 * WGS), K = 2 * DO, V = K + 2 * tile_bytes(BT);
  static constexpr int bytes = V + 2 * tile_bytes(BT);
};

template <int WGS>
struct DkdvSmem {  // K at 0
  static constexpr int V = tile_bytes(64 * WGS), Q = 2 * V, DO = Q + 2 * tile_bytes(BT);
  static constexpr int LSE = DO + 2 * tile_bytes(BT), DL = LSE + 2 * BT * 4, bytes = DL + 2 * BT * 4;
};

// q, k, v, o: (B, T, H, D) bf16; lse: (B, H, T) f32. Block (x, h, b): query rows
// [ROWS·x, ROWS·x + ROWS), ROWS = 64 · Plan<D>::FWD.
template <int D>
__global__ void __launch_bounds__(128 * Plan<D>::FWD, 1)
    full_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                    bf16* __restrict__ o, float* __restrict__ lse, int T, int H, float scale) {
  constexpr int WGS = Plan<D>::FWD, NT = 128 * WGS, ROWS = 64 * WGS;
  using Smem = FwdSmem<WGS>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32, quad = lane % 4;
  const int h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const long long rs = (long long)H * D;
  const size_t head = (size_t)blockIdx.z * T * rs + (size_t)h * D;
  q += head;
  k += head;
  v += head;
  o += head;
  lse += ((size_t)blockIdx.z * H + h) * T;
  const uint32_t sQ = smem_u32(smem), sK = sQ + Smem::K, sV = sQ + Smem::V;

  zero_pad<D, ROWS, NT>(smem, tid);
  zero_pad<D, BT, NT>(smem + Smem::K, tid);
  zero_pad<D, BT, NT>(smem + Smem::K + tile_bytes(BT), tid);
  load_tile<D, ROWS, NT>(sQ, q, rs, q0, T, tid);
  load_tile<D, BT, NT>(sK, k, rs, 0, T, tid);
  load_tile<D, BT, NT>(sV, v, rs, 0, T, tid);
  cp_commit();

  const float sl2 = scale * LOG2E;  // scores in log2 units
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sum
  const int nkt = (T + BT - 1) / BT;
#pragma unroll 1
  for (int j = 0; j < nkt; ++j) {
    arrive_tile();  // tile j is in; every warpgroup is done with tile j - 1
    if (j + 1 < nkt) {
      const uint32_t nx = ((j + 1) & 1) * tile_bytes(BT);
      load_tile<D, BT, NT>(sK + nx, k, rs, (j + 1) * BT, T, tid);
      load_tile<D, BT, NT>(sV + nx, v, rs, (j + 1) * BT, T, tid);
      cp_commit();
    }
    const uint32_t cur = (j & 1) * tile_bytes(BT);
    float s[32];
    wg_fence();
    scores(s, sQ, wg * 8, sK + cur);
    wg_commit();
    wg_wait();
    reg_fence(s);
    const int k0 = j * BT;
    if (k0 + BT > T) {
#pragma unroll
      for (int x = 0; x < 32; ++x)
        if (k0 + 8 * (x / 4) + 2 * quad + (x % 2) >= T) s[x] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) mx = fmaxf(mx, fmaxf(s[4 * c + 2 * i], s[4 * c + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[i], mx * sl2);  // every tile holds a real key, so mn is finite
      const float alpha = fast_exp2(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(fmaf(s[4 * c + 2 * i + e], sl2, -mn));
          s[4 * c + 2 * i + e] = p;
          sum += p;
        }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        acc[4 * c + 2 * i] *= alpha;
        acc[4 * c + 2 * i + 1] *= alpha;
      }
    }
    uint32_t p[16];
    to_operand(s, p);
    wg_fence();
    accumulate<D>(acc, p, sV + cur);
    wg_commit();
    wg_wait();
    reg_fence(acc);
  }
  const int r0 = q0 + wg * 64 + warp * 16;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
    const int r = r0 + lane / 4 + 8 * i;
    if (quad == 0 && r < T) lse[r] = m[i] * LN2 + logf(l[i]);
  }
  store_rows<D>(o, acc, inv, r0, T, rs, lane);
}

// q, k, v, o, dout, dq: (B, T, H, D) bf16; lse, delta: (B, H, T) f32. Block (x, h, b): query rows
// [ROWS·x, ROWS·x + ROWS), ROWS = 64 · Plan<D>::DQ; writes δ of its rows, then dq.
template <int D>
__global__ void __launch_bounds__(128 * Plan<D>::DQ, 1)
    full_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
                   bf16* __restrict__ dq, float* __restrict__ delta, int T, int H, float scale) {
  constexpr int WGS = Plan<D>::DQ, NT = 128 * WGS, ROWS = 64 * WGS;
  using Smem = DqSmem<WGS>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32, quad = lane % 4;
  const int h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const long long rs = (long long)H * D;
  const size_t head = (size_t)blockIdx.z * T * rs + (size_t)h * D;
  q += head;
  k += head;
  v += head;
  o += head;
  dout += head;
  dq += head;
  lse += ((size_t)blockIdx.z * H + h) * T;
  delta += ((size_t)blockIdx.z * H + h) * T;
  const uint32_t sQ = smem_u32(smem), sDO = sQ + Smem::DO, sK = sQ + Smem::K, sV = sQ + Smem::V;

  zero_pad<D, ROWS, NT>(smem, tid);
  zero_pad<D, ROWS, NT>(smem + Smem::DO, tid);
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    zero_pad<D, BT, NT>(smem + Smem::K + st * tile_bytes(BT), tid);
    zero_pad<D, BT, NT>(smem + Smem::V + st * tile_bytes(BT), tid);
  }
  load_tile<D, ROWS, NT>(sQ, q, rs, q0, T, tid);
  load_tile<D, ROWS, NT>(sDO, dout, rs, q0, T, tid);
  load_tile<D, BT, NT>(sK, k, rs, 0, T, tid);
  load_tile<D, BT, NT>(sV, v, rs, 0, T, tid);
  cp_commit();

  // While the first tiles load: δ = rowsum(dO ⊙ O) and lse (log2 units) of the thread's two rows;
  // a row past T gets lse = +inf, so its P is 0.
  const int r0 = q0 + wg * 64 + warp * 16;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + lane / 4 + 8 * i;
    float a = 0.f;
    if (r < T) {
      for (int c = quad; c < D / 8; c += 4) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + (size_t)r * rs + 8 * c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + (size_t)r * rs + 8 * c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
          a = fmaf(of.x, df.x, fmaf(of.y, df.y, a));
        }
      }
    }
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    dl[i] = a;
    lse2[i] = r < T ? lse[r] * LOG2E : INFINITY;
    if (quad == 0 && r < T) delta[r] = a;
  }

  const float sl2 = scale * LOG2E;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const int nkt = (T + BT - 1) / BT;
#pragma unroll 1
  for (int j = 0; j < nkt; ++j) {
    arrive_tile();
    if (j + 1 < nkt) {
      const uint32_t nx = ((j + 1) & 1) * tile_bytes(BT);
      load_tile<D, BT, NT>(sK + nx, k, rs, (j + 1) * BT, T, tid);
      load_tile<D, BT, NT>(sV + nx, v, rs, (j + 1) * BT, T, tid);
      cp_commit();
    }
    const uint32_t cur = (j & 1) * tile_bytes(BT);
    float s[32], dp[32];
    wg_fence();
    scores(s, sQ, wg * 8, sK + cur);
    scores(dp, sDO, wg * 8, sV + cur);
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(dp);
    const int k0 = j * BT;
    const bool ragged = k0 + BT > T;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x / 2) % 2;
      float p = fast_exp2(fmaf(s[x], sl2, -lse2[i]));
      if (ragged && k0 + 8 * (x / 4) + 2 * quad + (x % 2) >= T) p = 0.f;
      s[x] = p * (dp[x] - dl[i]) * scale;  // dS
    }
    uint32_t ds[16];
    to_operand(s, ds);
    wg_fence();
    accumulate<D>(acc, ds, sK + cur);
    wg_commit();
    wg_wait();
    reg_fence(acc);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq, acc, one, r0, T, rs, lane);
}

// Rows [r0, r0 + BT) of a (B, H, T) f32 residual of one head into shared memory; threads [0, BT).
__device__ __forceinline__ void load_rowvals(uint32_t dst, const float* __restrict__ src, int r0, int T, int t) {
  const int r = r0 + t;
  cp_async4(dst + 4 * t, src + (r < T ? r : 0), r < T);
}

// q, k, v, dout, dk, dv: (B, T, H, D) bf16; lse, delta: (B, H, T) f32. Block (x, h, b): key rows
// [ROWS·x, ROWS·x + ROWS), ROWS = 64 · Plan<D>::KV, over every query tile.
template <int D>
__global__ void __launch_bounds__(128 * Plan<D>::KV, 1)
    full_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H, float scale) {
  constexpr int WGS = Plan<D>::KV, NT = 128 * WGS, ROWS = 64 * WGS;
  using Smem = DkdvSmem<WGS>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32, quad = lane % 4;
  const int h = blockIdx.y, k0 = blockIdx.x * ROWS;
  const long long rs = (long long)H * D;
  const size_t head = (size_t)blockIdx.z * T * rs + (size_t)h * D;
  q += head;
  k += head;
  v += head;
  dout += head;
  dk += head;
  dv += head;
  lse += ((size_t)blockIdx.z * H + h) * T;
  delta += ((size_t)blockIdx.z * H + h) * T;
  const uint32_t sK = smem_u32(smem), sV = sK + Smem::V, sQ = sK + Smem::Q, sDO = sK + Smem::DO;
  const float* lse_s = reinterpret_cast<const float*>(smem + Smem::LSE);
  const float* dl_s = reinterpret_cast<const float*>(smem + Smem::DL);

  zero_pad<D, ROWS, NT>(smem, tid);
  zero_pad<D, ROWS, NT>(smem + Smem::V, tid);
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    zero_pad<D, BT, NT>(smem + Smem::Q + st * tile_bytes(BT), tid);
    zero_pad<D, BT, NT>(smem + Smem::DO + st * tile_bytes(BT), tid);
  }
  load_tile<D, ROWS, NT>(sK, k, rs, k0, T, tid);
  load_tile<D, ROWS, NT>(sV, v, rs, k0, T, tid);
  load_tile<D, BT, NT>(sQ, q, rs, 0, T, tid);
  load_tile<D, BT, NT>(sDO, dout, rs, 0, T, tid);
  if (tid < BT) load_rowvals(sK + Smem::LSE, lse, 0, T, tid);
  else if (tid < 2 * BT) load_rowvals(sK + Smem::DL, delta, 0, T, tid - BT);
  cp_commit();

  const float sl2 = scale * LOG2E;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const int nqt = (T + BT - 1) / BT;
#pragma unroll 1
  for (int j = 0; j < nqt; ++j) {
    arrive_tile();
    if (j + 1 < nqt) {
      const int nx = (j + 1) & 1, r1 = (j + 1) * BT;
      load_tile<D, BT, NT>(sQ + nx * tile_bytes(BT), q, rs, r1, T, tid);
      load_tile<D, BT, NT>(sDO + nx * tile_bytes(BT), dout, rs, r1, T, tid);
      if (tid < BT) load_rowvals(sK + Smem::LSE + nx * BT * 4, lse, r1, T, tid);
      else if (tid < 2 * BT) load_rowvals(sK + Smem::DL + nx * BT * 4, delta, r1, T, tid - BT);
      cp_commit();
    }
    const int st = j & 1;
    const uint32_t tQ = sQ + st * tile_bytes(BT), tDO = sDO + st * tile_bytes(BT);
    float s[32], dp[32];  // Sᵀ and dPᵀ: rows are this warpgroup's keys, columns the tile's queries
    wg_fence();
    scores(s, sK, wg * 8, tQ);
    scores(dp, sV, wg * 8, tDO);
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(dp);
    const int q0 = j * BT;
    const bool ragged = q0 + BT > T;
    const float* ls = lse_s + st * BT;
    const float* ds = dl_s + st * BT;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 8 * c + 2 * quad;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
      const float2 d2 = *reinterpret_cast<const float2*>(ds + col);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * c + 2 * i + e;
          float p = fast_exp2(fmaf(s[x], sl2, -(e ? l2.y : l2.x) * LOG2E));
          if (ragged && q0 + col + e >= T) p = 0.f;
          s[x] = p;                                         // Pᵀ
          dp[x] = p * (dp[x] - (e ? d2.y : d2.x)) * scale;  // dSᵀ
        }
    }
    uint32_t pa[16], da[16];
    to_operand(s, pa);
    to_operand(dp, da);
    wg_fence();
    accumulate<D>(dv_acc, pa, tDO);
    accumulate<D>(dk_acc, da, tQ);
    wg_commit();
    wg_wait();
    reg_fence(dv_acc);
    reg_fence(dk_acc);
  }
  const int r0 = k0 + wg * 64 + warp * 16;
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk, dk_acc, one, r0, T, rs, lane);
  store_rows<D>(dv, dv_acc, one, r0, T, rs, lane);
}

bool shape_ok(int B, int T, int H, int D) {
  return B > 0 && B <= 65535 && T > 0 && H > 0 && H <= 65535 && (D == 72 || D == 80);
}

// Launches `kernel` with `wgs` warpgroups per block, each block on 64 · wgs rows of one (b, h).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int wgs, int smem_bytes, int B, int T, int H, void* stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + 64 * wgs - 1) / (64 * wgs), H, B);
  kernel<<<grid, 128 * wgs, smem_bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

// One launch of each kernel at head dim D, with its plan's warpgroups and shared memory.
template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int T, int H, float scale,
        void* stream) {
  constexpr int WGS = Plan<D>::FWD;
  return launch(full_fwd_kernel<D>, WGS, FwdSmem<WGS>::bytes, B, T, H, stream, static_cast<const bf16*>(q),
                static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o),
                static_cast<float*>(lse), T, H, scale);
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse, void* dq,
           void* delta, int B, int T, int H, float scale, void* stream) {
  constexpr int WGS = Plan<D>::DQ;
  return launch(full_dq_kernel<D>, WGS, DqSmem<WGS>::bytes, B, T, H, stream, static_cast<const bf16*>(q),
                static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<const bf16*>(o),
                static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<bf16*>(dq),
                static_cast<float*>(delta), T, H, scale);
}

template <int D>
int bwd_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
             void* dk, void* dv, int B, int T, int H, float scale, void* stream) {
  constexpr int WGS = Plan<D>::KV;
  return launch(full_dkdv_kernel<D>, WGS, DkdvSmem<WGS>::bytes, B, T, H, stream, static_cast<const bf16*>(q),
                static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dk),
                static_cast<bf16*>(dv), T, H, scale);
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on success). Non-causal over B
// rows of T real tokens, D = 72 or 80, all tensors contiguous: q, k, v, o, dout, dq, dk, dv are
// (B, T, H, D) bf16; lse and delta (B, H, T) f32. dq writes delta, which dk/dv reads.

extern "C" int flash_full_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B, int T,
                                   int H, int D, float scale, void* stream) {
  if (!shape_ok(B, T, H, D)) return (int)cudaErrorInvalidValue;
  return D == 72 ? fwd<72>(q, k, v, o, lse, B, T, H, scale, stream) : fwd<80>(q, k, v, o, lse, B, T, H, scale, stream);
}

extern "C" int flash_full_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* dq, void* delta, int B, int T, int H,
                                      int D, float scale, void* stream) {
  if (!shape_ok(B, T, H, D)) return (int)cudaErrorInvalidValue;
  return D == 72 ? bwd_dq<72>(q, k, v, o, dout, lse, dq, delta, B, T, H, scale, stream)
                 : bwd_dq<80>(q, k, v, o, dout, lse, dq, delta, B, T, H, scale, stream);
}

extern "C" int flash_full_bwd_dkdv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                        const void* lse, const void* delta, void* dk, void* dv, int B, int T, int H,
                                        int D, float scale, void* stream) {
  if (!shape_ok(B, T, H, D)) return (int)cudaErrorInvalidValue;
  return D == 72 ? bwd_dkdv<72>(q, k, v, dout, lse, delta, dk, dv, B, T, H, scale, stream)
                 : bwd_dkdv<80>(q, k, v, dout, lse, delta, dk, dv, B, T, H, scale, stream);
}
