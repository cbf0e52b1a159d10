// Causal, segment-masked attention backward at head_dim 128 for Hopper (sm_90a): dq, which
// writes δ; then dk/dv.
//
// Replaces the backward halves of two Pallas entries (their forwards stay in attention.cu):
//  - adversarialvlm_tpu/ops/pallas/fused_attention.py::fused_sdpa_bthd at batch 1: _call_bwd_bthd
//    (pallas_call at :470, body _bwd_kernel_bthd :372);
//  - adversarialvlm_tpu/ops/pallas/attention.py::flash_sdpa (:178) at batch >= 2: the stock TPU
//    flash_attention's dq and dkv kernels through _flash_call (:97).
// Both compute the CAUSAL_SEG mode of attention.cu: query row i attends key j when j <= i and
// seg[i] == seg[j] (left pads carry segment 0). The operands are the projections' (B, T, heads,
// 128) layout; GQA q head h reads kv head h / (H / Hkv). The residuals are the forward's o and
// its (B, H, T) f32 row logsumexp.
//
// What bounds it on the H100: at the 7B decoder's shapes (32 heads of 128, T = 641 at batch 1,
// 4 rows of T = 677 at the batch-4 step) dq does 6·D·H flops per allowed pair and dk/dv 8 (about
// 23 and 31 GFLOP at the batch-4 step) on 6 and 8 bf16 (B, T, H, D) tensors (about 133 and 177
// MB): 170-175 operations per byte, under the card's ~295 ridge, so device memory bounds the
// ideal (0.040 and 0.053 ms at 3.35 TB/s). Beside the products every allowed pair costs an exp2
// and a dozen scalar operations on the accumulator registers, and at T ≈ 640 a head has only 11
// tiles of 64 rows, so the work is short walks that must fill 132 SMs.
//
// Design (all products are wgmma, bf16 in, f32 accumulate; flash_full.cu's structure):
//  - dq: a block is one warpgroup and owns 64 query rows of one (b, h). Per key tile of 64 up to
//    the causal limit: S = Q·Kᵀ and dP = dO·Vᵀ as m64n64k16 chains over 8 k-steps, P =
//    exp2(S·scale·log2e − lse·log2e) and dS = P ⊙ (dP − δ)·scale on the accumulator registers,
//    then dQ += dS·K as m64n128k16 with dS as the register A operand (the accumulator fragment is
//    already its layout) and K as an MN-major operand. dQ (64 f32 registers) stays in registers.
//    δ = rowsum(dO ⊙ O) is computed once per row and written for dk/dv, which runs second.
//  - dk/dv: a block is one warpgroup and owns 64 key rows of one kv head; it walks the n_rep q
//    heads and, for each, the query tiles at or after its keys: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, Pᵀ and
//    dSᵀ in registers, dV += Pᵀ·dO and dK += dSᵀ·Q (m64n128k16, Q and dO MN-major). dK and dV are
//    128 f32 registers a thread for the whole walk, so the GQA heads are summed in registers and
//    written once: deterministic, no atomics.
//  - Occupancy: blocks of one warpgroup, two per SM (97-98 KiB of shared memory each; dk/dv's
//    registers, about 220 a thread, allow two), so 352 blocks per kernel at batch 1 spread over
//    the 132 SMs, and each SM's two warpgroups hide each other's exp2 and masking behind their
//    products. The grid's slowest dimension is the tile, ordered longest walk first (dq: the last
//    query tile; dk/dv: key tile 0), so the short walks fill the tail.
//  - Loads: the other side's tiles stream through a two-stage ring filled by cp.async, issued by
//    the warpgroup one tile ahead. cp.async rather than TMA: the block is a single warpgroup with
//    no producer warp to spare, and cp.async writes each 16-byte chunk where wgmma's no-swizzle
//    canonical layout wants it: a tile of R rows × 128 columns is (R/8) × 16 core matrices of 8
//    rows × 16 bytes, each 128 contiguous bytes, 8-row groups 2 KiB apart and core columns 128
//    bytes apart (no padding column at D = 128). The same buffer is K-major for the products over
//    the head dim and MN-major for those over rows (the descriptor's strides swap roles), so q, k,
//    v and dO are stored once; rows past T are zero-filled by the copy.
//  - Masking in registers: the causal limit and the segment test per pair; a query row past T gets
//    lse = +inf in dq and a query column past T gets Pᵀ = 0 in dk/dv, so the zero-filled rows make
//    no inf or NaN. Rows past T are never written. Pad rows (segment 0) keep the plain version's
//    semantics: they attend earlier pads.
// Every entry checks cudaGetLastError() after its launch and returns it. D = 256 stays on
// attention.cu's entries. Measured times: PERF.md §6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;                     // head dim
constexpr int CP = D / 8;                  // core columns of a tile: 16
constexpr uint32_t C_STRIDE = 128;         // bytes from one core column to the next
constexpr uint32_t G_STRIDE = CP * 128;    // bytes from one 8-row group to the next
constexpr int BT = 64;                     // rows of a tile, on both sides
constexpr int TILE = BT * D * 2;           // 16 KiB
constexpr int NT = 128;                    // threads of a block: one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t core_off(int g, int c) { return (uint32_t)(g * CP + c) * 128u; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor, no swizzle: start address, leading-dimension byte offset (between
// core matrices along K), stride-dimension byte offset (between core matrices along M or N).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// K-major operand (tile rows are M or N, columns K = the head dim): the 16 columns of k-step kk.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + core_off(0, 2 * kk), C_STRIDE, G_STRIDE);
}

// MN-major operand (tile rows are K, columns N = the head dim): the 16 rows of k-step kk.
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

// Wait for this thread's copies, make them visible to wgmma's async proxy, then to the block.
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

// Rows [r0, r0 + BT) of one head (src: its row 0; rows `stride` elements apart) into a tile; rows
// at or past T are zero-filled by the copy.
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* __restrict__ src, long long stride, int r0,
                                          int T, int tid) {
#pragma unroll
  for (int i = tid; i < BT * CP; i += NT) {
    const int r8 = i & 7, rest = i >> 3, c = rest % CP, g = rest / CP;
    const int gr = r0 + g * 8 + r8;
    const bool ok = gr < T;
    cp_async16(tile + core_off(g, c) + r8 * 16, src + (size_t)(ok ? gr : 0) * stride + c * 8, ok);
  }
}

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

// D (64 × 64, f32) += A (64 × 16, shared, K-major) · B (16 × 64, shared, K-major).
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

// D (64 × 128, f32) += A (64 × 16, bf16 registers) · B (16 × 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
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

// S (64 × 64) = A · Bᵀ over the head dim: eight k-steps, both operands K-major tiles.
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(s, desc_k(a_tile, kk), desc_k(b_tile, kk), kk);
}

// acc (64 × 128) += A (64 × 64, registers) · B (64 × 128, a tile as an MN-major operand).
__device__ __forceinline__ void accumulate(float (&acc)[64], const uint32_t (&a)[16], uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) wgmma_rs_n128(acc, a + 4 * kk, desc_mn(b_tile, kk));
}

// Writes a warpgroup's 64 × 128 accumulator as bf16 rows r0 + (fragment row) of one head (dst: its
// row 0; rows `stride` elements apart), skipping rows at or past T.
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[64], int r0, int T,
                                           long long stride, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + lane / 4 + 8 * i;
    if (r >= T) continue;
    bf16* row = dst + (size_t)r * stride + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < CP; ++c)
      *reinterpret_cast<uint32_t*>(row + 8 * c) = pack_bf16(acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1]);
  }
}

// Shared memory, in bytes from the start.
struct DqSmem {  // Q at 0, then dO, a two-stage ring of K and of V tiles and of the keys' segments
  static constexpr int DO = TILE, K = 2 * TILE, V = 4 * TILE, SEG = 6 * TILE, bytes = SEG + 2 * BT * 4;
};

struct DkdvSmem {  // K at 0, then V, a two-stage ring of Q and dO tiles and of the queries' lse, δ, segments
  static constexpr int V = TILE, Q = 2 * TILE, DO = 4 * TILE, LSE = 6 * TILE, DL = LSE + 2 * BT * 4,
                       SEG = DL + 2 * BT * 4, bytes = SEG + 2 * BT * 4;
};

// q, o, dout, dq: (B, T, H, 128) bf16; k, v: (B, T, Hkv, 128) bf16; seg: (B, T) int32; lse, delta:
// (B, H, T) f32. Block (h, b, z): query rows [64·t, 64·t + 64) of head h of row b, t = nqt − 1 − z;
// writes δ of its rows, then dq.
__global__ void __launch_bounds__(NT, 2)
    causal_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const int* __restrict__ seg, const bf16* __restrict__ o, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, bf16* __restrict__ dq, float* __restrict__ delta, int T,
                     int H, int Hkv, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y, qt = gridDim.z - 1 - blockIdx.z, q0 = qt * BT;
  const int hk = h / (H / Hkv);
  const long long rq = (long long)H * D, rk = (long long)Hkv * D;
  const size_t qh = (size_t)b * T * rq + (size_t)h * D, kh = (size_t)b * T * rk + (size_t)hk * D;
  q += qh;
  o += qh;
  dout += qh;
  dq += qh;
  k += kh;
  v += kh;
  seg += (size_t)b * T;
  lse += ((size_t)b * H + h) * T;
  delta += ((size_t)b * H + h) * T;
  const uint32_t sQ = smem_u32(smem), sDO = sQ + DqSmem::DO, sK = sQ + DqSmem::K, sV = sQ + DqSmem::V,
                 sSeg = sQ + DqSmem::SEG;
  const int* kseg_s = reinterpret_cast<const int*>(smem + DqSmem::SEG);

  load_tile(sQ, q, rq, q0, T, tid);
  load_tile(sDO, dout, rq, q0, T, tid);
  load_tile(sK, k, rk, 0, T, tid);
  load_tile(sV, v, rk, 0, T, tid);
  if (tid < BT) load_rowval(sSeg, seg, 0, T, tid);
  cp_commit();

  // While the first tiles load: δ = rowsum(dO ⊙ O), lse (log2 units) and the segment of the
  // thread's two rows; a row past T gets lse = +inf, so its P is 0.
  const int r0 = q0 + warp * 16 + lane / 4;
  float lse2[2], dl[2];
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    float a = 0.f;
    if (r < T) {
#pragma unroll
      for (int c = quad; c < CP; c += 4) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + (size_t)r * rq + 8 * c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + (size_t)r * rq + 8 * c);
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
    qseg[i] = r < T ? seg[r] : 0;
    if (quad == 0 && r < T) delta[r] = a;
  }

  const float sl2 = scale * LOG2E;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int nkt = qt + 1;  // key tiles up to the causal limit
#pragma unroll 1
  for (int j = 0; j < nkt; ++j) {
    arrive_tile();  // tile j is in; the products of tile j - 1 are done
    if (j + 1 < nkt) {
      const int nx = (j + 1) & 1;
      load_tile(sK + nx * TILE, k, rk, (j + 1) * BT, T, tid);
      load_tile(sV + nx * TILE, v, rk, (j + 1) * BT, T, tid);
      if (tid < BT) load_rowval(sSeg + nx * BT * 4, seg, (j + 1) * BT, T, tid);
      cp_commit();
    }
    const int st = j & 1;
    const uint32_t tK = sK + st * TILE, tV = sV + st * TILE;
    float s[32], dp[32];
    wg_fence();
    scores(s, sQ, tK);
    scores(dp, sDO, tV);
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(dp);
    const int k0 = j * BT;
    const int* ks = kseg_s + st * BT;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 8 * c + 2 * quad;
      const int2 sk = *reinterpret_cast<const int2*>(ks + col);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * c + 2 * i + e;
          const bool ok = k0 + col + e <= r0 + 8 * i && (e ? sk.y : sk.x) == qseg[i];
          const float p = ok ? fast_exp2(fmaf(s[x], sl2, -lse2[i])) : 0.f;
          s[x] = p * (dp[x] - dl[i]) * scale;  // dS
        }
    }
    uint32_t ds[16];
    to_operand(s, ds);
    wg_fence();
    accumulate(acc, ds, tK);
    wg_commit();
    wg_wait();
    reg_fence(acc);
  }
  store_rows(dq, acc, q0 + warp * 16, T, rq, lane);
}

// q, dout: (B, T, H, 128) bf16; k, v, dk, dv: (B, T, Hkv, 128) bf16; seg: (B, T) int32; lse,
// delta: (B, H, T) f32. Block (hk, b, t): key rows [64·t, 64·t + 64) of kv head hk of row b, over
// its n_rep q heads and the query tiles at or after its keys.
__global__ void __launch_bounds__(NT, 2)
    causal_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const int* __restrict__ seg, const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H,
                       int Hkv, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int hk = blockIdx.x, b = blockIdx.y, kt = blockIdx.z, k0 = kt * BT;
  const int n_rep = H / Hkv;
  const long long rq = (long long)H * D, rk = (long long)Hkv * D;
  const size_t kh = (size_t)b * T * rk + (size_t)hk * D;
  q += (size_t)b * T * rq;  // head h: + h·D
  dout += (size_t)b * T * rq;
  k += kh;
  v += kh;
  dk += kh;
  dv += kh;
  seg += (size_t)b * T;
  lse += (size_t)b * H * T;  // head h: + h·T
  delta += (size_t)b * H * T;
  const uint32_t sK = smem_u32(smem), sV = sK + DkdvSmem::V, sQ = sK + DkdvSmem::Q, sDO = sK + DkdvSmem::DO;
  const float* lse_s = reinterpret_cast<const float*>(smem + DkdvSmem::LSE);
  const float* dl_s = reinterpret_cast<const float*>(smem + DkdvSmem::DL);
  const int* qseg_s = reinterpret_cast<const int*>(smem + DkdvSmem::SEG);

  // the walk: item w is query tile kt + w % nq of q head hk·n_rep + w / nq
  const int nq = (T + BT - 1) / BT - kt, items = n_rep * nq;
  auto load_item = [&](int w, int st) {
    const int h = hk * n_rep + w / nq, r1 = (kt + w % nq) * BT;
    load_tile(sQ + st * TILE, q + (size_t)h * D, rq, r1, T, tid);
    load_tile(sDO + st * TILE, dout + (size_t)h * D, rq, r1, T, tid);
    if (tid < BT) {
      load_rowval(sK + DkdvSmem::LSE + st * BT * 4, lse + (size_t)h * T, r1, T, tid);
      load_rowval(sK + DkdvSmem::DL + st * BT * 4, delta + (size_t)h * T, r1, T, tid);
      load_rowval(sK + DkdvSmem::SEG + st * BT * 4, seg, r1, T, tid);
    }
  };
  load_tile(sK, k, rk, k0, T, tid);
  load_tile(sV, v, rk, k0, T, tid);
  load_item(0, 0);
  cp_commit();

  const int kr = k0 + warp * 16 + lane / 4;  // the thread's two key rows: kr and kr + 8
  int kseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kseg[i] = kr + 8 * i < T ? seg[kr + 8 * i] : 0;

  const float sl2 = scale * LOG2E;
  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll 1
  for (int w = 0; w < items; ++w) {
    arrive_tile();
    if (w + 1 < items) {
      load_item(w + 1, (w + 1) & 1);
      cp_commit();
    }
    const int st = w & 1, q0 = (kt + w % nq) * BT;
    const uint32_t tQ = sQ + st * TILE, tDO = sDO + st * TILE;
    float s[32], dp[32];  // Sᵀ and dPᵀ: rows are this block's keys, columns the tile's queries
    wg_fence();
    scores(s, sK, tQ);
    scores(dp, sV, tDO);
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(dp);
    const float* ls = lse_s + st * BT;
    const float* ds = dl_s + st * BT;
    const int* qs = qseg_s + st * BT;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 8 * c + 2 * quad;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
      const float2 d2 = *reinterpret_cast<const float2*>(ds + col);
      const int2 sq = *reinterpret_cast<const int2*>(qs + col);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * c + 2 * i + e, gq = q0 + col + e;
          const bool ok = gq < T && kr + 8 * i <= gq && (e ? sq.y : sq.x) == kseg[i];
          const float p = ok ? fast_exp2(fmaf(s[x], sl2, -(e ? l2.y : l2.x) * LOG2E)) : 0.f;
          s[x] = p;                                         // Pᵀ
          dp[x] = p * (dp[x] - (e ? d2.y : d2.x)) * scale;  // dSᵀ
        }
    }
    uint32_t pa[16], da[16];
    to_operand(s, pa);
    to_operand(dp, da);
    wg_fence();
    accumulate(dv_acc, pa, tDO);
    accumulate(dk_acc, da, tQ);
    wg_commit();
    wg_wait();
    reg_fence(dv_acc);
    reg_fence(dk_acc);
  }
  store_rows(dk, dk_acc, k0 + warp * 16, T, rk, lane);
  store_rows(dv, dv_acc, k0 + warp * 16, T, rk, lane);
}

bool shape_ok(int B, int T, int H, int Hkv, int D_) {
  return B > 0 && B <= 65535 && T > 0 && (T + BT - 1) / BT <= 65535 && H > 0 && H <= 65535 && Hkv > 0 &&
         H % Hkv == 0 && D_ == D;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem_bytes, dim3 grid, void* stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem_bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on success). Causal with a
// segment mask over B rows, D = 128 only, all tensors contiguous: q, o, dout, dq are (B, T, H, D)
// bf16; k, v, dk, dv (B, T, Hkv, D) bf16; seg (B, T) int32; lse and delta (B, H, T) f32. dq writes
// delta, which dk/dv reads.

extern "C" int causal_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* seg, const void* o,
                                  const void* dout, const void* lse, void* dq, void* delta, int B, int T, int H,
                                  int Hkv, int D_, float scale, void* stream) {
  if (!shape_ok(B, T, H, Hkv, D_)) return (int)cudaErrorInvalidValue;
  return launch(causal_dq_kernel, DqSmem::bytes, dim3(H, B, (T + BT - 1) / BT), stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                static_cast<const int*>(seg), static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
                static_cast<const float*>(lse), static_cast<bf16*>(dq), static_cast<float*>(delta), T, H, Hkv,
                scale);
}

extern "C" int causal_bwd_dkdv_bf16(const void* q, const void* k, const void* v, const void* seg,
                                    const void* dout, const void* lse, const void* delta, void* dk, void* dv, int B,
                                    int T, int H, int Hkv, int D_, float scale, void* stream) {
  if (!shape_ok(B, T, H, Hkv, D_)) return (int)cudaErrorInvalidValue;
  return launch(causal_dkdv_kernel, DkdvSmem::bytes, dim3(Hkv, B, (T + BT - 1) / BT), stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                static_cast<const int*>(seg), static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H, Hkv,
                scale);
}
