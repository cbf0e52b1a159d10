// Segment-masked attention backward for Hopper (sm_90a), causal or not, at head dim 32, 64, 96, 128
// or 256, over operands read in place through their strides: dq, which writes δ; then dk/dv.
//
// Replaces the backward halves of three Pallas entries (their forwards are causal_fwd.cu's):
//  - adversarialvlm_tpu/ops/pallas/fused_attention.py::fused_sdpa_bthd at batch 1: _call_bwd_bthd
//    (pallas_call at :470, body _bwd_kernel_bthd :372);
//  - adversarialvlm_tpu/ops/pallas/attention.py::flash_sdpa (:178) at batch >= 2: the stock TPU
//    flash_attention's dq and dkv kernels through _flash_call (:97);
//  - adversarialvlm_tpu/ops/pallas/fused_attention.py::fused_sdpa: _call_bwd (:229, pallas_call at
//    :235, bodies _bwd_kernel :126 and _bwd_kernel_v2 :154; v1 and v2 are the same math), in
//    (B, H, T, D) layout, causal or not, no GQA; its single backward call is the two kernels here.
// The first two compute the CAUSAL_SEG mode of attention_sm90.cuh at head dim 96, 128 or 256 in the
// projections' (B, T, heads, D) layout; GQA q head h reads kv head h / (H / Hkv). fused_sdpa
// takes CAUSAL_SEG or SEG. The residuals are the forward's o and its (B, H, T) f32 row logsumexp.
//
// What bounds it on the H100: at the 7B decoder's shapes (32 heads of 128, T = 641 at batch 1,
// 4 rows of T = 677 at the batch-4 step) dq does 6·D·H flops per allowed pair and dk/dv 8 (about
// 23 and 31 GFLOP at the batch-4 step) on 6 and 8 bf16 (B, T, H, D) tensors (about 133 and 177
// MB): 170-175 operations per byte, under the card's ~295 ridge, so device memory bounds the
// ideal (0.040 and 0.053 ms at 3.35 TB/s). Beside the products every allowed pair costs an exp2
// and a dozen scalar operations on the accumulator registers, and at T ≈ 640 a head has only 11
// tiles of 64 rows, so the work is short walks that must fill 132 SMs. At head dim 96 (Phi-3.5's
// decoder, 32 heads; the batch-2 step, 2 × 797) dq and dk/dv are bound by bytes as well (0.0177 ms
// each) and run the D-128 plans at 96 columns.
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
//    canonical layout (attention_sm90.cuh) wants it, from any row stride; rows past T are
//    zero-filled by the copy.
//  - Masking in registers: the causal limit (CAUSAL_SEG; SEG walks every tile of the other side)
//    and the segment test per pair; a query row past T gets lse = +inf in dq, a key column past T
//    is masked in SEG's dq and a query column past T gets Pᵀ = 0 in dk/dv, so the zero-filled rows
//    make no inf or NaN. Rows past T are never written. Pad rows (segment 0) keep the plain
//    version's semantics: they attend pads (earlier ones, if causal).
//  - Head dims under 128 change only the tiles' width, the k-steps over the head dim and N of the
//    m64n{D}k16 products; the arithmetic per pair is the same.
//  - Head dim 256 (Gemma-3's global layers: the custom VJP of flash_sdpa; no attack step runs it,
//    every Gemma layer there is masked). A 64-row tile of 256 columns is 32 KiB and a warpgroup's
//    64 × 256 f32 accumulator 128 registers a thread, which sets both plans:
//    - dq: a block is two warpgroups of 64 query rows each (Q and dO of both: 128 KiB) over a
//      two-stage ring of 32-row K and V tiles (64 KiB): S and dP are m64n32k16 chains, dQ +=
//      dS·K two m64n256k16 k-steps a tile; 214 registers a thread, one block per SM.
//    - dk/dv (causal_dkdv_split_kernel): dK and dV of 64 key rows would be 256 registers a thread
//      in one warpgroup. So two warpgroups share one key tile and split the head dim: warpgroup w
//      accumulates columns [128w, 128w + 128) of dK and dV (128 registers). Each computes half of
//      the tile's Sᵀ and dPᵀ (query columns [32w, 32w + 32), m64n32k16 chains), Pᵀ and dSᵀ of
//      both halves meet in shared memory as bf16 (8 KiB each), and dV += Pᵀ·dO, dK += dSᵀ·Q run
//      as m64n128k16 with both operands in shared memory. K and V stay resident (64 KiB), Q, dO,
//      lse, δ and the segments stream through a two-stage ring (about 210 KiB in all). GQA heads
//      are summed in registers as at 128.
//    - Both keep their q, k, v and dO tiles in the 128-byte-swizzled layout of attention_sm90.cuh
//      (the m64n32k16 chains over 16 k-steps ran 1.2-1.4× faster than on the no-swizzle one) and
//      write dQ, dK and dV through a freed tile buffer as whole rows (PERF.md §6).
// Every entry checks cudaGetLastError() after its launch and returns it. Measured times: PERF.md §6.

#include "attention_sm90.cuh"

namespace {

using namespace attn;

constexpr int NT = 128;  // threads of a warpgroup, and of a block but at head dim 256

// dq's plan at head dim D (see the note above): warpgroups a block, each owning 64 query rows, and
// the rows of a K/V tile of the ring.
template <int D>
struct DqPlan {
  static constexpr int WGS = D > 128 ? 2 : 1, BK = D > 128 ? 32 : 64;
  static constexpr bool SW = D > 128;  // tiles in the 128-byte-swizzled layout (attention_sm90.cuh)
};

// Shared memory, in bytes from the start.
template <int D>
struct DqSmem {  // Q at 0, then dO, a two-stage ring of K and of V tiles and of the keys' segments
  static constexpr int WGS = DqPlan<D>::WGS, BK = DqPlan<D>::BK, TILE = Head<D>::TILE, KT = BK * D * 2;
  static constexpr int DO = WGS * TILE, K = 2 * WGS * TILE, V = K + 2 * KT, SEG = V + 2 * KT,
                       bytes = SEG + 2 * BK * 4 + (DqPlan<D>::SW ? 1024 : 0);
};

template <int D>
struct DkdvSmem {  // K at 0, then V, a two-stage ring of Q and dO tiles and of the queries' lse, δ, segments
  static constexpr int TILE = Head<D>::TILE;
  static constexpr int V = TILE, Q = 2 * TILE, DO = 4 * TILE, LSE = 6 * TILE, DL = LSE + 2 * BT * 4,
                       SEG = DL + 2 * BT * 4, bytes = SEG + 2 * BT * 4;
};

template <int D>
struct DkdvSplitSmem {  // DkdvSmem's, with Pᵀ and dSᵀ (64 × 64 bf16 tiles) after the ring
  static constexpr int TILE = Head<D>::TILE, PT = Head<BT>::TILE;
  static constexpr int V = TILE, Q = 2 * TILE, DO = 4 * TILE, P = 6 * TILE, DS = P + PT, LSE = DS + PT,
                       DL = LSE + 2 * BT * 4, SEG = DL + 2 * BT * 4, bytes = SEG + 2 * BT * 4 + 1024;
};

// q, o, dout and dq are laid out as lq, k and v as lk; seg: (B, T) int32; lse, delta: (B, H, T) f32,
// contiguous. Block (h, b, z): query rows [R·t, R·t + R) of head h of row b, R = 64·WGS, t = nqt −
// 1 − z; warpgroup w owns rows [R·t + 64w, R·t + 64w + 64); writes δ of its rows, then dq.
template <int D, int MASK>
__global__ void __launch_bounds__(NT * DqPlan<D>::WGS, 2 / DqPlan<D>::WGS)
    causal_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const int* __restrict__ seg, const bf16* __restrict__ o, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, bf16* __restrict__ dq, float* __restrict__ delta, int T,
                     int H, int Hkv, float scale, Layout lq, Layout lk) {
  typedef DqSmem<D> L;
  constexpr int CP = Head<D>::CP, WGS = L::WGS, BK = L::BK, KT = L::KT, THREADS = NT * WGS;
  constexpr bool SW = DqPlan<D>::SW;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = SW ? align_1k(smem_raw) : smem_raw;
  const int tid = threadIdx.x, wg = tid / NT, warp = (tid / 32) % 4, lane = tid % 32, quad = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y, qt = gridDim.z - 1 - blockIdx.z, q0 = qt * BT * WGS;
  const int hk = h / (H / Hkv);
  const long long rq = lq.r, rk = lk.r;
  const size_t qh = (size_t)(b * lq.b + h * lq.h), kh = (size_t)(b * lk.b + hk * lk.h);
  q += qh;
  o += qh;
  dout += qh;
  dq += qh;
  k += kh;
  v += kh;
  seg += (size_t)b * T;
  lse += ((size_t)b * H + h) * T;
  delta += ((size_t)b * H + h) * T;
  const uint32_t sQ = smem_u32(smem), sDO = sQ + L::DO, sK = sQ + L::K, sV = sQ + L::V, sSeg = sQ + L::SEG;
  const int* kseg_s = reinterpret_cast<const int*>(smem + L::SEG);

  // K and V tile j into ring stage st
  auto load_kv = [&](int j, int st) {
    if constexpr (SW) {
      load_tile_sw<D, BK, THREADS>(sK + st * KT, k, rk, j * BK, T, tid);
      load_tile_sw<D, BK, THREADS>(sV + st * KT, v, rk, j * BK, T, tid);
    } else {
      load_tile<D, BK, THREADS>(sK + st * KT, k, rk, j * BK, T, tid);
      load_tile<D, BK, THREADS>(sV + st * KT, v, rk, j * BK, T, tid);
    }
    if (tid < BK) load_rowval(sSeg + st * BK * 4, seg, j * BK, T, tid);
  };
  if constexpr (SW) {
    load_tile_sw<D, BT * WGS, THREADS>(sQ, q, rq, q0, T, tid);
    load_tile_sw<D, BT * WGS, THREADS>(sDO, dout, rq, q0, T, tid);
  } else {
    load_tile<D, BT * WGS, THREADS>(sQ, q, rq, q0, T, tid);
    load_tile<D, BT * WGS, THREADS>(sDO, dout, rq, q0, T, tid);
  }
  load_kv(0, 0);
  cp_commit();

  // While the first tiles load: δ = rowsum(dO ⊙ O), lse (log2 units) and the segment of the
  // thread's two rows; a row past T gets lse = +inf, so its P is 0.
  const int w0 = q0 + wg * BT, r0 = w0 + warp * 16 + lane / 4;  // the warpgroup's and the thread's rows
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
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // key tiles up to the block's causal limit, or all; a warpgroup skips the tiles past its own
  const int nkt = (MASK == CAUSAL_SEG ? min(q0 + BT * WGS, T) - 1 : T - 1) / BK + 1;
  const int wg_last = MASK == CAUSAL_SEG ? min(w0 + BT, T) - 1 : T - 1;
#pragma unroll 1
  for (int j = 0; j < nkt; ++j) {
    arrive_tile();  // tile j is in; the products of tile j - 1 are done
    if (j + 1 < nkt) {
      load_kv(j + 1, (j + 1) & 1);
      cp_commit();
    }
    const int k0 = j * BK;
    if (w0 >= T || k0 > wg_last) continue;  // no row of this warpgroup attends this tile
    const int st = j & 1;
    const uint32_t tK = sK + st * KT, tV = sV + st * KT;
    float s[BK / 2], dp[BK / 2];
    wg_fence();
    if constexpr (SW) {
      scores_sw<D, BT * WGS, BK, BK>(s, sQ, BT * wg, tK, 0);
      scores_sw<D, BT * WGS, BK, BK>(dp, sDO, BT * wg, tV, 0);
    } else {
      scores<D>(s, sQ, 8 * wg, tK);
      scores<D>(dp, sDO, 8 * wg, tV);
    }
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(dp);
    const int* ks = kseg_s + st * BK;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
      const int col = 8 * c + 2 * quad;
      const int2 sk = *reinterpret_cast<const int2*>(ks + col);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * c + 2 * i + e;
          const bool ok = (MASK == CAUSAL_SEG ? k0 + col + e <= r0 + 8 * i : k0 + col + e < T) &&
                          (e ? sk.y : sk.x) == qseg[i];
          const float p = ok ? fast_exp2(fmaf(s[x], sl2, -lse2[i])) : 0.f;
          s[x] = p * (dp[x] - dl[i]) * scale;  // dS
        }
    }
    uint32_t ds[BK / 4];
    to_operand(s, ds);
    wg_fence();
    if constexpr (SW)
      accumulate_sw<D, BK>(acc, ds, tK);
    else
      accumulate<D>(acc, ds, tK);
    wg_commit();
    wg_wait();
    reg_fence(acc);
  }
  if constexpr (SW) {  // dQ goes out through the warpgroup's Q rows, whole rows at a time
    wg_barrier(1 + wg);
    stage_rows<D, BT * WGS, D>(smem, acc, BT * wg, 0, warp, lane);
    wg_barrier(1 + wg);
    store_tile<D, BT * WGS, BT, NT>(dq, rq, smem, BT * wg, w0, T, tid % NT);
  } else {
    store_rows<D>(dq, acc, w0 + warp * 16, T, rq, lane);
  }
}

// q and dout are laid out as lq, k, v, dk and dv as lk; seg: (B, T) int32; lse, delta: (B, H, T)
// f32, contiguous. Block (hk, b, t): key rows [64·t, 64·t + 64) of kv head hk of row b, over its
// n_rep q heads and the query tiles at or after its keys (all of them in SEG).
template <int D, int MASK>
__global__ void __launch_bounds__(NT, 2)
    causal_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const int* __restrict__ seg, const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H,
                       int Hkv, float scale, Layout lq, Layout lk) {
  typedef DkdvSmem<D> L;
  constexpr int TILE = L::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int hk = blockIdx.x, b = blockIdx.y, kt = blockIdx.z, k0 = kt * BT;
  const int n_rep = H / Hkv;
  const long long rq = lq.r, rk = lk.r;
  const size_t kh = (size_t)(b * lk.b + hk * lk.h);
  q += (size_t)(b * lq.b);  // head h: + h·lq.h
  dout += (size_t)(b * lq.b);
  k += kh;
  v += kh;
  dk += kh;
  dv += kh;
  seg += (size_t)b * T;
  lse += (size_t)b * H * T;  // head h: + h·T
  delta += (size_t)b * H * T;
  const uint32_t sK = smem_u32(smem), sV = sK + L::V, sQ = sK + L::Q, sDO = sK + L::DO;
  const float* lse_s = reinterpret_cast<const float*>(smem + L::LSE);
  const float* dl_s = reinterpret_cast<const float*>(smem + L::DL);
  const int* qseg_s = reinterpret_cast<const int*>(smem + L::SEG);

  // the walk: item w is query tile t0 + w % nq of q head hk·n_rep + w / nq
  const int t0 = MASK == CAUSAL_SEG ? kt : 0, nq = (T + BT - 1) / BT - t0, items = n_rep * nq;
  auto load_item = [&](int w, int st) {
    const int h = hk * n_rep + w / nq, r1 = (t0 + w % nq) * BT;
    load_tile<D, BT, NT>(sQ + st * TILE, q + (size_t)(h * lq.h), rq, r1, T, tid);
    load_tile<D, BT, NT>(sDO + st * TILE, dout + (size_t)(h * lq.h), rq, r1, T, tid);
    if (tid < BT) {
      load_rowval(sK + L::LSE + st * BT * 4, lse + (size_t)h * T, r1, T, tid);
      load_rowval(sK + L::DL + st * BT * 4, delta + (size_t)h * T, r1, T, tid);
      load_rowval(sK + L::SEG + st * BT * 4, seg, r1, T, tid);
    }
  };
  load_tile<D, BT, NT>(sK, k, rk, k0, T, tid);
  load_tile<D, BT, NT>(sV, v, rk, k0, T, tid);
  load_item(0, 0);
  cp_commit();

  const int kr = k0 + warp * 16 + lane / 4;  // the thread's two key rows: kr and kr + 8
  int kseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kseg[i] = kr + 8 * i < T ? seg[kr + 8 * i] : 0;

  const float sl2 = scale * LOG2E;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll 1
  for (int w = 0; w < items; ++w) {
    arrive_tile();
    if (w + 1 < items) {
      load_item(w + 1, (w + 1) & 1);
      cp_commit();
    }
    const int st = w & 1, q0 = (t0 + w % nq) * BT;
    const uint32_t tQ = sQ + st * TILE, tDO = sDO + st * TILE;
    float s[32], dp[32];  // Sᵀ and dPᵀ: rows are this block's keys, columns the tile's queries
    wg_fence();
    scores<D>(s, sK, 0, tQ);
    scores<D>(dp, sV, 0, tDO);
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
          const bool ok = gq < T && (MASK != CAUSAL_SEG || kr + 8 * i <= gq) && (e ? sq.y : sq.x) == kseg[i];
          const float p = ok ? fast_exp2(fmaf(s[x], sl2, -(e ? l2.y : l2.x) * LOG2E)) : 0.f;
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
  store_rows<D>(dk, dk_acc, k0 + warp * 16, T, rk, lane);
  store_rows<D>(dv, dv_acc, k0 + warp * 16, T, rk, lane);
}

// Head dim 256 (see the note above): as causal_dkdv_kernel, with two warpgroups splitting the head
// dim of dK and dV. Warpgroup w computes Sᵀ and dPᵀ for query columns [32w, 32w + 32) of each tile,
// writes its half of Pᵀ and dSᵀ as bf16 into shared memory, and after the block's barrier
// accumulates columns [D/2·w, D/2·w + D/2) of dV += Pᵀ·dO and dK += dSᵀ·Q over all 64 queries.
template <int D, int MASK>
__global__ void __launch_bounds__(2 * NT, 1)
    causal_dkdv_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                             const int* __restrict__ seg, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, int T, int H, int Hkv, float scale, Layout lq, Layout lk) {
  typedef DkdvSplitSmem<D> L;
  static_assert(D == 256, "the split serves head dim 256: m64n128k16 over each half");
  constexpr int TILE = L::TILE, THREADS = 2 * NT, HALF = D / 2;
  constexpr uint32_t PANEL = Swz<D, BT>::PANEL;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);  // K, V, Q and dO tiles in the 128-byte-swizzled layout
  const int tid = threadIdx.x, wg = tid / NT, warp = (tid / 32) % 4, lane = tid % 32, quad = lane % 4;
  const int hk = blockIdx.x, b = blockIdx.y, kt = blockIdx.z, k0 = kt * BT;
  const int n_rep = H / Hkv;
  const long long rq = lq.r, rk = lk.r;
  const size_t kh = (size_t)(b * lk.b + hk * lk.h);
  q += (size_t)(b * lq.b);  // head h: + h·lq.h
  dout += (size_t)(b * lq.b);
  k += kh;
  v += kh;
  dk += kh;
  dv += kh;
  seg += (size_t)b * T;
  lse += (size_t)b * H * T;  // head h: + h·T
  delta += (size_t)b * H * T;
  const uint32_t sK = smem_u32(smem), sV = sK + L::V, sQ = sK + L::Q, sDO = sK + L::DO, sP = sK + L::P,
                 sDS = sK + L::DS;
  const float* lse_s = reinterpret_cast<const float*>(smem + L::LSE);
  const float* dl_s = reinterpret_cast<const float*>(smem + L::DL);
  const int* qseg_s = reinterpret_cast<const int*>(smem + L::SEG);

  // the walk: item w is query tile t0 + w % nq of q head hk·n_rep + w / nq
  const int t0 = MASK == CAUSAL_SEG ? kt : 0, nq = (T + BT - 1) / BT - t0, items = n_rep * nq;
  auto load_item = [&](int w, int st) {
    const int h = hk * n_rep + w / nq, r1 = (t0 + w % nq) * BT;
    load_tile_sw<D, BT, THREADS>(sQ + st * TILE, q + (size_t)(h * lq.h), rq, r1, T, tid);
    load_tile_sw<D, BT, THREADS>(sDO + st * TILE, dout + (size_t)(h * lq.h), rq, r1, T, tid);
    if (tid < BT) {
      load_rowval(sK + L::LSE + st * BT * 4, lse + (size_t)h * T, r1, T, tid);
      load_rowval(sK + L::DL + st * BT * 4, delta + (size_t)h * T, r1, T, tid);
      load_rowval(sK + L::SEG + st * BT * 4, seg, r1, T, tid);
    }
  };
  load_tile_sw<D, BT, THREADS>(sK, k, rk, k0, T, tid);
  load_tile_sw<D, BT, THREADS>(sV, v, rk, k0, T, tid);
  load_item(0, 0);
  cp_commit();

  const int kr = k0 + warp * 16 + lane / 4;  // the thread's two key rows: kr and kr + 8
  int kseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kseg[i] = kr + 8 * i < T ? seg[kr + 8 * i] : 0;

  const float sl2 = scale * LOG2E;
  float dk_acc[HALF / 2], dv_acc[HALF / 2];
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll 1
  for (int w = 0; w < items; ++w) {
    arrive_tile();  // item w is in; both warpgroups are done with item w - 1 and its Pᵀ and dSᵀ
    if (w + 1 < items) {
      load_item(w + 1, (w + 1) & 1);
      cp_commit();
    }
    const int st = w & 1, q0 = (t0 + w % nq) * BT;
    const uint32_t tQ = sQ + st * TILE, tDO = sDO + st * TILE;
    float s[16], dp[16];  // this warpgroup's half of Sᵀ and dPᵀ: rows are the keys, columns 32 queries
    wg_fence();
    scores_sw<D, BT, BT, 32>(s, sK, 0, tQ, 32 * wg);
    scores_sw<D, BT, BT, 32>(dp, sV, 0, tDO, 32 * wg);
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(dp);
    const float* ls = lse_s + st * BT;
    const float* ds = dl_s + st * BT;
    const int* qs = qseg_s + st * BT;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 32 * wg + 8 * c + 2 * quad;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
      const float2 d2 = *reinterpret_cast<const float2*>(ds + col);
      const int2 sq = *reinterpret_cast<const int2*>(qs + col);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float pv[2], dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * c + 2 * i + e, gq = q0 + col + e;
          const bool ok = gq < T && (MASK != CAUSAL_SEG || kr + 8 * i <= gq) && (e ? sq.y : sq.x) == kseg[i];
          const float p = ok ? fast_exp2(fmaf(s[x], sl2, -(e ? l2.y : l2.x) * LOG2E)) : 0.f;
          pv[e] = p;                                         // Pᵀ
          dsv[e] = p * (dp[x] - (e ? d2.y : d2.x)) * scale;  // dSᵀ
        }
        // key row 16·warp + lane/4 + 8i, query column col: the 64 × 64 K-major canonical layout
        const uint32_t off = Head<BT>::core_off(2 * warp + i, col / 8) + (lane / 4) * 16 + (col % 8) * 2;
        *reinterpret_cast<uint32_t*>(smem + L::P + off) = pack_bf16(pv[0], pv[1]);
        *reinterpret_cast<uint32_t*>(smem + L::DS + off) = pack_bf16(dsv[0], dsv[1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stores, to wgmma's proxy
    __syncthreads();  // both halves of Pᵀ and dSᵀ are in
    const uint32_t half = wg * (HALF / 64) * PANEL;  // this warpgroup's first panel of dO and Q
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      wgmma_ss_n128_tb(dv_acc, desc_k<BT>(sP, 0, kk), desc_mn_sw<D, BT>(tDO + half, kk));
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      wgmma_ss_n128_tb(dk_acc, desc_k<BT>(sDS, 0, kk), desc_mn_sw<D, BT>(tQ + half, kk));
    wg_commit();
    wg_wait();
    reg_fence(dv_acc);
    reg_fence(dk_acc);
  }
  __syncthreads();  // the products are done with K and V: dK and dV go out through their buffers
  stage_rows<D, BT, HALF>(smem, dk_acc, 0, (HALF / 8) * wg, warp, lane);
  stage_rows<D, BT, HALF>(smem + L::V, dv_acc, 0, (HALF / 8) * wg, warp, lane);
  __syncthreads();
  store_tile<D, BT, BT, THREADS>(dk, rk, smem, 0, k0, T, tid);
  store_tile<D, BT, BT, THREADS>(dv, rk, smem + L::V, 0, k0, T, tid);
}

bool shape_ok(int B, int T, int H, int Hkv) {
  return B > 0 && B <= 65535 && T > 0 && (T + BT - 1) / BT <= 65535 && H > 0 && H <= 65535 && Hkv > 0 &&
         H % Hkv == 0;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem_bytes, dim3 grid, int threads, void* stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

template <int D, int MASK>
int dq(const void* q, const void* k, const void* v, const void* seg, const void* o, const void* dout,
       const void* lse, void* dq_, void* delta, int B, int T, int H, int Hkv, float scale, Layout lq, Layout lk,
       void* stream) {
  constexpr int ROWS = BT * DqPlan<D>::WGS;
  return launch(causal_dq_kernel<D, MASK>, DqSmem<D>::bytes, dim3(H, B, (T + ROWS - 1) / ROWS),
                NT * DqPlan<D>::WGS, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                static_cast<const int*>(seg), static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
                static_cast<const float*>(lse), static_cast<bf16*>(dq_), static_cast<float*>(delta), T, H, Hkv,
                scale, lq, lk);
}

template <int D, int MASK>
int dkdv(const void* q, const void* k, const void* v, const void* seg, const void* dout, const void* lse,
         const void* delta, void* dk, void* dv, int B, int T, int H, int Hkv, float scale, Layout lq, Layout lk,
         void* stream) {
  const dim3 grid(Hkv, B, (T + BT - 1) / BT);
  if constexpr (D > 128)
    return launch(causal_dkdv_split_kernel<D, MASK>, DkdvSplitSmem<D>::bytes, grid, 2 * NT, stream,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  static_cast<const int*>(seg), static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H, Hkv,
                  scale, lq, lk);
  else
    return launch(causal_dkdv_kernel<D, MASK>, DkdvSmem<D>::bytes, grid, NT, stream,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  static_cast<const int*>(seg), static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H, Hkv,
                  scale, lq, lk);
}

Layout layout_of(const long long* s) { return Layout{s[0], s[1], s[2]}; }

// fused_sdpa: one instantiation per (head dim, mask mode).
#define FUSED_DISPATCH(CALL)                                          \
  switch (D) {                                                        \
    case 32: return causal ? CALL(32, CAUSAL_SEG) : CALL(32, SEG);    \
    case 64: return causal ? CALL(64, CAUSAL_SEG) : CALL(64, SEG);    \
    case 96: return causal ? CALL(96, CAUSAL_SEG) : CALL(96, SEG);    \
    case 128: return causal ? CALL(128, CAUSAL_SEG) : CALL(128, SEG); \
    default: return (int)cudaErrorInvalidValue;                       \
  }

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on success). dq writes delta,
// which dk/dv reads.
//
// causal_bwd_*: the backward of attention.py's batch-1 wrappers (B = 1) and of flash.py's batched
// ones, causal with a segment mask over B rows, D = 96, 128 or 256, all tensors contiguous: q, o, dout, dq
// are (B, T, H, D) bf16; k, v, dk, dv (B, T, Hkv, D) bf16; seg (B, T) int32; lse and delta
// (B, H, T) f32.
//
// fused_bwd_*: the fused_sdpa counterpart, causal (CAUSAL_SEG) or not (SEG), D in {32, 64, 96, 128},
// no GQA. q, k, v, o, dout, dq, dk, dv: (B, H, T, D) bf16 in any layout whose head dim is contiguous
// and whose rows start on 16-byte boundaries; sq and sk are the {batch, row, head} element strides
// of q (shared by o, dout and dq) and of k (shared by v, dk and dv). seg: (B, T) int32 segment ids;
// lse, delta: (B, H, T) f32, contiguous.

extern "C" int causal_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* seg, const void* o,
                                  const void* dout, const void* lse, void* dq_, void* delta, int B, int T, int H,
                                  int Hkv, int D, float scale, void* stream) {
  if (!shape_ok(B, T, H, Hkv)) return (int)cudaErrorInvalidValue;
  const Layout lq = bthd(T, H, D), lk = bthd(T, Hkv, D);
  switch (D) {
#define CALL(DD) dq<DD, CAUSAL_SEG>(q, k, v, seg, o, dout, lse, dq_, delta, B, T, H, Hkv, scale, lq, lk, stream)
    case 96: return CALL(96);
    case 128: return CALL(128);
    case 256: return CALL(256);
#undef CALL
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int causal_bwd_dkdv_bf16(const void* q, const void* k, const void* v, const void* seg,
                                    const void* dout, const void* lse, const void* delta, void* dk, void* dv, int B,
                                    int T, int H, int Hkv, int D, float scale, void* stream) {
  if (!shape_ok(B, T, H, Hkv)) return (int)cudaErrorInvalidValue;
  const Layout lq = bthd(T, H, D), lk = bthd(T, Hkv, D);
  switch (D) {
#define CALL(DD) dkdv<DD, CAUSAL_SEG>(q, k, v, seg, dout, lse, delta, dk, dv, B, T, H, Hkv, scale, lq, lk, stream)
    case 96: return CALL(96);
    case 128: return CALL(128);
    case 256: return CALL(256);
#undef CALL
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int fused_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* seg, const void* o,
                                 const void* dout, const void* lse, void* dq_, void* delta, int B, int T, int H,
                                 int D, const long long* sq, const long long* sk, int causal, float scale,
                                 void* stream) {
  if (!shape_ok(B, T, H, H)) return (int)cudaErrorInvalidValue;
  const Layout lq = layout_of(sq), lk = layout_of(sk);
#define CALL(DD, MM) dq<DD, MM>(q, k, v, seg, o, dout, lse, dq_, delta, B, T, H, H, scale, lq, lk, stream)
  FUSED_DISPATCH(CALL)
#undef CALL
}

extern "C" int fused_bwd_dkdv_bf16(const void* q, const void* k, const void* v, const void* seg, const void* dout,
                                   const void* lse, const void* delta, void* dk, void* dv, int B, int T, int H,
                                   int D, const long long* sq, const long long* sk, int causal, float scale,
                                   void* stream) {
  if (!shape_ok(B, T, H, H)) return (int)cudaErrorInvalidValue;
  const Layout lq = layout_of(sq), lk = layout_of(sk);
#define CALL(DD, MM) dkdv<DD, MM>(q, k, v, seg, dout, lse, delta, dk, dv, B, T, H, H, scale, lq, lk, stream)
  FUSED_DISPATCH(CALL)
#undef CALL
}
