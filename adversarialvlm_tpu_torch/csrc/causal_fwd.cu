// Causal and segment-masked attention forward for Hopper (sm_90a), at head dim 32, 64, 96, 128 or
// 256, over operands read in place through their strides. It writes o and the row logsumexp.
//
// Replaces the forward halves of three Pallas entries:
//  - adversarialvlm_tpu/ops/pallas/fused_attention.py::fused_sdpa_bthd at batch 1: _call_fwd_bthd
//    (pallas_call at :441, body _fwd_kernel_bthd :361);
//  - adversarialvlm_tpu/ops/pallas/attention.py::flash_sdpa (:178) at batch >= 2: the stock TPU
//    flash_attention forward through _flash_call (:97), over left-padded rows whose segment ids are
//    their attention masks;
//  - adversarialvlm_tpu/ops/pallas/fused_attention.py::fused_sdpa: _call_fwd (:208, pallas_call at
//    :213, bodies _fwd_kernel :107 and _fwd_kernel_v2 :115), in (B, H, T, D) layout, causal or not,
//    no GQA.
// The first two are CAUSAL_SEG at head dim 96, 128 or 256 in the projections' (B, T, heads, D) layout
// (GQA: q head h reads kv head h / (H / Hkv)). The mask modes are those of attention_sm90.cuh.
// Scores and softmax in f32, o in bf16, and the (B, H, T) f32 natural-log row logsumexp, the
// residual causal_bwd.cu reads.
//
// What bounds it on the H100: at the 7B decoder's shapes (32 heads of 128) the forward does 4·D
// flops per allowed pair on q, k, v and o once each: T 641 at batch 1, 3.1 GFLOP on 21 MB; the
// batch-4 step (4 × 677), 12 GFLOP on 89 MB; the test-decode prefill (50 × 704), 148 GFLOP on 1.16
// GB. That is 130-150 operations per byte, under the card's ~295 ridge, so device memory bounds the
// ideal (0.0063, 0.0266 and 0.3457 ms at 3.35 TB/s). What costs beside the products: an exp2 and a
// few scalar operations per pair on the accumulator registers, and walks of at most T/64 = 11 key
// tiles, each a serial chain of products, softmax and products that other warpgroups must hide.
// At head dim 256 (Gemma-3's global layers; the judge's text-only prefill, 16 rows of 704, 8 heads,
// 4 kv heads) the forward is 32.5 GFLOP on 138 MB: 235 operations per byte, just under the ridge,
// so bytes still bound the ideal (0.041 ms), with the products close behind (0.033 ms).
// At head dim 96 (Phi-3.5's decoder, 32 heads; the batch-2 attack step, 2 × 797) it is 7.7 GFLOP on
// 39.5 MB, about 195 operations per byte: bytes bound the ideal (0.0118 ms). The D-128 plan serves
// it unchanged: the instantiation at 96 only shortens each product's k-steps and P·V's width.
//
// Design (all products are wgmma, bf16 in, f32 accumulate; the structure of flash_full.cu's forward):
//  - A warpgroup owns 64 query rows of one (b, h) and its Q tile. For each key tile of 64 rows it
//    walks, S = Q·Kᵀ is m64n64k16 over D/16 k-steps with the scores in registers; the online softmax
//    runs on the accumulator registers (row max and sum with quad shuffles, exp2 with scale·log2e
//    folded in); P is packed to bf16 in registers as the A operand and O += P·V is m64n{D}k16 with V
//    the MN-major operand of the same tile buffer. O, the row max and the row sum stay in registers
//    for the whole walk; nothing passes through f32 shared memory.
//  - Loads: K, V and the keys' segment ids stream through a ring of three stages filled by cp.async,
//    issued two walked tiles ahead, so two tiles are in flight while one computes. cp.async rather
//    than TMA: it puts each 16-byte chunk where wgmma's no-swizzle layout wants it from any row
//    stride (fused_sdpa's (B, H, T, D) views), and zero-fills rows past T.
//  - The walk: key tiles up to the causal limit (CAUSAL_SEG) or all of them (SEG), minus every tile
//    whose segment interval [min, max] is disjoint from the query tile's: disjoint intervals mean no
//    equal ids, so the skip is exact for any segment ids. For a left-padded row it skips the pad key
//    tiles of an all-real query tile. Each block first reduces the min and max segment id of every
//    tile of its walk into shared memory (one warp reduction per tile). The per-pair causal and
//    segment test runs only on tiles that need it: the diagonal tile, a ragged last key tile and any
//    tile whose query and key segments are not all one id; the interior tiles go unmasked.
//  - Occupancy: a block is WGS = 3 warpgroups (192 query rows) sharing one ring, one block per SM:
//    about 166 registers a thread fill the SM's register file, and at D 128 Q and the ring take
//    about 145 KiB of shared memory. The warpgroups hide each other's softmax and waits behind their
//    products. On the H100 this ran faster than blocks of two warpgroups or two blocks of one at all
//    three shapes; a third ring stage added little, and ordering the grid so that the blocks of one
//    head run together (sharing its K and V in L2) did not pay (PERF.md §6). The grid runs every
//    head's longest causal walks first, so the short walks fill the tail.
//  - Head dim 256 (causal_fwd256_kernel, CAUSAL_SEG only): a warpgroup's O (64 × 256 f32) is 128
//    registers a thread and S 32 more, and a 64-row tile of 256 columns is 32 KiB. A block is one
//    warpgroup with one Q, one K and one V tile (98 KiB, 204 registers a thread), two blocks an SM,
//    FlashAttention-2's layout at this width: V of tile j loads under S and the softmax of tile j,
//    and K of the next tile under the softmax and P·V (three barriers a tile). The two blocks of an
//    SM ran as fast as one block of two warpgroups sharing a two-stage ring (192 KiB), and what
//    paid on the H100 was elsewhere (PERF.md §6): tiles in the 128-byte-swizzled layout (the score
//    chain over 16 k-steps ran 1.5× faster than on the no-swizzle one), O written out through its
//    freed Q buffer as whole rows rather than a fragment's 4-byte pieces, the walk starting at the
//    diagonal tile, whose K load needs no segment interval and so leaves with Q's, and the
//    intervals reduced over 32-row halves with four rounds of loads in flight rather than in
//    serial rounds. O += P·V is one m64n256k16 per k-step.
//  - A row whose allowed keys all lie in later tiles keeps max = -inf until then; the exp2 is then
//    taken against 0, so no inf - inf is formed. Rows past T are never written.
// Every entry checks cudaGetLastError() after its launch and returns it.

#include <limits.h>

#include "attention_sm90.cuh"

namespace {

using namespace attn;

constexpr int WGS = 3, STAGES = 3;  // warpgroups a block, stages of the K/V ring (see the note above)

// Shared memory of a block, in bytes from the start: its Q rows, a ring of STAGES stages of K, V and
// the keys' segment ids, then the min and max segment id of each of the walk's tiles.
template <int D>
struct FwdSmem {
  static constexpr int TILE = Head<D>::TILE;
  static constexpr int K = WGS * TILE, V = K + STAGES * TILE, SEG = V + STAGES * TILE,
                       TSEG = SEG + STAGES * BT * 4;
  static constexpr int bytes(int ntiles) { return TSEG + 8 * ntiles; }
};

// Head dim 256 (see the note above): one warpgroup's Q, one K and one V tile, all 128-byte swizzled
// (1 KiB aligned), the keys' segment ids of the K tile, then the min and max segment id of each
// half of each of the walk's tiles.
struct Fwd256Smem {
  static constexpr int TILE = Swz<256, BT>::TILE;
  static constexpr int K = TILE, V = 2 * TILE, SEG = 3 * TILE, TSEG = SEG + BT * 4;
  static constexpr int bytes(int ntiles) { return TSEG + 16 * ntiles + 1024; }
};

// Sets the scores of the pairs a query row may not attend in a tile of 64 keys from k0 to -inf: keys
// past T, past the row (CAUSAL_SEG) or of another segment. ks: the keys' segment ids; the thread's
// rows are r0 and r0 + 8, of segments qseg.
template <int MASK>
__device__ __forceinline__ void mask_tile(float (&s)[32], const int* ks, int k0, int T, int r0, const int (&qseg)[2],
                                          int quad) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int col = 8 * c + 2 * quad;
    const int2 sk = *reinterpret_cast<const int2*>(ks + col);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gk = k0 + col + e;
        const bool ok = gk < T && (MASK != CAUSAL_SEG || gk <= r0 + 8 * i) && (e ? sk.y : sk.x) == qseg[i];
        if (!ok) s[4 * c + 2 * i + e] = -INFINITY;
      }
  }
}

// The online softmax over one tile's scores, on the accumulator registers: the rows' new max m (log2
// units), P = exp2(s·scale·log2e − m) in place of the scores, the rows' sums l and O rescaled.
template <int D>
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&acc)[D / 2], float (&m)[2], float (&l)[2],
                                               float sl2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 8; ++c) mx = fmaxf(mx, fmaxf(s[4 * c + 2 * i], s[4 * c + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[i], mx * sl2);
    const float base = mn == -INFINITY ? 0.f : mn;  // no allowed key yet: every p and alpha is 0
    const float alpha = fast_exp2(m[i] - base);
    m[i] = mn;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = fast_exp2(fmaf(s[4 * c + 2 * i + e], sl2, -base));
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
}

// The rows' logsumexp (natural log) and O divided by the row sums, at the end of the walk.
template <int D>
__device__ __forceinline__ void finish_rows(float (&acc)[D / 2], const float (&m)[2], float (&l)[2],
                                            float* __restrict__ lse, int r0, int T, int quad) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float inv = 1.f / l[i];
    const int r = r0 + 8 * i;
    if (quad == 0 && r < T) lse[r] = m[i] * LN2 + logf(l[i]);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      acc[4 * c + 2 * i] *= inv;
      acc[4 * c + 2 * i + 1] *= inv;
    }
  }
}

// Block x of the 1-D grid: query rows [ROWS·qb, ROWS·qb + ROWS) of head h of batch row b, ROWS =
// 64·WGS, every head's longest walks first. q and o are laid out as lq, k and v as lk; seg is (B, T)
// and lse (B, H, T), both contiguous.
template <int D, int MASK>
__global__ void __launch_bounds__(128 * WGS, 1)  // at most 170 registers a thread
    causal_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const int* __restrict__ seg, bf16* __restrict__ o, float* __restrict__ lse, int B, int T,
                      int H, int Hkv, float scale, Layout lq, Layout lk) {
  typedef FwdSmem<D> S;
  constexpr int NT = 128 * WGS, ROWS = 64 * WGS, TILE = S::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32, quad = lane % 4;
  const int nqb = (T + ROWS - 1) / ROWS, x = blockIdx.x;
  const int bh = x % (B * H), qb = nqb - 1 - x / (B * H);
  const int h = bh % H, b = bh / H, q0 = qb * ROWS;
  const int hk = h / (H / Hkv);
  q += b * lq.b + h * lq.h;
  o += b * lq.b + h * lq.h;
  k += b * lk.b + hk * lk.h;
  v += b * lk.b + hk * lk.h;
  seg += (size_t)b * T;
  lse += ((size_t)b * H + h) * T;
  const uint32_t sQ = smem_u32(smem), sK = sQ + S::K, sV = sQ + S::V, sSeg = sQ + S::SEG;
  const int* kseg_s = reinterpret_cast<const int*>(smem + S::SEG);
  int* tmin = reinterpret_cast<int*>(smem + S::TSEG);

  load_tile<D, ROWS, NT>(sQ, q, lq.r, q0, T, tid);
  cp_commit();

  // While Q loads: the segment interval of every tile of the walk (the query tiles are among them).
  const int nkt = (MASK == CAUSAL_SEG ? min(q0 + ROWS, T) - 1 : T - 1) / BT + 1;
  int* tmax = tmin + nkt;
  for (int t = tid / 32; t < nkt; t += NT / 32) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = t * BT + lane; r < min(t * BT + BT, T); r += 32) {
      const int s_ = seg[r];
      lo = min(lo, s_);
      hi = max(hi, s_);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      tmin[t] = lo;
      tmax[t] = hi;
    }
  }
  __syncthreads();

  // Whether warpgroup w's query tile attends some key of tile j, and the block's next walked tile.
  auto needs = [&](int w, int j) {
    const int t = q0 / BT + w;
    if (t * BT >= T || (MASK == CAUSAL_SEG && j > t)) return false;
    return tmin[j] <= tmax[t] && tmin[t] <= tmax[j];
  };
  auto next_tile = [&](int j) {
    for (; j < nkt; ++j)
#pragma unroll
      for (int w = 0; w < WGS; ++w)
        if (needs(w, j)) return j;
    return nkt;
  };
  // Tile j into ring stage st, as one commit group (empty past the walk's end, so every iteration
  // commits one group and the wait below counts alike).
  auto load_kv = [&](int j, int st) {
    if (j < nkt) {
      load_tile<D, BT, NT>(sK + st * TILE, k, lk.r, j * BT, T, tid);
      load_tile<D, BT, NT>(sV + st * TILE, v, lk.r, j * BT, T, tid);
      if (tid < BT) load_rowval(sSeg + st * BT * 4, seg, j * BT, T, tid);
    }
    cp_commit();
  };
  int j = next_tile(0), jl = j;  // every row attends itself, so its own tile is walked
  load_kv(j, 0);
#pragma unroll
  for (int st = 1; st < STAGES - 1; ++st) {
    jl = next_tile(jl + 1);
    load_kv(jl, st);
  }

  const int qt = q0 / BT + wg;
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;  // the thread's rows: r0 and r0 + 8
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qseg[i] = r0 + 8 * i < T ? seg[r0 + 8 * i] : INT_MIN;

  const float sl2 = scale * LOG2E;  // scores in log2 units
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sum
#pragma unroll 1
  for (int n = 0; j < nkt; ++n) {
    arrive_tile<STAGES - 2>();  // tile j is in; every warpgroup is done with the tile before it
    jl = next_tile(jl + 1);
    load_kv(jl, (n + STAGES - 1) % STAGES);
    if (needs(wg, j)) {
      const int st = n % STAGES, k0 = j * BT;
      float s[32];
      wg_fence();
      scores<D>(s, sQ, wg * 8, sK + st * TILE);
      wg_commit();
      wg_wait();
      reg_fence(s);
      const bool open = (MASK != CAUSAL_SEG || j < qt) && k0 + BT <= T && tmin[qt] == tmax[qt] &&
                        tmin[j] == tmax[j] && tmin[j] == tmin[qt];  // every pair allowed
      if (!open) mask_tile<MASK>(s, kseg_s + st * BT, k0, T, r0, qseg, quad);
      online_softmax<D>(s, acc, m, l, sl2);
      uint32_t p[16];
      to_operand(s, p);
      wg_fence();
      accumulate<D>(acc, p, sV + st * TILE);
      wg_commit();
      wg_wait();
      reg_fence(acc);
    }
    j = next_tile(j + 1);
  }
  finish_rows<D>(acc, m, l, lse, r0, T, quad);
  store_rows<D>(o, acc, q0 + wg * 64 + warp * 16, T, lq.r, lane);
}

// Head dim 256, causal within segments (see the note above): block x of the 1-D grid is query tile
// qt (64 rows) of head h of batch row b, one warpgroup, every head's longest walks first; K and V
// tiles load in turns into one buffer each. Operands as causal_fwd_kernel's, in the projections'
// (B, T, heads, 256) layout.
__global__ void __launch_bounds__(128, 2)  // two blocks an SM: at most 255 registers a thread
    causal_fwd256_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const int* __restrict__ seg, bf16* __restrict__ o, float* __restrict__ lse, int B, int T,
                         int H, int Hkv, float scale, Layout lq, Layout lk) {
  constexpr int D = 256, NT = 128;
  typedef Fwd256Smem S;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int nqt = (T + BT - 1) / BT, x = blockIdx.x;
  const int bh = x % (B * H), qt = nqt - 1 - x / (B * H);
  const int h = bh % H, b = bh / H, q0 = qt * BT;
  const int hk = h / (H / Hkv);
  q += b * lq.b + h * lq.h;
  o += b * lq.b + h * lq.h;
  k += b * lk.b + hk * lk.h;
  v += b * lk.b + hk * lk.h;
  seg += (size_t)b * T;
  lse += ((size_t)b * H + h) * T;
  const uint32_t sQ = smem_u32(smem), sK = sQ + S::K, sV = sQ + S::V, sSeg = sQ + S::SEG;
  const int* kseg_s = reinterpret_cast<const int*>(smem + S::SEG);
  int* tmin = reinterpret_cast<int*>(smem + S::TSEG);

  auto load_k = [&](int j) {  // one commit group, empty past the walk's end
    if (j < qt + 1) {
      load_tile_sw<D, BT, NT>(sK, k, lk.r, j * BT, T, tid);
      if (tid < BT) load_rowval(sSeg, seg, j * BT, T, tid);
    }
    cp_commit();
  };
  // The walk starts at the diagonal tile, which every row attends (each attends itself), so its
  // load needs no segment interval and goes out with Q's.
  load_tile_sw<D, BT, NT>(sQ, q, lq.r, q0, T, tid);
  load_k(qt);

  const int r0 = q0 + warp * 16 + lane / 4;  // the thread's rows: r0 and r0 + 8
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qseg[i] = r0 + 8 * i < T ? seg[r0 + 8 * i] : INT_MIN;

  // While Q and the first K load: the min and max segment id of each 32-row half of every tile up
  // to the diagonal, one warp reduction each, four rounds of the block's loads in flight at once.
  const int nkt = qt + 1, rows = min(q0 + BT, T);
  int* tmax = tmin + 2 * nkt;
  for (int r1 = 0; r1 < rows; r1 += 4 * NT) {
    int sv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r1 + u * NT + tid;
      sv[u] = r < rows ? seg[r] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r1 + u * NT + tid, half = (r1 + u * NT) / 32 + warp;
      const int lo = __reduce_min_sync(0xffffffffu, r < rows ? sv[u] : INT_MAX);
      const int hi = __reduce_max_sync(0xffffffffu, r < rows ? sv[u] : INT_MIN);
      if (lane == 0 && half < 2 * nkt) {
        tmin[half] = lo;
        tmax[half] = hi;
      }
    }
  }
  __syncthreads();
  // a tile's interval; a half past T holds (INT_MAX, INT_MIN), the identity of min and max
  auto lo = [&](int t) { return min(tmin[2 * t], tmin[2 * t + 1]); };
  auto hi = [&](int t) { return max(tmax[2 * t], tmax[2 * t + 1]); };

  // The next key tile before the diagonal, from j, whose segment interval meets the query tile's (as
  // causal_fwd_kernel's), or nkt at the walk's end.
  const int qlo = lo(qt), qhi = hi(qt);
  auto next_tile = [&](int j) {
    for (; j < qt; ++j)
      if (lo(j) <= qhi && qlo <= hi(j)) return j;
    return nkt;
  };
  int j = qt;

  const float sl2 = scale * LOG2E;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll 1
  while (j < nkt) {
    arrive_tile();  // K of tile j is in, and P·V of the tile before is done with the V buffer
    load_tile_sw<D, BT, NT>(sV, v, lk.r, j * BT, T, tid);  // V of tile j loads under S and the softmax
    cp_commit();
    const int k0 = j * BT;
    float s[32];
    wg_fence();
    scores_sw<D, BT, BT, 64>(s, sQ, 0, sK, 0);
    wg_commit();
    wg_wait();
    reg_fence(s);
    const bool open = j < qt && qlo == qhi && lo(j) == hi(j) && lo(j) == qlo;
    if (!open) mask_tile<CAUSAL_SEG>(s, kseg_s, k0, T, r0, qseg, quad);  // open: every pair allowed
    const int jn = next_tile(j == qt ? 0 : j + 1);
    __syncthreads();  // S of tile j is done with the K buffer and its segment ids
    load_k(jn);       // K of the next tile loads under the softmax and P·V
    online_softmax<D>(s, acc, m, l, sl2);
    uint32_t p[16];
    to_operand(s, p);
    arrive_tile<1>();  // V of tile j is in (the next K may still be loading)
    wg_fence();
    accumulate_sw<D, BT>(acc, p, sV);
    wg_commit();
    wg_wait();
    reg_fence(acc);
    j = jn;
  }
  finish_rows<D>(acc, m, l, lse, r0, T, quad);
  __syncthreads();  // the products are done with Q: O goes out through its buffer, whole rows at a time
  stage_rows<D, BT, D>(smem, acc, 0, 0, warp, lane);
  __syncthreads();
  store_tile<D, BT, BT, NT>(o, lq.r, smem, 0, q0, T, tid);
}

constexpr int MAX_TILES = 4096;  // each tile's segment interval takes 8 bytes of shared memory (16 at D 256)

bool shape_ok(int B, int T, int H, int Hkv) {
  return B > 0 && B <= 65535 && T > 0 && (T + BT - 1) / BT <= MAX_TILES && H > 0 && Hkv > 0 && H % Hkv == 0;
}

// Launches `kernel` over blocks of `rows` query rows of each head.
template <typename Kernel>
int start(Kernel kernel, int rows, int threads, int bytes, const void* q, const void* k, const void* v,
          const void* seg, void* o, void* lse, int B, int T, int H, int Hkv, float scale, Layout lq, Layout lk,
          void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * ((T + rows - 1) / rows);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<bf16*>(o), static_cast<float*>(lse), B, T, H, Hkv, scale, lq, lk);
  return (int)cudaGetLastError();
}

// The kernel, threads and shared memory of head dim D.
template <int D, int MASK>
int launch(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse, int B, int T, int H,
           int Hkv, float scale, Layout lq, Layout lk, void* stream) {
  static_assert(D != 256 || MASK == CAUSAL_SEG, "head dim 256 is causal within segments only");
  const int ntiles = (T + BT - 1) / BT;
  if constexpr (D == 256)
    return start(causal_fwd256_kernel, 64, 128, Fwd256Smem::bytes(ntiles), q, k, v, seg, o, lse, B, T, H, Hkv,
                 scale, lq, lk, stream);
  else
    return start(causal_fwd_kernel<D, MASK>, 64 * WGS, 128 * WGS, FwdSmem<D>::bytes(ntiles), q, k, v, seg, o, lse, B,
                 T, H, Hkv, scale, lq, lk, stream);
}

template <int D>
int fused(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse, int B, int T, int H,
          const long long* sq, const long long* sk, int causal, float scale, void* stream) {
  const Layout lq{sq[0], sq[1], sq[2]}, lk{sk[0], sk[1], sk[2]};
  if (causal) return launch<D, CAUSAL_SEG>(q, k, v, seg, o, lse, B, T, H, H, scale, lq, lk, stream);
  return launch<D, SEG>(q, k, v, seg, o, lse, B, T, H, H, scale, lq, lk, stream);
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on success).
//
// causal_fwd_bf16: the forward of attention.py's batch-1 wrappers (B = 1) and of flash.py's batched
// ones, causal within segments, D = 96, 128 or 256, all tensors contiguous: q, o (B, T, H, D) bf16; k, v
// (B, T, Hkv, D) bf16; seg (B, T) int32 (0 = pad, 1 = real); lse (B, H, T) f32.
//
// fused_fwd_bf16: the fused_sdpa counterpart, causal (CAUSAL_SEG) or not (SEG), D in {32, 64, 96,
// 128}, no GQA. q, k, v, o: (B, H, T, D) bf16 in any layout whose head dim is contiguous and whose
// rows start on 16-byte boundaries; sq and sk are the {batch, row, head} element strides of q
// (shared by o) and of k (shared by v). seg: (B, T) int32 segment ids; lse: (B, H, T) f32, contiguous.

extern "C" int causal_fwd_bf16(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse,
                               int B, int T, int H, int Hkv, int D, float scale, void* stream) {
  if (!shape_ok(B, T, H, Hkv)) return (int)cudaErrorInvalidValue;
  const Layout lq = bthd(T, H, D), lk = bthd(T, Hkv, D);
  switch (D) {
    case 96: return launch<96, CAUSAL_SEG>(q, k, v, seg, o, lse, B, T, H, Hkv, scale, lq, lk, stream);
    case 128: return launch<128, CAUSAL_SEG>(q, k, v, seg, o, lse, B, T, H, Hkv, scale, lq, lk, stream);
    case 256: return launch<256, CAUSAL_SEG>(q, k, v, seg, o, lse, B, T, H, Hkv, scale, lq, lk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int fused_fwd_bf16(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse,
                              int B, int T, int H, int D, const long long* sq, const long long* sk, int causal,
                              float scale, void* stream) {
  if (!shape_ok(B, T, H, H)) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return fused<32>(q, k, v, seg, o, lse, B, T, H, sq, sk, causal, scale, stream);
    case 64: return fused<64>(q, k, v, seg, o, lse, B, T, H, sq, sk, causal, scale, stream);
    case 96: return fused<96>(q, k, v, seg, o, lse, B, T, H, sq, sk, causal, scale, stream);
    case 128: return fused<128>(q, k, v, seg, o, lse, B, T, H, sq, sk, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
