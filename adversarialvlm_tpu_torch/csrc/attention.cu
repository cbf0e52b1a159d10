// Causal, segment-masked attention at head dim 256 over a batch of B rows, in the projections'
// (B, T, heads, 256) layout: three WMMA kernel templates (forward; dq, which writes δ; dk/dv), each
// with a grid layer per batch row. Every other attention of the port is a wgmma design of its own:
// causal_fwd.cu and causal_bwd.cu (the causal forward and backward at head dim 128, and fused_sdpa at
// 32-128, causal or not), flash_full.cu (the non-causal head_dim-72 attention of vision towers).
//
// Replaces, at head dim 256 (ops/kernels/flash.py routes the head dims), two Pallas entries:
//  - adversarialvlm_tpu/ops/pallas/fused_attention.py::fused_sdpa_bthd at batch 1, that is
//    _call_fwd_bthd (pallas_call at :441, body _fwd_kernel_bthd :361) and _call_bwd_bthd (pallas_call
//    at :470, body _bwd_kernel_bthd :372): the flash_* entries with one row;
//  - adversarialvlm_tpu/ops/pallas/attention.py::flash_sdpa (:178), which calls the stock TPU
//    flash_attention's forward, dkv and dq kernels through _flash_call (:97), over a left-padded
//    batch. Its segment ids are the rows' attention masks (pads 0, real tokens 1) and its causality
//    is by raw index.
// The TPU entries pad T to their block (segment 0) and slice the output back; these kernels mask the
// ragged tile instead (the pad rows of a TPU entry are garbage by contract, and a real row never
// attends them), so nothing is padded or copied in device memory.
//
// The mask: query row i may attend key j when j <= i and seg[i] == seg[j] (left pads carry segment
// 0, so a pad row attends earlier pads and a real row attends earlier real tokens; every row attends
// at least itself). Scores are f32, softmax in f32, output in bf16. GQA: q-head h reads kv head
// h / (H / Hkv).
//
// What bounds it on the H100: the causal half of the T×T scores per head is 4·D flops per allowed
// pair forward on q/k/v/o read once, a few hundred operations per byte at T ≈ 640, so the tensor
// cores bound it when they are fed well; a batch of B rows multiplies both by B.
//
// Design: the TPU kernel keeps a whole head's (T, T) scores in VMEM; Hopper's shared memory cannot
// hold them, so these kernels tile over T. A block owns one tile of BQ query rows of one head (or,
// for dk/dv, BKV key rows of one kv head) and walks the other side's tiles up to the causal limit,
// so no (T, T) tensor is ever written to device memory and there is no cap on T.
//  - Forward: online softmax over key tiles. Each warp owns 16 query rows: it computes that strip
//    of S = q·kᵀ with bf16 WMMA into f32 shared memory, updates the rows' running max and sum,
//    rescales its f32 output strip and adds P·v. Only the k/v tile loads are shared by the block.
//    It also writes each row's logsumexp, the one extra residual the backward uses (the TPU
//    kernel recomputes the row sums from q and k instead).
//  - dq: recomputes P = exp(s·scale − lse) per key tile, dP = dO·vᵀ, dS = P ⊙ (dP − δ)·scale and
//    accumulates dS·k. δ = rowsum(dO ⊙ O) is computed here once per row and written out for the
//    dk/dv kernel, which therefore runs second.
//  - dk/dv: each warp owns 16 key rows; the block loops over the n_rep q-heads of its kv head and
//    over the query tiles at or after its keys, accumulating dv += Pᵀ·dO and dk += dSᵀ·q in f32
//    shared memory, so GQA heads are summed in f32 and written once as bf16.
// Accumulators live in shared memory, loads are plain 16-byte copies and a block has 2 or 4 warps:
// simple and correct first. causal_fwd.cu and causal_bwd.cu show the wgmma redesign these templates
// are due (a 64-row tile of 256 columns is 32 KiB, so their two-stage rings need a narrower tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG = -1e30f;

// Element strides of a (B, T, heads, D) operand: batch, row (token), head. The head dim itself is
// contiguous.
struct Layout {
  long long b, r, h;
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [r0, r0 + ROWS) of one head (``src`` points at its row 0; rows ``row_stride`` elements
// apart) of a bf16 tensor into shared memory with row stride D + 8; rows at or past T are zero, so
// they add nothing to q·kᵀ, dO·vᵀ or P·v.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int r0, int T,
                                          long long row_stride, int tid) {
  constexpr int CH = D / 8;
  for (int c = tid; c < ROWS * CH; c += NT) {
    const int r = c / CH, cc = (c % CH) * 8;
    const int gr = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < T)
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * row_stride + cc);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + cc) = val;
  }
}

// C (16 × N, f32, ldc) = A (16 × K, bf16 row-major, lda) · Bᵀ where B is (N × K) row-major with
// ldb: the "q·kᵀ" shape. One warp.
template <int N, int K>
__device__ __forceinline__ void warp_mm_abt(float* C, int ldc, const bf16* A, int lda, const bf16* B, int ldb) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    FragC c;
    wmma::fill_fragment(c, 0.0f);
#pragma unroll 4
    for (int kk = 0; kk < K; kk += 16) {
      FragA a;
      FragBCol b;
      wmma::load_matrix_sync(a, A + kk, lda);
      wmma::load_matrix_sync(b, B + j * 16 * ldb + kk, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(C + j * 16, c, ldc, wmma::mem_row_major);
  }
}

// C (16 × N, f32 in shared memory, ldc) += A (16 × K, bf16 row-major) · B (K × N, bf16 row-major).
template <int N, int K>
__device__ __forceinline__ void warp_mm_acc(float* C, int ldc, const bf16* A, int lda, const bf16* B, int ldb) {
#pragma unroll 2
  for (int j = 0; j < N / 16; ++j) {
    FragC c;
    wmma::load_matrix_sync(c, C + j * 16, ldc, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      FragA a;
      FragBRow b;
      wmma::load_matrix_sync(a, A + kk, lda);
      wmma::load_matrix_sync(b, B + kk * ldb + j * 16, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(C + j * 16, c, ldc, wmma::mem_row_major);
  }
}

// Whether query gq may attend key gk (sq, sk: their segments).
__device__ __forceinline__ bool allowed(int gq, int gk, int T, int sq, int sk) {
  return gq < T && gk <= gq && sk == sq;
}

template <int D, int BQ, int BKV>
struct FwdSmem {
  static constexpr int LDH = D + 8, LDS = BKV + 4, LDP = BKV + 8, LDO = D + 4;
  static constexpr size_t bytes = (size_t)(BQ + 2 * BKV) * LDH * sizeof(bf16) + (size_t)BQ * LDS * sizeof(float) +
                                  (size_t)BQ * LDP * sizeof(bf16) + (size_t)BQ * LDO * sizeof(float) +
                                  2 * BQ * sizeof(float) + (BQ + BKV) * sizeof(int);
};

// q and o are laid out as lq, k and v as lk; seg is (B, T) and lse (B, H, T), both contiguous.
template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(BQ / 16 * 32)
    attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const int* __restrict__ seg, bf16* __restrict__ o, float* __restrict__ lse, int T, int H,
                    int Hkv, float scale, Layout lq, Layout lk) {
  typedef FwdSmem<D, BQ, BKV> L;
  const size_t bz = blockIdx.z;  // batch row: every operand advances by one whole sequence
  q += bz * lq.b;
  k += bz * lk.b;
  v += bz * lk.b;
  seg += bz * T;
  o += bz * lq.b;
  lse += bz * H * T;
  constexpr int NT = BQ / 16 * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * L::LDH;
  bf16* Vs = Ks + BKV * L::LDH;
  float* Ss = reinterpret_cast<float*>(Vs + BKV * L::LDH);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * L::LDS);
  float* Os = reinterpret_cast<float*>(Ps + BQ * L::LDP);
  float* m_s = Os + BQ * L::LDO;
  float* l_s = m_s + BQ;
  int* qseg = reinterpret_cast<int*>(l_s + BQ);
  int* kseg = qseg + BQ;

  const int h = blockIdx.y, hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, rw = warp * 16;

  load_rows<BQ, D, NT>(Qs, q + (size_t)h * lq.h, q0, T, lq.r, tid);
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = NEG;
    l_s[r] = 0.0f;
    qseg[r] = q0 + r < T ? seg[q0 + r] : -1;
  }
  for (int i = tid; i < BQ * L::LDO; i += NT) Os[i] = 0.0f;

  // key tiles up to the causal limit
  const int nkt = (min(q0 + BQ, T) - 1) / BKV + 1;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // everyone is done with the previous k/v tile
    load_rows<BKV, D, NT>(Ks, k + (size_t)hk * lk.h, k0, T, lk.r, tid);
    load_rows<BKV, D, NT>(Vs, v + (size_t)hk * lk.h, k0, T, lk.r, tid);
    for (int c = tid; c < BKV; c += NT) kseg[c] = k0 + c < T ? seg[k0 + c] : -2;
    __syncthreads();

    warp_mm_abt<BKV, D>(Ss + rw * L::LDS, L::LDS, Qs + rw * L::LDH, L::LDH, Ks, L::LDH);
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = rw + rr, gq = q0 + r, sq = qseg[r];
      float sv[BKV / 32];
      bool ok[BKV / 32];
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < BKV / 32; ++c) {
        const int col = lane + 32 * c, gk = k0 + col;
        ok[c] = allowed(gq, gk, T, sq, kseg[col]);
        sv[c] = ok[c] ? Ss[r * L::LDS + col] * scale : NEG;
        mx = fmaxf(mx, sv[c]);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < BKV / 32; ++c) {
        const float p = ok[c] ? expf(sv[c] - m_new) : 0.0f;
        Ps[r * L::LDP + lane + 32 * c] = __float2bfloat16(p);
        sum += p;
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_old - m_new);
      for (int d = lane; d < D; d += 32) Os[r * L::LDO + d] *= alpha;  // columns >= D stay 0
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncwarp();
    warp_mm_acc<D, BKV>(Os + rw * L::LDO, L::LDO, Ps + rw * L::LDP, L::LDP, Vs, L::LDH);
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = rw + rr, gq = q0 + r;
    if (gq >= T) break;
    const float inv = 1.0f / l_s[r];
    for (int d = lane; d < D; d += 32) o[(size_t)gq * lq.r + (size_t)h * lq.h + d] = __float2bfloat16(Os[r * L::LDO + d] * inv);
    if (lane == 0) lse[(size_t)h * T + gq] = m_s[r] + logf(l_s[r]);
  }
}

template <int D, int BQ, int BKV>
struct DqSmem {
  static constexpr int LDH = D + 8, LDS = BKV + 4, LDP = BKV + 8, LDO = D + 4;
  static constexpr size_t bytes = (size_t)(2 * BQ + 2 * BKV) * LDH * sizeof(bf16) +
                                  (size_t)2 * BQ * LDS * sizeof(float) + (size_t)BQ * LDP * sizeof(bf16) +
                                  (size_t)BQ * LDO * sizeof(float) + 2 * BQ * sizeof(float) +
                                  (BQ + BKV) * sizeof(int);
};

// q, o, dout and dq are laid out as lq, k and v as lk; lse and delta (B, H, T) contiguous.
template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(BQ / 16 * 32)
    attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const int* __restrict__ seg, const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, bf16* __restrict__ dq, float* __restrict__ delta, int T,
                       int H, int Hkv, float scale, Layout lq, Layout lk) {
  typedef DqSmem<D, BQ, BKV> L;
  const size_t bz = blockIdx.z;
  q += bz * lq.b;
  k += bz * lk.b;
  v += bz * lk.b;
  seg += bz * T;
  o += bz * lq.b;
  dout += bz * lq.b;
  lse += bz * H * T;
  dq += bz * lq.b;
  delta += bz * H * T;
  constexpr int NT = BQ / 16 * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * L::LDH;
  bf16* Ks = dOs + BQ * L::LDH;
  bf16* Vs = Ks + BKV * L::LDH;
  float* Ss = reinterpret_cast<float*>(Vs + BKV * L::LDH);
  float* dPs = Ss + BQ * L::LDS;
  bf16* dSs = reinterpret_cast<bf16*>(dPs + BQ * L::LDS);
  float* dQs = reinterpret_cast<float*>(dSs + BQ * L::LDP);
  float* lse_s = dQs + BQ * L::LDO;
  float* dl_s = lse_s + BQ;
  int* qseg = reinterpret_cast<int*>(dl_s + BQ);
  int* kseg = qseg + BQ;

  const int h = blockIdx.y, hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, rw = warp * 16;

  load_rows<BQ, D, NT>(Qs, q + (size_t)h * lq.h, q0, T, lq.r, tid);
  load_rows<BQ, D, NT>(dOs, dout + (size_t)h * lq.h, q0, T, lq.r, tid);
  for (int r = tid; r < BQ; r += NT) {
    lse_s[r] = q0 + r < T ? lse[(size_t)h * T + q0 + r] : 0.0f;
    qseg[r] = q0 + r < T ? seg[q0 + r] : -1;
  }
  for (int i = tid; i < BQ * L::LDO; i += NT) dQs[i] = 0.0f;
  __syncthreads();
  // δ = rowsum(dO ⊙ O), in f32, for the warp's own rows
  for (int rr = 0; rr < 16; ++rr) {
    const int r = rw + rr, gq = q0 + r;
    float acc = 0.0f;
    if (gq < T)
      for (int d = lane; d < D; d += 32)
        acc += __bfloat162float(dOs[r * L::LDH + d]) * __bfloat162float(o[(size_t)gq * lq.r + (size_t)h * lq.h + d]);
    acc = warp_sum(acc);
    if (lane == 0) {
      dl_s[r] = acc;
      if (gq < T) delta[(size_t)h * T + gq] = acc;
    }
  }

  const int nkt = (min(q0 + BQ, T) - 1) / BKV + 1;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();
    load_rows<BKV, D, NT>(Ks, k + (size_t)hk * lk.h, k0, T, lk.r, tid);
    load_rows<BKV, D, NT>(Vs, v + (size_t)hk * lk.h, k0, T, lk.r, tid);
    for (int c = tid; c < BKV; c += NT) kseg[c] = k0 + c < T ? seg[k0 + c] : -2;
    __syncthreads();

    warp_mm_abt<BKV, D>(Ss + rw * L::LDS, L::LDS, Qs + rw * L::LDH, L::LDH, Ks, L::LDH);
    warp_mm_abt<BKV, D>(dPs + rw * L::LDS, L::LDS, dOs + rw * L::LDH, L::LDH, Vs, L::LDH);
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = rw + rr, gq = q0 + r, sq = qseg[r];
      const float lr = lse_s[r], dr = dl_s[r];
#pragma unroll
      for (int c = 0; c < BKV / 32; ++c) {
        const int col = lane + 32 * c, gk = k0 + col;
        const bool ok = allowed(gq, gk, T, sq, kseg[col]);
        const float p = ok ? expf(Ss[r * L::LDS + col] * scale - lr) : 0.0f;
        dSs[r * L::LDP + col] = __float2bfloat16(p * (dPs[r * L::LDS + col] - dr) * scale);
      }
    }
    __syncwarp();
    warp_mm_acc<D, BKV>(dQs + rw * L::LDO, L::LDO, dSs + rw * L::LDP, L::LDP, Ks, L::LDH);
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = rw + rr, gq = q0 + r;
    if (gq >= T) break;
    for (int d = lane; d < D; d += 32) dq[(size_t)gq * lq.r + (size_t)h * lq.h + d] = __float2bfloat16(dQs[r * L::LDO + d]);
  }
}

template <int D, int BQ, int BKV>
struct DkdvSmem {
  static constexpr int LDH = D + 8, LDS = BQ + 4, LDP = BQ + 8, LDO = D + 4;
  static constexpr size_t bytes = (size_t)(2 * BQ + 2 * BKV) * LDH * sizeof(bf16) +
                                  (size_t)2 * BKV * LDS * sizeof(float) + (size_t)2 * BKV * LDP * sizeof(bf16) +
                                  (size_t)2 * BKV * LDO * sizeof(float) + 2 * BQ * sizeof(float) +
                                  (BQ + BKV) * sizeof(int);
};

// q and dout are laid out as lq, k, v, dk and dv as lk; lse and delta (B, H, T) contiguous.
template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(BKV / 16 * 32)
    attn_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const int* __restrict__ seg, const bf16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int T,
                         int H, int Hkv, float scale, Layout lq, Layout lk) {
  typedef DkdvSmem<D, BQ, BKV> L;
  const size_t bz = blockIdx.z;
  q += bz * lq.b;
  k += bz * lk.b;
  v += bz * lk.b;
  seg += bz * T;
  dout += bz * lq.b;
  lse += bz * H * T;
  delta += bz * H * T;
  dk += bz * lk.b;
  dv += bz * lk.b;
  constexpr int NT = BKV / 16 * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BKV * L::LDH;
  bf16* Qs = Vs + BKV * L::LDH;
  bf16* dOs = Qs + BQ * L::LDH;
  float* St = reinterpret_cast<float*>(dOs + BQ * L::LDH);  // (BKV, BQ): sᵀ
  float* dPt = St + BKV * L::LDS;
  bf16* Pt = reinterpret_cast<bf16*>(dPt + BKV * L::LDS);
  bf16* dSt = Pt + BKV * L::LDP;
  float* dKs = reinterpret_cast<float*>(dSt + BKV * L::LDP);
  float* dVs = dKs + BKV * L::LDO;
  float* lse_s = dVs + BKV * L::LDO;
  float* dl_s = lse_s + BQ;
  int* qseg = reinterpret_cast<int*>(dl_s + BQ);
  int* kseg = qseg + BQ;

  const int hk = blockIdx.y, n_rep = H / Hkv;
  const int k0 = blockIdx.x * BKV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, rw = warp * 16;

  load_rows<BKV, D, NT>(Ks, k + (size_t)hk * lk.h, k0, T, lk.r, tid);
  load_rows<BKV, D, NT>(Vs, v + (size_t)hk * lk.h, k0, T, lk.r, tid);
  for (int c = tid; c < BKV; c += NT) kseg[c] = k0 + c < T ? seg[k0 + c] : -2;
  for (int i = tid; i < BKV * L::LDO; i += NT) {
    dKs[i] = 0.0f;
    dVs[i] = 0.0f;
  }

  const int nqt = (T + BQ - 1) / BQ;
  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = hk * n_rep + rep;
    // query tiles at or after this key tile
    for (int qt = k0 / BQ; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_rows<BQ, D, NT>(Qs, q + (size_t)h * lq.h, q0, T, lq.r, tid);
      load_rows<BQ, D, NT>(dOs, dout + (size_t)h * lq.h, q0, T, lq.r, tid);
      for (int c = tid; c < BQ; c += NT) {
        const bool in = q0 + c < T;
        lse_s[c] = in ? lse[(size_t)h * T + q0 + c] : 0.0f;
        dl_s[c] = in ? delta[(size_t)h * T + q0 + c] : 0.0f;
        qseg[c] = in ? seg[q0 + c] : -1;
      }
      __syncthreads();

      warp_mm_abt<BQ, D>(St + rw * L::LDS, L::LDS, Ks + rw * L::LDH, L::LDH, Qs, L::LDH);
      warp_mm_abt<BQ, D>(dPt + rw * L::LDS, L::LDS, Vs + rw * L::LDH, L::LDH, dOs, L::LDH);
      __syncwarp();
      for (int rr = 0; rr < 16; ++rr) {
        const int r = rw + rr, gk = k0 + r, sk = kseg[r];
#pragma unroll
        for (int c = 0; c < BQ / 32; ++c) {
          const int col = lane + 32 * c, gq = q0 + col;
          const bool ok = allowed(gq, gk, T, qseg[col], sk);
          const float p = ok ? expf(St[r * L::LDS + col] * scale - lse_s[col]) : 0.0f;
          Pt[r * L::LDP + col] = __float2bfloat16(p);
          dSt[r * L::LDP + col] = __float2bfloat16(p * (dPt[r * L::LDS + col] - dl_s[col]) * scale);
        }
      }
      __syncwarp();
      warp_mm_acc<D, BQ>(dVs + rw * L::LDO, L::LDO, Pt + rw * L::LDP, L::LDP, dOs, L::LDH);
      warp_mm_acc<D, BQ>(dKs + rw * L::LDO, L::LDO, dSt + rw * L::LDP, L::LDP, Qs, L::LDH);
    }
  }
  __syncthreads();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = rw + rr, gk = k0 + r;
    if (gk >= T) break;
    for (int d = lane; d < D; d += 32) {
      dk[(size_t)gk * lk.r + (size_t)hk * lk.h + d] = __float2bfloat16(dKs[r * L::LDO + d]);
      dv[(size_t)gk * lk.r + (size_t)hk * lk.h + d] = __float2bfloat16(dVs[r * L::LDO + d]);
    }
  }
}

bool shape_ok(int B, int T, int H, int Hkv) {
  return B > 0 && B <= 65535 && T > 0 && H > 0 && Hkv > 0 && H % Hkv == 0;
}

// The projections' contiguous (B, T, heads, D) layout.
Layout bthd(int T, int heads, int D) {
  return Layout{(long long)T * heads * D, (long long)heads * D, (long long)D};
}

template <int D, int BQ, int BKV>
int launch_fwd(const void* q, const void* k, const void* v, const int* seg, void* o, float* lse, int B, int T,
               int H, int Hkv, float scale, Layout lq, Layout lk, cudaStream_t stream) {
  const size_t bytes = FwdSmem<D, BQ, BKV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<D, BQ, BKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  attn_fwd_kernel<D, BQ, BKV><<<grid, BQ / 16 * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), seg,
      static_cast<bf16*>(o), lse, T, H, Hkv, scale, lq, lk);
  return (int)cudaGetLastError();
}

template <int D, int BQ, int BKV>
int launch_dq(const void* q, const void* k, const void* v, const int* seg, const void* o, const void* dout,
              const float* lse, void* dq, float* delta, int B, int T, int H, int Hkv, float scale, Layout lq,
              Layout lk, cudaStream_t stream) {
  const size_t bytes = DqSmem<D, BQ, BKV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<D, BQ, BKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  attn_bwd_dq_kernel<D, BQ, BKV><<<grid, BQ / 16 * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), seg,
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq), delta, T, H, Hkv,
      scale, lq, lk);
  return (int)cudaGetLastError();
}

template <int D, int BQ, int BKV>
int launch_dkdv(const void* q, const void* k, const void* v, const int* seg, const void* dout, const float* lse,
                const float* delta, void* dk, void* dv, int B, int T, int H, int Hkv, float scale, Layout lq,
                Layout lk, cudaStream_t stream) {
  const size_t bytes = DkdvSmem<D, BQ, BKV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<D, BQ, BKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BKV - 1) / BKV, Hkv, B);
  attn_bwd_dkdv_kernel<D, BQ, BKV><<<grid, BKV / 16 * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), seg,
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H, Hkv, scale,
      lq, lk);
  return (int)cudaGetLastError();
}

// The flash entries' causal kernels at head dim 256, (B, T, H, D) layout.
int fwd(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse, int B, int T, int H,
        int Hkv, int D, float scale, void* stream) {
  if (!shape_ok(B, T, H, Hkv)) return (int)cudaErrorInvalidValue;
  const Layout lq = bthd(T, H, D), lk = bthd(T, Hkv, D);
  if (D == 256)
    return launch_fwd<256, 64, 64>(q, k, v, static_cast<const int*>(seg), o, static_cast<float*>(lse), B, T, H,
                                   Hkv, scale, lq, lk, static_cast<cudaStream_t>(stream));
  return (int)cudaErrorInvalidValue;
}

int bwd_dq(const void* q, const void* k, const void* v, const void* seg, const void* o, const void* dout,
           const void* lse, void* dq, void* delta, int B, int T, int H, int Hkv, int D, float scale, void* stream) {
  if (!shape_ok(B, T, H, Hkv)) return (int)cudaErrorInvalidValue;
  const Layout lq = bthd(T, H, D), lk = bthd(T, Hkv, D);
  if (D == 256)
    return launch_dq<256, 64, 32>(q, k, v, static_cast<const int*>(seg), o, dout, static_cast<const float*>(lse),
                                  dq, static_cast<float*>(delta), B, T, H, Hkv, scale, lq, lk,
                                  static_cast<cudaStream_t>(stream));
  return (int)cudaErrorInvalidValue;
}

int bwd_dkdv(const void* q, const void* k, const void* v, const void* seg, const void* dout, const void* lse,
             const void* delta, void* dk, void* dv, int B, int T, int H, int Hkv, int D, float scale, void* stream) {
  if (!shape_ok(B, T, H, Hkv)) return (int)cudaErrorInvalidValue;
  const Layout lq = bthd(T, H, D), lk = bthd(T, Hkv, D);
  if (D == 256)
    return launch_dkdv<256, 64, 32>(q, k, v, static_cast<const int*>(seg), dout, static_cast<const float*>(lse),
                                    static_cast<const float*>(delta), dk, dv, B, T, H, Hkv, scale, lq, lk,
                                    static_cast<cudaStream_t>(stream));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on success). Head dim 256 only;
// a batch of B left-padded rows, one grid layer per row (attention.py's batch-1 wrappers pass B = 1),
// all tensors contiguous: the forward, then the backward (dq, then dk/dv). q, o, dout, dq:
// (B, T, H, D) bf16; k, v, dk, dv: (B, T, Hkv, D) bf16; seg: (B, T) int32 (0 = pad, 1 = real); lse,
// delta: (B, H, T) f32. Tiles: (BQ, BKV) = (64, 64) in the forward; 32 key rows per dq/dk-dv block,
// whose 64-row tiles would not fit the shared memory at D = 256.

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse,
                              int B, int T, int H, int Hkv, int D, float scale, void* stream) {
  return fwd(q, k, v, seg, o, lse, B, T, H, Hkv, D, scale, stream);
}

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* seg, const void* o,
                                 const void* dout, const void* lse, void* dq, void* delta, int B, int T, int H,
                                 int Hkv, int D, float scale, void* stream) {
  return bwd_dq(q, k, v, seg, o, dout, lse, dq, delta, B, T, H, Hkv, D, scale, stream);
}

extern "C" int flash_bwd_dkdv_bf16(const void* q, const void* k, const void* v, const void* seg,
                                   const void* dout, const void* lse, const void* delta, void* dk, void* dv, int B,
                                   int T, int H, int Hkv, int D, float scale, void* stream) {
  return bwd_dkdv(q, k, v, seg, dout, lse, delta, dk, dv, B, T, H, Hkv, D, scale, stream);
}
