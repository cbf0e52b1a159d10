// Input gradient of a frozen linear y = x · Wᵀ: dx (T, I) = dy (T, O) · W (O, I), bf16 in and
// out, f32 accumulation.
//
// Replaces: adversarialvlm_tpu/ops/pallas/matmul.py::dgrad_matmul (pallas_call at :163), the
// backward of models/layers.py::_linear_pdx. As there, the weight cotangent is not computed and x
// is not needed.
//
// What bounds it on the H100: at the attack's shapes (T ≈ 576-680; O, I in {1024, 4096, 11008})
// the product does 2·T·O·I operations on 2·(T·O + O·I + T·I) bytes, several hundred operations
// per byte, above the card's ~295 operations/byte ridge: the tensor cores bound it when they are
// fed. The TPU kernel existed to avoid a transposed weight copy in HBM; here the row-major (O, I)
// W is already the B operand of an NN product, so no copy is made either.
//
// Design: a simple tiled GEMM. Each block computes a 128×128 tile of dx with eight warps (4×2,
// 32×64 each) using bf16 WMMA 16×16×16 with f32 accumulators in registers, over 32-deep slices of
// O staged in shared memory by a two-stage cp.async pipeline. Ragged edges (T = 577, any O or I
// tail) are zero-filled on load and masked on store; O and I must be multiples of 8 so a 16-byte
// chunk is wholly inside or outside the matrix. It uses no wgmma, TMA or warp specialisation,
// which is why it runs several times slower than the library GEMM: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int WARPS_M = 4;
constexpr int WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;  // rows of dx per warp
constexpr int WN = BN / WARPS_N;  // columns of dx per warp
constexpr int FM = WM / 16;
constexpr int FN = WN / 16;
constexpr int A_LD = BK + 8;  // padded rows: 16-byte aligned, fewer bank conflicts
constexpr int B_LD = BN + 8;
constexpr int A_TILE = BM * A_LD;
constexpr int B_TILE = BK * B_LD;
constexpr int SMEM_BYTES = 2 * (A_TILE + B_TILE) * (int)sizeof(bf16);
constexpr int EPI_LD = 16 + 4;
static_assert(THREADS * 16 * EPI_LD * (int)sizeof(float) / 32 <= SMEM_BYTES, "epilogue scratch");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void load_stage(const bf16* dy, const bf16* w, bf16* As, bf16* Bs,
                                           int T, int O, int I, int m0, int n0, int k0, int tid) {
  for (int c = tid; c < BM * BK / 8; c += THREADS) {
    const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
    const int gr = m0 + r, gk = k0 + kc;
    const bool ok = gr < T && gk < O;
    cp_async16(As + r * A_LD + kc, ok ? dy + (size_t)gr * O + gk : dy, ok);
  }
  for (int c = tid; c < BK * BN / 8; c += THREADS) {
    const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    const int gk = k0 + r, gn = n0 + nc;
    const bool ok = gk < O && gn < I;
    cp_async16(Bs + r * B_LD + nc, ok ? w + (size_t)gk * I + gn : w, ok);
  }
}

__global__ void __launch_bounds__(THREADS)
    dgrad_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w, bf16* __restrict__ dx,
                 int T, int O, int I) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* As[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem) + A_TILE};
  bf16* Bs[2] = {reinterpret_cast<bf16*>(smem) + 2 * A_TILE,
                 reinterpret_cast<bf16*>(smem) + 2 * A_TILE + B_TILE};

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (O + BK - 1) / BK;
  load_stage(dy, w, As[0], Bs[0], T, O, I, m0, n0, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load_stage(dy, w, As[cur ^ 1], Bs[cur ^ 1], T, O, I, m0, n0, (kt + 1) * BK, tid);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait<1>();
    __syncthreads();
    const bf16* A = As[cur];
    const bf16* B = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(a[i], A + (wm * WM + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::load_matrix_sync(b[j], B + kk * B_LD + wn * WN + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: each warp stages one 16×16 fragment at a time in shared memory, then writes it as
  // bf16, 8 values (16 bytes) per lane, masking rows past T and columns past I
  float* scratch = reinterpret_cast<float*>(smem) + warp * 16 * EPI_LD;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], EPI_LD, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2, c = (lane % 2) * 8;
      const int gr = m0 + wm * WM + i * 16 + r, gc = n0 + wn * WN + j * 16 + c;
      if (gr < T && gc < I) {
        __align__(16) bf16 vals[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16(scratch[r * EPI_LD + c + e]);
        *reinterpret_cast<uint4*>(dx + (size_t)gr * I + gc) = *reinterpret_cast<const uint4*>(vals);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// dy (T, O), w (O, I) and dx (T, I): contiguous bf16 on one device; O % 8 == 0 and I % 8 == 0.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dgrad_bf16(const void* dy, const void* w, void* dx, int T, int O, int I, void* stream) {
  if (T <= 0 || O <= 0 || I <= 0 || O % 8 != 0 || I % 8 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((I + BN - 1) / BN, (T + BM - 1) / BM);
  dgrad_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(w), static_cast<bf16*>(dx), T, O, I);
  return (int)cudaGetLastError();
}
