// K2: white noise -> triangular L-matmul -> gamma mix, in one kernel, fp32.
//
// Replaces the TPU kernel `_fused_bluenoise_flat` (body `_fused_kernel`,
// helpers `_white_block` and `_bits_to_unit`) of
// bndm_tpu/ops/pallas_bluenoise.py, which the training step dispatches for
// every fresh res-64 correlated noise draw. For M = B*C columns it writes
//   wn    = standard-normal white noise, (n, M),
//   bn    = L @ wn with L the lower-triangular (n, n) covariance factor,
//   noise = bn*(1-gamma) + wn*gamma (or bn alone for GBN),
// with gamma given per column (the per-sample gamma repeated per channel).
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 on CUDA cores):
// at the training batch of 64 (M = 192) the product is n(n+1)*M = 3.2e9 fp32
// FLOP, 0.048 ms, against 43 MB of bytes (L's triangle, three outputs),
// 0.013 ms: it is bound by fp32 arithmetic. No TF32: its 10-bit mantissa
// breaks the 2e-5 contract of the noise engine, as for K1.
//
// Design. The TPU kernel generates a whole (4096, 256) white column into
// VMEM once and reuses it across a sequential grid. An SM has neither the
// memory nor the order, so here every white value is a pure function of
// (seeds, row, column): Philox4x32-10 (Salmon et al., SC'11; the generator
// of cuRAND and Triton) with counter (row, column, 0, 0) and key (seed0,
// seed1); words 0 and 1 become u1, u2 in (0, 1) by `_bits_to_unit`'s rule
// (top 24 bits * 2^-24 + 2^-25), and wn = sqrt(-2 ln u1) cos(2 pi u2).
// The operand tile (k, j) and the output tile (i = k, j) then agree by
// construction, with no order between blocks, and the TPU kernel's
// block-seeding arithmetic (seed0 + k*131071 + j) is gone. The stream is
// not the TPU's, as the TPU's is not jax.random's.
// Each block owns one output tile (rows i*BM.., columns j*BN..) and loops
// over K only up to min(n, (i+1)*BM), the triangular bound of K1. It
// generates each W tile into shared memory and multiplies it with the L tile
// in fp32 FMAs. The last BM/BK tiles of that loop are the block's own rows:
// their white values are kept in shared memory (Wd) and written as wn in the
// epilogue, together with bn and the mix, so no white value round-trips
// through device memory before use. The price is regeneration: a white value
// is generated once per row block below it, n/(2*BM) times on average, each
// ~10 Philox rounds and a logf/cosf/sqrtf; BM = 128 keeps that near the
// cost of the BM FMAs each value feeds. Row blocks are launched heaviest
// first (the longest K loops), which shortens the tail of the triangle.
// The sum over K is blocked: each BK-long slice is summed apart and added to
// the running sum once, because one FMA chain over 4096 terms missed the TPU
// kernel's own bound, bn within 1e-5 of fp64 (tests/test_fused_noise_tpu.py).
// Transcendentals are logf, sqrtf and cosf (no fast math), so the plain
// PyTorch version reproduces wn to 1e-5. The mix is written with explicit
// round-to-nearest intrinsics: nvcc would contract a*b + c*d into an FMA,
// and the torch expression bn*(1-g) + wn*g it must equal exactly does not.
// The ragged row, K and column edges are masked in the kernel; gamma of a
// column past M is never read. L is ASSUMED lower-triangular: the diagonal
// tiles multiply through its zeros.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return static_cast<float>(bits >> 8) * 5.9604644775390625e-08f  // 2^-24
         + 2.98023223876953125e-08f;                               // 2^-25
}

// The white value at (row, col): Philox4x32-10, then Box-Muller's cosine.
__device__ __forceinline__ float white(uint32_t row, uint32_t col, uint32_t k0,
                                       uint32_t k1) {
  uint32_t c0 = row, c1 = col, c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = kPhiloxM0 * c0, hi0 = __umulhi(kPhiloxM0, c0);
    const uint32_t lo1 = kPhiloxM1 * c2, hi1 = __umulhi(kPhiloxM1, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  const float u1 = bits_to_unit(c0);
  const float u2 = bits_to_unit(c1);
  return sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
}

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
fused_bluenoise_kernel(const float* __restrict__ L, const float* __restrict__ gamma,
                       float* __restrict__ noise, float* __restrict__ bn,
                       float* __restrict__ wn, int n, int m, uint32_t seed0,
                       uint32_t seed1, int gbn_only) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int L_PER_THREAD = BM * BK / THREADS;
  constexpr int W_PER_THREAD = BK * BN / THREADS;
  static_assert(BM * BK % THREADS == 0, "L tile must split evenly");
  static_assert(BK * BN % THREADS == 0, "W tile must split evenly");
  static_assert(BM % BK == 0, "the last K tiles must cover the block's own rows");

  // L is stored transposed (k-major) so a thread reads its TM rows of one
  // k step as consecutive words; +1 pads away bank conflicts on the store.
  __shared__ float Ls[BK][BM + 1];
  __shared__ float Ws[BK][BN];
  __shared__ float Wd[BM][BN];  // white values of the block's own rows

  const int tid = threadIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest first
  const int col0 = blockIdx.x * BN;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  const int k_end = min(n, row0 + BM);  // triangular bound

  float l_reg[L_PER_THREAD];
  auto fetch_L = [&](int k0) {
#pragma unroll
    for (int s = 0; s < L_PER_THREAD; ++s) {
      const int e = tid + s * THREADS;
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      l_reg[s] = (gr < n && gk < n) ? L[(size_t)gr * n + gk] : 0.f;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fetch_L(0);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int s = 0; s < L_PER_THREAD; ++s) {
      const int e = tid + s * THREADS;
      Ls[e % BK][e / BK] = l_reg[s];
    }
    const bool own = k0 >= row0;  // this K tile is the block's own rows
#pragma unroll
    for (int s = 0; s < W_PER_THREAD; ++s) {
      const int e = tid + s * THREADS;
      const int kk = e / BN, c = e % BN;
      const int gk = k0 + kk, gc = col0 + c;
      const float w = (gk < n && gc < m) ? white(gk, gc, seed0, seed1) : 0.f;
      Ws[kk][c] = w;
      if (own) Wd[k0 - row0 + kk][c] = w;
    }
    __syncthreads();
    if (k0 + BK < k_end) fetch_L(k0 + BK);  // in flight during the FMAs below

    // blocked summation: the BK products of this tile are summed apart and
    // added to acc once, so rounding grows with n / BK additions, not n
    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Ls[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    const int gr = row0 + r;
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx * TN + j;
      const int gc = col0 + c;
      if (gc >= m) continue;
      const size_t o = (size_t)gr * m + gc;
      const float b = acc[i][j];
      const float w = Wd[r][c];
      bn[o] = b;
      wn[o] = w;
      if (gbn_only) {
        noise[o] = b;
      } else {
        const float g = gamma[gc];
        noise[o] = __fadd_rn(__fmul_rn(b, __fsub_rn(1.f, g)), __fmul_rn(w, g));
      }
    }
  }
}

}  // namespace

// noise, bn, wn (n, m) from L (n, n) and gamma (m,); all fp32, row-major,
// contiguous, on the current device; (seed0, seed1) is the Philox key.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int bndm_fused_bluenoise_f32(const void* L, const void* gamma, void* noise,
                                        void* bn, void* wn, int n, int m,
                                        unsigned int seed0, unsigned int seed1,
                                        int gbn_only, void* stream) {
  constexpr int BM = 128, BN = 32, BK = 16, TM = 8, TN = 4;
  const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  const dim3 block((BM / TM) * (BN / TN));
  fused_bluenoise_kernel<BM, BN, BK, TM, TN><<<grid, block, 0,
                                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(gamma),
      static_cast<float*>(noise), static_cast<float*>(bn), static_cast<float*>(wn), n, m,
      seed0, seed1, gbn_only);
  return static_cast<int>(cudaGetLastError());
}
