// K1: out = L @ W with L lower-triangular, fp32 throughout.
//
// Replaces the TPU kernel `_pallas_matmul` (body `_matmul_kernel`) of
// bndm_tpu/ops/pallas_bluenoise.py, which `apply_L` dispatches for every
// correlated noise draw: L is the (4096, 4096) covariance factor and W the
// white noise folded to (4096, M) with batch and channel as columns.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 on CUDA cores):
//   * M = 12 (one res-128 super-res request: 4 tiles x 3 channels): reading
//     the lower triangle of L, n(n+1)/2 * 4 B = 33.6 MB, about 10 us. The
//     product is a skinny matrix-vector-like pass and is memory bound.
//   * M = 1500 (a res-64 batch of 500): n(n+1) * M = 2.5e10 fp32 FLOP,
//     about 0.38 ms. There it is bound by fp32 arithmetic.
// TF32 tensor cores are not used: their 10-bit mantissa breaks the 2e-5
// contract the noise engine is held to, so every product is an fp32 FMA.
//
// Design. Each thread block owns one output tile (rows i*BM.., columns
// j*BN..) and loops over K only up to min(n, (i+1)*BM): the triangular
// bound the Pallas kernel expresses with `live`. Column tiles wholly above
// the diagonal are never read, which halves both the bytes and the FLOPs.
// Tiles that straddle the diagonal multiply through L's zeros, so the
// kernel ASSUMES L is lower-triangular; row block i never reads a column of
// L past (i+1)*BM - 1.
// L and W tiles are staged through shared memory, and the next tile is
// fetched into registers while the current one is multiplied, which hides
// part of the load latency in the memory-bound skinny case. The ragged
// edges (rows, K and columns) are masked in the kernel instead of padding W.
// Two tile shapes: a narrow one (many row blocks, deep K tiles) for M <= 16,
// where the pass is memory bound and 4096/64 row blocks would leave half
// the 132 SMs idle, and a square one for wide M.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
tri_matmul_kernel(const float* __restrict__ L, const float* __restrict__ W,
                  float* __restrict__ out, int n, int m) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int L_PER_THREAD = BM * BK / THREADS;
  constexpr int W_PER_THREAD = BK * BN / THREADS;
  static_assert(BM * BK % THREADS == 0, "L tile must split evenly");
  static_assert(BK * BN % THREADS == 0, "W tile must split evenly");

  // L is stored transposed (k-major) so a thread reads its TM rows of one
  // k step as consecutive words; +1 pads away bank conflicts on the store.
  __shared__ float Ls[BK][BM + 1];
  __shared__ float Ws[BK][BN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  const int k_end = min(n, row0 + BM);  // triangular bound

  float l_reg[L_PER_THREAD];
  float w_reg[W_PER_THREAD];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int s = 0; s < L_PER_THREAD; ++s) {
      const int e = tid + s * THREADS;
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      l_reg[s] = (gr < n && gk < n) ? L[(size_t)gr * n + gk] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < W_PER_THREAD; ++s) {
      const int e = tid + s * THREADS;
      const int kk = e / BN, c = e % BN;
      const int gk = k0 + kk, gc = col0 + c;
      w_reg[s] = (gk < n && gc < m) ? W[(size_t)gk * m + gc] : 0.f;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int s = 0; s < L_PER_THREAD; ++s) {
      const int e = tid + s * THREADS;
      Ls[e % BK][e / BK] = l_reg[s];
    }
#pragma unroll
    for (int s = 0; s < W_PER_THREAD; ++s) {
      const int e = tid + s * THREADS;
      Ws[e / BN][e % BN] = w_reg[s];
    }
    __syncthreads();
    if (k0 + BK < k_end) fetch(k0 + BK);  // in flight during the FMAs below

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
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc < m) out[(size_t)gr * m + gc] = acc[i][j];
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
void launch(const float* L, const float* W, float* out, int n, int m,
            cudaStream_t stream) {
  const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  const dim3 block((BM / TM) * (BN / TN));
  tri_matmul_kernel<BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(L, W, out, n, m);
}

}  // namespace

// out (n, m) = L (n, n) @ W (n, m); all fp32, row-major, contiguous, on the
// current device. Returns the cudaError_t of the launch (0 on success).
extern "C" int bndm_tri_matmul_f32(const void* L, const void* W, void* out,
                                   int n, int m, void* stream) {
  const auto* l = static_cast<const float*>(L);
  const auto* w = static_cast<const float*>(W);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= 16) {
    launch<32, 16, 64, 2, 1>(l, w, o, n, m, s);
  } else {
    launch<64, 64, 16, 4, 4>(l, w, o, n, m, s);
  }
  return static_cast<int>(cudaGetLastError());
}
