// K2: white noise -> triangular L-matmul -> gamma mix, fp32 in and out.
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
// What bounds it on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32 on the tensor
// cores, 67 TFLOP/s fp32 on the CUDA cores): the product. At the training
// batch of 64 (M = 192) it is n(n+1)*M = 3.2e9 FLOP, which in 3xTF32 is
// three tensor-core products, 0.0195 ms, against 43 MB of bytes (L's
// triangle, three outputs), 0.013 ms. 3xTF32 with a blocked sum keeps bn
// within the TPU kernel's own 1e-5 of fp64 (tri_mma.cuh says how); plain
// TF32 would not.
//
// Design: two passes in one call, on the caller's stream.
// (a) The generator writes wn once, straight into its output: every white
//     value is a pure function of (seeds, row, column), Philox4x32-10
//     (Salmon et al., SC'11; the generator of cuRAND and Triton) at counter
//     (row, column, 0, 0) with key (seed0, seed1); words 0 and 1 become u1,
//     u2 in (0, 1) by `_bits_to_unit`'s rule (top 24 bits * 2^-24 + 2^-25),
//     and wn = sqrt(-2 ln u1) cos(2 pi u2) with logf, sqrtf and cosf (no fast
//     math), so the plain PyTorch version reproduces wn to 1e-5. Consecutive
//     threads take consecutive columns: the stores coalesce. The stream is
//     not the TPU's, as the TPU's is not jax.random's; the TPU kernel's
//     block-seeding arithmetic (seed0 + k*131071 + j) is gone. At M = 192
//     wn is 3.1 MB and stays in the 50 MB L2 for (b).
// (b) The product bn = L @ wn on the shared 3xTF32 core (tri_mma.cuh), with
//     wn as its W operand, and an epilogue that stores bn, reads wn at the
//     same element (from L2) and writes the mix. Tiles cut between blocks
//     get the same epilogue in the fix-up kernel, after their partial sums
//     are added in slot order. Writing wn once costs 3 MB of traffic at
//     M = 192; drawing it inside the product instead would regenerate each
//     white value in every row block below it, ~16 times at n = 4096.
// The mix is written with explicit round-to-nearest intrinsics: nvcc would
// contract a*b + c*d into an FMA, and the torch expression bn*(1-g) + wn*g
// it must equal exactly does not. Gamma of a column past M is never read.
//
// The kernels allocate nothing (the wrapper passes the outputs, the
// schedule and the scratch) and do not synchronise; the C entry point
// returns the last cudaError_t.

#include "tri_mma.cuh"

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

constexpr int WHITE_THREADS = 256;

// (a): one element a thread, row-major, so a warp's stores are contiguous.
__global__ void __launch_bounds__(WHITE_THREADS)
fused_bluenoise_white_kernel(float* __restrict__ wn, int n, int m, uint32_t seed0,
                             uint32_t seed1) {
  const int i = blockIdx.x * WHITE_THREADS + threadIdx.x;  // n * m < 2^31 (the wrapper checks)
  if (i >= n * m) return;
  wn[i] = white(i / m, i % m, seed0, seed1);
}

__device__ __forceinline__ float mix(float b, float w, float g) {
  return __fadd_rn(__fmul_rn(b, __fsub_rn(1.f, g)), __fmul_rn(w, g));
}

// (b)'s epilogue: bn, then the mix with wn (GBN: noise = bn). store4 needs
// gamma 16-byte aligned (the wrapper sees to it).
struct fused_bluenoise_epilogue {
  float* noise;
  float* bn;
  const float* wn;
  const float* gamma;
  int gbn_only;
  __device__ __forceinline__ void store(size_t o, int col, float b) const {
    bn[o] = b;
    noise[o] = gbn_only ? b : mix(b, wn[o], gamma[col]);
  }
  __device__ __forceinline__ void store4(size_t o, int col, float4 b) const {
    *reinterpret_cast<float4*>(bn + o) = b;
    if (!gbn_only) {
      const float4 w = *reinterpret_cast<const float4*>(wn + o);
      const float4 g = *reinterpret_cast<const float4*>(gamma + col);
      b = make_float4(mix(b.x, w.x, g.x), mix(b.y, w.y, g.y), mix(b.z, w.z, g.z),
                      mix(b.w, w.w, g.w));
    }
    *reinterpret_cast<float4*>(noise + o) = b;
  }
};

}  // namespace

// noise, bn, wn (n, m) from L (n, n) and gamma (m,); all fp32, row-major,
// contiguous, on the current device; (seed0, seed1) is the Philox key. The
// product walks the wide schedule: units (5 int32 each), block_start
// (n_blocks + 1), fixups (4 int32 each), the scratch ws (one 128 x tile_n
// fp32 tile per slot), column tiles of tile_n (64 or 128). Returns the last
// cudaError_t (0 on success).
extern "C" int bndm_fused_bluenoise_f32(const void* L, const void* gamma, void* noise, void* bn,
                                        void* wn, void* ws, const void* units,
                                        const void* block_start, int n_blocks,
                                        const void* fixups, int n_fixups, int tile_n, int n,
                                        int m, unsigned int seed0, unsigned int seed1,
                                        int gbn_only, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<float*>(wn);
  const int blocks = (n * m + WHITE_THREADS - 1) / WHITE_THREADS;
  fused_bluenoise_white_kernel<<<blocks, WHITE_THREADS, 0, s>>>(w, n, m, seed0, seed1);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const fused_bluenoise_epilogue epi{static_cast<float*>(noise), static_cast<float*>(bn), w,
                                     static_cast<const float*>(gamma), gbn_only};
  return static_cast<int>(tri_mma::launch(
      static_cast<const float*>(L), w, static_cast<float*>(ws), static_cast<const int*>(units),
      static_cast<const int*>(block_start), n_blocks, static_cast<const int*>(fixups), n_fixups,
      tile_n, n, m, epi, s));
}
