// K1: out = L @ W with L lower-triangular, fp32 in and out.
//
// Replaces the TPU kernel `_pallas_matmul` (body `_matmul_kernel`) of
// bndm_tpu/ops/pallas_bluenoise.py:74, which `apply_L` dispatches for every
// correlated noise draw: L is the (4096, 4096) covariance factor and W the
// white noise folded to (4096, M) with batch and channel as columns.
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 on the CUDA
// cores, 495 TFLOP/s TF32 on the tensor cores):
//   * skinny M (a super-res request is M = 12: 4 tiles x 3 channels): the
//     bytes. The lower triangle of L is n(n+1)/2 * 4 B = 33.6 MB, about
//     10 us; its n(n+1) * M fp32 FLOPs overtake it near M = 42.
//   * wide M (a res-128 train step at batch 64 is M = 768, a res-64 gallery
//     batch of 500 is M = 1500): the operations. In 3xTF32 they are
//     3 n(n+1) M tensor-core FLOP, 0.078 ms and 0.153 ms, against 0.19 ms
//     and 0.38 ms for the same product in fp32 FMAs.
// Plain TF32 (a 10-bit mantissa) would break the 2e-5 contract the noise
// engine is held to; 3xTF32 with a blocked sum keeps fp32 accuracy
// (tri_mma.cuh says how). The triangular skip holds in both designs:
// nothing right of a row block's diagonal tile is read. Tiles that straddle
// the diagonal multiply through L's zeros, so the kernels ASSUME L is
// lower-triangular.
//
// Two designs, chosen by M in the wrapper (ops/cuda_bluenoise.py,
// SKINNY_MAX_M, set from a sweep on the card):
//
// (a) Skinny, bndm_tri_matmul_skinny_f32, fp32 FMAs. Row block i of 16 rows
//     reads (i+1) * 16 columns of L, so a plain grid leaves the last block
//     with twice the mean bytes and one SM's latency sets the time. Each
//     block takes the pair of row blocks (i, nb-1-i) (the table `pairs`,
//     computed in Python), so every block reads the same n * 16 elements of
//     L, and 128 pairs fill the SMs at n = 4096. Its work is a list of
//     items, the short block's K chunks of 256 and then the long block's,
//     about 17 for every pair, so the blocks are level in steps as well as
//     in bytes. The items flow through a ring of 4 shared-memory stages
//     filled by cp.async (16-byte copies, zero-filled past the triangular
//     bound): 3 items, 48 KB of L, are in flight while one is multiplied,
//     more than Little's law asks of an SM at 3.35 TB/s. An item's chunk of
//     W (256 x M) is staged beside it (L2 serves it). Each lane holds 2
//     rows of each block (1 for M > 16) and all M columns, and the 8 warps
//     x 4 lanes per row split an item's K. So a W value read from shared
//     memory (a broadcast) feeds 2 FMAs, and every lane works on every
//     item: with a lane per row the broadcast loads, not HBM, set the time.
//     The partial sums are added in shared memory in a fixed order. At
//     M = 12 the kernel reads L about as fast as torch.sum reads the same
//     33.6 MB (PERF.md); a deeper ring, longer items and bulk (TMA) copies
//     of L were no faster.
//
// (b) Wide, bndm_tri_matmul_wide_f32: the shared 3xTF32 tensor-core core
//     of tri_mma.cuh (a persistent grid over the work list of
//     `wide_schedule`, split tiles added by a second kernel in slot order)
//     with an epilogue that stores the sums. Column tiles are 64 or 128
//     wide, as the wrapper picks by M.
//
// The kernels launch on the caller's stream, allocate nothing (the wrapper
// passes the schedule and the scratch) and do not synchronise; each C
// entry point returns cudaGetLastError().

#include "tri_mma.cuh"

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using tri_mma::cp_async16;
using tri_mma::cp_async4;
using tri_mma::cp_async_commit;
using tri_mma::cp_async_wait;

// ------------------------------ (a) skinny M --------------------------------

constexpr int SK_BM = 16;  // rows of a row block: a block takes two, short and long
constexpr int SK_STAGES = 4;
constexpr int SK_THREADS = 256;
constexpr int SK_WARPS = SK_THREADS / 32;

// MC: columns held (>= m); RL: rows of each block a lane holds; KC: K of
// one item (16 rows x KC of L and KC x MC of W, one ring stage).
template <int MC, int RL, int KC>
struct Skinny {
  static constexpr int LPAD = KC + 4;  // L row stride in shared memory, 16-byte aligned
  static constexpr int STAGE = SK_BM * LPAD + KC * MC;  // floats
  static constexpr int RG = SK_BM / RL;  // lanes on distinct rows
  static constexpr int KS = 32 / RG;     // ... times K slices of a warp's share
  static constexpr int KSUB = KC / SK_WARPS / KS;
  static constexpr int PARTS = SK_WARPS * KS;  // partial sums per output
  static constexpr int RING = SK_STAGES * STAGE * 4;
  static constexpr int RED = PARTS * 2 * SK_BM * MC * 4;
  static constexpr int SMEM = RING > RED ? RING : RED;
  static_assert(KSUB % 4 == 0, "float4 reads of L");
  static_assert(MC % 4 == 0, "float4 reads of W");
};

// The block's items: the short row block's K chunks, then the long one's,
// ceil(short_end / KC) + ceil(long_end / KC) of them, about the same count
// for every pair. Lane (g, ks) holds rows g + RG*i (i < RL) of each block
// and k = warp*KC/8 + ks*KSUB .. + KSUB of every item.
template <int MC, int RL, int KC, bool VEC>
__global__ void __launch_bounds__(SK_THREADS, 1)
tri_skinny_kernel(const float* __restrict__ L, const float* __restrict__ W,
                  float* __restrict__ out, const int* __restrict__ pairs, int n, int m) {
  using S = Skinny<MC, RL, KC>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane % S::RG, ks = lane / S::RG;
  const int rb_short = pairs[2 * blockIdx.x];  // -1: the long block is alone
  const int rb_long = pairs[2 * blockIdx.x + 1];
  const int short_end = rb_short >= 0 ? min(n, (rb_short + 1) * SK_BM) : 0;
  const int long_end = min(n, (rb_long + 1) * SK_BM);
  const int n_short = (short_end + KC - 1) / KC;
  const int n_items = n_short + (long_end + KC - 1) / KC;

  auto load = [&](int stage, int t) {
    const bool is_short = t < n_short;
    const int row0 = (is_short ? rb_short : rb_long) * SK_BM;
    const int end = is_short ? short_end : long_end;  // the triangular bound
    const int k0 = (is_short ? t : t - n_short) * KC;
    float* Ls = smem + stage * S::STAGE;
    float* Ws = Ls + SK_BM * S::LPAD;
    constexpr int V = VEC ? 4 : 1;
    for (int e = tid; e < SK_BM * (KC / V); e += SK_THREADS) {
      const int r = e / (KC / V), c = (e % (KC / V)) * V;
      const int gr = row0 + r, gk = k0 + c;
      const bool ok = gr < n && gk < end;
      const float* src = ok ? L + static_cast<size_t>(gr) * n + gk : L;
      if (VEC) cp_async16(Ls + r * S::LPAD + c, src, ok);
      else cp_async4(Ls + r * S::LPAD + c, src, ok);
    }
    for (int e = tid; e < KC * (MC / V); e += SK_THREADS) {
      const int kk = e / (MC / V), j = (e % (MC / V)) * V;
      const int gk = k0 + kk;
      const bool ok = gk < end && j < m;
      const float* src = ok ? W + static_cast<size_t>(gk) * m + j : W;
      if (VEC) cp_async16(Ws + kk * MC + j, src, ok);
      else cp_async4(Ws + kk * MC + j, src, ok);
    }
  };

  float acc[RL][MC], acc_short[RL][MC];
#pragma unroll
  for (int i = 0; i < RL; ++i)
#pragma unroll
    for (int j = 0; j < MC; ++j) acc[i][j] = acc_short[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < SK_STAGES - 1; ++s) {
    if (s < n_items) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < n_items; ++t) {
    cp_async_wait<SK_STAGES - 2>();
    __syncthreads();  // item t landed; item t-1's stage is free
    const int next = t + SK_STAGES - 1;
    if (next < n_items) load(next % SK_STAGES, next);
    cp_async_commit();
    if (t == n_short) {  // the long block's items start
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < MC; ++j) {
          acc_short[i][j] = acc[i][j];
          acc[i][j] = 0.f;
        }
    }
    const int k = warp * (KC / SK_WARPS) + ks * S::KSUB;
    const float* Ls = smem + (t % SK_STAGES) * S::STAGE + g * S::LPAD + k;
    const float* Ws = smem + (t % SK_STAGES) * S::STAGE + SK_BM * S::LPAD + k * MC;
#pragma unroll
    for (int q = 0; q < S::KSUB; q += 4) {
      float a[RL][4];
#pragma unroll
      for (int i = 0; i < RL; ++i) {  // a quarter warp reads 8 rows: no bank conflict
        const float4 v = *reinterpret_cast<const float4*>(Ls + i * S::RG * S::LPAD + q);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* wr = Ws + (q + u) * MC;
#pragma unroll
        for (int j = 0; j < MC; j += 4) {  // one address per quarter warp: a broadcast
          const float4 b = *reinterpret_cast<const float4*>(wr + j);
#pragma unroll
          for (int i = 0; i < RL; ++i) {
            acc[i][j] = fmaf(a[i][u], b.x, acc[i][j]);
            acc[i][j + 1] = fmaf(a[i][u], b.y, acc[i][j + 1]);
            acc[i][j + 2] = fmaf(a[i][u], b.z, acc[i][j + 2]);
            acc[i][j + 3] = fmaf(a[i][u], b.w, acc[i][j + 3]);
          }
        }
      }
    }
  }

  // the partials of the (warp, K slice) pairs, added in that fixed order
  cp_async_wait<0>();
  __syncthreads();
  float* red = smem;  // [part][32 local rows: short, then long][MC], over the ring
  const int part = warp * S::KS + ks;
#pragma unroll
  for (int i = 0; i < RL; ++i)
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      red[(part * 2 * SK_BM + g + S::RG * i) * MC + j] = acc_short[i][j];
      red[(part * 2 * SK_BM + SK_BM + g + S::RG * i) * MC + j] = acc[i][j];
    }
  __syncthreads();
  for (int e = tid; e < 2 * SK_BM * MC; e += SK_THREADS) {
    const int r = e / MC, j = e % MC;
    const bool is_short = r < SK_BM;
    if (j >= m || (is_short && rb_short < 0)) continue;
    const int gr = is_short ? rb_short * SK_BM + r : rb_long * SK_BM + (r - SK_BM);
    if (gr >= n) continue;
    float s = red[r * MC + j];
#pragma unroll 4
    for (int p = 1; p < S::PARTS; ++p) s += red[(p * 2 * SK_BM + r) * MC + j];
    out[static_cast<size_t>(gr) * m + j] = s;
  }
}

template <int MC, int RL, int KC, bool VEC>
int launch_skinny(const float* L, const float* W, float* out, const int* pairs, int n_pairs,
                  int n, int m, cudaStream_t stream) {
  constexpr int smem = Skinny<MC, RL, KC>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(tri_skinny_kernel<MC, RL, KC, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tri_skinny_kernel<MC, RL, KC, VEC><<<n_pairs, SK_THREADS, smem, stream>>>(L, W, out, pairs,
                                                                            n, m);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int dispatch_skinny(const float* L, const float* W, float* out, const int* pairs, int n_pairs,
                    int n, int m, cudaStream_t s) {
  if (m <= 4) return launch_skinny<4, 2, 256, VEC>(L, W, out, pairs, n_pairs, n, m, s);
  if (m <= 8) return launch_skinny<8, 2, 256, VEC>(L, W, out, pairs, n_pairs, n, m, s);
  if (m <= 12) return launch_skinny<12, 2, 256, VEC>(L, W, out, pairs, n_pairs, n, m, s);
  if (m <= 16) return launch_skinny<16, 2, 256, VEC>(L, W, out, pairs, n_pairs, n, m, s);
  if (m <= 32) return launch_skinny<32, 1, 256, VEC>(L, W, out, pairs, n_pairs, n, m, s);
  if (m <= 64) return launch_skinny<64, 1, 128, VEC>(L, W, out, pairs, n_pairs, n, m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool vec_ok(const void* L, const void* W, int n, int m) {
  return n % 4 == 0 && m % 4 == 0 && reinterpret_cast<uintptr_t>(L) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(W) % 16 == 0;
}

struct tri_matmul_epilogue {  // K1 stores the sums as they are
  float* out;
  __device__ __forceinline__ void store(size_t o, int, float v) const { out[o] = v; }
  __device__ __forceinline__ void store4(size_t o, int, float4 v) const {
    *reinterpret_cast<float4*>(out + o) = v;
  }
};

}  // namespace

// out (n, m) = L (n, n) @ W (n, m) for m <= 64; all fp32, row-major,
// contiguous, on the current device. pairs: n_pairs x 2 int32 row blocks
// (short, long) of 16 rows, short -1 for none. Returns the launch's
// cudaError_t (0 on success).
extern "C" int bndm_tri_matmul_skinny_f32(const void* L, const void* W, void* out,
                                          const void* pairs, int n_pairs, int n, int m,
                                          void* stream) {
  const auto* l = static_cast<const float*>(L);
  const auto* w = static_cast<const float*>(W);
  auto* o = static_cast<float*>(out);
  const auto* p = static_cast<const int*>(pairs);
  auto s = static_cast<cudaStream_t>(stream);
  return vec_ok(L, W, n, m) ? dispatch_skinny<true>(l, w, o, p, n_pairs, n, m, s)
                            : dispatch_skinny<false>(l, w, o, p, n_pairs, n, m, s);
}

// The same product for any m through the wide schedule: units (5 int32
// each), block_start (n_blocks + 1), fixups (4 int32 each), the scratch ws
// (one 128 x tile_n fp32 tile per slot) and the column tile, 64 or 128.
// Returns the last cudaError_t.
extern "C" int bndm_tri_matmul_wide_f32(const void* L, const void* W, void* out, void* ws,
                                        const void* units, const void* block_start,
                                        int n_blocks, const void* fixups, int n_fixups,
                                        int tile_n, int n, int m, void* stream) {
  return static_cast<int>(tri_mma::launch(
      static_cast<const float*>(L), static_cast<const float*>(W), static_cast<float*>(ws),
      static_cast<const int*>(units), static_cast<const int*>(block_start), n_blocks,
      static_cast<const int*>(fixups), n_fixups, tile_n, n, m,
      tri_matmul_epilogue{static_cast<float*>(out)}, static_cast<cudaStream_t>(stream)));
}
