// The triangular product out = L @ W on the tensor cores in 3xTF32, shared
// by K1's wide design (tri_matmul.cu) and K2's product pass
// (fused_bluenoise.cu). L is the lower-triangular (n, n) fp32 factor, W an
// fp32 (n, m) operand; each caller passes its own epilogue, which receives
// every finished output element.
//
// Precision. Every operand x is split in registers into a TF32 high part
// hi = rna(x) and a TF32 low part lo = rna(x - hi) (x - hi is exact), and a
// product is lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, the two small terms issued
// first; lo_a*lo_b (< 2^-22 of the product) is dropped. The tensor core
// multiplies TF32 exactly but does not round its sums to nearest, so one
// accumulator chained over K = 4096 drifts an order of magnitude past the
// 1e-5 contract. The sum is therefore blocked: each ring stage (BK = 32 of
// K) accumulates into a fresh zeroed fragment, which is added to the running
// fp32 sum with one __fadd_rn. On an H100 that keeps bn within a few 1e-6 of
// fp64 (PERF.md), below plain fp32 FMAs' own error.
//
// Schedule. One persistent block per SM walks a work list computed in
// Python (ops/cuda_bluenoise.py::wide_schedule): the output tiles' K steps,
// up to each row tile's triangular bound, laid end to end and cut into
// equal contiguous shares. A share is a run of units (row tile, column
// tile, k_lo, k_hi, slot). The block's ring of STAGES cp.async stages runs
// on across its units, so the next unit's first tiles load while this one
// finishes. A unit that is a whole tile hands its sums to the epilogue; a
// piece of a tile cut between blocks writes them to a scratch slot, and a
// second kernel adds a tile's slots in slot order and then calls the same
// epilogue. No float atomics: the output is the same bits run to run.
//
// Tiles. BM = 128 rows by BN (64 or 128, the caller's choice by m) columns,
// 256 threads as 8 warps; a warp owns a (BM/WM) x (BN/WN) sub-tile of m16n8
// mma.sync fragments. L's tile is kept [row][k] with rows padded to 36
// floats (its fragments come in by ldmatrix) and W's [k][col] padded to
// BN + 8, so the fragment reads of a warp fall on 32 distinct banks. A
// finished tile goes through shared memory beside the ring, so that the
// epilogue and the scratch see coalesced float4s; the fix-up kernel spreads
// each cut tile over 8-16 blocks, 4 columns a thread. Tiles that straddle
// the diagonal multiply through L's zeros: L is ASSUMED lower-triangular.
// Ragged n, m and K are masked (cp.async with a source size of 0 fills
// zeros); the 16-byte copies need n and m to be multiples of 4 and aligned
// pointers, otherwise the same kernel copies 4 bytes at a time.
//
// What bounds it on an H100: not the tensor cores. The kernel runs at about
// a quarter of the 3xTF32 bound and two thirds of the fp32 FMA bound at
// M = 768 and 1500 (PERF.md), and the time goes to the tile loads, the
// barriers and the epilogue (a build without any arithmetic keeps close to
// half of it) plus the arithmetic, which 8 warps an SM overlap only in part.
// mma.sync, not wgmma: its fragments come from registers, where the split is
// natural. A TF32 wgmma version (W's tile split and transposed into shared
// memory once a stage, L's fragments from registers) was right on the card
// and only a few percent faster, for the same reason, so it was not kept.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace tri_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 (or 4) bytes global -> shared; ok = false writes zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {  // <= N groups still in flight
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo, both TF32 (fp32 bit patterns with the low 13 bits zero).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = __fsub_rn(x, __uint_as_float(hi));  // exact
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d (16 x 8) += a (16 x 8, row) @ b (8 x 8, col), TF32 in, fp32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a @ b: the same product into a fresh (zero) accumulator.
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// The four 8 x 4 TF32 quarters of a 16 x 8 A fragment in one instruction:
// lane l gives the address of row (l & 15), k 4 * (l >> 4) of the fragment
// and gets back rows g, g+8 at k t, t+4 (g = l / 4, t = l % 4), as
// mma.m16n8k8 wants them (each 32-bit word read as two 16-bit halves).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}

constexpr int BM = 128;  // rows of an output tile (WIDE_TILE in the wrapper)
constexpr int BK = 32;   // K of a ring stage and of a schedule step (WIDE_BK)
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int APAD = BK + 4;  // L tile row stride (floats): banks 4g + t

template <int BN>
struct Geometry {
  static_assert(BN == 64 || BN == 128, "column tiles of 64 or 128");
  static constexpr int BPAD = BN + 8;       // W tile row stride: banks 8t + g
  static constexpr int WN = BN == 128 ? 4 : 2;  // warps across the columns
  static constexpr int WM = (THREADS / 32) / WN;
  static constexpr int WTM = BM / WM, WTN = BN / WN;  // a warp's sub-tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;   // its m16n8 fragments
  static constexpr int STAGE = BM * APAD + BK * BPAD;  // floats
  static constexpr int EPAD = BN + 8;  // the finished tile's row stride: banks 8g + 2t
  static constexpr int SMEM = (STAGES * STAGE + BM * EPAD) * 4;  // the ring, then the tile
  static constexpr int TILE = BM * BN;  // floats of a scratch slot
};

// Hands 4 consecutive sums of row gr, columns gc.., to the epilogue: as one
// float4 where vec (m % 4 == 0: the rows are 16-byte aligned and the 4 lie
// within m or past it together), else element by element, masked at m. An
// epilogue Epi has `store4(offset, column, float4 sums)` and
// `store(offset, column, sum)`.
template <class Epi>
__device__ __forceinline__ void store_sums(const Epi& epi, float4 sum, int gr, int gc, int m,
                                           bool vec) {
  if (gc >= m) return;
  const size_t o = static_cast<size_t>(gr) * m + gc;
  if (vec) {
    epi.store4(o, gc, sum);
    return;
  }
  const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (gc + u < m) epi.store(o + u, gc + u, v[u]);
}

// units: (row tile, column tile, k_lo, k_hi, slot), slot -1 = the whole
// tile, handed to the epilogue; block b walks units[block_start[b] ..
// block_start[b+1]).
template <int BN, bool VEC, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
tri_mma_kernel(const float* __restrict__ L, const float* __restrict__ W,
               float* __restrict__ ws, const int* __restrict__ units,
               const int* __restrict__ block_start, int n, int m, Epi epi) {
  using G = Geometry<BN>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the fragments' group and thread in group
  const int wrow = (warp / G::WN) * G::WTM, wcol = (warp % G::WN) * G::WTN;
  const int u_first = block_start[blockIdx.x], u_end = block_start[blockIdx.x + 1];
  auto steps_of = [&](int u) { return (units[5 * u + 3] - units[5 * u + 2] + BK - 1) / BK; };
  int total = 0;
  for (int u = u_first; u < u_end; ++u) total += steps_of(u);

  int load_u = u_first, load_s = 0;  // the unit and step the next load fills
  auto load_next = [&](int stage) {
    if (load_u >= u_end) return;
    const int* unit = units + 5 * load_u;
    const int row0 = unit[0] * BM, col0 = unit[1] * BN, k_hi = unit[3];
    const int k0 = unit[2] + load_s * BK;
    float* As = smem + stage * G::STAGE;
    float* Bs = As + BM * APAD;
    constexpr int V = VEC ? 4 : 1;
    constexpr int A_COPIES = BM * (BK / V) / THREADS, B_COPIES = BK * (BN / V) / THREADS;
    static_assert(A_COPIES * THREADS == BM * (BK / V) && B_COPIES * THREADS == BK * (BN / V),
                  "the tiles split evenly over the threads");
#pragma unroll
    for (int i = 0; i < A_COPIES; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BK / V), c = (e % (BK / V)) * V;
      const int gr = row0 + r, gk = k0 + c;
      const bool ok = gr < n && gk < k_hi;  // k_hi: the triangular bound
      const float* src = ok ? L + static_cast<size_t>(gr) * n + gk : L;
      if (VEC) cp_async16(As + r * APAD + c, src, ok);
      else cp_async4(As + r * APAD + c, src, ok);
    }
#pragma unroll
    for (int i = 0; i < B_COPIES; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e / (BN / V), j = (e % (BN / V)) * V;
      const int gk = k0 + kk, gc = col0 + j;
      const bool ok = gk < k_hi && gc < m;
      const float* src = ok ? W + static_cast<size_t>(gk) * m + gc : W;
      if (VEC) cp_async16(Bs + kk * G::BPAD + j, src, ok);
      else cp_async4(Bs + kk * G::BPAD + j, src, ok);
    }
    if (++load_s == steps_of(load_u)) {
      ++load_u;
      load_s = 0;
    }
  };

  float acc[G::MT][G::NT][4];
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load_next(s);
    cp_async_commit();
  }
  int cur_u = u_first, cur_s = 0, cur_steps = u_first < u_end ? steps_of(u_first) : 0;
  for (int step = 0; step < total; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // this step's tiles landed; the last step's stage is free
    load_next((step + STAGES - 1) % STAGES);
    cp_async_commit();

    const float* As = smem + (step % STAGES) * G::STAGE + (wrow + (lane & 15)) * APAD +
                      4 * (lane >> 4);
    const float* Bs = smem + (step % STAGES) * G::STAGE + BM * APAD + t * G::BPAD + wcol + g;
    float part[G::MT][G::NT][4];  // this stage's products alone: the blocked sum
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t a_hi[G::MT][4], a_lo[G::MT][4], b_hi[G::NT][2], b_lo[G::NT][2];
#pragma unroll
      for (int i = 0; i < G::MT; ++i) {  // rows g, g+8; k t, t+4 of fragment i
        ldmatrix_x4(a_hi[i], As + i * 16 * APAD + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_tf32(__uint_as_float(a_hi[i][q]), a_hi[i][q], a_lo[i][q]);
      }
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {  // k t, t+4; column g of fragment j
        const float* b = Bs + kk * G::BPAD + j * 8;
        split_tf32(b[0], b_hi[j][0], b_lo[j][0]);
        split_tf32(b[4 * G::BPAD], b_hi[j][1], b_lo[j][1]);
      }
      // the two small products first, then hi * hi, into every fragment
#pragma unroll
      for (int i = 0; i < G::MT; ++i)
#pragma unroll
        for (int j = 0; j < G::NT; ++j) {
          if (kk == 0) mma_tf32_fresh(part[i][j], a_lo[i], b_hi[j]);
          else mma_tf32(part[i][j], a_lo[i], b_hi[j]);
        }
#pragma unroll
      for (int i = 0; i < G::MT; ++i)
#pragma unroll
        for (int j = 0; j < G::NT; ++j) mma_tf32(part[i][j], a_hi[i], b_lo[j]);
#pragma unroll
      for (int i = 0; i < G::MT; ++i)
#pragma unroll
        for (int j = 0; j < G::NT; ++j) mma_tf32(part[i][j], a_hi[i], b_hi[j]);
    }
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = __fadd_rn(acc[i][j][q], part[i][j][q]);

    if (++cur_s < cur_steps) continue;
    // The unit is done (the whole block at once): its sums go through shared
    // memory, beside the ring, which runs on, so that each thread then owns
    // 4 consecutive columns and every global access is a coalesced float4.
    const int* unit = units + 5 * cur_u;
    const int row0 = unit[0] * BM, col0 = unit[1] * BN, slot = unit[4];
    float* E = smem + STAGES * G::STAGE;
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)  // rows g and g+8; columns 2t, 2t+1
          *reinterpret_cast<float2*>(E + (wrow + i * 16 + g + 8 * h) * G::EPAD + wcol + j * 8 +
                                     2 * t) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    __syncthreads();  // (the next step's barrier keeps the next unit from E until it is read)
#pragma unroll
    for (int v = 0; v < G::TILE / (4 * THREADS); ++v) {
      const int e = (v * THREADS + tid) * 4, r = e / BN, c = e % BN;
      const float4 sum = *reinterpret_cast<const float4*>(E + r * G::EPAD + c);
      if (slot >= 0) {  // a partial: the whole tile, unmasked
        *reinterpret_cast<float4*>(ws + static_cast<size_t>(slot) * G::TILE + e) = sum;
      } else if (row0 + r < n) {
        store_sums(epi, sum, row0 + r, col0 + c, m, VEC);
      }
    }
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    ++cur_u;
    cur_s = 0;
    cur_steps = cur_u < u_end ? steps_of(cur_u) : 0;
  }
  cp_async_wait<0>();
}

// fixups: (row tile, column tile, first slot, slot count). Block (f, y)
// takes 4 x THREADS elements of tile f, 4 consecutive columns a thread,
// adds their partials in slot order and hands the sums to the epilogue.
template <int BN, class Epi>
__global__ void __launch_bounds__(THREADS)
tri_mma_fixup_kernel(const float* __restrict__ ws, const int* __restrict__ fixups, int n, int m,
                     Epi epi) {
  using G = Geometry<BN>;
  const int* f = fixups + 4 * blockIdx.x;
  const int row0 = f[0] * BM, col0 = f[1] * BN, slot0 = f[2], count = f[3];
  const int e = (blockIdx.y * THREADS + threadIdx.x) * 4;
  const float* p = ws + static_cast<size_t>(slot0) * G::TILE + e;
  float4 s = *reinterpret_cast<const float4*>(p);
#pragma unroll 4
  for (int q = 1; q < count; ++q) {  // the loads do not wait for the adds
    const float4 v = *reinterpret_cast<const float4*>(p + static_cast<size_t>(q) * G::TILE);
    s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z),
                    __fadd_rn(s.w, v.w));
  }
  const int gr = row0 + e / BN;
  if (gr < n) store_sums(epi, s, gr, col0 + e % BN, m, m % 4 == 0);
}

template <int BN, bool VEC, class Epi>
cudaError_t launch_tiles(const float* L, const float* W, float* ws, const int* units,
                         const int* block_start, int n_blocks, const int* fixups, int n_fixups,
                         int n, int m, Epi epi, cudaStream_t stream) {
  constexpr int smem = Geometry<BN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(tri_mma_kernel<BN, VEC, Epi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  tri_mma_kernel<BN, VEC, Epi><<<n_blocks, THREADS, smem, stream>>>(L, W, ws, units, block_start,
                                                                      n, m, epi);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_fixups == 0) return err;
  const dim3 grid(n_fixups, Geometry<BN>::TILE / (4 * THREADS));
  tri_mma_fixup_kernel<BN, Epi><<<grid, THREADS, 0, stream>>>(ws, fixups, n, m, epi);
  return cudaGetLastError();
}

// out-of-place L @ W over the schedule, column tiles of tile_n (64 or 128);
// returns the last cudaError_t.
template <class Epi>
cudaError_t launch(const float* L, const float* W, float* ws, const int* units,
                   const int* block_start, int n_blocks, const int* fixups, int n_fixups,
                   int tile_n, int n, int m, Epi epi, cudaStream_t s) {
  const bool vec = n % 4 == 0 && m % 4 == 0 && reinterpret_cast<uintptr_t>(L) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(W) % 16 == 0;
  const auto* u = units;
  const auto* b = block_start;
  if (tile_n == 64)
    return vec ? launch_tiles<64, true>(L, W, ws, u, b, n_blocks, fixups, n_fixups, n, m, epi, s)
               : launch_tiles<64, false>(L, W, ws, u, b, n_blocks, fixups, n_fixups, n, m, epi, s);
  if (tile_n == 128)
    return vec ? launch_tiles<128, true>(L, W, ws, u, b, n_blocks, fixups, n_fixups, n, m, epi, s)
               : launch_tiles<128, false>(L, W, ws, u, b, n_blocks, fixups, n_fixups, n, m, epi,
                                          s);
  return cudaErrorInvalidValue;
}

}  // namespace tri_mma
