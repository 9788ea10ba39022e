// P2: y = x + 1 in bf16 through a copy pipeline managed by hand.
//
// Replaces the TPU kernel `manual_dma(rows_per_chunk).f` of
// scripts/bench_pallas_stream.py (body `kern`, :58-92): one program walks
// every chunk of a bf16 (256000, 1024) array with double-buffered DMA in,
// the add, and double-buffered DMA out, ordered by DMA semaphores.
//
// What bounds it on an H100 SXM: bytes. It reads its input once and writes
// its output once, 2 x 524,288,000 B at the full shape, 0.3130 ms at the
// data sheet's 3.35 TB/s; one add per element is nothing against the card's
// arithmetic. The design aims to keep enough bytes in flight per SM that
// HBM, and not the latency of one copy, sets the time.
//
// Design. The TPU program is one sequential loop, and one block cannot fill
// HBM, so one persistent block per SM walks the chunks grid-stride. Each
// block keeps a ring of STAGES input and STAGES output buffers in shared
// memory (2 stages like the TPU's, more in the bench's sweep). The TPU's 1-2
// MiB chunks do not fit in 227 KB, so a chunk is a few tens of KiB.
//   * Loads: thread 0 issues a 1-D bulk TMA copy
//     (cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes)
//     whose completion is counted on the stage's mbarrier, armed with
//     arrive.expect_tx. The chunks are contiguous bytes, so no tensor map
//     (cuTensorMapEncodeTiled, which needs libcuda) is needed.
//   * Compute: every thread waits on the barrier's phase parity (it flips
//     each time a stage is reused), adds 1 with the native bf16 add
//     (__hadd2, correctly rounded like torch's float add then round), 16
//     bytes at a time, into the output stage, then fences
//     (fence.proxy.async.shared::cta) so the bulk store sees those writes.
//   * Stores: thread 0 issues a bulk store
//     (cp.async.bulk.global.shared::cta.bulk_group) and commits it. An
//     output stage is rewritten only after cp.async.bulk.wait_group.read
//     says the store of STAGES iterations ago has read it: the counterpart
//     of `put_out(slot, i - 2).wait()`. Right after a store is issued, the
//     input stage it came from is refilled with the chunk STAGES ahead.
//   * Bulk copies need 16-byte aligned addresses and sizes (the wrapper
//     raises on a misaligned pointer). The last chunk may be shorter (a
//     smaller bulk copy); the < 8 elements past the last 16-byte boundary
//     of the array are added by plain threads of block 0.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry point returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int BAR_BYTES = 128;  // mbarriers first; the stages start 128-aligned

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {  // <= N groups still reading smem
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
stream_dma_kernel(const char* __restrict__ x, char* __restrict__ y, long long bulk_bytes,
                  int chunk, long long n_elems) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* in_buf = smem + BAR_BYTES;
  unsigned char* out_buf = in_buf + static_cast<size_t>(STAGES) * chunk;
  const int tid = threadIdx.x;
  const long long n_chunks = (bulk_bytes + chunk - 1) / chunk;
  const long long stride = gridDim.x;

  auto chunk_len = [&](long long c) -> uint32_t {
    const long long rest = bulk_bytes - c * chunk;
    return static_cast<uint32_t>(rest < chunk ? rest : chunk);
  };
  auto fetch = [&](int s, long long c) {  // thread 0 only
    const uint32_t len = chunk_len(c);
    const uint32_t bar = smem_addr(&bars[s]);
    mbar_expect_tx(bar, len);
    bulk_load(smem_addr(in_buf + static_cast<size_t>(s) * chunk), x + c * chunk, len, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_addr(&bars[s]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < STAGES && blockIdx.x + s * stride < n_chunks; ++s)
      fetch(s, blockIdx.x + s * stride);  // fill the ring
  }
  __syncthreads();

  const __nv_bfloat162 one = __float2bfloat162_rn(1.0f);
  int i = 0;
  for (long long c = blockIdx.x; c < n_chunks; c += stride, ++i) {
    const int s = i % STAGES;
    const uint32_t len = chunk_len(c);
    if (tid == 0) bulk_wait_read<STAGES - 1>();  // the store of iteration i - STAGES read out[s]
    mbar_wait(smem_addr(&bars[s]), (i / STAGES) & 1);
    __syncthreads();
    const uint4* src = reinterpret_cast<const uint4*>(in_buf + static_cast<size_t>(s) * chunk);
    uint4* dst = reinterpret_cast<uint4*>(out_buf + static_cast<size_t>(s) * chunk);
    for (uint32_t k = tid; k < len / 16; k += THREADS) {
      uint4 v = src[k];
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = __hadd2(h[j], one);
      dst[k] = v;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // out[s] written, in[s] read by every thread
    if (tid == 0) {
      bulk_store(y + c * chunk, smem_addr(dst), len);
      if (c + STAGES * stride < n_chunks) fetch(s, c + STAGES * stride);
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

  if (blockIdx.x == 0) {  // the ragged tail past the last 16-byte boundary
    const long long k = bulk_bytes / 2 + tid;
    if (k < n_elems) {
      const auto* xb = reinterpret_cast<const __nv_bfloat16*>(x);
      auto* yb = reinterpret_cast<__nv_bfloat16*>(y);
      yb[k] = __hadd(xb[k], __float2bfloat16_rn(1.0f));
    }
  }
}

template <int STAGES>
int launch(const void* x, void* y, long long n_elems, int chunk, cudaStream_t stream) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = BAR_BYTES + 2LL * STAGES * chunk;
  if (smem > smem_max) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(stream_dma_kernel<STAGES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bulk_bytes = (2 * n_elems) & ~15LL;
  const long long n_chunks = (bulk_bytes + chunk - 1) / chunk;
  const int grid = static_cast<int>(n_chunks < 1 ? 1 : (n_chunks < sms ? n_chunks : sms));
  stream_dma_kernel<STAGES><<<grid, THREADS, smem, stream>>>(
      static_cast<const char*>(x), static_cast<char*>(y), bulk_bytes, chunk, n_elems);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = x + 1 over n_elems contiguous bf16 values, 16-byte aligned, on the
// current device, in chunks of `chunk` bytes (a multiple of 16) through a
// ring of `stages` (2, 3 or 4) stages. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments it does not take), 0 on success.
extern "C" int bndm_stream_add_one_bf16(const void* x, void* y, long long n_elems, int chunk,
                                        int stages, void* stream) {
  if (n_elems < 1 || chunk < 16 || chunk % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (stages) {
    case 2: return launch<2>(x, y, n_elems, chunk, s);
    case 3: return launch<3>(x, y, n_elems, chunk, s);
    case 4: return launch<4>(x, y, n_elems, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
