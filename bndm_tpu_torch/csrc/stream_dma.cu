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
// arithmetic. So the design keeps loads in flight at every moment, through
// the add and through the stores, and lets no thread of a block wait on
// another's stage.
//
// Design. The TPU program is one sequential loop, and one block cannot fill
// HBM, so as many blocks as the SMs hold at once (by shared memory: the
// occupancy API) take the chunks. They claim them in address order from a
// counter in device memory, which keeps the card on a narrow window of
// addresses and lets the SMs that stream fastest take the most: an equal
// split fixed up front (chunks grid-stride) waits for the slowest SM at
// the end. Every block claims once past the last chunk; the last block to
// finish sets the counter back to 0, so no launch is added to clear it.
// A block's shared memory is one ring of STAGES chunk buffers; a chunk is
// loaded, added and stored from the same buffer, in place. Each stage has
// two mbarriers, "full" (the load landed) and "added" (every consumer warp
// is done with it), and the index of the chunk it holds (-1: no more).
//   * Warp 0 produces, one thread of it: it fills the ring with 1-D bulk
//     TMA loads (cp.async.bulk.shared::cluster.global.mbarrier::
//     complete_tx::bytes, counted on "full" armed with arrive.expect_tx;
//     the chunks are contiguous bytes, so no tensor map is needed), each
//     claim made one load ahead. For each chunk in turn it waits on
//     "added", issues the bulk store
//     (cp.async.bulk.global.shared::cta.bulk_group) and commits it; then,
//     once cp.async.bulk.wait_group.read says the store issued LAG chunks
//     earlier has read its stage, refills that stage with the next chunk
//     it claimed. So STAGES - LAG - 1 loads stay in flight while the
//     consumers add. Loads and stores carry an L2 evict-first policy:
//     nothing is read twice.
//   * The other warps consume: each waits on "full" (the phase parity
//     flips each time the ring comes round), adds 1 with the native bf16
//     add (__hadd2, correctly rounded like torch's float add then round),
//     16 bytes a thread at a time, fences (fence.proxy.async.shared::cta)
//     so that the bulk store sees its writes, and arrives on "added", one
//     arrival a warp. No block-wide barrier is crossed after the setup.
//   * Bulk copies need 16-byte aligned addresses and sizes (the wrapper
//     raises on a misaligned pointer). The last chunk may be shorter (a
//     smaller bulk copy); the < 8 elements past the last 16-byte boundary
//     of the array are added by plain threads of block 0.
//
// The kernel launches on the caller's stream, allocates nothing (the caller
// owns the two claim counters, zeroed once) and does not synchronise; the C
// entry point returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CONSUMER_WARPS = 4;
constexpr int THREADS = 32 * (1 + CONSUMER_WARPS);  // warp 0 produces, the rest add
constexpr int MAX_STAGES = 8;
constexpr int HEAD_BYTES = 256;  // 2 mbarriers and a chunk index a stage; then the ring
constexpr int LAG = 1;  // stores left reading their stage when one is refilled

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes,
                                           uint64_t policy) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::
                   "l"(dst),
               "r"(src), "r"(bytes), "l"(policy)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {  // <= N groups still reading smem
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(THREADS)
stream_dma_kernel(const char* __restrict__ x, char* __restrict__ y, long long bulk_bytes,
                  int chunk, int stages, long long n_elems, unsigned long long* claims) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* added = full + MAX_STAGES;
  long long* ids = reinterpret_cast<long long*>(added + MAX_STAGES);  // each stage's chunk
  unsigned char* ring = smem + HEAD_BYTES;
  const int tid = threadIdx.x;
  const long long n_chunks = (bulk_bytes + chunk - 1) / chunk;

  auto chunk_len = [&](long long c) -> uint32_t {
    const long long rest = bulk_bytes - c * chunk;
    return static_cast<uint32_t>(rest < chunk ? rest : chunk);
  };
  auto stage = [&](int i) { return ring + static_cast<size_t>(i) * chunk; };

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(smem_addr(&full[i]), 1);
      mbar_init(smem_addr(&added[i]), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (blockIdx.x == 0 && tid < 8) {  // the ragged tail past the last 16-byte boundary
    const long long k = bulk_bytes / 2 + tid;
    if (k < n_elems) {
      const auto* xb = reinterpret_cast<const __nv_bfloat16*>(x);
      auto* yb = reinterpret_cast<__nv_bfloat16*>(y);
      yb[k] = __hadd(xb[k], __float2bfloat16_rn(1.0f));
    }
  }

  // The k-th chunk a block takes goes to stage k % stages, whose barriers
  // then complete their phase k / stages. s and ph follow that for this
  // thread's current chunk.
  int s = 0;
  uint32_t ph = 0;
  auto advance = [&]() {
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  };

  if (tid < 32) {  // the producer
    if (tid != 0) return;
    const uint64_t policy = evict_first_policy();
    auto claim = [&]() { return static_cast<long long>(atomicAdd(&claims[0], 1ULL)); };
    long long c_in = claim();  // the next chunk to load, into stage s_in; claimed ahead
    int s_in = 0;
    bool claiming = true;
    auto post = [&]() {  // stage s_in takes chunk c_in, or the end mark (-1)
      const uint32_t bar = smem_addr(&full[s_in]);
      if (c_in < n_chunks) {
        ids[s_in] = c_in;
        const uint32_t len = chunk_len(c_in);
        mbar_expect_tx(bar, len);
        bulk_load(smem_addr(stage(s_in)), x + c_in * chunk, len, bar, policy);
        c_in = claim();
      } else {
        ids[s_in] = -1;
        mbar_arrive(bar);
        claiming = false;
      }
      if (++s_in == stages) s_in = 0;
    };
    for (int k = 0; k < stages && claiming; ++k) post();  // fill the ring
    int stored = 0;
    for (long long c = ids[s]; c >= 0; advance(), c = ids[s]) {
      mbar_wait(smem_addr(&added[s]), ph);
      bulk_store(y + c * chunk, smem_addr(stage(s)), chunk_len(c), policy);
      // s_in is the stage of the store issued LAG chunks ago: free once
      // no more than LAG stores are left reading
      if (++stored > LAG && claiming) {
        bulk_wait_read<LAG>();
        post();
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    // every block claims once past the end; the last block to get here
    // sets the counters back to 0 for the next launch
    __threadfence();
    if (atomicAdd(&claims[1], 1ULL) == gridDim.x - 1) {
      atomicExch(&claims[0], 0ULL);
      atomicExch(&claims[1], 0ULL);
    }
    return;
  }

  const __nv_bfloat162 one = __float2bfloat162_rn(1.0f);
  for (;; advance()) {  // the consumers
    mbar_wait(smem_addr(&full[s]), ph);
    const long long c = ids[s];
    if (c < 0) break;
    uint4* buf = reinterpret_cast<uint4*>(stage(s));
    const uint32_t n16 = chunk_len(c) / 16;
    for (uint32_t k = tid - 32; k < n16; k += 32 * CONSUMER_WARPS) {
      uint4 v = buf[k];
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __hadd2(h[i], one);
      buf[k] = v;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(smem_addr(&added[s]));
  }
}

}  // namespace

// y = x + 1 over n_elems contiguous bf16 values, 16-byte aligned, on the
// current device, in chunks of `chunk` bytes (a multiple of 16) through a
// ring of `stages` (2 to 8) stages; `claims` points to two uint64 counters
// that hold 0 and that the launch leaves at 0, used by one stream. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments it does not take, or a ring larger
// than a block's shared memory), 0 on success.
extern "C" int bndm_stream_add_one_bf16(const void* x, void* y, long long n_elems, int chunk,
                                        int stages, void* claims, void* stream) {
  if (n_elems < 1 || chunk < 16 || chunk % 16 != 0 || stages < 2 || stages > MAX_STAGES ||
      claims == nullptr || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, smem_max = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = HEAD_BYTES + static_cast<long long>(stages) * chunk;
  if (smem > smem_max) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(stream_dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stream_dma_kernel, THREADS,
                                                        static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long bulk_bytes = (2 * n_elems) & ~15LL;
  const long long n_chunks = (bulk_bytes + chunk - 1) / chunk;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(n_chunks < 1 ? 1 : (n_chunks < resident ? n_chunks : resident));
  stream_dma_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(x), static_cast<char*>(y), bulk_bytes, chunk, stages, n_elems,
      static_cast<unsigned long long*>(claims));
  return static_cast<int>(cudaGetLastError());
}
