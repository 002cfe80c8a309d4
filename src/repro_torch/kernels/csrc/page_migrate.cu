// Page migration (demote/promote) as CUDA gather/scatter kernels.
//
// Replaces the Pallas TPU kernels page_gather (repro/kernels/page_migrate.py
// :31, pallas_call :47) and page_scatter (:59, pallas_call :79).
//
//   page_gather:  out[s][i]         = store[s][frames[i]]
//   page_scatter: store[s][frames[i]] = pages[s][i]      (in place)
//
// over one or two stores s (the cache's K and V) in one launch.  A frame
// is one whole KV page of every layer, (L, Hkv, P, D) contiguous
// elements, in float32 at P = 16: 360,448 bytes for tinyllama-1.1b,
// 458,752 for chatglm3-6b and qwen2-vl-2b, 524,288 for phi3.5-moe (8
// layers), 2,228,224 for gemma3-4b, 3,276,800 for phi3-medium-14b and
// 4,718,592 for musicgen-medium.
//
// Bound: bytes.  A launch reads and writes n * stores * frame_bytes and
// does no arithmetic: a flush of 14 pairs over tinyllama's two stores
// moves 2 * 28 * 360,448 B = 20 MB, 6.0 us at 3.35 TB/s.  Design:
// * Frames by value.  The launcher copies up to kMaxPairs frame indices
//   and the base addresses into a __grid_constant__ parameter struct
//   (1.1 KB), so no block waits on a dependent global load before its
//   first copy: the counterpart of the TPU kernel's scalar prefetch.
//   The wrapper launches a longer list in chunks of kMaxPairs.
// * TMA bulk copies through a shared-memory ring.  A persistent grid of
//   kBlocksPerSm blocks an SM walks work items (store, pair, 8 KB chunk
//   of the frame; a shorter tail, a multiple of 16 bytes).  One thread a
//   block issues cp.async.bulk global->shared into stage j % kStages,
//   completing on that stage's mbarrier, then cp.async.bulk
//   shared->global out of it; before it reloads a stage it waits until
//   the store out of it has read it (bulk_group wait_group.read).  No
//   register holds data, and each SM keeps up to 128 KB in flight, well
//   above the ~25 KB Little's law asks for at HBM's rate and latency.
//   Chunks of 8 KB (tinyllama's frame is 44 of them, phi3.5's 64) in 8
//   stages beat 16 KB in 4 on the card: the persistent grid's last
//   items are smaller, so its blocks finish closer together.
// * The staging tensor can stay in L2 between the two phases of a flush:
//   the gather writes it with an evict_last hint and the scatter reads it
//   with evict_first; the frames the gather reads are migrating away, so
//   it reads them evict_first too.  That pays only while the staging fits
//   the 50 MB L2.  A serve run's median flush is 12 pairs over both
//   stores: 8.7 MB of staging for tinyllama-1.1b, 11 MB for chatglm3 and
//   qwen2-vl, 53 MB for gemma3-4b, 79 MB for phi3-medium and 113 MB for
//   musicgen-medium.  On an H100 80GB HBM3 at 700 W a gather then a
//   scatter took 15.1-18.0 us against 19.9-22.8 for the two alone at the
//   first three, 66.4 against 69.4 at gemma3, and no less than the two
//   alone at the last two (106.5 against 103.9, 153.2 against 152.6 us):
//   there the staging goes through HBM, and each copy runs at 90-95% of
//   HBM's rate (chip_smoke.py, phase 4; PERF.md).
// Scatter writes in place.  Duplicate target frames are legal only with
// identical payloads, so the order of those racing writes does not
// matter.
#include "common.cuh"

namespace {

constexpr int kMaxPairs = 256;   // page_migrate.py MAX_PAIRS
constexpr int kMaxStores = 2;
constexpr int kChunk = 8192;     // bytes a work item moves, at most
constexpr int kStages = 8;
constexpr int kBlocksPerSm = 2;  // 2 * 64 KB of ring an SM
constexpr int kSmemBytes = kStages * kChunk + kStages * 8;

struct FrameCopy {
  const uint8_t* src[kMaxStores];  // gather: the stores; scatter: staging
  uint8_t* dst[kMaxStores];        // gather: staging; scatter: the stores
  int64_t frame_bytes;
  int32_t chunks;                  // work items a frame
  int32_t n;                       // pairs
  int32_t n_stores;
  int32_t frames[kMaxPairs];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_policy_evict_normal() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// global -> shared, completing `bytes` transactions on the mbarrier.
__device__ __forceinline__ void bulk_load(unsigned smem, const void* gmem,
                                          unsigned bytes, unsigned bar,
                                          uint64_t policy) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      ::"r"(smem), "l"(gmem), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// shared -> global, tracked by this thread's bulk async-groups.
__device__ __forceinline__ void bulk_store(void* gmem, unsigned smem,
                                           unsigned bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;\n"
      ::"l"(gmem), "r"(smem), "r"(bytes), "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

template <bool kGather>
__global__ void __launch_bounds__(32)
page_copy_kernel(const __grid_constant__ FrameCopy p) {
  extern __shared__ __align__(128) uint8_t smem[];
  if (threadIdx.x != 0) return;  // one thread drives the copy engine
  const int64_t total =
      static_cast<int64_t>(p.n_stores) * p.n * p.chunks;
  const int64_t first = blockIdx.x;
  if (first >= total) return;
  const int count = static_cast<int>((total - first + gridDim.x - 1) / gridDim.x);
  const unsigned ring = smem_addr(smem);
  const unsigned bars = smem_addr(smem + kStages * kChunk);
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bars + 8 * s),
                 "r"(1u) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // What a launch reads is not read again; the staging the gather writes
  // is read once, by the scatter, so it stays in L2 until then.
  const uint64_t load_policy = l2_policy_evict_first();
  const uint64_t store_policy =
      kGather ? l2_policy_evict_last() : l2_policy_evict_normal();

  // Work item j of this block: bytes at src -> dst.
  auto item = [&](int j, const uint8_t*& src, uint8_t*& dst) -> unsigned {
    const int64_t w = first + static_cast<int64_t>(j) * gridDim.x;
    const int c = static_cast<int>(w % p.chunks);
    const int64_t t = w / p.chunks;
    const int i = static_cast<int>(t % p.n);
    const int s = static_cast<int>(t / p.n);
    const int64_t frame = p.frames[i];
    const int64_t off = static_cast<int64_t>(c) * kChunk;
    src = p.src[s] + (kGather ? frame : i) * p.frame_bytes + off;
    dst = p.dst[s] + (kGather ? i : frame) * p.frame_bytes + off;
    const int64_t left = p.frame_bytes - off;
    return static_cast<unsigned>(left < kChunk ? left : kChunk);
  };
  auto load = [&](int j) {
    const uint8_t* src;
    uint8_t* dst;
    const unsigned bytes = item(j, src, dst);
    const int s = j % kStages;
    bulk_load(ring + s * kChunk, src, bytes, bars + 8 * s, load_policy);
  };

  for (int j = 0; j < count && j < kStages; ++j) load(j);
  for (int j = 0; j < count; ++j) {
    const int s = j % kStages;
    mbar_wait(bars + 8 * s, (j / kStages) & 1);
    const uint8_t* src;
    uint8_t* dst;
    const unsigned bytes = item(j, src, dst);
    bulk_store(dst, ring + s * kChunk, bytes, store_policy);
    // Refill the stage item j - 1 used, once its store has read it; the
    // store just issued may still be reading.
    if (j >= 1 && j - 1 + kStages < count) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(j - 1 + kStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// src/dst: n_stores base addresses each (see FrameCopy); frames: n host
// int32 frame indices, read here and passed by value.  Bases and
// frame_bytes must be 16-byte aligned (TMA bulk copies need it; the
// wrapper checks, and so does this launcher).
template <bool kGather>
int launch(const void* const* src, void* const* dst, int n_stores,
           const int32_t* frames, int n, int64_t frame_bytes, int sm_count,
           void* stream) {
  if (n <= 0 || frame_bytes <= 0) return 0;
  if (n > kMaxPairs || n_stores < 1 || n_stores > kMaxStores || sm_count < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  FrameCopy p{};
  uintptr_t align = static_cast<uintptr_t>(frame_bytes);
  for (int s = 0; s < n_stores; ++s) {
    p.src[s] = static_cast<const uint8_t*>(src[s]);
    p.dst[s] = static_cast<uint8_t*>(dst[s]);
    align |= reinterpret_cast<uintptr_t>(src[s]) | reinterpret_cast<uintptr_t>(dst[s]);
  }
  if (align % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  for (int i = 0; i < n; ++i) p.frames[i] = frames[i];
  p.frame_bytes = frame_bytes;
  p.chunks = static_cast<int32_t>((frame_bytes + kChunk - 1) / kChunk);
  p.n = n;
  p.n_stores = n_stores;
  const int64_t total = static_cast<int64_t>(n_stores) * n * p.chunks;
  const int64_t cap = static_cast<int64_t>(sm_count) * kBlocksPerSm;
  const unsigned grid = static_cast<unsigned>(total < cap ? total : cap);
  cudaError_t err = cudaFuncSetAttribute(
      page_copy_kernel<kGather>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  page_copy_kernel<kGather><<<grid, 32, kSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[s] rows i (staging, n frames each), store[s] rows frames[i].
extern "C" int page_gather(const void* const* stores, void* const* out,
                           int n_stores, const int32_t* frames, int n,
                           int64_t frame_bytes, int sm_count, void* stream) {
  return launch<true>(stores, out, n_stores, frames, n, frame_bytes, sm_count,
                      stream);
}

// store[s] rows frames[i], written in place, from pages[s] rows i.
extern "C" int page_scatter(void* const* stores, const void* const* pages,
                            int n_stores, const int32_t* frames, int n,
                            int64_t frame_bytes, int sm_count, void* stream) {
  return launch<false>(pages, stores, n_stores, frames, n, frame_bytes, sm_count,
                       stream);
}
