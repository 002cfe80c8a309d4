// Page migration (demote/promote) as CUDA gather/scatter kernels.
//
// Replaces the Pallas TPU kernels page_gather (repro/kernels/page_migrate.py
// :31, pallas_call :47) and page_scatter (:59, pallas_call :79).
//
//   page_gather:  out[i]         = src[frames[i]]
//   page_scatter: dst[frames[i]] = pages[i]      (in place)
//
// A frame is one whole KV page of every layer, (L, Hkv, P, D) contiguous
// elements: 360,448 bytes for tinyllama-1.1b in float32 at P = 16.
//
// Bound: bytes.  Each copy reads and writes N * frame_bytes, so a flush
// of N = 64 full-width frames moves 2 * 64 * 360,448 B = 46 MB, about
// 14 us at 3.35 TB/s; it does no arithmetic.  Design: grid (chunks, N);
// blockIdx.y selects the frame and the block loads its frame index
// itself (the TPU kernel had it scalar-prefetched), blockIdx.x strides
// over the frame in 16-byte vectors so neighbouring threads touch
// neighbouring addresses and enough blocks are in flight to cover all
// SMs.  Scatter writes in place; duplicate target frames are legal only
// with identical payloads (the trash-frame padding of the staged flush),
// so the order of those racing writes does not matter.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 4;

template <bool kGather>
__global__ void frame_copy_kernel(const uint4* __restrict__ src,
                                  uint4* __restrict__ dst,
                                  const int32_t* __restrict__ frames,
                                  int64_t units) {
  const int64_t i = blockIdx.y;
  const int64_t frame = frames[i];
  const uint4* s = src + (kGather ? frame : i) * units;
  uint4* d = dst + (kGather ? i : frame) * units;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       u < units; u += stride) {
    d[u] = s[u];
  }
}

// Frames and both base addresses must be 16-byte aligned (the wrapper
// checks; every store the port builds is).
template <bool kGather>
int launch(const void* src, void* dst, const void* frames, int64_t n,
           int64_t frame_bytes, void* stream) {
  if (n == 0 || frame_bytes == 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(dst) |
                          static_cast<uintptr_t>(frame_bytes);
  if (align % sizeof(uint4) != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t units = frame_bytes / static_cast<int64_t>(sizeof(uint4));
  int64_t chunks = (units + kThreads * kUnitsPerThread - 1) /
                   (kThreads * kUnitsPerThread);
  if (chunks > 65535) chunks = 65535;
  dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(n));
  frame_copy_kernel<kGather><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst),
      static_cast<const int32_t*>(frames), units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out: (n, frame) contiguous; src: (F, frame) contiguous.
extern "C" int page_gather(const void* src, const void* frames, void* out,
                           int64_t n, int64_t frame_bytes, void* stream) {
  return launch<true>(src, out, frames, n, frame_bytes, stream);
}

// dst: (F, frame) contiguous, written in place; pages: (n, frame).
extern "C" int page_scatter(void* dst, const void* frames, const void* pages,
                            int64_t n, int64_t frame_bytes, void* stream) {
  return launch<false>(pages, dst, frames, n, frame_bytes, stream);
}
