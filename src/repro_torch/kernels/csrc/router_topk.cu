// MoE router (softmax over experts, top-k, renormalise) as a CUDA kernel
// for Hopper.
//
// Replaces the Pallas TPU kernel router_topk
// (repro/kernels/router_topk.py:47, pallas_call :60; body _router_kernel
// :22).  Per token row of logits (T, E) float32:
//   probs = softmax(logits)                                  (T, E) f32
//   k rounds of masked argmax over probs, the lowest index winning a
//   tie (as lax.top_k and the TPU kernel's jnp.argmax), each winner
//   masked to -1 before the next round                       idx (T, k)
//   vals = the k winners / max(sum of them, 1e-9)            vals (T, k)
//
// Bound: bytes.  Each logit is read once and each prob written once,
// 8 * T * E bytes plus 8 * T * k for vals and idx: 2.3 MB at T = 4096,
// E = 64, k = 6, about 0.7 us at 3.35 TB/s.  The arithmetic (one exp
// per logit, k warp reductions per row) is far below the float32 rate.
// At the serving shapes (T = 8 or 47, E = 16) launch latency sets the
// time.
//
// Design: one warp per token row, so a row needs no shared memory and
// no barrier.  Lane l holds the logits l, l + 32, ... of the row in
// registers (E <= 32 * kMaxPerLane); warp shuffles give the row max,
// the sum of exponentials and, in each top-k round, an argmax that
// breaks ties to the lower index.  probs are written once, coalesced
// across the warp; lane j < k then writes the j-th value and index.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPerLane = 8;  // E <= 256
constexpr int kMaxK = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void router_topk_kernel(const float* __restrict__ logits,
                                   float* __restrict__ probs,
                                   float* __restrict__ vals,
                                   int32_t* __restrict__ idx, int T, int E,
                                   int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= T) return;  // whole warps leave together
  const float* x = logits + static_cast<int64_t>(row) * E;
  float* pr = probs + static_cast<int64_t>(row) * E;

  float v[kMaxPerLane];
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < kMaxPerLane; ++c) {
    const int e = lane + 32 * c;
    v[c] = e < E ? x[e] : -INFINITY;
    m = fmaxf(m, v[c]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxPerLane; ++c) {
    v[c] = lane + 32 * c < E ? expf(v[c] - m) : 0.f;
    sum += v[c];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
#pragma unroll
  for (int c = 0; c < kMaxPerLane; ++c) {
    const int e = lane + 32 * c;
    if (e < E) {
      v[c] = v[c] / sum;
      pr[e] = v[c];
    } else {
      v[c] = -INFINITY;  // never selected: masked entries hold -1
    }
  }

  float top_v[kMaxK];
  int top_i[kMaxK];
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    if (r >= k) break;
    // this lane's best: the first maximum in index order
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int c = 0; c < kMaxPerLane; ++c) {
      if (v[c] > bv) {
        bv = v[c];
        bi = lane + 32 * c;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    top_v[r] = bv;
    top_i[r] = bi;
    total += bv;
#pragma unroll
    for (int c = 0; c < kMaxPerLane; ++c) {
      if (lane + 32 * c == bi) v[c] = -1.f;
    }
  }
  const float denom = fmaxf(total, 1e-9f);
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    if (r < k && lane == r) {
      vals[static_cast<int64_t>(row) * k + r] = top_v[r] / denom;
      idx[static_cast<int64_t>(row) * k + r] = top_i[r];
    }
  }
}

}  // namespace

// logits, probs: (T, E) float32 contiguous; vals: (T, k) float32;
// idx: (T, k) int32.  1 <= k <= min(E, 8), 1 <= E <= 256.
extern "C" int router_topk(const void* logits, void* probs, void* vals,
                           void* idx, int T, int E, int k, void* stream) {
  if (E < 1 || E > 32 * kMaxPerLane || k < 1 || k > kMaxK || k > E) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T == 0) return 0;
  const int blocks = (T + kWarpsPerBlock - 1) / kWarpsPerBlock;
  router_topk_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<float*>(probs),
      static_cast<float*>(vals), static_cast<int32_t*>(idx), T, E, k);
  return static_cast<int>(cudaGetLastError());
}
