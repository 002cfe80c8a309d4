// MoE capacity dispatch and combine on Hopper.
//
// No TPU kernel: the JAX package runs these steps in XLA
// (repro/models/moe.py:121-137), around the expert einsums.
//
// moe_dispatch: xe[s] = x[src[s]] for each of the E * C expert slots, a
//   zero row where src[s] is -1.  Each kept slot receives exactly one
//   token row, so this equals the JAX package's scatter-add of the rows
//   into zeros (xe.at[slot].add) value for value.
// moe_combine: y[t] = sum over j in ascending order of
//   vals[t, j] * ye[slot[t * k + j]], a dropped assignment (slot E * C)
//   contributing a zero row.  Products and sums are rounded one by one
//   (no fused multiply-add), as the plain version's multiply and adds.
//
// Bound: bytes.  At phi3.5-moe's decode (16 slots, T = 8, d = 4096) each
// kernel moves about 0.26 MB, 0.08 us at 3.35 TB/s: launch latency sets
// the time.  Design: a flat grid over 16-byte vectors of the output, four
// a thread in flight, so even a few rows spread over many SMs; each
// thread reads the index of its row, which the row's other threads read
// from the same cache line.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    moe_dispatch_kernel(const float* __restrict__ x,
                        const int32_t* __restrict__ src, float* __restrict__ xe,
                        int64_t rows, int d) {
  const int n = kVec ? d / 4 : d;  // vectors a row
  const int64_t total = rows * n;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll) + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = first + u * kThreads;
    if (i >= total) break;
    const int64_t s = i / n;
    const int c = static_cast<int>(i - s * n);
    const int t = __ldg(src + s);
    if (kVec) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t >= 0) v = __ldg(reinterpret_cast<const float4*>(x + static_cast<int64_t>(t) * d) + c);
      reinterpret_cast<float4*>(xe + s * d)[c] = v;
    } else {
      xe[s * d + c] = t >= 0 ? __ldg(x + static_cast<int64_t>(t) * d + c) : 0.f;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    moe_combine_kernel(const float* __restrict__ ye,
                       const int32_t* __restrict__ slot,
                       const float* __restrict__ vals, float* __restrict__ y,
                       int T, int d, int k, int drop) {
  const int n = kVec ? d / 4 : d;
  const int64_t total = static_cast<int64_t>(T) * n;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll) + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = first + u * kThreads;
    if (i >= total) break;
    const int t = static_cast<int>(i / n);
    const int c = static_cast<int>(i - static_cast<int64_t>(t) * n);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < k; ++j) {
      const int s = __ldg(slot + static_cast<int64_t>(t) * k + j);
      const float g = __ldg(vals + static_cast<int64_t>(t) * k + j);
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (s != drop) {
        if (kVec) {
          const float4 r = __ldg(reinterpret_cast<const float4*>(ye + static_cast<int64_t>(s) * d) + c);
          v[0] = r.x;
          v[1] = r.y;
          v[2] = r.z;
          v[3] = r.w;
        } else {
          v[0] = __ldg(ye + static_cast<int64_t>(s) * d + c);
        }
      }
#pragma unroll
      for (int q = 0; q < (kVec ? 4 : 1); ++q) {
        const float p = __fmul_rn(v[q], g);
        acc[q] = j == 0 ? p : __fadd_rn(acc[q], p);
      }
    }
    if (kVec) {
      reinterpret_cast<float4*>(y + static_cast<int64_t>(t) * d)[c] =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      y[static_cast<int64_t>(t) * d + c] = acc[0];
    }
  }
}

int blocks_for(int64_t total) {
  return static_cast<int>((total + kThreads * kUnroll - 1) / (kThreads * kUnroll));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (T, d) float32 contiguous; src (E * C) int32 in [-1, T); xe (E * C, d).
extern "C" int moe_dispatch(const void* x, const void* src, void* xe,
                            int64_t rows, int d, void* stream) {
  if (rows < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(xe);
  const int64_t total = rows * (vec ? d / 4 : d);
  auto st = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto sp = static_cast<const int32_t*>(src);
  auto op = static_cast<float*>(xe);
  if (vec) {
    moe_dispatch_kernel<true><<<blocks_for(total), kThreads, 0, st>>>(xp, sp, op, rows, d);
  } else {
    moe_dispatch_kernel<false><<<blocks_for(total), kThreads, 0, st>>>(xp, sp, op, rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// ye (drop, d) float32 contiguous, drop = E * C; slot (T * k) int32 in
// [0, drop]; vals (T, k) float32; y (T, d).
extern "C" int moe_combine(const void* ye, const void* slot, const void* vals,
                           void* y, int T, int d, int k, int drop,
                           void* stream) {
  if (T < 1 || d < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % 4 == 0 && aligned16(ye) && aligned16(y);
  const int64_t total = static_cast<int64_t>(T) * (vec ? d / 4 : d);
  auto st = static_cast<cudaStream_t>(stream);
  auto yp = static_cast<const float*>(ye);
  auto sp = static_cast<const int32_t*>(slot);
  auto vp = static_cast<const float*>(vals);
  auto op = static_cast<float*>(y);
  if (vec) {
    moe_combine_kernel<true><<<blocks_for(total), kThreads, 0, st>>>(yp, sp, vp, op, T, d, k, drop);
  } else {
    moe_combine_kernel<false><<<blocks_for(total), kThreads, 0, st>>>(yp, sp, vp, op, T, d, k, drop);
  }
  return static_cast<int>(cudaGetLastError());
}
