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
// moe_combine_bwd: the gradient of moe_combine (JAX differentiates the
//   gather and gated sum of repro/models/moe.py:133-135 in XLA; no TPU
//   kernel).  dye[slot[t * k + j]] = vals[t, j] * dy[t], one rounding, as
//   the plain version; each kept slot is filled by exactly one assignment,
//   so no atomics; slots no token fills are 0 (a memset first).
//   dvals[t, j] = <ye[slot[t * k + j]], dy[t]>, 0 for a dropped assignment.
//   One block per token: its threads split d in 16-byte vectors, keep one
//   partial dot a gate in registers, and reduce the k of them at once
//   (warp shuffles, then one pass through shared memory) in a fixed order,
//   so the result is the same from run to run.  The backward of
//   moe_dispatch is moe_combine with unit gates (dx[t] = sum over j of
//   dxe[slot[t * k + j]]), so it needs no kernel of its own.
//
// Bound: bytes.  At phi3.5-moe's decode (16 slots, T = 8, d = 4096) each
// kernel moves about 0.26 MB, 0.08 us at 3.35 TB/s: launch latency sets
// the time.  Design: a flat grid over 16-byte vectors of the output, four
// a thread in flight, so even a few rows spread over many SMs; each
// thread reads the index of its row, which the row's other threads read
// from the same cache line.  moe_combine_bwd is bound by bytes too: at
// phi3.5-moe's training shape (T = 2048, E * C = 5120 slots, d = 4096) it
// reads dy and the kept rows of ye and writes all of dye; the memset
// writes every slot once more, which a kernel that zeroes only the empty
// slots (it would need the route's src) would save.
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

constexpr int kMaxK = 8;
constexpr int kMaxWarps = kThreads / 32;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    moe_combine_bwd_kernel(const float* __restrict__ dy,
                           const float* __restrict__ ye,
                           const int32_t* __restrict__ slot,
                           const float* __restrict__ vals,
                           float* __restrict__ dye, float* __restrict__ dvals,
                           int d, int k, int drop) {
  __shared__ float partial[kMaxWarps][kMaxK];
  const int t = blockIdx.x;
  const int n = kVec ? d / 4 : d;
  const float* dyt = dy + static_cast<int64_t>(t) * d;
  float dot[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) dot[j] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j >= k) break;
    const int s = __ldg(slot + static_cast<int64_t>(t) * k + j);
    if (s == drop) continue;
    const float g = __ldg(vals + static_cast<int64_t>(t) * k + j);
    const float* row = ye + static_cast<int64_t>(s) * d;
    float* out = dye + static_cast<int64_t>(s) * d;
    float acc = 0.f;
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      if (kVec) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(dyt) + c);
        const float4 b = __ldg(reinterpret_cast<const float4*>(row) + c);
        reinterpret_cast<float4*>(out)[c] = make_float4(
            __fmul_rn(g, a.x), __fmul_rn(g, a.y), __fmul_rn(g, a.z), __fmul_rn(g, a.w));
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
      } else {
        const float a = __ldg(dyt + c);
        out[c] = __fmul_rn(g, a);
        acc = fmaf(a, __ldg(row + c), acc);
      }
    }
    dot[j] = acc;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    float v = dot[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) partial[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < k) {
    float v = 0.f;
    const int warps = blockDim.x >> 5;
    for (int w = 0; w < warps; ++w) v += partial[w][threadIdx.x];
    dvals[static_cast<int64_t>(t) * k + threadIdx.x] = v;
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

// dy (T, d) float32 contiguous; ye (drop, d), drop = E * C; slot (T * k)
// int32 in [0, drop]; vals (T, k); dye (drop, d) and dvals (T, k) written.
extern "C" int moe_combine_bwd(const void* dy, const void* ye, const void* slot,
                               const void* vals, void* dye, void* dvals, int T,
                               int d, int k, int drop, void* stream) {
  if (T < 1 || d < 1 || k < 1 || k > kMaxK || drop < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dye, 0, static_cast<size_t>(drop) * d * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = d % 4 == 0 && aligned16(dy) && aligned16(ye) && aligned16(dye);
  const int n = vec ? d / 4 : d;
  int threads = 32;
  while (threads < n && threads < kThreads) threads *= 2;
  auto dp = static_cast<const float*>(dy);
  auto yp = static_cast<const float*>(ye);
  auto sp = static_cast<const int32_t*>(slot);
  auto vp = static_cast<const float*>(vals);
  auto op = static_cast<float*>(dye);
  auto gp = static_cast<float*>(dvals);
  if (vec) {
    moe_combine_bwd_kernel<true><<<T, threads, 0, st>>>(dp, yp, sp, vp, op, gp, d, k, drop);
  } else {
    moe_combine_bwd_kernel<false><<<T, threads, 0, st>>>(dp, yp, sp, vp, op, gp, d, k, drop);
  }
  return static_cast<int>(cudaGetLastError());
}
