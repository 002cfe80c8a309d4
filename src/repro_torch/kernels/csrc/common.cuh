// Shared helpers for the port's CUDA kernels (plain C interface, bound
// with ctypes by repro_torch/kernels/build.py).
//
// Every entry point takes the caller's stream as a void*, launches on it
// without synchronising, and returns cudaGetLastError() so the Python
// wrapper can raise on a launch the runtime refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

extern "C" const char* tpp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

template <typename T>
__device__ __forceinline__ float to_float(T x);

template <>
__device__ __forceinline__ float to_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// ---- 16-byte copies and vectors -------------------------------------------
// cp.async.cg: the copy bypasses L1 and the registers; the thread goes on
// at once.  src_bytes < 16 fills the rest with zeros (0: a zero row, and
// the source is not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most n (0-3) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// One aligned 16-byte load of T elements, converted to float: N = 4
// floats or 8 bf16.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 is the high half of a float
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Four floats to a 16-byte aligned address, shared or global.
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// N floats (1, 2 or a multiple of 4) at an address aligned to
// min(N, 4) floats, shared or global: one access of up to 16 bytes each.
template <int N>
__device__ __forceinline__ void ld_vec(const float* p, float (&x)[N]) {
  if constexpr (N == 1) {
    x[0] = *p;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    static_assert(N % 4 == 0, "ld_vec: N is 1, 2 or a multiple of 4");
#pragma unroll
    for (int i = 0; i < N; i += 4) Vec16<float>::load(p + i, x + i);
  }
}

template <int N>
__device__ __forceinline__ void st_vec(float* p, const float (&x)[N]) {
  if constexpr (N == 1) {
    *p = x[0];
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    static_assert(N % 4 == 0, "st_vec: N is 1, 2 or a multiple of 4");
#pragma unroll
    for (int i = 0; i < N; i += 4) store4(p + i, x + i);
  }
}
