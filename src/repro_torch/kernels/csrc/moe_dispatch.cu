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
//   contributing a zero row.  Products and sums are float32, rounded one
//   by one (no fused multiply-add), as the plain version's multiply and
//   adds, and the sum is rounded once to ye's type; each gate is first
//   rounded to ye's type.  In bfloat16 that is
//   bf16(sum_j f32(ye_j) * f32(bf16(g_j))), JAX's jitted lines
//   (repro/models/moe.py:134-135) bit for bit.  With round_each, each
//   partial sum is rounded to ye's type too: the dispatch's backward in
//   bfloat16, where XLA transposes the repeat of repro/models/moe.py:123
//   into a bfloat16 sum over the k gates, rounded after each add.
// moe_combine_bwd: the gradient of moe_combine (JAX differentiates the
//   gather and gated sum of repro/models/moe.py:133-135 in XLA; no TPU
//   kernel).  dye[slot[t * k + j]] = vals[t, j] * dy[t], the gate first
//   rounded to dy's type, then one rounding, as the plain version; each kept slot is filled by exactly one assignment,
//   so no atomics; slots no token fills are 0 (a memset first).
//   dvals[t, j] = <ye[slot[t * k + j]], dy[t]>, float32 products and
//   sums in any element type, 0 for a dropped assignment.
//   One block per token: its threads split d in 16-byte vectors, keep one
//   partial dot a gate in registers, and reduce the k of them at once
//   (warp shuffles, then one pass through shared memory) in a fixed order,
//   so the result is the same from run to run.  The backward of
//   moe_dispatch is moe_combine with unit gates (dx[t] = sum over j of
//   dxe[slot[t * k + j]]) and round_each, so it needs no kernel of its
//   own.
//
// Element types: float32 and bfloat16 (x, ye, dy and the outputs share
// it; gates, dvals and every sum are float32).  A 16-byte vector holds 4
// floats or 8 bfloat16: the dispatch copies it as it is, the combine and
// its backward hold it in registers as it is (4 words either way) and
// widen it to floats only for the arithmetic.
//
// What bounds them.  Both move bytes and do (almost) no arithmetic.  At
// decode (phi3.5-moe: T = 8, d = 4096, 16 slots; deepseek-v2-lite: T = 2
// or 8, d = 2048, 64 slots) each moves 0.1-0.6 MB, 0.03-0.2 us at
// 3.35 TB/s, so latency sets the time: the launch, and each round trip to
// L2 or HBM that a thread must wait for before it can issue the next.  At
// deepseek's T = 4096 (24,576 assignments, 30,720 slots of 8 KB) they
// stream 235-285 MB and HBM's rate sets the time.  The design:
//
// 1. Indices staged once.  A block covers a tile of rows (tokens for the
//    combine, slots for the dispatch) × 16-byte column vectors (4
//    floats or 8 bfloat16: the plans count vectors of either).  Its
//    threads load the tile's slot and gate (or src) entries in one
//    coalesced pass into shared memory; after one __syncthreads() no
//    thread reads an index from global memory again, where each of a
//    row's d/4 threads used to read the same entries itself.
// 2. All k rows in flight, the grid sized to the card.  A combine
//    thread issues the loads of 8 row vectors at once (32 registers)
//    before any arithmetic, then rounds in ascending j, so it waits on
//    two round trips (indices, then rows) instead of one per gate and
//    vector: the rows of 8 gates for one vector, or, where k <= 2 and the
//    work passes two waves of the card's resident threads (2048 an SM),
//    of 2 gates for 4 vectors (on the H100 the faster of the two at
//    phi3.5-moe's T = 2048: tools/moe_turns.py times both).  k > 8 runs
//    in groups of 8 in ascending order.  A dispatch thread moves one
//    vector.  The wrappers plan the grid from the card's SM count
//    (glue_plan in moe_dispatch.py): a block takes the power of two of
//    threads (32-256) nearest below two blocks an SM, so a decode call
//    spreads over tens to hundreds of SMs.
//    d not a multiple of a vector's elements, or a pointer off 16 bytes,
//    takes the element path with the same staging and plan.
// 3. Programmatic dependent launch.  Both launch through
//    cudaLaunchKernelEx with programmatic stream serialization, so the
//    card may schedule their blocks while the previous kernel in the
//    stream drains.  Each block first waits (griddepcontrol.wait) until
//    that kernel has finished and its writes are visible, and only then
//    reads any input: the dispatch's src is written by moe_route just
//    before it, and the dispatch's backward fills its unit gates with
//    torch.ones just before the combine.  On the H100 this saves about
//    1.3 us an edge when the launches are queued back to back, as a CUDA
//    graph runs them, and next to nothing in a host-bound step, whose
//    launches arrive with gaps; staging the combine's indices before the
//    wait saved at most 0.14 us more, so no input is read before it
//    (tools/moe_turns.py times both).  Loads bypass L1 (ld.global.cg): no
//    row is read twice by one SM.
//
// moe_combine_bwd is bound by bytes too: at phi3.5-moe's training shape
// (T = 2048, E * C = 5120 slots, d = 4096) it reads dy and the kept rows
// of ye and writes all of dye; the memset writes every slot once more,
// which a kernel that zeroes only the empty slots (it would need the
// route's src) would save.  It launches with <<<>>>.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // the most threads a block of any kernel here
constexpr int kGroup = 8;      // row vectors a combine thread loads at once
constexpr int kStageBytes = 48 * 1024;  // the combine's staged indices, at most

// Wait until the previous kernel in the stream has completed and its
// writes are visible (a no-op when launched without programmatic
// serialization).
__device__ __forceinline__ void wait_for_previous_kernel() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// One "vector" of the kernels below: 16 bytes (kVec) or one element,
// kept as it is in memory.  Raw<T, kVec>::N elements of type T.
template <typename T, bool kVec>
struct Raw {
  using type = typename std::conditional<kVec, uint4, T>::type;
  static constexpr int N = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
};

template <typename V>
__device__ __forceinline__ V ldcg(const V* p) {
  return __ldcg(p);
}

template <>
__device__ __forceinline__ __nv_bfloat16 ldcg<__nv_bfloat16>(const __nv_bfloat16* p) {
  const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __ushort_as_bfloat16(u);
}

template <typename V>
__device__ __forceinline__ V zero_vec();

template <>
__device__ __forceinline__ uint4 zero_vec<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

template <>
__device__ __forceinline__ float zero_vec<float>() {
  return 0.f;
}

template <>
__device__ __forceinline__ __nv_bfloat16 zero_vec<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// The N elements of a raw vector as floats, and back (rounded to T).
template <typename T, bool kVec>
__device__ __forceinline__ void widen(const typename Raw<T, kVec>::type& v,
                                      float (&x)[Raw<T, kVec>::N]) {
  if constexpr (!kVec) {
    x[0] = to_float<T>(v);
  } else if constexpr (sizeof(T) == 4) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  } else {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 is the high half of a float
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ typename Raw<T, kVec>::type narrow(
    const float (&x)[Raw<T, kVec>::N]) {
  if constexpr (!kVec) {
    return from_float<T>(x[0]);
  } else if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  } else {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = static_cast<unsigned>(__bfloat16_as_ushort(from_float<T>(x[2 * i]))) |
             (static_cast<unsigned>(__bfloat16_as_ushort(from_float<T>(x[2 * i + 1])))
              << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// x rounded to T and widened again: the identity for float.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

// Block (X, Y): Y slots of the tile, X threads across a row's vectors,
// one vector each.  blockIdx.x: the slot tile, blockIdx.y: the column
// chunk.  A copy: the vector moves as it is, in any element type.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    moe_dispatch_kernel(const T* __restrict__ x,
                        const int32_t* __restrict__ src, T* __restrict__ xe,
                        int64_t rows, int d) {
  using V = typename Raw<T, kVec>::type;
  constexpr int N = Raw<T, kVec>::N;
  __shared__ int32_t s_src[kThreads];
  const int n = d / N;  // vectors a row
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * blockDim.y;
  const int here = rows - r0 < blockDim.y ? static_cast<int>(rows - r0) : blockDim.y;
  wait_for_previous_kernel();
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < here) s_src[tid] = __ldcg(src + r0 + tid);
  __syncthreads();
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (static_cast<int>(threadIdx.y) >= here || c >= n) return;
  const int t = s_src[threadIdx.y];
  const V v = t >= 0 ? ldcg(reinterpret_cast<const V*>(x + static_cast<int64_t>(t) * d) + c)
                     : zero_vec<V>();
  reinterpret_cast<V*>(xe + (r0 + threadIdx.y) * d)[c] = v;
}

// Block (X, Y) as the dispatch's, over Y tokens; each thread takes kVPT
// vectors, X apart, and holds the rows of kG gates at once (kG * kVPT =
// 8 vectors, 32 registers in either type).  Dynamic shared memory holds
// the tile's Y * k slots, then its Y * k gates.
template <typename T, bool kVec, int kG, int kVPT>
__global__ void __launch_bounds__(kThreads)
    moe_combine_kernel(const T* __restrict__ ye,
                       const int32_t* __restrict__ slot,
                       const float* __restrict__ vals, T* __restrict__ y,
                       int T_, int d, int k, int drop, int round_each) {
  using V = typename Raw<T, kVec>::type;
  constexpr int N = Raw<T, kVec>::N;
  extern __shared__ int32_t stage[];
  const int n = d / N;
  const int Y = blockDim.y;
  const int t0 = blockIdx.x * Y;
  const int tokens = min(Y, T_ - t0);
  int32_t* s_slot = stage;
  float* s_val = reinterpret_cast<float*>(stage + Y * k);
  wait_for_previous_kernel();
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int64_t base = static_cast<int64_t>(t0) * k;
  for (int i = tid; i < tokens * k; i += blockDim.x * Y) {
    s_slot[i] = __ldcg(slot + base + i);
    s_val[i] = __ldcg(vals + base + i);
  }
  __syncthreads();
  const int tt = threadIdx.y;
  if (tt >= tokens) return;
  const int c0 = blockIdx.y * blockDim.x * kVPT + threadIdx.x;
  const int32_t* ts = s_slot + tt * k;
  const float* tg = s_val + tt * k;
  float acc[kVPT][N];
  for (int j0 = 0; j0 < k; j0 += kG) {
    const int g = min(kG, k - j0);
    V v[kG][kVPT];
#pragma unroll
    for (int j = 0; j < kG; ++j) {  // the group's rows, all in flight
      if (j < g) {
        const int s = ts[j0 + j];
#pragma unroll
        for (int u = 0; u < kVPT; ++u) {
          const int c = c0 + u * blockDim.x;
          v[j][u] = s != drop && c < n
                        ? ldcg(reinterpret_cast<const V*>(ye + static_cast<int64_t>(s) * d) + c)
                        : zero_vec<V>();
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kG; ++j) {  // then the rounding, ascending j
      if (j < g) {
        const float gate = round_to<T>(tg[j0 + j]);
#pragma unroll
        for (int u = 0; u < kVPT; ++u) {
          float x[N];
          widen<T, kVec>(v[j][u], x);
#pragma unroll
          for (int q = 0; q < N; ++q) {
            const float p = __fmul_rn(x[q], gate);
            float a = j0 + j == 0 ? p : __fadd_rn(acc[u][q], p);
            if (round_each) a = round_to<T>(a);
            acc[u][q] = a;
          }
        }
      }
    }
  }
  const int64_t row = static_cast<int64_t>(t0 + tt) * d;
#pragma unroll
  for (int u = 0; u < kVPT; ++u) {
    const int c = c0 + u * blockDim.x;
    if (c < n) reinterpret_cast<V*>(y + row)[c] = narrow<T, kVec>(acc[u]);
  }
}

constexpr int kMaxK = 8;
constexpr int kMaxWarps = kThreads / 32;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    moe_combine_bwd_kernel(const T* __restrict__ dy,
                           const T* __restrict__ ye,
                           const int32_t* __restrict__ slot,
                           const float* __restrict__ vals,
                           T* __restrict__ dye, float* __restrict__ dvals,
                           int d, int k, int drop) {
  using V = typename Raw<T, kVec>::type;
  constexpr int N = Raw<T, kVec>::N;
  __shared__ float partial[kMaxWarps][kMaxK];
  const int t = blockIdx.x;
  const int n = d / N;
  const V* dyt = reinterpret_cast<const V*>(dy + static_cast<int64_t>(t) * d);
  float dot[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) dot[j] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j >= k) break;
    const int s = __ldg(slot + static_cast<int64_t>(t) * k + j);
    if (s == drop) continue;
    const float g = round_to<T>(__ldg(vals + static_cast<int64_t>(t) * k + j));
    const V* row = reinterpret_cast<const V*>(ye + static_cast<int64_t>(s) * d);
    V* out = reinterpret_cast<V*>(dye + static_cast<int64_t>(s) * d);
    float acc = 0.f;
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      float a[N], b[N], o[N];
      widen<T, kVec>(dyt[c], a);
      widen<T, kVec>(row[c], b);
#pragma unroll
      for (int q = 0; q < N; ++q) {
        o[q] = __fmul_rn(g, a[q]);
        acc = fmaf(a[q], b[q], acc);
      }
      out[c] = narrow<T, kVec>(o);
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Elements of a 16-byte vector of dtype (0 = float32, 1 = bfloat16), or
// 0 for a dtype the kernels do not take.
int per_vector(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 8 : 0; }

// A launch shape: the wrappers' plan (glue_plan in moe_dispatch.py);
// each thread of the combine takes vpt vectors.
struct Plan {
  dim3 grid, block;
  int vpt;
};

// The plan of rows × n vectors at a block of bx × by threads, or false
// if the block or the grid is out of range.
bool make_plan(int64_t rows, int n, int vpt, int bx, int by, Plan* p) {
  if (bx < 1 || by < 1 || bx * by > kThreads || vpt < 1) return false;
  const int64_t cols = (n + vpt - 1) / vpt;
  const int64_t gx = (rows + by - 1) / by, gy = (cols + bx - 1) / bx;
  if (gx > 0x7fffffff || gy > 65535) return false;
  p->grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  p->block = dim3(bx, by);
  p->vpt = vpt;
  return true;
}

// cudaLaunchKernelEx with programmatic stream serialization: the kernel
// may start while the previous one in the stream drains, and waits for
// it before its first read.
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), const Plan& p, size_t smem,
                       cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = p.grid;
  cfg.blockDim = p.block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T>
cudaError_t dispatch_typed(const void* x, const void* src, void* xe, int64_t rows,
                           int d, bool vec, const Plan& p, cudaStream_t st) {
  auto xp = static_cast<const T*>(x);
  auto sp = static_cast<const int32_t*>(src);
  auto op = static_cast<T*>(xe);
  return vec ? launch_pdl(moe_dispatch_kernel<T, true>, p, 0, st, xp, sp, op, rows, d)
             : launch_pdl(moe_dispatch_kernel<T, false>, p, 0, st, xp, sp, op, rows, d);
}

// The combine at plan p: each thread holds 8 row vectors at once, the
// rows of 8 gates (vpt 1) or of 2 gates × 4 vectors (vpt 4).
template <typename T, bool kVec, typename... Args>
cudaError_t launch_combine(const Plan& p, size_t smem, cudaStream_t st, Args... args) {
  return p.vpt == 4 ? launch_pdl(moe_combine_kernel<T, kVec, 2, 4>, p, smem, st, args...)
                    : launch_pdl(moe_combine_kernel<T, kVec, kGroup, 1>, p, smem, st, args...);
}

template <typename T>
cudaError_t combine_typed(const void* ye, const void* slot, const void* vals, void* y,
                          int T_, int d, int k, int drop, int round_each, bool vec,
                          const Plan& p, size_t smem, cudaStream_t st) {
  auto yp = static_cast<const T*>(ye);
  auto sp = static_cast<const int32_t*>(slot);
  auto vp = static_cast<const float*>(vals);
  auto op = static_cast<T*>(y);
  return vec ? launch_combine<T, true>(p, smem, st, yp, sp, vp, op, T_, d, k, drop, round_each)
             : launch_combine<T, false>(p, smem, st, yp, sp, vp, op, T_, d, k, drop, round_each);
}

template <typename T>
cudaError_t combine_bwd_typed(const void* dy, const void* ye, const void* slot,
                              const void* vals, void* dye, void* dvals, int T_, int d,
                              int k, int drop, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(dye, 0, static_cast<size_t>(drop) * d * sizeof(T), st);
  if (err != cudaSuccess) return err;
  constexpr int per = 16 / static_cast<int>(sizeof(T));
  const bool vec = d % per == 0 && aligned16(dy) && aligned16(ye) && aligned16(dye);
  const int n = vec ? d / per : d;
  int threads = 32;
  while (threads < n && threads < kThreads) threads *= 2;
  auto dp = static_cast<const T*>(dy);
  auto yp = static_cast<const T*>(ye);
  auto sp = static_cast<const int32_t*>(slot);
  auto vp = static_cast<const float*>(vals);
  auto op = static_cast<T*>(dye);
  auto gp = static_cast<float*>(dvals);
  if (vec) {
    moe_combine_bwd_kernel<T, true><<<T_, threads, 0, st>>>(dp, yp, sp, vp, op, gp, d, k, drop);
  } else {
    moe_combine_bwd_kernel<T, false><<<T_, threads, 0, st>>>(dp, yp, sp, vp, op, gp, d, k, drop);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and xe share it).  x (T, d)
// contiguous; src (E * C) int32 in [-1, T); xe (E * C, d).  vec: 16-byte
// vectors (d a multiple of a vector's elements, x and xe aligned), else
// elements; a block of bx × by threads.
extern "C" int moe_dispatch(int dtype, const void* x, const void* src, void* xe,
                            int64_t rows, int d, int vec, int bx, int by,
                            void* stream) {
  const int per = per_vector(dtype);
  Plan p;
  if (per == 0 || rows < 1 || d < 1 ||
      (vec && (d % per != 0 || !aligned16(x) || !aligned16(xe))) ||
      !make_plan(rows, vec ? d / per : d, 1, bx, by, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 1 ? dispatch_typed<__nv_bfloat16>(x, src, xe, rows, d, vec, p, st)
                 : dispatch_typed<float>(x, src, xe, rows, d, vec, p, st));
}

// dtype as the dispatch's (ye and y share it).  ye (drop, d) contiguous,
// drop = E * C; slot (T * k) int32 in [0, drop]; vals (T, k) float32; y
// (T, d).  vec as the dispatch's; a block of bx × by threads, vpt (1 or
// 4) vectors a thread; round_each rounds each partial sum to the element
// type.  Any k: the block's by * k indices must fit kStageBytes.
extern "C" int moe_combine(int dtype, const void* ye, const void* slot, const void* vals,
                           void* y, int T, int d, int k, int drop, int round_each,
                           int vec, int vpt, int bx, int by, void* stream) {
  constexpr int kEntry = sizeof(int32_t) + sizeof(float);
  const int per = per_vector(dtype);
  Plan p;
  if (per == 0 || T < 1 || d < 1 || k < 1 || (vpt != 1 && vpt != 4) ||
      (vec && (d % per != 0 || !aligned16(ye) || !aligned16(y))) ||
      static_cast<int64_t>(by) * k * kEntry > kStageBytes ||
      !make_plan(T, vec ? d / per : d, vpt, bx, by, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(by) * k * kEntry;
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 1 ? combine_typed<__nv_bfloat16>(ye, slot, vals, y, T, d, k, drop, round_each,
                                                vec, p, smem, st)
                 : combine_typed<float>(ye, slot, vals, y, T, d, k, drop, round_each, vec, p,
                                        smem, st));
}

// dtype as the dispatch's (dy, ye and dye share it).  dy (T, d)
// contiguous; ye (drop, d), drop = E * C; slot (T * k) int32 in [0,
// drop]; vals (T, k) float32; dye (drop, d) and dvals (T, k) float32
// written.
extern "C" int moe_combine_bwd(int dtype, const void* dy, const void* ye, const void* slot,
                               const void* vals, void* dye, void* dvals, int T,
                               int d, int k, int drop, void* stream) {
  if (per_vector(dtype) == 0 || T < 1 || d < 1 || k < 1 || k > kMaxK || drop < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 1 ? combine_bwd_typed<__nv_bfloat16>(dy, ye, slot, vals, dye, dvals, T, d, k,
                                                    drop, st)
                 : combine_bwd_typed<float>(dy, ye, slot, vals, dye, dvals, T, d, k, drop, st));
}
