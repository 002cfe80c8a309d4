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
// What bounds them.  Both move bytes and do (almost) no arithmetic.  At
// decode (phi3.5-moe: T = 8, d = 4096, 16 slots; deepseek-v2-lite: T = 2
// or 8, d = 2048, 64 slots) each moves 0.1-0.6 MB, 0.03-0.2 us at
// 3.35 TB/s, so latency sets the time: the launch, and each round trip to
// L2 or HBM that a thread must wait for before it can issue the next.  At
// deepseek's T = 4096 (24,576 assignments, 30,720 slots of 8 KB) they
// stream 235-285 MB and HBM's rate sets the time.  The design:
//
// 1. Indices staged once.  A block covers a tile of rows (tokens for the
//    combine, slots for the dispatch) × 16-byte column vectors.  Its
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
//    d % 4 != 0 or a pointer off 16 bytes takes the element path with
//    the same staging and plan.
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

// N = 4 floats (16 bytes, aligned) or 1 float, cached in L2 only.
template <int N>
__device__ __forceinline__ void load_cg(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldcg(p);
  }
}

template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&x)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    p[0] = x[0];
  }
}

// Block (X, Y): Y slots of the tile, X threads across a row's vectors,
// one vector each.  blockIdx.x: the slot tile, blockIdx.y: the column
// chunk.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    moe_dispatch_kernel(const float* __restrict__ x,
                        const int32_t* __restrict__ src, float* __restrict__ xe,
                        int64_t rows, int d) {
  constexpr int N = kVec ? 4 : 1;
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
  float v[N];
  if (t >= 0) {
    load_cg<N>(x + static_cast<int64_t>(t) * d + static_cast<int64_t>(c) * N, v);
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = 0.f;
  }
  store_n<N>(xe + (r0 + threadIdx.y) * d + static_cast<int64_t>(c) * N, v);
}

// Block (X, Y) as the dispatch's, over Y tokens; each thread takes kVPT
// vectors, X apart, and holds the rows of kG gates at once (kG * kVPT =
// 8 vectors, 32 registers).  Dynamic shared memory holds the tile's
// Y * k slots, then its Y * k gates.
template <bool kVec, int kG, int kVPT>
__global__ void __launch_bounds__(kThreads)
    moe_combine_kernel(const float* __restrict__ ye,
                       const int32_t* __restrict__ slot,
                       const float* __restrict__ vals, float* __restrict__ y,
                       int T, int d, int k, int drop) {
  constexpr int N = kVec ? 4 : 1;
  extern __shared__ int32_t stage[];
  const int n = d / N;
  const int Y = blockDim.y;
  const int t0 = blockIdx.x * Y;
  const int tokens = min(Y, T - t0);
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
    float v[kG][kVPT][N];
#pragma unroll
    for (int j = 0; j < kG; ++j) {  // the group's rows, all in flight
      if (j < g) {
        const int s = ts[j0 + j];
#pragma unroll
        for (int u = 0; u < kVPT; ++u) {
          const int c = c0 + u * blockDim.x;
          if (s != drop && c < n) {
            load_cg<N>(ye + static_cast<int64_t>(s) * d + static_cast<int64_t>(c) * N,
                       v[j][u]);
          } else {
#pragma unroll
            for (int q = 0; q < N; ++q) v[j][u][q] = 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kG; ++j) {  // then the rounding, ascending j
      if (j < g) {
        const float gate = tg[j0 + j];
#pragma unroll
        for (int u = 0; u < kVPT; ++u) {
#pragma unroll
          for (int q = 0; q < N; ++q) {
            const float p = __fmul_rn(v[j][u][q], gate);
            acc[u][q] = j0 + j == 0 ? p : __fadd_rn(acc[u][q], p);
          }
        }
      }
    }
  }
  const int64_t row = static_cast<int64_t>(t0 + tt) * d;
#pragma unroll
  for (int u = 0; u < kVPT; ++u) {
    const int c = c0 + u * blockDim.x;
    if (c < n) store_n<N>(y + row + static_cast<int64_t>(c) * N, acc[u]);
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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

// The combine at plan p: each thread holds 8 row vectors at once, the
// rows of 8 gates (vpt 1) or of 2 gates × 4 vectors (vpt 4).
template <bool kVec, typename... Args>
cudaError_t launch_combine(const Plan& p, size_t smem, cudaStream_t st, Args... args) {
  return p.vpt == 4 ? launch_pdl(moe_combine_kernel<kVec, 2, 4>, p, smem, st, args...)
                    : launch_pdl(moe_combine_kernel<kVec, kGroup, 1>, p, smem, st, args...);
}

}  // namespace

// x (T, d) float32 contiguous; src (E * C) int32 in [-1, T); xe (E * C, d).
// vec: 16-byte vectors (d % 4 == 0, x and xe aligned), else elements; a
// block of bx × by threads.
extern "C" int moe_dispatch(const void* x, const void* src, void* xe,
                            int64_t rows, int d, int vec, int bx, int by,
                            void* stream) {
  Plan p;
  if (rows < 1 || d < 1 || (vec && (d % 4 != 0 || !aligned16(x) || !aligned16(xe))) ||
      !make_plan(rows, vec ? d / 4 : d, 1, bx, by, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto sp = static_cast<const int32_t*>(src);
  auto op = static_cast<float*>(xe);
  return static_cast<int>(vec ? launch_pdl(moe_dispatch_kernel<true>, p, 0, st, xp, sp, op, rows, d)
                              : launch_pdl(moe_dispatch_kernel<false>, p, 0, st, xp, sp, op, rows, d));
}

// ye (drop, d) float32 contiguous, drop = E * C; slot (T * k) int32 in
// [0, drop]; vals (T, k) float32; y (T, d).  vec as the dispatch's; a
// block of bx × by threads, vpt (1 or 4) vectors a thread.  Any k: the
// block's by * k indices must fit kStageBytes.
extern "C" int moe_combine(const void* ye, const void* slot, const void* vals,
                           void* y, int T, int d, int k, int drop, int vec,
                           int vpt, int bx, int by, void* stream) {
  constexpr int kEntry = sizeof(int32_t) + sizeof(float);
  Plan p;
  if (T < 1 || d < 1 || k < 1 || (vpt != 1 && vpt != 4) ||
      (vec && (d % 4 != 0 || !aligned16(ye) || !aligned16(y))) ||
      static_cast<int64_t>(by) * k * kEntry > kStageBytes ||
      !make_plan(T, vec ? d / 4 : d, vpt, bx, by, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(by) * k * kEntry;
  auto st = static_cast<cudaStream_t>(stream);
  auto yp = static_cast<const float*>(ye);
  auto sp = static_cast<const int32_t*>(slot);
  auto vp = static_cast<const float*>(vals);
  auto op = static_cast<float*>(y);
  return static_cast<int>(
      vec ? launch_combine<true>(p, smem, st, yp, sp, vp, op, T, d, k, drop)
          : launch_combine<false>(p, smem, st, yp, sp, vp, op, T, d, k, drop));
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
