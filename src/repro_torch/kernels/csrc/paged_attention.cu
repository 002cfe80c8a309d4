// Paged decode attention as a CUDA kernel for Hopper, split over pages.
//
// Replaces the Pallas TPU kernel paged_attention
// (repro/kernels/paged_attention.py:144, pallas_call :195; bodies
// _paged_kernel :72, _paged_kernel_pos :106, _online_update :48).
//
// One new token per sequence attends over that sequence's KV pages,
// selected by a (B, MP) block table of frame ids.  GQA is folded as
// (Hkv, G, D).  Two mask modes, as in the TPU kernel:
//   length mode:   slot ip*P + j is valid iff it is < lengths[b];
//   position mode: page_pos[b, ip] + j <= q_pos[b], and, with a window,
//                  > q_pos[b] - window.  Pad entries carry
//                  PAD_PAGE_POS = 1 << 30 and mask out entirely.
// A fully masked row gives exactly 0, never NaN: l is clamped at 1e-20
// and a page or split with no valid slot leaves m at -inf without
// poisoning the running sums.
//
// Bound: bytes.  One launch reads every referenced (P, D) K and V tile
// once, B * MP * 2 * Hkv * P * D * itemsize: 2 MB for tinyllama-1.1b at
// B = MP = 8 in float32, 0.35 us at 3.35 TB/s, against 4 MFLOP.  At
// that size the chain of dependent loads (block table, then the page)
// and the launch set the time, so the design is about latency: as many
// pages in flight at once as the card holds.
//
// Design (flash-decoding).  The grid is (Hkv * GC, B, NS): each block
// takes one KV head (GC > 1 only for G > 16: then each block takes up
// to 16 of the G query heads), one sequence and one split, a contiguous
// run of pps block-table entries; the wrapper picks NS so the grid
// covers the card (kernels/paged_attention.py, split_plan).  Inside a
// block:
//   * warp 0 reads the split's block-table entries and page starts, 32
//     at a time, and compacts the live ones (a valid slot at least) into
//     a list in shared memory: pages wholly masked (pad entries, pages
//     before the window, past the length) are never loaded, and the
//     page loop waits on no global load but the pages';
//   * a live page's K and V tiles are copied into shared memory with
//     16-byte cp.async (float32) or 16-byte loads converted to float
//     (bfloat16), into a ring of up to four stages when the split has
//     more than one page, so pages k + 1 .. k + 3 load while page k is
//     computed;
//   * one warp per query head: the lanes split D (EPL elements each,
//     the head's q in registers), each lane forms partial dot products
//     for PT keys at once, and a butterfly reduce-scatter (PT - 1 + 5 -
//     log2 PT shuffles) leaves the full score of key lane / (32 / PT)
//     in each lane;
//   * the online softmax runs per warp with shuffles, and acc (EPL
//     floats a lane) stays in registers across pages.
// With NS = 1 each warp writes its head of out.  Otherwise each warp
// writes (m, l) and acc[D] in float32 to the wrapper's scratch; the last
// block of each (sequence, head) to finish, found through an atomic
// counter (one acquire-release add a block, after a barrier) that it
// resets to 0 for the next launch, rescales and sums
// the NS records in split order (so the result does not depend on which
// block finished last; lane s reads split s's (m, l), and the acc rows
// are read several at a time) and writes out.  A second kernel would cost a
// second launch per layer on a decode step that the host already bounds.
// The kernel takes the frame stride, so a per-layer view store[:, li]
// of an (F, L, Hkv, P, D) store is read in place with no copy.
#include <math.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 16;
constexpr int kMaxSmem = 232448;  // the H100's opt-in limit per block
constexpr int kMaxStages = 4;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* bt;
  const int32_t* lengths;
  const int32_t* page_pos;
  const int32_t* q_pos;
  void* out;
  float* part_acc;    // (B, Hkv * GC, NS, NW, D) when NS > 1
  float* part_ml;     // (B, Hkv * GC, NS, NW, 2): m, l
  int32_t* counters;  // (B, Hkv * GC), zero between launches
  int MP, G, P, D, GC, NW, NS, pps, stages, tile_pad, vec;
  int64_t k_fs, v_fs;
  float scale;
  int has_window, window;
};

// EPL floats of a shared-memory row starting at column d0, zeros past D.
template <int EPL>
__device__ __forceinline__ void lds_row(const float* row, int d0, int D,
                                        bool vec, float (&x)[EPL]) {
  if (vec && d0 + EPL <= D) {
    ld_vec<EPL>(row + d0, x);
  } else {
#pragma unroll
    for (int i = 0; i < EPL; ++i) x[i] = d0 + i < D ? row[d0 + i] : 0.f;
  }
}

__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// The same for a global row, read through L2 (written by other blocks).
template <int EPL>
__device__ __forceinline__ void ldcg_row(const float* row, int d0, int D,
                                         bool vec, float (&x)[EPL]) {
  if (vec && d0 + EPL <= D) {
    if constexpr (EPL == 1) {
      x[0] = __ldcg(row + d0);
    } else if constexpr (EPL == 2) {
      const float2 v = __ldcg(reinterpret_cast<const float2*>(row + d0));
      x[0] = v.x;
      x[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < EPL; i += 4) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(row + d0 + i));
        x[i] = v.x;
        x[i + 1] = v.y;
        x[i + 2] = v.z;
        x[i + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < EPL; ++i) x[i] = d0 + i < D ? __ldcg(row + d0 + i) : 0.f;
  }
}

template <int EPL>
__device__ __forceinline__ void stg_row(float* row, int d0, int D, bool vec,
                                        const float (&x)[EPL]) {
  if (vec && d0 + EPL <= D) {
    st_vec<EPL>(row + d0, x);
  } else {
#pragma unroll
    for (int i = 0; i < EPL; ++i)
      if (d0 + i < D) row[d0 + i] = x[i];
  }
}

// One level of the butterfly: v holds N values; lanes with bit O set
// keep the upper half and send the lower, the others the reverse.
template <int N, int O>
__device__ __forceinline__ void reduce_level(float* v, int lane) {
  if constexpr (N > 1) {
    const bool upper = lane & O;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = upper ? v[i] : v[i + N / 2];
      const float keep = upper ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, O);
    }
    reduce_level<N / 2, O / 2>(v, lane);
  }
}

// Sum of v[j] over the warp for PT keys at once: afterwards lane holds
// the full sum for key lane / (32 / PT).
template <int PT>
__device__ __forceinline__ float reduce_scatter(float (&v)[PT], int lane) {
  reduce_level<PT, 16>(v, lane);
  float s = v[0];
#pragma unroll
  for (int o = 16 / PT; o >= 1; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

struct Mask {
  bool pos_mode, has_window;
  int qp, len, window;
  __device__ __forceinline__ bool valid(int pos) const {
    return pos_mode ? pos <= qp && (!has_window || pos > qp - window)
                    : pos < len;
  }
  // some slot of the page starting at `start` is valid: the first is
  // not past the query (or the length), the last not before the window
  __device__ __forceinline__ bool page_live(int start, int P) const {
    return pos_mode ? start <= qp && (!has_window || start + P - 1 > qp - window)
                    : start < len;
  }
};

// Keys c0 .. c0 + PT - 1 of a page (rows of the K and V tiles ks, vs in
// shared memory; the page starts at position `start`) into one warp's
// online softmax (m, l) and acc.  FULL: D = 32 EPL and the chunk lies
// inside the page, so no load has a bounds check and the compiler can
// issue all of a chunk's loads at once.
template <int EPL, int PT, bool FULL>
__device__ __forceinline__ void attend_chunk(
    const float* ks, const float* vs, int c0, int start, int P, int D,
    bool vrow, int lane, const float (&qv)[EPL], const Mask& mk, float& m,
    float& l, float (&acc)[EPL]) {
  const int d0 = lane * EPL;
  float part[PT];
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    float kx[EPL];
    if (FULL) {
      ld_vec<EPL>(ks + (c0 + j) * D + d0, kx);
    } else if (c0 + j < P) {
      lds_row<EPL>(ks + (c0 + j) * D, d0, D, vrow, kx);
    } else {
#pragma unroll
      for (int i = 0; i < EPL; ++i) kx[i] = 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) s = fmaf(qv[i], kx[i], s);
    part[j] = s;
  }
  const int slot = c0 + lane / (32 / PT);
  float s = reduce_scatter<PT>(part, lane);
  s = slot < P && mk.valid(start + slot) ? s : -INFINITY;
  float mc = s;
#pragma unroll
  for (int o = 16; o >= 32 / PT; o >>= 1)
    mc = fmaxf(mc, __shfl_xor_sync(kFull, mc, o));
  const float m_new = fmaxf(m, mc);
  const float m_safe = m_new == -INFINITY ? 0.f : m_new;
  // a masked key (s = -inf) gives exp(-inf) = 0; so does m = -inf
  const float p = expf(s - m_safe);
  float ps = p;
#pragma unroll
  for (int o = 16; o >= 32 / PT; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
  const float corr = expf(m - m_safe);
  l = l * corr + ps;
  m = m_new;
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] *= corr;
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    const float pj = __shfl_sync(kFull, p, j * (32 / PT));
    float vx[EPL];
    if (FULL) {
      ld_vec<EPL>(vs + (c0 + j) * D + d0, vx);
    } else if (c0 + j < P) {
      lds_row<EPL>(vs + (c0 + j) * D, d0, D, vrow, vx);
    } else {
      continue;
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[i] = fmaf(pj, vx[i], acc[i]);
  }
}

// Copy page ip's K and V tiles (P * D elements each, contiguous) into
// one stage of the ring, as float.
template <typename T>
__device__ __forceinline__ void load_page(const Args& a, const T* kt,
                                          const T* vt, float* ks, float* vs) {
  const int n = a.P * a.D;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (a.vec) {
    constexpr int N = Vec16<T>::N;
    if constexpr (sizeof(T) == 4) {
      for (int i = tid * N; i < n; i += nt * N) {
        cp_async16(ks + i, kt + i);
        cp_async16(vs + i, vt + i);
      }
    } else {
      for (int i = tid * N; i < n; i += nt * N) {
        float x[N];
        Vec16<T>::load(kt + i, x);
#pragma unroll
        for (int j = 0; j < N; j += 4) store4(ks + i + j, x + j);
        Vec16<T>::load(vt + i, x);
#pragma unroll
        for (int j = 0; j < N; j += 4) store4(vs + i + j, x + j);
      }
    }
  } else {
    for (int i = tid; i < n; i += nt) {
      ks[i] = to_float(kt[i]);
      vs[i] = to_float(vt[i]);
    }
  }
}

template <typename T, int EPL, int PT>
__global__ void __launch_bounds__(kMaxWarps * 32)
    paged_attention_kernel(const Args a) {
  extern __shared__ __align__(16) float ring[];  // stages x (K, V) tiles
  __shared__ int last_block, n_live_s;
  const int hx = blockIdx.x;  // h * GC + gc
  const int h = hx / a.GC;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = (hx % a.GC) * a.NW + warp;
  const bool has_head = g < a.G;
  const int D = a.D, P = a.P, MP = a.MP;
  const int Hkv = gridDim.x / a.GC;
  const int d0 = lane * EPL;
  const bool vrow = D % EPL == 0;
  const int64_t tile = static_cast<int64_t>(P) * D;

  const T* qr = static_cast<const T*>(a.q) +
                ((static_cast<int64_t>(b) * Hkv + h) * a.G + g) * D;
  float qv[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    qv[i] = has_head && d0 + i < D ? to_float(qr[d0 + i]) * a.scale : 0.f;
  }

  const bool pos_mode = a.page_pos != nullptr;
  const int qp = pos_mode ? a.q_pos[b] : 0;
  const int len = pos_mode ? 0 : a.lengths[b];
  const Mask mk{pos_mode, a.has_window != 0, qp, len, a.window};
  const bool full = D == 32 * EPL && P % PT == 0;
  const int32_t* bt = a.bt + static_cast<int64_t>(b) * MP;
  const int32_t* pp = pos_mode ? a.page_pos + static_cast<int64_t>(b) * MP
                               : nullptr;
  const int ip0 = split * a.pps;
  const int ip1 = min(MP, ip0 + a.pps);

  // The split's live entries (a valid slot at least), compacted into
  // shared memory by warp 0, 32 entries a load: the page loop below then
  // waits on no global load but the pages'.
  int* live_frame = reinterpret_cast<int*>(ring + a.stages * 2 * a.tile_pad);
  int* live_start = live_frame + a.pps;
  if (warp == 0) {
    int count = 0;
    for (int c = ip0; c < ip1; c += 32) {
      const int ip = c + lane;
      bool live = false;
      int start = 0, frame = 0;
      if (ip < ip1) {
        start = pos_mode ? pp[ip] : ip * P;
        frame = bt[ip];
        live = mk.page_live(start, P);
      }
      const unsigned mask = __ballot_sync(kFull, live);
      if (live) {
        const int k = count + __popc(mask & ((1u << lane) - 1));
        live_frame[k] = frame;
        live_start[k] = start;
      }
      count += __popc(mask);
    }
    if (lane == 0) n_live_s = count;
  }
  __syncthreads();
  const int n_live = n_live_s;

  auto issue = [&](int64_t frame, int stage) {
    float* ks = ring + static_cast<int64_t>(stage) * 2 * a.tile_pad;
    load_page<T>(a, static_cast<const T*>(a.k) + frame * a.k_fs + h * tile,
                 static_cast<const T*>(a.v) + frame * a.v_fs + h * tile, ks,
                 ks + a.tile_pad);
  };

  float m = -INFINITY, l = 0.f, acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.f;

  // A ring of S stages: S - 1 pages in flight while one is computed (one
  // in flight, issued after it, for S = 1).  Every step commits one
  // cp.async group, empty past the last live page, so that waiting for
  // all but the newest (ahead - 1) groups waits for the page computed.
  const int S = a.stages;
  const int ahead = S == 1 ? 1 : S - 1;
  int iss = 0;  // next live page to issue
  auto issue_next = [&](int stage) {
    if (iss < n_live) issue(live_frame[iss++], stage);
    cp_async_commit();
  };
  for (int st = 0; st < ahead; ++st) issue_next(st);
  for (int it = 0; it < n_live; ++it) {
    const int stage = it % S;
    cp_async_wait(ahead - 1);
    __syncthreads();  // page it is in; every reader of the stage reused is done
    if (S > 1) issue_next((it + S - 1) % S);
    const float* ks = ring + static_cast<int64_t>(stage) * 2 * a.tile_pad;
    const float* vs = ks + a.tile_pad;
    const int start = live_start[it];
    for (int c0 = 0; c0 < P; c0 += PT) {
      if (full) {
        attend_chunk<EPL, PT, true>(ks, vs, c0, start, P, D, vrow, lane, qv,
                                    mk, m, l, acc);
      } else {
        attend_chunk<EPL, PT, false>(ks, vs, c0, start, P, D, vrow, lane, qv,
                                     mk, m, l, acc);
      }
    }
    if (S == 1) {
      __syncthreads();  // every reader of the one stage is done
      issue_next(0);
    }
  }

  const int64_t row = (static_cast<int64_t>(b) * Hkv + h) * a.G + g;
  if (a.NS == 1) {
    if (has_head) {
      T* o = static_cast<T*>(a.out) + row * D;
      const float lc = fmaxf(l, 1e-20f);
#pragma unroll
      for (int i = 0; i < EPL; ++i)
        if (d0 + i < D) o[d0 + i] = from_float<T>(acc[i] / lc);
    }
    return;
  }

  // one record of (m, l) and acc[D] per warp and split
  const int64_t bh = static_cast<int64_t>(b) * gridDim.x + hx;
  const int64_t rec = (bh * a.NS + split) * a.NW + warp;
  if (has_head) {
    if (lane == 0) {
      a.part_ml[2 * rec] = m;
      a.part_ml[2 * rec + 1] = l;
    }
    stg_row<EPL>(a.part_acc + rec * D, d0, D, vrow, acc);
  }
  // After the barrier one thread counts the split with release
  // semantics (the block's records are visible before the count) and
  // acquire semantics (the last block sees every other split's records).
  __syncthreads();
  if (threadIdx.x == 0) {
    const int done = atomic_add_acq_rel(a.counters + bh, 1);
    last_block = done == a.NS - 1;
    if (last_block) a.counters[bh] = 0;  // every split has counted
  }
  __syncthreads();
  if (!last_block || !has_head) return;

  // combine the NS records of head g: lane s takes split s's (m, l), and
  // the acc rows are summed in split order, several loads in flight
  const int64_t rec0 = bh * a.NS * a.NW + warp;  // split 0; split s at + s * NW
  float M = -INFINITY;
  for (int s = lane; s < a.NS; s += 32)
    M = fmaxf(M, __ldcg(a.part_ml + 2 * (rec0 + s * a.NW)));
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) M = fmaxf(M, __shfl_xor_sync(kFull, M, o));
  float L = 0.f, o[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) o[i] = 0.f;
  for (int s0 = 0; s0 < a.NS; s0 += 32) {
    float w = 0.f;
    if (s0 + lane < a.NS) {
      const float* ml = a.part_ml + 2 * (rec0 + (s0 + lane) * a.NW);
      const float ms = __ldcg(ml);
      w = ms == -INFINITY ? 0.f : expf(ms - M);
      L = fmaf(w, __ldcg(ml + 1), L);
    }
    const int n = min(32, a.NS - s0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(kFull, w, j);
      float x[EPL];
      ldcg_row<EPL>(a.part_acc + (rec0 + (s0 + j) * a.NW) * D, d0, D, vrow, x);
#pragma unroll
      for (int i = 0; i < EPL; ++i) o[i] = fmaf(wj, x[i], o[i]);
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) L += __shfl_xor_sync(kFull, L, off);
  T* out = static_cast<T*>(a.out) + row * D;
  const float lc = fmaxf(L, 1e-20f);
#pragma unroll
  for (int i = 0; i < EPL; ++i)
    if (d0 + i < D) out[d0 + i] = from_float<T>(o[i] / lc);
}

template <typename T, int EPL, int PT>
int launch_pt(const Args& a, int B, int Hkv, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T, EPL, PT>;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(a.stages) * a.tile_pad +
                       2 * static_cast<size_t>(a.pps));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(Hkv * a.GC, B, a.NS);
  kernel<<<grid, a.NW * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int EPL>
int launch_epl(const Args& a, int B, int Hkv, cudaStream_t stream) {
  if (a.P <= 8) return launch_pt<T, EPL, 8>(a, B, Hkv, stream);
  if (a.P <= 16) return launch_pt<T, EPL, 16>(a, B, Hkv, stream);
  return launch_pt<T, EPL, 32>(a, B, Hkv, stream);
}

template <typename T>
int launch(Args a, int B, int Hkv, cudaStream_t stream) {
  if (B == 0) return 0;
  if (a.D < 1 || a.D > 256 || a.P < 1 || a.NW < 1 || a.NW > kMaxWarps ||
      a.GC * a.NW < a.G || a.NS < 1 || a.pps < 1 ||
      static_cast<int64_t>(a.NS) * a.pps < a.MP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 16-byte copies need 16-byte aligned tiles, in every frame
  const int64_t tile_bytes = static_cast<int64_t>(a.P) * a.D * sizeof(T);
  a.vec = reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.v) % 16 == 0 &&
          (a.k_fs * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
          (a.v_fs * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
          tile_bytes % 16 == 0;
  a.tile_pad = (a.P * a.D + 3) / 4 * 4;
  const size_t stage_bytes = sizeof(float) * 2 * static_cast<size_t>(a.tile_pad);
  const size_t list_bytes = sizeof(int) * 2 * static_cast<size_t>(a.pps);
  if (stage_bytes + list_bytes > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int fit = static_cast<int>((kMaxSmem - list_bytes) / stage_bytes);
  a.stages = a.pps < kMaxStages ? a.pps : kMaxStages;
  if (a.stages > fit) a.stages = fit;
  const int epl = a.D <= 32 ? 1 : a.D <= 64 ? 2 : a.D <= 128 ? 4 : 8;
  switch (epl) {
    case 1: return launch_epl<T, 1>(a, B, Hkv, stream);
    case 2: return launch_epl<T, 2>(a, B, Hkv, stream);
    case 4: return launch_epl<T, 4>(a, B, Hkv, stream);
    default: return launch_epl<T, 8>(a, B, Hkv, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, K, V and out share it).
// q, out: (B, Hkv * G, D) contiguous.  k, v: frame f starts at
// f * frame_stride elements and holds a contiguous (Hkv, P, D) block.
// bt, page_pos: (B, MP) int32; lengths, q_pos: (B,) int32.  page_pos
// null selects length mode.  The grid is (Hkv * GC, B, NS) blocks of
// NW warps, split s taking entries [s * pps, (s + 1) * pps).  With
// NS > 1, part holds B * Hkv * GC * NS * NW * (D + 2) floats and
// counters B * Hkv * GC int32 zeros, which the kernel leaves at zero.
extern "C" int paged_attention(int dtype, const void* q, const void* k,
                               const void* v, const void* bt,
                               const void* lengths, const void* page_pos,
                               const void* q_pos, void* out, void* part,
                               void* counters, int B, int MP, int Hkv, int G,
                               int P, int D, int GC, int NW, int NS, int pps,
                               int64_t k_fs, int64_t v_fs, float scale,
                               int has_window, int window, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bt = static_cast<const int32_t*>(bt);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.page_pos = static_cast<const int32_t*>(page_pos);
  a.q_pos = static_cast<const int32_t*>(q_pos);
  a.out = out;
  a.part_acc = static_cast<float*>(part);
  a.part_ml = a.part_acc + static_cast<int64_t>(B) * Hkv * GC * NS * NW * D;
  a.counters = static_cast<int32_t*>(counters);
  a.MP = MP;
  a.G = G;
  a.P = P;
  a.D = D;
  a.GC = GC;
  a.NW = NW;
  a.NS = NS;
  a.pps = pps;
  a.k_fs = k_fs;
  a.v_fs = v_fs;
  a.scale = scale;
  a.has_window = has_window;
  a.window = window;
  if (NS > 1 && (part == nullptr || counters == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, B, Hkv, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, B, Hkv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
