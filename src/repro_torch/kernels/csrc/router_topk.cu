// MoE routing on Hopper: the router's softmax and top-k (router_topk), and
// the whole routing stage of an MoE layer in one launch (moe_route).
//
// Replaces the Pallas TPU kernel router_topk
// (repro/kernels/router_topk.py:47, pallas_call :60; body _router_kernel
// :22).  Per token row of logits (T, E) float32:
//   probs = softmax(logits)                                  (T, E) f32
//   k rounds of masked argmax over probs, the lowest index winning a
//   tie (as lax.top_k and the TPU kernel's jnp.argmax), each winner
//   masked to -1 before the next round                       idx (T, k)
//   vals = the k winners / max(sum of them, 1e-9)            vals (T, k)
// route_row below computes one such row with one warp: lane l holds the
// logits l, l + 32, ... in registers (E <= 32 * kMaxPerLane), warp
// shuffles give the row max, the sum of exponentials and, in each
// round, an argmax that breaks ties to the lower index.
//
// router_topk: that function alone, one warp a row.  Bound: bytes,
// 8 * T * E + 8 * T * k; at the serving shapes launch latency sets it.
//
// moe_route: the function of repro/models/moe.py:90-119 (which JAX runs
// in XLA around the router) in one launch.  From x (T, d) and the router
// weight w (d, E) it writes logits = x @ w, probs, vals, idx, and the
// capacity dispatch: assignments a = t * k + j in flat order, first
// come first served per expert, pos = the number of earlier assignments
// to the same expert; slot[a] = e * C + pos if pos < C else E * C;
// src[e * C + pos] = t (-1 where no assignment landed); counts[e];
// aux = E * sum_e mean_t(probs[:, e]) * counts[e] / (T * k).
// Bound: at decode (T = 8, d = 4096, E = 16) the 262 KB of w and
// 131 KB of x, 0.12 us at 3.35 TB/s, so latency sets the time: the
// launch, DRAM, one counter, and the tail below, whose instructions a
// decode step finds evicted from L2 (the expert products stream GBs
// between two MoE layers); at T = 4096, d = 2048, E = 64 the 1.07
// GFLOP of float32 FMAs, 16 us at 67 TFLOP/s.  With several token tiles
// (prefill, training, T = 47 and up) what the kernel adds to the
// product is serial work after it: each tile's top-k and ranks, then the
// dispatch of all T * k assignments, which one block used to place alone
// (196,608 of them at T = 32,768); it is now spread over the grid.
//
// Design: one grid of (NC chunks of d) x (NT tiles of TM tokens) blocks
// of 256 threads, planned on the host (route_plan in router_topk.py):
// about two blocks an SM, at most 16 chunks a tile.
//   Phase 1, every block: the partial product of its token tile over its
//   chunk of d, in k-tiles of BK columns (up to 256 at a small token
//   tile, so that a decode batch needs 16 chunks of one k-tile each)
//   staged through shared memory (x transposed, w as it lies, 16-byte
//   loads, the next tile's loads in registers during the current tile's
//   FMAs).  Each thread holds a 4x4 register tile; when the tile has
//   fewer outputs than the block has threads, KS slices of threads split
//   each k-tile and are summed in slice order.  The partial goes to
//   scratch.
//   Phase 2, the last block of each token tile (an acq_rel counter that
//   the last arriver resets, as in paged_attention.cu): sums the NC
//   partials in chunk order, eight loads in flight (no float atomics, so
//   a rerun gives the same bits), writes logits, runs route_row on each
//   row, and ranks the tile's assignments per expert: __match_any_sync
//   groups the lanes of a 32-assignment chunk by expert and __popc of
//   the lower peers gives the rank (one warp when the tile holds at most
//   32 assignments; else per-warp counts in shared memory and a scan
//   over warps give the bases).
//   One tile (decode): the same block writes counts, aux and the slots,
//   in one launch.
//   Several tiles: each tile publishes its ranks (into slot), counts and
//   column sums, by expert ((E, NT) in the scratch), and the grid's last
//   block (a second counter) only scans: a warp an expert, whose column
//   over the tiles is four warp-wide prefix sums a round of 128 tiles,
//   with a carry; the tiles' bases go over their counts, the totals to
//   counts, and the column sums, summed in a fixed order, to aux.  It
//   stages the counts and sums in the shared memory phase 1 is done with
//   where they fit there (T = 2048 at E = 64), else scans them where they
//   lie: no extra shared memory for any block, no cap on T but the 2^24
//   assignments.  A second launch of NT blocks (moe_route_kernel_place)
//   then places each tile's assignments at its expert's base + rank,
//   chained by programmatic dependent launch: every block of the first
//   lets it start (griddepcontrol.launch_dependents), and its blocks wait
//   (griddepcontrol.wait) for the first grid's end before they read.
//   The tail is one block's serial work, so its code is kept short: a
//   rolled top-k loop, route_row instantiated per logits a lane, the
//   paths of several tiles and of more than 32 assignments out of line.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPerLane = 8;  // E <= 256
constexpr int kMaxK = 8;
constexpr unsigned kFull = 0xffffffffu;

// One token row, called by a whole warp: softmax over the E logits at x,
// top-k, renormalise.  Lane l holds logits l, l + 32, ... (PL of them,
// E <= 32 * PL).  probs go to pr and, if ps is not null, to ps (which
// may be x itself: each lane reads its own entries before it writes
// them); the k winners to vals/idx and, if idx_s is not null, their
// experts to idx_s.  The rounds stay a loop: the code is fetched cold
// on every launch, so its size is time.
template <int PL>
__device__ __forceinline__ void route_row(const float* x, float* pr, float* ps,
                                          float* vals, int32_t* idx,
                                          int32_t* idx_s, int E, int k,
                                          int lane) {
  float v[PL];
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < PL; ++c) {
    const int e = lane + 32 * c;
    v[c] = e < E ? x[e] : -INFINITY;
    m = fmaxf(m, v[c]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < PL; ++c) {
    v[c] = lane + 32 * c < E ? expf(v[c] - m) : 0.f;
    sum += v[c];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
#pragma unroll
  for (int c = 0; c < PL; ++c) {
    const int e = lane + 32 * c;
    if (e < E) {
      v[c] = v[c] / sum;
      pr[e] = v[c];
      if (ps != nullptr) ps[e] = v[c];
    } else {
      v[c] = -INFINITY;  // never selected: masked entries hold -1
    }
  }

  // lane r keeps round r's winner
  float mine_v = 0.f, total = 0.f;
  int mine_i = 0;
#pragma unroll 1
  for (int r = 0; r < k; ++r) {
    // this lane's best: the first maximum in index order
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int c = 0; c < PL; ++c) {
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
    if (lane == r) {
      mine_v = bv;
      mine_i = bi;
    }
    total += bv;
#pragma unroll
    for (int c = 0; c < PL; ++c) {
      if (lane + 32 * c == bi) v[c] = -1.f;
    }
  }
  if (lane < k) {
    vals[lane] = mine_v / fmaxf(total, 1e-9f);
    idx[lane] = mine_i;
    if (idx_s != nullptr) idx_s[lane] = mine_i;
  }
}

// route_row with PL for E: the one instantiation a launch runs.
__device__ __forceinline__ void route_row_any(const float* x, float* pr, float* ps,
                                              float* vals, int32_t* idx,
                                              int32_t* idx_s, int E, int k,
                                              int lane) {
  if (E <= 32) {
    route_row<1>(x, pr, ps, vals, idx, idx_s, E, k, lane);
  } else if (E <= 64) {
    route_row<2>(x, pr, ps, vals, idx, idx_s, E, k, lane);
  } else if (E <= 128) {
    route_row<4>(x, pr, ps, vals, idx, idx_s, E, k, lane);
  } else {
    route_row<8>(x, pr, ps, vals, idx, idx_s, E, k, lane);
  }
}

__global__ void router_topk_kernel(const float* __restrict__ logits,
                                   float* __restrict__ probs,
                                   float* __restrict__ vals,
                                   int32_t* __restrict__ idx, int T, int E,
                                   int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= T) return;  // whole warps leave together
  const int64_t r = row;
  route_row_any(logits + r * E, probs + r * E, nullptr, vals + r * k, idx + r * k,
                nullptr, E, k, lane);
}

// ---- moe_route ------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBKMin = 32;  // k-tiles are a power of 2 from 32 deep
constexpr int kR = 4;    // a thread's register tile: kR tokens x kR experts
constexpr int kMaxX4 = 2;  // float4 loads of x a thread stages: TM * BK <= 2048
constexpr int kMaxW4 = 8;  // of w: BK * Ep <= 8192
constexpr int kMaxDevices = 64;

struct RouteArgs {
  const float* x;    // (T, d)
  const float* w;    // (d, E)
  float* logits;     // (T, E)
  float* probs;      // (T, E)
  float* vals;       // (T, k)
  int32_t* idx;      // (T, k)
  int32_t* slot;     // (T * k): the rank within the tile, then the slot
  int32_t* src;      // (E * C)
  int32_t* counts;   // (E)
  float* aux;        // ()
  float* part;       // (NT, NC, TM, Ep) partial products
  float* colsum;     // (E, NT) the tiles' column sums of probs
  int32_t* tcnt;     // (E, NT) the tiles' counts, then their bases
  int* counters;     // (NT + 1), zero between launches
  int T, d, E, k, C;
  int TM, NT, NC, DC;  // token tile, tiles, chunks of d, chunk depth
  int BK;              // k-tile depth
  int NE, NM, KS;      // threads across experts, tokens, k slices
  int vec_x, vec_w;    // 16-byte loads of x rows, w rows
};

__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// One thread's share of a k-tile at kt: x rows t0.. (zero past T and
// past k_end) and w rows kt.. (zero past E and k_end), in registers.
// BK / 4 = 1 << lbk4 vectors a row of x, NE = 1 << lne a row of w.
__device__ __forceinline__ void load_tile(const RouteArgs& a, int t0, int rows,
                                          int kt, int k_end, int lbk4, int lne,
                                          float4 (&rx)[kMaxX4], float4 (&rw)[kMaxW4]) {
  const int nx = a.TM << lbk4, nw = a.BK << lne;
#pragma unroll
  for (int i = 0; i < kMaxX4; ++i) {
    const int f = threadIdx.x + i * kThreads;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (f < nx) {
      const int t = f >> lbk4, c = kt + 4 * (f & ((1 << lbk4) - 1));
      if (t < rows && c < k_end) {
        const float* p = a.x + static_cast<int64_t>(t0 + t) * a.d + c;
        if (a.vec_x) {
          v = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          v.x = __ldg(p);
          if (c + 1 < k_end) v.y = __ldg(p + 1);
          if (c + 2 < k_end) v.z = __ldg(p + 2);
          if (c + 3 < k_end) v.w = __ldg(p + 3);
        }
      }
    }
    rx[i] = v;
  }
#pragma unroll
  for (int i = 0; i < kMaxW4; ++i) {
    const int f = threadIdx.x + i * kThreads;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (f < nw) {
      const int r = kt + (f >> lne), e = 4 * (f & (a.NE - 1));
      if (r < k_end && e < a.E) {
        const float* p = a.w + static_cast<int64_t>(r) * a.E + e;
        if (a.vec_w) {
          v = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          v.x = __ldg(p);
          if (e + 1 < a.E) v.y = __ldg(p + 1);
          if (e + 2 < a.E) v.z = __ldg(p + 2);
          if (e + 3 < a.E) v.w = __ldg(p + 3);
        }
      }
    }
    rw[i] = v;
  }
}

// The registers of load_tile into shared memory: xs[kk][t] (rows of
// TM + 4 floats, so the transposing stores spread over the banks) and
// ws[kk][e] (rows of Ep floats).
__device__ __forceinline__ void store_tile(const RouteArgs& a, float* xs, float* ws,
                                           int lbk4, int lne,
                                           const float4 (&rx)[kMaxX4],
                                           const float4 (&rw)[kMaxW4]) {
  const int XS = a.TM + 4, nx = a.TM << lbk4, nw = a.BK << lne;
#pragma unroll
  for (int i = 0; i < kMaxX4; ++i) {
    const int f = threadIdx.x + i * kThreads;
    if (f < nx) {
      const int t = f >> lbk4, c = 4 * (f & ((1 << lbk4) - 1));
      xs[(c + 0) * XS + t] = rx[i].x;
      xs[(c + 1) * XS + t] = rx[i].y;
      xs[(c + 2) * XS + t] = rx[i].z;
      xs[(c + 3) * XS + t] = rx[i].w;
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxW4; ++i) {
    const int f = threadIdx.x + i * kThreads;
    if (f < nw) reinterpret_cast<float4*>(ws)[f] = rw[i];
  }
}

// Ranks of a warp's share [lo, hi) of the tile's n assignments (experts
// in ids), by expert, in flat order.  count: wc[e] += the assignments
// to e; otherwise pos[a] = wc[e] + the rank, and wc[e] advances.
template <bool kCount>
__device__ __forceinline__ void rank_assignments(const int32_t* ids, int lo,
                                                 int hi, int* wc,
                                                 int32_t* pos, int lane) {
  const unsigned lower = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32) {
    const int a = base + lane;
    const unsigned live = __ballot_sync(kFull, a < hi);
    if (a < hi) {
      const int e = ids[a];
      const unsigned peers = __match_any_sync(live, e);
      const bool leader = lane == 31 - __clz(peers);
      if (kCount) {
        if (leader) wc[e] += __popc(peers);
      } else {
        const int at = wc[e];
        pos[a] = at + __popc(peers & lower);
        __syncwarp(live);  // every peer has read wc[e]
        if (leader) wc[e] = at + __popc(peers);
      }
    }
    __syncwarp();
  }
}

// Shared memory of moe_route in 4-byte words, where each region starts:
// the same on the host (the launch's size) and in the kernel.  Phase 1
// stages k-tiles (and sums the slices) below lg; phases 2 and 3 use the
// regions from lg up, and the grid's last block stages the tiles' counts
// and sums below lg where they fit there.
struct Smem {
  int lg, grp, ids, rk, wc, cs, tc, term, total;
};

__host__ __device__ inline Smem smem_layout(int TM, int Ep, int KS, int BK, int k,
                                            int E) {
  const int O = TM * Ep, stage = BK * (TM + 4 + Ep);
  Smem s;
  s.lg = stage > KS * O ? stage : KS * O;  // (TM, Ep) logits, then probs
  s.grp = s.lg + O;                        // (kThreads) group sums
  s.ids = s.grp + kThreads;                // (TM * k) experts
  s.rk = s.ids + TM * k;                   // (TM * k) ranks within the tile
  s.wc = s.rk + TM * k;                    // (kWarps, E) per-warp counts
  s.cs = s.wc + kWarps * E;                // (E) column sums of probs
  s.tc = s.cs + E;                         // (E) the tile's counts
  s.term = s.tc + E;                       // (E) aux terms
  s.total = s.term + E;
  return s;
}

// The sum over chunks c = c0, c0 + step, ... < NC, in that order, of
// output o of the partials, eight loads in flight.
__device__ __forceinline__ float sum_chunks(const float* parts, int O, int o,
                                           int c0, int step, int NC) {
  float s = 0.f;
  for (int c = c0; c < NC; c += 8 * step) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = c + j * step < NC ? parts[static_cast<int64_t>(c + j * step) * O + o] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c + j * step < NC) s += v[j];
  }
  return s;
}

// Assignment i to expert e at position pos: its slot, and the slot's token.
__device__ __forceinline__ void place(const RouteArgs& a, int i, int e, int pos,
                                      int drop) {
  if (pos < a.C) {
    a.slot[i] = e * a.C + pos;
    a.src[e * a.C + pos] = i / a.k;
  } else {
    a.slot[i] = drop;
  }
}

// Paths a decode batch does not take live out of line, so that the code
// it runs lies in one stretch: the tail runs once a launch, in one
// block, and every line of it is fetched cold.

// Ranks of more than 32 assignments: warp w takes the w-th run of
// 32-aligned chunks; per-warp counts, a scan over warps, ranks.
__device__ __noinline__ void rank_tile(const int32_t* ids, int32_t* rk, int* wc,
                                       int* tc, int n, int E) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kWarps * E; i += kThreads) wc[i] = 0;
  __syncthreads();
  const int seg = ((n + kWarps * 32 - 1) / (kWarps * 32)) * 32;
  const int lo = min(n, warp * seg), hi = min(n, lo + seg);
  rank_assignments<true>(ids, lo, hi, wc + warp * E, nullptr, lane);
  __syncthreads();
  for (int e = tid; e < E; e += kThreads) {  // exclusive scan over warps
    int run = 0;
    for (int q = 0; q < kWarps; ++q) {
      const int c = wc[q * E + e];
      wc[q * E + e] = run;
      run += c;
    }
    tc[e] = run;
  }
  __syncthreads();
  rank_assignments<false>(ids, lo, hi, wc + warp * E, rk, lane);
}

// Several token tiles: publish this tile's ranks (into slot), counts and
// column sums (tiles by expert, (E, NT)), and count the tile; the grid's
// last block (last_block) then scans the tiles' counts of each expert
// into the tiles' bases (over the counts) and writes counts and aux.
// The counts and sums are staged in the stage_words of shared memory at
// stage (phase 1's, free by now) where they fit, else scanned where they
// lie in the global scratch.
__device__ __noinline__ void finish_tiles(const RouteArgs& a, int tile, int n,
                                          const int32_t* rk, const int* tc,
                                          const float* cs, float* stage,
                                          int stage_words, float* term,
                                          bool* last_block) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < n; i += kThreads)
    a.slot[static_cast<int64_t>(tile) * a.TM * a.k + i] = rk[i];
  for (int e = tid; e < a.E; e += kThreads) {
    a.tcnt[static_cast<int64_t>(e) * a.NT + tile] = tc[e];
    a.colsum[static_cast<int64_t>(e) * a.NT + tile] = cs[e];
  }
  __syncthreads();
  if (tid == 0) {
    const int done = atomic_add_acq_rel(a.counters + a.NT, 1);
    *last_block = done == a.NT - 1;
    if (*last_block) a.counters[a.NT] = 0;  // every tile has counted
  }
  __syncthreads();
  if (!*last_block) return;

  const int n2 = a.NT * a.E;
  const int32_t* cnt = a.tcnt;
  const float* sums = a.colsum;
  if (2 * n2 <= stage_words) {
    int* sb = reinterpret_cast<int*>(stage);
    float* sf = stage + n2;
    for (int i0 = tid; i0 < n2; i0 += 4 * kThreads) {  // 8 loads in flight
      int c[4];
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j * kThreads;
        c[j] = i < n2 ? a.tcnt[i] : 0;
        f[j] = i < n2 ? a.colsum[i] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j * kThreads;
        if (i < n2) {
          sb[i] = c[j];
          sf[i] = f[j];
        }
      }
    }
    __syncthreads();
    cnt = sb;
    sums = sf;
  }
  // a warp an expert: its column over the tiles, 128 tiles a round, four
  // warp-wide prefix sums side by side; the bases go over the counts
  for (int e = warp; e < a.E; e += kWarps) {
    const int64_t col = static_cast<int64_t>(e) * a.NT;
    int carry = 0;
    float fsum = 0.f;
    for (int q0 = 0; q0 < a.NT; q0 += 4 * 32) {
      int c[4], inc[4];
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + 32 * j + lane;
        c[j] = q < a.NT ? cnt[col + q] : 0;
        f[j] = q < a.NT ? sums[col + q] : 0.f;
        inc[j] = c[j];
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int up = __shfl_up_sync(kFull, inc[j], o);
          if (lane >= o) inc[j] += up;
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + 32 * j + lane;
        if (q < a.NT) a.tcnt[col + q] = carry + inc[j] - c[j];
        carry += __shfl_sync(kFull, inc[j], 31);
        fsum += f[j];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) fsum += __shfl_xor_sync(kFull, fsum, o);
    if (lane == 0) {
      a.counts[e] = carry;
      term[e] = (fsum / static_cast<float>(a.T)) *
                (static_cast<float>(carry) / static_cast<float>(a.T * a.k));
    }
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int e = 0; e < a.E; ++e) s += term[e];
    *a.aux = static_cast<float>(a.E) * s;
  }
}

// The placement of several tiles, launched after moe_route_kernel with
// programmatic stream serialization: block b takes tile b and places
// each of its assignments at its expert's base in the tile + its rank.
// Named under moe_route_kernel, so that a profile counts it with
// moe_route.
__global__ void __launch_bounds__(kThreads)
    moe_route_kernel_place(const __grid_constant__ RouteArgs a) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int tile = blockIdx.x;
  const int i0 = tile * a.TM * a.k, n = min(a.TM, a.T - tile * a.TM) * a.k;
  const int drop = a.E * a.C;
  for (int i = i0 + threadIdx.x; i < i0 + n; i += kThreads) {
    const int e = a.idx[i], rank = a.slot[i];
    place(a, i, e, rank + a.tcnt[static_cast<int64_t>(e) * a.NT + tile], drop);
  }
}

// kTiles: several token tiles (NT > 1), which the placement launch
// follows; a decode batch (one tile) runs the instantiation without them.
template <bool kTiles>
__global__ void __launch_bounds__(kThreads)
    moe_route_kernel(const __grid_constant__ RouteArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  int* smi = reinterpret_cast<int*>(smem4);
  __shared__ bool last_block;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x, tile = blockIdx.y;
  const int t0 = tile * a.TM, rows = min(a.TM, a.T - t0);
  const int Ep = a.NE * kR, XS = a.TM + 4, O = a.TM * Ep;
  const int lbk4 = __ffs(a.BK / 4) - 1, lne = __ffs(a.NE) - 1;

  // several tiles: the placement launch may start as soon as every block
  // has begun; its blocks wait (griddepcontrol.wait) for this grid's end
  if constexpr (kTiles) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // src starts at -1; each block sets a share, all before any is placed
  {
    const int nb = gridDim.x * gridDim.y, b = tile * gridDim.x + chunk;
    const int n = a.E * a.C;
    for (int i = b * kThreads + tid; i < n; i += nb * kThreads) a.src[i] = -1;
  }

  // ---- phase 1: the partial product over this chunk of d ----
  const int eg = tid & (a.NE - 1), mg = (tid >> lne) & (a.NM - 1);
  const int ks = tid / (a.NE * a.NM);
  const int k_begin = chunk * a.DC, k_end = min(a.d, k_begin + a.DC);
  float acc[kR][kR];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[i][j] = 0.f;
  float* xs = sm;
  float* ws = sm + a.BK * XS;
  float4 rx[kMaxX4], rw[kMaxW4];
  load_tile(a, t0, rows, k_begin, k_end, lbk4, lne, rx, rw);
  for (int kt = k_begin; kt < k_end; kt += a.BK) {
    store_tile(a, xs, ws, lbk4, lne, rx, rw);
    __syncthreads();
    if (kt + a.BK < k_end) load_tile(a, t0, rows, kt + a.BK, k_end, lbk4, lne, rx, rw);
#pragma unroll 4
    for (int kk = ks; kk < a.BK; kk += a.KS) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + kk * XS + mg * kR);
      const float4 wv = *reinterpret_cast<const float4*>(ws + kk * Ep + eg * kR);
      const float xr[kR] = {xv.x, xv.y, xv.z, xv.w};
      const float wr[kR] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(xr[i], wr[j], acc[i][j]);
    }
    __syncthreads();  // every reader of the tile is done
  }
  // the KS slices of each output summed in slice order, to the partial
  float* part = a.part + (static_cast<int64_t>(tile) * a.NC + chunk) * O;
  float* red = sm;  // (KS, TM, Ep), over the staging buffers
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    float* row = (a.KS == 1 ? part : red + ks * O) + (mg * kR + i) * Ep + eg * kR;
    *reinterpret_cast<float4*>(row) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  if (a.KS > 1) {
    __syncthreads();
    for (int o = tid; o < O; o += kThreads) {
      float s = red[o];
      for (int q = 1; q < a.KS; ++q) s += red[q * O + o];
      part[o] = s;
    }
  }
  // After the barrier one thread counts the chunk with release semantics
  // (the block's partial is visible before the count) and acquire
  // semantics (the last block sees every other chunk's partial).
  __syncthreads();
  if (tid == 0) {
    const int done = atomic_add_acq_rel(a.counters + tile, 1);
    last_block = done == a.NC - 1;
    if (last_block) a.counters[tile] = 0;  // every chunk has counted
  }
  __syncthreads();
  if (!last_block) return;

  // ---- phase 2: this tile's logits, top-k and ranks ----
  // Plain loads from here on: the acquire above orders them after every
  // release, and a plain load can be in flight with others.
  const Smem L = smem_layout(a.TM, Ep, a.KS, a.BK, a.k, a.E);
  float* lg = sm + L.lg;
  float* grp = sm + L.grp;
  int32_t* ids = smi + L.ids;
  int32_t* rk = smi + L.rk;
  float* cs = sm + L.cs;
  int* tc = smi + L.tc;
  float* term = sm + L.term;
  const float* parts = a.part + static_cast<int64_t>(tile) * a.NC * O;
  // G = kThreads / O groups (1 when O >= kThreads) take every G-th chunk,
  // their sums added in group order
  const int G = O >= kThreads ? 1 : kThreads / O;
  if (G == 1) {
    for (int o = tid; o < O; o += kThreads) lg[o] = sum_chunks(parts, O, o, 0, 1, a.NC);
  } else {
    grp[tid] = sum_chunks(parts, O, tid % O, tid / O, G, a.NC);
    __syncthreads();
    if (tid < O) {
      float t = grp[tid];
      for (int q = 1; q < G; ++q) t += grp[q * O + tid];
      lg[tid] = t;
    }
  }
  __syncthreads();
  for (int o = tid; o < rows * Ep; o += kThreads) {
    const int m = o / Ep, e = o % Ep;
    if (e < a.E) a.logits[static_cast<int64_t>(t0 + m) * a.E + e] = lg[o];
  }
  for (int r = warp; r < rows; r += kWarps) {
    const int64_t t = t0 + r;
    route_row_any(lg + r * Ep, a.probs + t * a.E, lg + r * Ep, a.vals + t * a.k,
                  a.idx + t * a.k, ids + r * a.k, a.E, a.k, lane);
  }
  __syncthreads();
  for (int e = tid; e < a.E; e += kThreads) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += lg[r * Ep + e];
    cs[e] = s;
  }
  // ranks within the tile, in flat order
  const int n = rows * a.k;
  if (n <= 32) {  // one warp: the lower peers are the rank, the peers the count
    if (warp == 0) {
      const bool live = lane < n;
      const unsigned mask = __ballot_sync(kFull, live);
      for (int e = lane; e < a.E; e += 32) tc[e] = 0;
      __syncwarp();
      if (live) {
        const int e = ids[lane];
        const unsigned peers = __match_any_sync(mask, e);
        rk[lane] = __popc(peers & ((1u << lane) - 1u));
        if (lane == 31 - __clz(peers)) tc[e] = __popc(peers);
      }
    }
  } else {
    rank_tile(ids, rk, smi + L.wc, tc, n, a.E);
  }
  __syncthreads();
  // one tile: counts, aux and slots from shared memory
  if constexpr (!kTiles) {
    for (int e = tid; e < a.E; e += kThreads) {
      a.counts[e] = tc[e];
      term[e] = (cs[e] / static_cast<float>(a.T)) *
                (static_cast<float>(tc[e]) / static_cast<float>(a.T * a.k));
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int e = 0; e < a.E; ++e) s += term[e];
      *a.aux = static_cast<float>(a.E) * s;
    }
    const int drop = a.E * a.C;
    for (int i = tid; i < n; i += kThreads) place(a, i, ids[i], rk[i], drop);
  } else {
    finish_tiles(a, tile, n, rk, tc, cs, sm, L.lg, term, &last_block);
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

// x (T, d), w (d, E) float32 contiguous; outputs as RouteArgs; part,
// colsum, tcnt scratch of the sizes RouteArgs gives; counters (NT + 1)
// int32, zero, left zero.  The plan (TM = 4 * NM, NT, NC, DC, BK, NE,
// NM, KS) comes from route_plan: NE * NM * KS = 256, NM <= 16, NE <= 64,
// all powers of 2, BK a power of 2 from 32 with TM * BK <= 2048 and BK * 4 * NE <= 8192, DC a
// multiple of BK, NC * DC >= d.
extern "C" int moe_route(const void* x, const void* w, void* logits,
                         void* probs, void* vals, void* idx, void* slot,
                         void* src, void* counts, void* aux, void* part,
                         void* colsum, void* tcnt, void* counters, int T,
                         int d, int E, int k, int C, int NT, int NC, int DC,
                         int BK, int NE, int NM, int KS, void* stream) {
  const int TM = kR * NM, Ep = kR * NE;
  if (E < 1 || E > 32 * kMaxPerLane || k < 1 || k > kMaxK || k > E || T < 1 ||
      d < 1 || C < 1 || NE * NM * KS != kThreads || NM > 16 || Ep < E ||
      (NE & (NE - 1)) != 0 || (NM & (NM - 1)) != 0 ||
      BK < kBKMin || (BK & (BK - 1)) != 0 || TM * BK > 4 * kMaxX4 * kThreads ||
      BK * Ep > 4 * kMaxW4 * kThreads || Ep > 32 * kMaxPerLane || DC % BK != 0 ||
      static_cast<int64_t>(NC) * DC < d || NT != (T + TM - 1) / TM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RouteArgs a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.logits = static_cast<float*>(logits);
  a.probs = static_cast<float*>(probs);
  a.vals = static_cast<float*>(vals);
  a.idx = static_cast<int32_t*>(idx);
  a.slot = static_cast<int32_t*>(slot);
  a.src = static_cast<int32_t*>(src);
  a.counts = static_cast<int32_t*>(counts);
  a.aux = static_cast<float*>(aux);
  a.part = static_cast<float*>(part);
  a.colsum = static_cast<float*>(colsum);
  a.tcnt = static_cast<int32_t*>(tcnt);
  a.counters = static_cast<int*>(counters);
  a.T = T;
  a.d = d;
  a.E = E;
  a.k = k;
  a.C = C;
  a.TM = TM;
  a.NT = NT;
  a.NC = NC;
  a.DC = DC;
  a.BK = BK;
  a.NE = NE;
  a.NM = NM;
  a.KS = KS;
  a.vec_x = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.vec_w = E % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const size_t bytes = sizeof(float) * smem_layout(TM, Ep, KS, BK, k, E).total;
  // above 48 KB of dynamic shared memory a kernel opts in, on each device
  static size_t opted[2][kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const bool tiles = NT > 1;
  auto kernel = tiles ? moe_route_kernel<true> : moe_route_kernel<false>;
  if (bytes > (48u << 10) && bytes > opted[tiles][dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[tiles][dev] = bytes;
  }
  const dim3 grid(NC, NT);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<grid, kThreads, bytes, st>>>(a);
  if (NT == 1) return static_cast<int>(cudaGetLastError());
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // several tiles: the placement, a block a tile, chained by programmatic
  // dependent launch (its blocks may be scheduled once every block of the
  // first has begun, and wait for the first grid's end)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NT);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, moe_route_kernel_place, a);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
