// Flash attention (prefill) as a CUDA kernel for Hopper.
//
// Replaces the Pallas TPU kernel flash_attention
// (repro/kernels/flash_attention.py:94, pallas_call :123; body
// _flash_kernel :29).  q (B, H, S, D) attends over k, v (B, Hkv, T, D);
// query head h reads KV head h / (H / Hkv).  Masks, as in the TPU
// kernel: key positions >= T (none here: the kernel never pads), with
// causal k_pos <= q_pos (top-left aligned, q_pos from 0), with a window
// k_pos > q_pos - window.  The softmax is online in float32 with the TPU
// kernel's guards: m_safe = 0 while a row has seen only masked keys,
// corr = 0 on the first valid tile, and l clamped at 1e-20, so a fully
// masked row gives 0, never NaN.
//
// Bound: at the serving prefill shape (phi3.5-moe: H = 32, Hkv = 8,
// S = T = 47, D = 128, float32) the bytes, 1.9 MB of q, k, v and out,
// take 0.6 us at 3.35 TB/s against 18 MFLOP of causal work, 0.3 us at
// the 67 TFLOP/s float32 rate outside the tensor cores; there latency
// sets the time.  At S = 512, D = 64 the causal work, 269 MFLOP, bounds
// it (4 us in float32, 0.27 us in bf16 at 989 TFLOP/s); at S = 2048,
// H = 32, D = 128, 34 GFLOP (0.5 ms in float32, 35 us in bf16).
//
// Two paths, picked at launch:
//
// float32 (and bf16 rows off 16-byte alignment): the CUDA cores.  TF32
// and the tensor cores stay off: parity with the reference is defined in
// float32.  What bounds it is the rate at which float32 FMAs can be fed
// from shared memory.  One block per (query tile of BQ = 16, 32 or 64
// rows, head, batch), 256 threads; a loop inside the block over 64-key
// tiles takes the place of the TPU kernel's sequential key-tile grid
// dimension, from the first tile the window reaches to the causal
// diagonal, so tiles wholly masked are never loaded.
//   * Register tiles.  Thread (rg, kg), rg, kg < 16, holds the scores
//     of rows rg + 16 i (i < TM = BQ / 16: 4, 2 or 1) and keys kg + 16 j
//     (j < 4): each float4 of q and of K it reads from shared memory
//     feeds TM or 4 FMAs per element, 64 FMAs per 8 loads at TM = 4.
//     K rows are padded by 4 floats so the 8 threads of a quarter warp
//     hit 8 distinct bank groups.  The softmax of a row runs over the 16 lanes that hold it,
//     with shuffles.  The probabilities go to shared memory transposed,
//     the TM rows of a thread side by side, and p.V accumulates into the
//     same thread's rows and D / 16 columns, in registers across key
//     tiles; the correction corr rescales them in registers.
//   * Overlapped loads.  q and each K/V tile are copied with 16-byte
//     cp.async (float32, 16-byte aligned rows) into a two-stage ring:
//     tile k + 1 is in flight while tile k is computed.  Two barriers a
//     tile.  bfloat16 rows off alignment are read element by element and
//     converted to float on the way in.  Shared memory holds float.
//   * Causal balance.  The grid is one dimension with the query tile
//     slowest, in reverse: the heaviest tiles (the last, which walk the
//     most keys) are dispatched first, and the short ones fill in
//     behind them.  BQ = 64 where that gives a block per SM, 32 where
//     that keeps half the SMs busy, else 16, so a short or narrow
//     prompt still spreads over the card.
//   * Head dimensions.  The kernel is a template on DT in {16, 32, 64,
//     128, 256}; a D below DT (80, 96, ...) is zero-padded in shared
//     memory (cp.async's zero fill past D).  DT = 256 runs one stage
//     (216 KB of shared memory at BQ = 64), the others two.
//
// bfloat16 with 16-byte aligned rows (D a multiple of 8): Hopper's
// warpgroup tensor cores (flash_attention_kernel_wgmma).  The TPU kernel
// widens q, k and v to float32 and keeps the scores and p in float32 up
// to one rounding at the output.  Here q.k^T is wgmma with bf16 operands
// and float32 sums (the products of two bf16 are exact in float32, so
// only the order of the sum differs), and p.V splits p into three bf16
// parts, the top 8 significant bits, the next 8 and the last 8, three
// products against the same V summed in float32: the parts add up to p
// exactly.  One rounding of p would move each weight by up to 2^-9; two
// parts keep it to 2^-18, which on the card rounded many times more
// outputs away from the float32 reference than the CUDA-core path does
// and split a bf16 serve lifecycle of chip_smoke.py at a near tie.
//   Bound: the causal work, 4 D flops a visible (query, key) pair, at
//   989 TFLOP/s: 34.8 us at S = 2048, H = 32, D = 128.  The three parts
//   make this design issue 8 D a pair, so its own floor is twice that,
//   69.5 us.  What holds it above that floor is each warpgroup's chain a
//   tile (wait for the tile, q.k^T, softmax, split, p.V, each waiting for
//   the last) and the instructions the chain issues, which only the other
//   warpgroup's products overlap.  At a short prompt or a grid that
//   leaves SMs idle, the latency of a block's first loads and of its
//   chain of key tiles sets the time.
//   Design:
//   * Blocks.  Two warpgroups of 64 query rows each (BQ = 128) where that
//     gives a block per SM, over tiles of 128 keys (D <= 128), which halves
//     the chain's fixed costs a key.  Where 128-row blocks leave SMs idle
//     and the keys span more than one tile, two warpgroups share 64 rows
//     and take alternate tiles of 64 keys (their (o, m, l) merge through
//     shared memory at the end); else one warpgroup of 64 rows and
//     64-key tiles (a short prompt: one head a block, which measured
//     faster than the G heads of a KV head packed into a block's rows).
//     There is no producer warp: a ninth warp puts three warps on one of
//     the SM's four register files, 168 registers a thread, and with a
//     producer warpgroup and setmaxnreg (24 / 240) ptxas still kept the
//     consumers near 172 registers and spilled them.  Thread 0 issues the
//     loads as its warpgroup passes the tiles.
//   * A TMA ring.  q arrives once a block; K and V tiles go through a ring
//     of 2-8 stages (by the shared memory they take), each with a full
//     and an empty mbarrier; a stage is refilled while group 0 runs a
//     later tile's p.V.  The host encodes a tensor map of each operand per
//     call (its strides, so the engine's transposed (1, S, H, D) views
//     need no copy); boxes of 64 columns land 128-byte swizzled, as the
//     wgmma descriptors read them, and the hardware zero-fills rows past
//     T or S and columns past D.  A wait on a copy that never lands traps.
//     Every warp waits for and releases every tile, so no stage's phase
//     sees an arrival early.
//   * S = q.k^T, m64nBKk16 from two K-major descriptors (q and K as
//     stored).  The softmax runs on the accumulator fragments: lane l
//     holds rows l / 4 and l / 4 + 8 of its warp's 16, so a row's max and
//     sum take two shuffles in its quad; scores in log2 units, the scale
//     folded into ex2.approx's argument; masks only on a tile that is not
//     wholly valid.
//   * O += P.V from registers.  The score accumulator is, lane for lane,
//     the register A operand of the next product: three m64n128k16 (D =
//     128; m64n64k16 a 64-column slab otherwise) a 16-key step, one a
//     part of p, against the same MN-major descriptor of V (transposed by
//     the instruction), in commits of 64 keys (32 at D = 256) with a wait
//     between.  The tensor cores take each tile's p.V from zero; o, the
//     sum over tiles, is rescaled and added in float32 on the CUDA cores
//     (o = o corr + p.V).  Summed across all tiles inside the tensor
//     cores, as mma.sync did, p.V rounded 0.002 of the outputs at S =
//     2048 away from the float32 reference; a tile at a time, 0.0007.  At
//     D = 256 registers leave no room for that second accumulator: o is
//     rescaled, then accumulates in the tensor cores.
//   * One tile at a time, and no branch among a tile's products (ptxas
//     serializes every wgmma of a kernel where one is conditional or an
//     accumulator it has in flight is written): the k-steps run the
//     template's width (a D of 80 or 96 runs all 8 over zero columns).
//     Issuing the next tile's q.k^T with this tile's p.V, so that the
//     softmax overlaps it, and the two groups taking turns on the tensor
//     cores (FlashAttention-3's schedules) both measured slower.
//   * Schedule.  The grid's order is the float32 path's, heaviest tiles
//     first; a block loads the tiles from the first its window reaches to
//     its causal diagonal, and a warpgroup computes only those its rows
//     see.  Widths: a template on DT in {64, 128, 256}.
// The kernel takes the (batch, head, position) strides of q, k and v,
// so the engine's (B, S, H, D) projections are read through a
// transposed view with no copy; each row of D must be contiguous.  out
// is (B, H, S, D) contiguous, in q's type.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBK = 64;  // keys per tile
constexpr int kKG = 16;  // key groups: 4 keys a thread
constexpr int kRG = 16;  // row groups: BQ / 16 rows a thread
constexpr int kThreads = kKG * kRG;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;

struct Strides {
  int64_t b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int H, G, S, T, D, n_qt;
  Strides qs, ks, vs;
  float scale;
  int causal, has_window, window, vec;
};

template <int DT, int BQ>
struct Layout {
  static constexpr int kStages = DT >= 256 ? 1 : 2;
  static constexpr int QLD = DT + 4;  // q and K rows, padded
  static constexpr int PLD = BQ + 4;  // rows of the transposed p tile
  static constexpr int kQ = BQ * QLD;
  static constexpr int kK = kBK * QLD;
  static constexpr int kV = kBK * DT;
  static constexpr int kP = kBK * PLD;
  static constexpr int kFloats = kQ + kStages * (kK + kV) + kP;
  static_assert(sizeof(float) * kFloats <= kMaxSmem, "shared memory");
};

// Rows [r0, r0 + n) of a (rows, D) operand into shared memory at row
// stride ld as float, DT columns, zero rows from `valid` on and zero
// columns from D on.
template <typename T, int DT>
__device__ __forceinline__ void load_rows(const Params& p, const T* base,
                                          int64_t stride, int r0, int n,
                                          int valid, float* dst, int ld) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (p.vec) {  // D a multiple of N, rows 16-byte aligned
    constexpr int N = Vec16<T>::N;
    constexpr int CPR = DT / N;  // 16-byte chunks per row
    for (int c = tid; c < n * CPR; c += nt) {
      const int r = c / CPR;
      const int d = (c % CPR) * N;
      const bool in = r0 + r < valid && d < p.D;
      const T* src = base + (in ? (r0 + r) * stride + d : 0);
      float* to = dst + r * ld + d;
      if constexpr (sizeof(T) == 4) {
        cp_async16(to, src, in ? 16 : 0);
      } else {
        float x[N];
        if (in) {
          Vec16<T>::load(src, x);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) x[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < N; i += 4) store4(to + i, x + i);
      }
    }
  } else {
    for (int c = tid; c < n * DT; c += nt) {
      const int r = c / DT;
      const int d = c % DT;
      const bool in = r0 + r < valid && d < p.D;
      dst[r * ld + d] = in ? to_float(base[(r0 + r) * stride + d]) : 0.f;
    }
  }
}

template <typename T, int DT, int BQ>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const Params p) {
  using L = Layout<DT, BQ>;
  constexpr int TM = BQ / kRG;   // rows a thread: rg + 16 i, i < TM
  constexpr int CPT = DT / kKG;  // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                             // (BQ, QLD)
  float* k_s = q_s + L::kQ;                      // stages x (BK, QLD)
  float* v_s = k_s + L::kStages * L::kK;         // stages x (BK, DT)
  float* p_s = v_s + L::kStages * L::kV;         // (BK, PLD), transposed

  const int hb = gridDim.x / p.n_qt;  // heads x batch
  const int qt = p.n_qt - 1 - static_cast<int>(blockIdx.x) / hb;
  const int rem = static_cast<int>(blockIdx.x) % hb;
  const int h = rem % p.H;
  const int b = rem / p.H;
  const int hk = h / p.G;
  const int tid = threadIdx.x;
  const int kg = tid % kKG;
  const int rg = tid / kKG;
  const int q0 = qt * BQ;

  const T* qb = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
  const T* kb = static_cast<const T*>(p.k) + b * p.ks.b + hk * p.ks.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.vs.b + hk * p.vs.h;

  const int q_last = min(q0 + BQ, p.S) - 1;
  const int k_end = p.causal ? min(p.T, q_last + 1) : p.T;
  const int k_begin = p.has_window ? max(0, q0 - p.window + 1) : 0;
  const int kt0 = k_begin / kBK;
  const int n_tiles = k_end > kt0 * kBK ? (k_end - kt0 * kBK + kBK - 1) / kBK : 0;

  float acc[TM][CPT];
  float m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  auto issue = [&](int t, int stage) {
    const int k0 = (kt0 + t) * kBK;
    load_rows<T, DT>(p, kb, p.ks.s, k0, kBK, p.T, k_s + stage * L::kK, L::QLD);
    load_rows<T, DT>(p, vb, p.vs.s, k0, kBK, p.T, v_s + stage * L::kV, DT);
    cp_async_commit();
  };
  if (n_tiles > 0) {
    load_rows<T, DT>(p, qb, p.qs.s, q0, BQ, p.S, q_s, L::QLD);
    issue(0, 0);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = L::kStages == 2 ? t & 1 : 0;
    const int k0 = (kt0 + t) * kBK;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every reader of tile t - 1 is done
    if (L::kStages == 2 && t + 1 < n_tiles) issue(t + 1, stage ^ 1);
    const float* ks = k_s + stage * L::kK;
    const float* vs = v_s + stage * L::kV;

    // scores: s[i][j] = q[rg + 16 i] . k[kg + 16 j]
    float s[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DT; d += 4) {
      float qx[TM][4], kx[4][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        Vec16<float>::load(q_s + (rg + kRG * i) * L::QLD + d, qx[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Vec16<float>::load(ks + (kg + kKG * j) * L::QLD + d, kx[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qx[i][e], kx[j][e], s[i][j]);
    }

    // masks, then the online softmax of each row over its 16 lanes
    const bool full = k0 + kBK <= p.T && (!p.causal || k0 + kBK - 1 <= q0) &&
                      (!p.has_window || k0 > q0 + BQ - 1 - p.window);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qp = q0 + rg + kRG * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + kg + kKG * j;
        const bool valid = full || (kp < p.T && (!p.causal || kp <= qp) &&
                                    (!p.has_window || kp > qp - p.window));
        s[i][j] = valid ? s[i][j] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < kKG; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_safe);
        sum += s[i][j];
      }
#pragma unroll
      for (int o = 1; o < kKG; o <<= 1) sum += __shfl_xor_sync(kFull, sum, o);
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) x[i] = s[i][j];
      st_vec<TM>(p_s + (kg + kKG * j) * L::PLD + TM * rg, x);
    }
    __syncthreads();  // the p tile is complete

    // acc[i][c] += sum_j p[row i][j] v[j][col c]
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pj[TM], vx[CPT];
      ld_vec<TM>(p_s + j * L::PLD + TM * rg, pj);
      const float* vr = vs + j * DT;
      if constexpr (CPT >= 4) {
#pragma unroll
        for (int c = 0; c < CPT; c += 4)
          Vec16<float>::load(vr + (c / 4) * 4 * kKG + 4 * kg, vx + c);
      } else if constexpr (CPT == 2) {
        const float2 v2 = *reinterpret_cast<const float2*>(vr + 2 * kg);
        vx[0] = v2.x;
        vx[1] = v2.y;
      } else {
        vx[0] = vr[kg];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pj[i], vx[c], acc[i][c]);
    }
    if (L::kStages == 1 && t + 1 < n_tiles) {
      __syncthreads();  // every reader of the one stage is done
      issue(t + 1, 0);
    }
  }

  // out = acc / l, rows < S, columns < D
  T* ob = static_cast<T*>(p.out) + (static_cast<int64_t>(b) * p.H + h) *
                                       static_cast<int64_t>(p.S) * p.D;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qp = q0 + rg + kRG * i;
    if (qp >= p.S) continue;
    const float lc = fmaxf(l[i], 1e-20f);
    T* orow = ob + static_cast<int64_t>(qp) * p.D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = CPT >= 4 ? (c / 4) * 4 * kKG + 4 * kg + c % 4
                               : CPT * kg + c;
      if (col < p.D) orow[col] = from_float<T>(acc[i][c] / lc);
    }
  }
}

// ---- bfloat16 on the warpgroup tensor cores --------------------------------
// (x, y) as three bf16 pairs, x in the low half of each 32-bit register (the
// lower column of an mma fragment), whose sum is exactly (x, y): each part is
// the top 16 bits of what the parts before it left (hi: the sign, the
// exponent and 7 bits of the mantissa; mid the next 8 significant bits;
// lo the last 8, which a bf16 holds whole).  Each difference is exact in
// float32, and the truncations cost a mask and a byte permute each.
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi, unsigned& mid,
                                           unsigned& lo) {
  const unsigned xb = __float_as_uint(x), yb = __float_as_uint(y);
  hi = __byte_perm(xb, yb, 0x7632);
  const float rx = x - __uint_as_float(xb & 0xffff0000u);
  const float ry = y - __uint_as_float(yb & 0xffff0000u);
  const unsigned rxb = __float_as_uint(rx), ryb = __float_as_uint(ry);
  mid = __byte_perm(rxb, ryb, 0x7632);
  lo = __byte_perm(__float_as_uint(rx - __uint_as_float(rxb & 0xffff0000u)),
                   __float_as_uint(ry - __uint_as_float(ryb & 0xffff0000u)), 0x7632);
}

// 2^x (ex2.approx.ftz: about 2^-22 relative; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// mbarriers and the Tensor Memory Accelerator (TMA): one thread asks for
// a box of a tensor (CUtensorMap, encoded on the host) to be copied into
// shared memory; the copy completes its bytes on an mbarrier, and the
// hardware writes zeros where the box passes the tensor's end.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The box at column c0, row r0 of head h, batch b; heads_inner: the map
// orders its dimensions (D, heads, positions, batch).
__device__ __forceinline__ void tma_box(unsigned dst, const CUtensorMap& map,
                                        int heads_inner, int c0, int r0, int h, int b,
                                        unsigned bar) {
  const int x1 = heads_inner ? h : r0, x2 = heads_inner ? r0 : h;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(x1), "r"(x2), "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// A wait that never ends (a copy that did not land) traps after about
// 2^30 polls, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) __trap();
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

// The tensor-core kernel's parameters: the tensor maps of q, k and v,
// each (D, positions, heads, batch), or (D, heads, positions, batch)
// where the heads' stride is the smaller (the engine's transposed
// views), with boxes of 64 columns by BQ or 64 rows, 128-byte swizzled.
struct TcParams {
  CUtensorMap q, k, v;
  Params p;
  int q_hi, k_hi, v_hi;  // heads inner
};

// ---- wgmma ----
// Shared-memory matrix descriptors for tiles as TMA writes them with the
// 128-byte swizzle: rows of 128 bytes (64 bf16), 16-byte chunk c of row
// r at chunk c ^ (r % 8), 8-row groups 1024 bytes apart, every tile
// 1024-byte aligned.  Bits: start address >> 4 [0, 14), leading byte
// offset >> 4 [16, 30), stride byte offset >> 4 [32, 46), swizzle mode
// [62, 64) (1: 128 bytes).
//   K-major (q and K rows, the 16 columns of a k-step side by side): the
//   stride is the 1024 bytes between 8-row groups; the leading offset is
//   not read (1).  A k-step of 16 columns moves the start by 32 bytes
//   within the swizzled row.
//   MN-major (V, 16 keys of 64 columns a k-step): 8-key groups 1024
//   bytes apart; one 64-column atom an instruction, so the leading offset
//   (the stride between atoms) is not read either: 1024 as well.
__device__ __forceinline__ uint64_t desc_sw128(unsigned addr, unsigned lead) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The compiler may not move a read of r above, or a write of r below, this
// point: registers that an asynchronous wgmma writes or reads are touched
// only between the waits.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, float32) = a (64 x 16) . b (16 x 64) + (accumulate ? d : 0),
// a and b bf16 from K-major shared-memory descriptors.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, float32) = a (64 x 16, bf16 in registers: each warp's 16
// rows as the A fragment of mma.sync m16n8k16) . b (16 x 64, bf16, an
// MN-major descriptor: 16 rows of V, transposed by the instruction) +
// (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const unsigned (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 128, float32) = a (64 x 16) . b (16 x 128) + (accumulate ? d : 0),
// a and b bf16 from K-major shared-memory descriptors.
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// (d0, d1) (64 x 128, float32: columns 0-63, 64-127) = a (64 x 16, bf16 in
// registers, as wgmma_rs) . b (16 x 128, bf16, MN-major: two 64-column
// atoms, the descriptor's leading offset apart) + (accumulate ? (d0, d1) : 0).
__device__ __forceinline__ void wgmma_rs128(float (&d0)[32], float (&d1)[32],
                                            const unsigned (&a)[4], uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]), "+f"(d0[5]),
        "+f"(d0[6]), "+f"(d0[7]), "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]),
        "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]), "+f"(d0[16]), "+f"(d0[17]),
        "+f"(d0[18]), "+f"(d0[19]), "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]),
        "+f"(d0[30]), "+f"(d0[31]), "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]),
        "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]), "+f"(d1[8]), "+f"(d1[9]),
        "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]),
        "+f"(d1[22]), "+f"(d1[23]), "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// How a block's rows are cut: kRows, each warpgroup its own 64 query rows
// of one head; kSplit, two warpgroups on the same 64 rows, over alternate
// key tiles, merged at the end.
enum WgMode { kRows = 0, kSplit = 1 };

// A block: NWG warpgroups, and no producer warp: thread 0 issues the TMA
// loads as its warpgroup passes the tiles.  A ninth warp would put three
// warps on one of the SM's four register files, 168 registers a thread.
template <int DT, int NWG, int MODE>
struct WgLayout {
  static_assert(DT % 64 == 0, "whole 64-column slabs");
  static_assert(MODE != kSplit || NWG == 2, "kSplit: two warpgroups on one row tile");
  static constexpr int BQ = MODE == kRows ? 64 * NWG : 64;  // query rows
  static constexpr int NS = DT / 64;                        // 64-column slabs
  static constexpr int kThreads = 128 * NWG;
  // keys a tile: 128 with two groups of rows up to D = 128, halving the
  // tiles' fixed costs (waits, barriers, the latency of each product's
  // chain); 64 under kSplit, whose groups take alternate tiles of short
  // rows, with one group (a short prompt: the wider tile measured slower),
  // and at D = 256, whose registers hold no wider score tile
  static constexpr int BK = MODE == kRows && NWG == 2 && DT <= 128 ? 128 : 64;
  static constexpr int KT = BK / 16;  // 16-key steps of p.V
  // stages of the K/V ring (64 KB a stage at BK = 128, D = 128, or at
  // D = 256); a stage is refilled LAG tiles after it was read, so that
  // under kSplit the other group's tile in flight never blocks it
  static constexpr int kStages = DT >= 256 ? 2 : BK == 128 ? (DT >= 128 ? 3 : 6)
                                                           : (DT >= 128 ? 6 : 8);
  static constexpr int LAG = MODE == kSplit ? 3 : 1;
  static_assert(kStages > LAG, "a load in flight ahead of the tiles read");
  // up to D = 128 each tile's p.V is taken from zero in a second
  // accumulator and added to o in float32; at D = 256 registers leave no
  // room for it
  static constexpr bool kTileAcc = DT <= 128;
  // 16-key steps of p.V a commit (a wait between commits): their parts of
  // p stay in registers until the products that read them complete
  static constexpr int KC = DT >= 256 ? 2 : 4;
  // p.V as one m64n128k16 over both 64-column slabs of V at D = 128
  static constexpr bool kWide = DT == 128;
  static constexpr int kQ = BQ * DT * 2;    // bytes
  static constexpr int kKV = BK * DT * 2;   // one K or V tile
  static constexpr int kStage = 2 * kKV;    // K, then V
  static constexpr int kData = kQ + kStages * kStage;
  static constexpr int kBytes = 1024 + kData + 8 * (1 + 2 * kStages);  // 1 KB to align
  // kSplit's merge: every warp's o, m and l, lane by lane, over q and the ring
  static constexpr int kSlot = 32 * (DT / 2 + 4);  // floats a warp
  static constexpr int kMerge = MODE == kSplit ? 4 * NWG * 4 * kSlot : 0;
  static_assert(kBytes <= kMaxSmem, "shared memory");
  static_assert(kMerge <= kData, "merge buffer");
};

// The bfloat16 function of flash_attention_kernel (16-byte aligned rows,
// D a multiple of 8) with both products on wgmma.  Consumer warpgroup w
// owns 64 query rows; in the m64n64 accumulator warp i of the group holds
// rows 16 i + [0, 16), lane l rows l / 4 and l / 4 + 8 of each 8-key
// column tile j at keys 8 j + 2 (l % 4) and + 1, so a row's max and sum
// take two shuffles in its quad, and the probabilities, still in
// registers, are, lane for lane, the A fragment of p.V.  Named under
// flash_attention_kernel, so that a profile counts it with the wrapper's
// launches.
template <int DT, int NWG, int MODE>
__global__ void __launch_bounds__(WgLayout<DT, NWG, MODE>::kThreads, 1)
    flash_attention_kernel_wgmma(const __grid_constant__ TcParams tp) {
  using L = WgLayout<DT, NWG, MODE>;
  using bf16 = __nv_bfloat16;
  const Params& p = tp.p;
  constexpr int BQ = L::BQ, NS = L::NS, ST = L::kStages, BK = L::BK;
  constexpr int KT = DT / 16;  // 16-column steps of q.k^T
  extern __shared__ __align__(16) unsigned char sm_raw[];
  unsigned char* sm_bytes = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(sm_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const unsigned q_s = smem_u32(sm_bytes);  // NS slabs of (BQ, 64), swizzled
  const unsigned kv_s = q_s + L::kQ;        // stages x (K, V) x NS slabs of (BK, 64)
  const unsigned q_bar = kv_s + ST * L::kStage;
  const unsigned full = q_bar + 8, empty = full + 8 * ST;

  // the grid: query tiles slowest, the heaviest (last) first
  const int hb = gridDim.x / p.n_qt;
  const int qt = p.n_qt - 1 - static_cast<int>(blockIdx.x) / hb;
  const int rem = static_cast<int>(blockIdx.x) % hb;
  const int h = rem % p.H;
  const int b = rem / p.H;
  const int hk = h / p.G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(kFull, tid / 128, 0);  // warp-uniform, as the compiler sees it

  // the block's key tiles: from the first the window reaches to the
  // causal diagonal; none where no key is left (every tile it loads holds
  // a key that one of its rows sees)
  const int q_last = min(q0 + BQ, p.S) - 1;
  const int k_end = p.causal ? min(p.T, q_last + 1) : p.T;
  const int k_begin = p.has_window ? max(0, q0 - p.window + 1) : 0;
  const int kt0 = k_begin / BK;
  const int n_tiles = k_end > k_begin ? (k_end - kt0 * BK + BK - 1) / BK : 0;

  if (tid == 0) {
    mbar_init(q_bar, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NWG);  // every warp, every tile
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 loads: q, then tile u into stage u % ST once every warp has
  // released tile u - ST, as group 0 passes tile u - ST + LAG
  auto load = [&](int u) {
    const int st = u % ST;
    const unsigned bar = full + 8 * st, dst = kv_s + st * L::kStage;
    if (u >= ST) mbar_wait(empty + 8 * st, (u / ST - 1) & 1);
    mbar_expect(bar, L::kStage);
    const int k0 = (kt0 + u) * BK;
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      tma_box(dst + sl * BK * 128, tp.k, tp.k_hi, 64 * sl, k0, hk, b, bar);
      tma_box(dst + L::kKV + sl * BK * 128, tp.v, tp.v_hi, 64 * sl, k0, hk, b, bar);
    }
  };
  if (tid == 0) {
    if (n_tiles > 0) {
      mbar_expect(q_bar, L::kQ);
#pragma unroll
      for (int sl = 0; sl < NS; ++sl)
        tma_box(q_s + sl * BQ * 128, tp.q, tp.q_hi, 64 * sl, q0, h, b, q_bar);
    }
    for (int u = 0; u < min(n_tiles, ST - L::LAG); ++u) load(u);
  }

  {
    const int lane = tid & 31, wi = (tid >> 5) & 3;  // warp of the group
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = MODE == kRows ? 64 * wg : 0;  // the group's first row in the block
    const int wq0 = q0 + r0 + 16 * wi;           // the warp's first row
    // the group's keys: it computes a tile only where they meet it (under
    // kSplit, and only its own tiles: g, g + 2, ...)
    const int f_row = q0 + r0;
    const bool live = f_row < p.S;
    const int w_end = p.causal ? min(p.T, min(f_row + 63, p.S - 1) + 1) : p.T;
    const int w_begin = p.has_window ? max(0, f_row - p.window + 1) : 0;
    auto own = [&](int t) {
      const int k0 = (kt0 + t) * BK;
      return (MODE != kSplit || (t & 1) == wg) && live && k0 < w_end && k0 + BK > w_begin;
    };
    // as group 0 passes tile t, its thread 0 issues the load of tile t +
    // ST - LAG: for a tile it computes, while the tile's p.V runs
    auto refill = [&](int t) {
      if (tid == 0 && t + ST - L::LAG < n_tiles) load(t + ST - L::LAG);
    };
    // every group waits for every tile, in order
    auto wait_full = [&](int t) { mbar_wait(full + 8 * (t % ST), (t / ST) & 1); };
    // a warp's part of tile t is done: once every warp's is, thread 0 may
    // refill its stage
    auto release = [&](int t) {
      if (lane == 0) mbar_arrive(empty + 8 * (t % ST));
    };
    // the group's next own tile from `t` on; tiles before it are waited
    // for and released (every warp passes every tile, so no warp
    // arrives twice on a stage's barrier in one phase)
    auto next_own = [&](int t) {
      for (; t < n_tiles && !own(t); ++t) {
        refill(t);
        wait_full(t);
        release(t);
      }
      return t;
    };

    float o[NS][32];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this lane's columns
    const float sl2 = p.scale * 1.4426950408889634f;         // scores in log2 units
    if (n_tiles > 0) mbar_wait(q_bar, 0);

    auto stage_of = [&](int t) { return kv_s + (t % ST) * L::kStage; };
    // s = q . k^T of tile t (every k-step of the template's width: the
    // columns past D are zeros); no branch among the products, so that
    // ptxas keeps s in place and does not serialize them
    // (a descriptor's start address is its low bits: a step adds its byte
    // offset / 16 to the tile's descriptor)
    const uint64_t dq = desc_sw128(q_s + r0 * 128, 1);
    auto issue_qk = [&](float (&s)[BK / 2], int t) {
      const uint64_t dk = desc_sw128(stage_of(t), 1);
      reg_fence(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const int off = (kk & 3) * 32;  // within the swizzled row
        const uint64_t a = dq + ((kk >> 2) * (BQ * 128) + off) / 16;
        const uint64_t b = dk + ((kk >> 2) * (BK * 128) + off) / 16;
        if constexpr (BK == 128) {
          wgmma_ss128(s, a, b, kk > 0);
        } else {
          wgmma_ss(s, a, b, kk > 0);
        }
      }
      wgmma_commit();
    };
    // masks (only on a tile that is not wholly valid for the warp's rows),
    // then the online softmax of rows g and g + 8 over the quad; p
    // overwrites s, and corr is each row's rescale of o
    auto softmax = [&](float (&s)[BK / 2], int t, float (&corr)[2]) {
      const int k0 = (kt0 + t) * BK;
      const bool full_tile = k0 + BK <= p.T &&
                             (!p.causal || k0 + BK - 1 <= wq0) &&
                             (!p.has_window || k0 > wq0 + 15 - p.window);
      if (!full_tile) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int qp = wq0 + g + 8 * (c >> 1);
            const int kp = k0 + 8 * j + 2 * t4 + (c & 1);
            const bool valid = kp < p.T && (!p.causal || kp <= qp) &&
                               (!p.has_window || kp > qp - p.window);
            if (!valid) s[4 * j + c] = -INFINITY;
          }
      }
      // m in log2 units: the scale folds into the exponent's FMA
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[hh], mx * sl2);
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        corr[hh] = m[hh] == -INFINITY ? 0.f : exp2_approx(m[hh] - m_safe);
        float sum0 = 0.f, sum1 = 0.f;  // a masked score gives 2^-inf = 0
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          s[4 * j + 2 * hh] = exp2_approx(fmaf(s[4 * j + 2 * hh], sl2, -m_safe));
          s[4 * j + 2 * hh + 1] = exp2_approx(fmaf(s[4 * j + 2 * hh + 1], sl2, -m_safe));
          sum0 += s[4 * j + 2 * hh];
          sum1 += s[4 * j + 2 * hh + 1];
        }
        l[hh] = l[hh] * corr[hh] + (sum0 + sum1);
        m[hh] = m_new;
      }
    };
    // the parts of p (hi, mid, lo) of 16-key steps [kk0, kk0 + KC), each
    // step the A fragment of its keys: rows g and g + 8, keys 2 t4 (+ 1)
    // and 2 t4 + 8 (+ 1)
    auto split_p = [&](const float (&s)[BK / 2], int kk0, unsigned (&pp)[L::KC][3][4]) {
#pragma unroll
      for (int c = 0; c < L::KC; ++c) {
        const int j = 2 * (kk0 + c);
        split_bf16(s[4 * j], s[4 * j + 1], pp[c][0][0], pp[c][1][0], pp[c][2][0]);
        split_bf16(s[4 * j + 2], s[4 * j + 3], pp[c][0][1], pp[c][1][1], pp[c][2][1]);
        split_bf16(s[4 * j + 4], s[4 * j + 5], pp[c][0][2], pp[c][1][2], pp[c][2][2]);
        split_bf16(s[4 * j + 6], s[4 * j + 7], pp[c][0][3], pp[c][1][3], pp[c][2][3]);
      }
    };
    // acc += p . v of tile t's 16-key steps [kk0, kk0 + KC): three products
    // a step and slab, one a part of p, against the same V; fresh: acc
    // starts from zero
    auto issue_pv = [&](float (&acc)[NS][32], const unsigned (&pp)[L::KC][3][4], int t,
                        int kk0, bool fresh) {
      const uint64_t dv =
          desc_sw128(stage_of(t) + L::kKV, L::kWide ? (BK * 128) >> 4 : 1024 >> 4);
#pragma unroll
      for (int n = 0; n < NS; ++n) reg_fence(acc[n]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < L::KC; ++c)
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          const uint64_t dvk = dv + (kk0 + c) * (16 * 128 / 16);  // the step's 16 rows of V
          const int acc_in = !fresh || kk0 + c + part > 0;
          if constexpr (L::kWide) {
            wgmma_rs128(acc[0], acc[1], pp[c][part], dvk, acc_in);
          } else {
#pragma unroll
            for (int n = 0; n < NS; ++n)
              wgmma_rs(acc[n], pp[c][part], dvk + n * (BK * 128 / 16), acc_in);
          }
        }
      wgmma_commit();
    };

    // One tile at a time; the other group's products fill the tensor cores
    // during this one's softmax.  (Issuing the next tile's q.k^T before this
    // tile's p.V, and the two groups taking turns on the tensor cores as in
    // FlashAttention-3, both measured slower on the H100.)
    float s[BK / 2];
    for (int t = next_own(0); t < n_tiles; t = next_own(t + 1)) {
      wait_full(t);
      issue_qk(s, t);
      wgmma_wait<0>();
      reg_fence(s);
      float corr[2];
      softmax(s, t, corr);
      if constexpr (L::kTileAcc) {
        // the tensor cores take the tile's p.V from zero, so their sums run
        // over its 64 keys; o, the sum over tiles, is rescaled and added in
        // float32 (o = o corr + p.V)
        float ot[NS][32];
#pragma unroll
        for (int kk0 = 0; kk0 < L::KT; kk0 += L::KC) {
          unsigned pp[L::KC][3][4];
          split_p(s, kk0, pp);
          issue_pv(ot, pp, t, kk0, true);
          if (kk0 == 0) refill(t);
          wgmma_wait<0>();
#pragma unroll
          for (int n = 0; n < NS; ++n) reg_fence(ot[n]);
        }
        release(t);
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[n][i] = fmaf(o[n][i], corr[(i >> 1) & 1], ot[n][i]);
      } else {
        // D = 256: o itself accumulates p.V in the tensor cores, rescaled
        // before the tile's products, in two commits of 32 keys
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[n][i] *= corr[(i >> 1) & 1];
#pragma unroll
        for (int kk0 = 0; kk0 < L::KT; kk0 += L::KC) {
          unsigned pp[L::KC][3][4];
          split_p(s, kk0, pp);
          issue_pv(o, pp, t, kk0, false);
          if (kk0 == 0) refill(t);
          wgmma_wait<0>();
#pragma unroll
          for (int n = 0; n < NS; ++n) reg_fence(o[n]);
        }
        release(t);
      }
    }

    // kSplit: each warp's o, m and l, lane by lane, into shared memory
    // (over q and the ring, all read); then group w merges both, in group
    // order, and writes 8-column tiles [w NO / 2, (w + 1) NO / 2)
    constexpr int NO = DT / 8;
    int n_lo = 0, n_hi = NO;
    if constexpr (MODE == kSplit) {
      __syncthreads();  // every warp is done with q and the ring
      float* mg = reinterpret_cast<float*>(sm_bytes) + wi * L::kSlot + lane;
      constexpr int kGroup = 4 * L::kSlot;  // floats a group
      {
        float* my = mg + wg * kGroup;
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int i = 0; i < 32; ++i) my[32 * (32 * n + i)] = o[n][i];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          my[32 * (4 * NO + hh)] = m[hh];
          my[32 * (4 * NO + 2 + hh)] = l[hh];
        }
      }
      __syncthreads();
      n_lo = wg * (NO / NWG);
      n_hi = n_lo + NO / NWG;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mq[NWG], m_new = -INFINITY;
#pragma unroll
        for (int q = 0; q < NWG; ++q) {
          mq[q] = mg[q * kGroup + 32 * (4 * NO + hh)];
          m_new = fmaxf(m_new, mq[q]);
        }
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        float lt = 0.f;
#pragma unroll
        for (int q = 0; q < NWG; ++q) {
          mq[q] = exp2_approx(mq[q] - m_safe);  // the group's weight
          lt += mg[q * kGroup + 32 * (4 * NO + 2 + hh)] * mq[q];
        }
        l[hh] = lt;
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (8 * n + j < n_lo || 8 * n + j >= n_hi) continue;
#pragma unroll
            for (int c = 2 * hh; c < 2 * hh + 2; ++c) {
              float x = 0.f;
#pragma unroll
              for (int q = 0; q < NWG; ++q)
                x += mg[q * kGroup + 32 * (32 * n + 4 * j + c)] * mq[q];
              o[n][4 * j + c] = x;
            }
          }
      }
    }

    // out = o / l: rows < S, columns < D
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lt = l[hh];
      lt += __shfl_xor_sync(kFull, lt, 1);
      lt += __shfl_xor_sync(kFull, lt, 2);
      const float lc = fmaxf(lt, 1e-20f);
      const int r = wq0 + g + 8 * hh;
      bf16* orow = static_cast<bf16*>(p.out) +
                   ((static_cast<int64_t>(b) * p.H + h) * p.S + r) * p.D + 2 * t4;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * n + 8 * j;
          if (!live || r >= p.S || col >= p.D || 8 * n + j < n_lo || 8 * n + j >= n_hi) continue;
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[n][4 * j + 2 * hh] / lc, o[n][4 * j + 2 * hh + 1] / lc);
        }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, looked up once through the
// runtime (no link against libcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
    }
  }
  return fn;
}

// The map of a (B, heads, positions, D) bf16 operand at `base` with
// strides st (elements), boxes of 64 columns x `rows` rows; *heads_inner
// says which order of the middle dimensions it took.
cudaError_t encode(CUtensorMap* map, int* heads_inner, const void* base, const Strides& st,
                   int B, int heads, int positions, int D, int rows) {
  auto fn = tensor_map_encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  // a dimension of size 1 is never stepped: any stride the map takes
  auto stride = [](int64_t s, int n) {
    return static_cast<cuuint64_t>(n == 1 ? 16 : 2 * s);
  };
  const cuuint64_t sp = stride(st.s, positions), sh = stride(st.h, heads);
  const bool hi = heads > 1 && positions > 1 && sh < sp;
  *heads_inner = hi;
  const cuuint64_t np = static_cast<cuuint64_t>(positions), nh = static_cast<cuuint64_t>(heads);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), hi ? nh : np, hi ? np : nh,
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {hi ? sh : sp, hi ? sp : sh, stride(st.b, B)};
  const cuuint32_t r = static_cast<cuuint32_t>(rows);
  const cuuint32_t box[4] = {64, hi ? 1u : r, hi ? r : 1u, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                          dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DT, int NWG, int MODE>
int launch_wg(const Params& p0, int B, cudaStream_t stream) {
  using L = WgLayout<DT, NWG, MODE>;
  auto kernel = flash_attention_kernel_wgmma<DT, NWG, MODE>;
  TcParams tp;
  tp.p = p0;
  const int Hkv = p0.H / p0.G;
  tp.p.n_qt = (p0.S + L::BQ - 1) / L::BQ;
  cudaError_t e = encode(&tp.q, &tp.q_hi, p0.q, p0.qs, B, p0.H, p0.S, p0.D, L::BQ);
  if (e == cudaSuccess) e = encode(&tp.k, &tp.k_hi, p0.k, p0.ks, B, Hkv, p0.T, p0.D, L::BK);
  if (e == cudaSuccess) e = encode(&tp.v, &tp.v_hi, p0.v, p0.vs, B, Hkv, p0.T, p0.D, L::BK);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = L::kBytes;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = static_cast<int64_t>(tp.p.n_qt) * p0.H * B;
  kernel<<<static_cast<unsigned>(blocks), L::kThreads, smem, stream>>>(tp);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan (mirrored by wgmma_plan in kernels/flash_attention.py):
//   * two warpgroups of 64 rows each (BQ = 128) where that gives a block
//     per SM;
//   * else, where the keys span more than one tile (and D <= 128), kSplit:
//     64 rows, two warpgroups over alternate key tiles, which halves the
//     longest block's chain of tiles;
//   * else one warpgroup of 64 rows.
template <int DT>
int launch_wg_dt(const Params& p, int B, int sms, cudaStream_t stream) {
  auto blocks = [&](int bq) {
    return static_cast<int64_t>((p.S + bq - 1) / bq) * p.H * B;
  };
  if (blocks(128) >= sms) return launch_wg<DT, 2, kRows>(p, B, stream);
  if constexpr (DT <= 128) {
    if (p.T > kBK) return launch_wg<DT, 2, kSplit>(p, B, stream);
  }
  return launch_wg<DT, 1, kRows>(p, B, stream);
}

template <typename T, int DT, int BQ>
int launch_bq(Params p, int B, cudaStream_t stream) {
  using L = Layout<DT, BQ>;
  auto kernel = flash_attention_kernel<T, DT, BQ>;
  const size_t smem = sizeof(float) * L::kFloats;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  p.n_qt = (p.S + BQ - 1) / BQ;
  const int64_t blocks = static_cast<int64_t>(p.n_qt) * p.H * B;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// 64 rows when that gives a block per SM; 32 when that keeps half the
// SMs busy; else 16 (two 16-row blocks on one SM share its issue slots,
// so 16 pays only where 32 would leave most SMs idle).
template <typename T, int DT>
int launch_dt(const Params& p, int B, int sms, cudaStream_t stream) {
  auto blocks = [&](int bq) {
    return static_cast<int64_t>((p.S + bq - 1) / bq) * p.H * B;
  };
  if (blocks(64) >= sms) return launch_bq<T, DT, 64>(p, B, stream);
  if (2 * blocks(32) >= sms) return launch_bq<T, DT, 32>(p, B, stream);
  return launch_bq<T, DT, 16>(p, B, stream);
}

template <typename T>
int launch(Params p, int B, int sms, cudaStream_t stream) {
  if (B == 0 || p.S == 0) return 0;
  const int dt = p.D <= 16 ? 16 : p.D <= 32 ? 32 : p.D <= 64 ? 64
               : p.D <= 128 ? 128 : 256;
  // 16-byte chunks: D a multiple of 16 bytes, base pointers and every
  // stride 16-byte aligned
  const int64_t item = sizeof(T);
  auto al = [&](const void* ptr, const Strides& st) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
           (st.b * item) % 16 == 0 && (st.h * item) % 16 == 0 &&
           (st.s * item) % 16 == 0;
  };
  p.vec = (p.D * item) % 16 == 0 && al(p.q, p.qs) && al(p.k, p.ks) &&
          al(p.v, p.vs);
  // bfloat16 on the tensor cores; the tensor maps need every stride of a
  // dimension longer than 1 to be non-zero
  auto stepped = [&](const Strides& st, int heads, int positions) {
    return (B == 1 || st.b != 0) && (heads == 1 || st.h != 0) &&
           (positions == 1 || st.s != 0);
  };
  const int Hkv = p.H / p.G;
  if (sizeof(T) == 2 && p.vec && stepped(p.qs, p.H, p.S) && stepped(p.ks, Hkv, p.T) &&
      stepped(p.vs, Hkv, p.T)) {
    if (p.D <= 64) return launch_wg_dt<64>(p, B, sms, stream);
    if (p.D <= 128) return launch_wg_dt<128>(p, B, sms, stream);
    return launch_wg_dt<256>(p, B, sms, stream);
  }
  switch (dt) {
    case 16: return launch_dt<T, 16>(p, B, sms, stream);
    case 32: return launch_dt<T, 32>(p, B, sms, stream);
    case 64: return launch_dt<T, 64>(p, B, sms, stream);
    case 128: return launch_dt<T, 128>(p, B, sms, stream);
    default: return launch_dt<T, 256>(p, B, sms, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// q: (B, H, S, D), k and v: (B, Hkv, T, D), each given by its base
// pointer and (batch, head, position) strides in elements, the last
// dimension contiguous.  out: (B, H, S, D) contiguous.  D <= 256.  sms:
// the card's SM count, which picks the query tile.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int B, int H,
                               int Hkv, int S, int T, int D, int64_t q_sb,
                               int64_t q_sh, int64_t q_ss, int64_t k_sb,
                               int64_t k_sh, int64_t k_ss, int64_t v_sb,
                               int64_t v_sh, int64_t v_ss, float scale,
                               int causal, int has_window, int window,
                               int sms, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.H = H;
  p.G = H / Hkv;
  p.S = S;
  p.T = T;
  p.D = D;
  p.qs = Strides{q_sb, q_sh, q_ss};
  p.ks = Strides{k_sb, k_sh, k_ss};
  p.vs = Strides{v_sb, v_sh, v_ss};
  p.scale = scale;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, sms, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
