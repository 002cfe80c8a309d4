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
// bfloat16 with 16-byte aligned rows (D a multiple of 8): the tensor
// cores (flash_attention_kernel_mma).  The TPU kernel widens q, k and v
// to float32 and keeps the scores and p in float32 up to one rounding at
// the output; here q.k^T is mma.sync m16n8k16 with bf16 operands and
// float32 sums (the products of two bf16 are exact in float32, so only
// the order of the sum differs), and p.V splits p into three bf16 parts,
// bf16(p), bf16 of the rest and bf16 of what is left, three products
// against the same V fragments summed in float32: 3 x 8 bits hold p's
// 24, so p is kept whole.  One rounding of p would move each weight by
// up to 2^-9; two parts keep it to 2^-18, which on the card rounded many
// times more outputs away from the float32 reference than the CUDA-core
// path does and split a bf16 serve lifecycle of chip_smoke.py at a near
// tie.  What bounds the kernel is the tensor cores' issue rate under
// mma.sync (wgmma's asynchronous 64-row products reach more of the 989
// TFLOP/s) and, at a short prompt or a grid that leaves SMs idle, the
// latency of one warp's chain of key tiles.  Design (FlashAttention-2's
// shape, on this card):
//   * Warps.  A block has 8 row warps of 16 query rows (BQ = 128) where
//     that gives a block per SM, else 4 (BQ = 64); where even that leaves
//     SMs idle and the keys span more than one tile, 2 row warps (32
//     rows, twice the blocks) in 4 key groups (2 at D = 128): group g
//     takes key tiles g, g + KG, ..., and the groups' (m, l, o) merge
//     through shared memory at the end.  The grid's order is the float32
//     path's, heaviest tiles first; a warp skips a key tile wholly
//     outside its rows' causal or window range.
//   * Loads.  q and the K and V tiles of 64 keys arrive by TMA: the host
//     encodes a tensor map of each operand per call (its strides, so the
//     engine's transposed views need no copy), and one thread asks for
//     64-column boxes that land 128-byte swizzled, so that ldmatrix's 8
//     rows of a matrix hit 8 distinct bank groups; the hardware zero-fills
//     rows past T or S and columns past D.  Rounds of KG tiles go through
//     a ring of 3 stages (D <= 64) or 2, each completing on its mbarrier.
//     Per-thread 16-byte cp.async spent most of a tile's time in issue on
//     the H100, and per-row bulk copies clogged the memory pipe.
//   * Softmax on the fragments.  In the m16n8 accumulator lane i holds
//     rows i / 4 and i / 4 + 8, so a row's max and sum take two
//     __shfl_xor_sync in its quad; scores are kept in log2 units (scale
//     times log2 e) for ex2.approx; masks are applied only on a tile that
//     is not wholly valid for the warp.  The row sum stays per lane,
//     rescaled by corr, and is summed over the quad once, at the end.
//     The guards are the float32 path's.  The accumulator of the scores
//     is, lane for lane, the A fragment of p.V: p never leaves registers.
//   * Widths.  A template on DT in {64, 128, 256}, whole 64-column slabs;
//     the k-steps of q.k^T and the output tiles stop at D (16 runs 1 of
//     4 steps, 80 and 96 run 5 and 6 of 8).  q's fragments stay in
//     registers up to D = 64 at 8 warps, 128 at fewer.
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

// ---- bfloat16 on the tensor cores ------------------------------------------
// A bf16 pair in one 32-bit register: lo in the low half (the lower column
// of an mma fragment), hi in the high half.
__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x, y) as three bf16 pairs whose sum keeps them to about 2^-27:
// hi = bf16(x, y), mid = bf16(x - hi, y - hi), lo = bf16(x - hi - mid,
// y - hi - mid) (each difference is exact in float32).
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi, unsigned& mid,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));
}

// Four 8x8 b16 matrices from shared memory: lane i gives the shared
// address of row i % 8 of matrix i / 8, and receives row i / 4, columns
// 2 (i % 4) and + 1 of each (.trans: of each matrix transposed).
__device__ __forceinline__ void ldsm_x4(unsigned a, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned a, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16x16, row) . b (16x8, col), bf16 in, float32 sums.  Not
// volatile: the compiler may move it among the loads.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// A tile of `rows` rows in shared memory as TMA writes it: DT / 64 slabs
// of 64 columns, each rows x 128 bytes, 16-byte chunk c of row r at chunk
// c ^ (r % 8), so that the 8 rows an ldmatrix matrix reads fall in 8
// distinct bank groups.  The byte offset of chunk c (8 columns) of row r.
template <int ROWS>
__device__ __forceinline__ unsigned swz(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// NR warps of 16 query rows each, KG groups of them over the key tiles
// (group g takes the tiles g, g + KG, ... of the same rows).
template <int DT, int NR, int KG>
struct TcLayout {
  static_assert(DT % 64 == 0, "whole 64-column slabs");
  static constexpr int BQ = 16 * NR;                // query rows
  static constexpr int NW = NR * KG;                // warps
  // two blocks of 8 warps an SM (128 registers a thread) up to D = 128
  static constexpr int kMinBlocks = DT <= 128 && NW == 8 ? 2 : 1;
  static constexpr int kStages = DT <= 64 ? 3 : 2;  // rounds of tiles in flight
  static constexpr int kQ = BQ * DT * 2;            // bytes
  static constexpr int kKV = kBK * DT * 2;          // one K or V tile
  static constexpr int kStage = 2 * KG * kKV;       // K, then V, of KG tiles
  static constexpr int kData = kQ + kStages * kStage;
  static constexpr int kBytes = 1024 + kData + 8 * kStages;  // 1 KB to align
  // every group's o, m and l, lane by lane, over the stages
  static constexpr int kMerge = KG == 1 ? 0 : 4 * KG * NR * 32 * (DT / 2 + 4);
  static_assert(kBytes <= kMaxSmem, "shared memory");
  static_assert(kMerge <= kStages * kStage, "merge buffer");
};

// The bfloat16 function of flash_attention_kernel (16-byte aligned rows,
// D a multiple of 8) with both products on the tensor cores.  Row warp
// r owns query rows q0 + 16 r + [0, 16); in mma's m16n8 accumulator
// lane i holds rows i / 4 and i / 4 + 8, columns 2 (i % 4) and + 1 of
// each 8-column tile, so a row's max and sum take two shuffles in its
// quad of lanes, and the probabilities, still in registers, are the A
// fragment of p.V.  Named under flash_attention_kernel, so that a
// profile counts it with the wrapper's launches.
template <int DT, int NR, int KG>
__global__ void __launch_bounds__(NR * KG * 32, TcLayout<DT, NR, KG>::kMinBlocks)
    flash_attention_kernel_mma(const __grid_constant__ TcParams tp) {
  using L = TcLayout<DT, NR, KG>;
  using bf16 = __nv_bfloat16;
  const Params& p = tp.p;
  constexpr int BQ = L::BQ;
  constexpr int KT = DT / 16;  // 16-column steps of q.k^T
  constexpr int NO = DT / 8;   // 8-column tiles of the output
  constexpr int NS = DT / 64;  // 64-column slabs of a tile
  constexpr bool kQRegs = DT <= (L::kMinBlocks == 2 ? 64 : 128);  // q's fragments in registers
  extern __shared__ __align__(16) unsigned char sm_raw[];
  unsigned char* sm_bytes = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(sm_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const unsigned q_s = smem_u32(sm_bytes);  // (BQ, DT), swizzled
  const unsigned kv_s = q_s + L::kQ;        // stages x (K, V) x KG x (BK, DT)
  const unsigned bars = kv_s + L::kStages * L::kStage;

  const int hb = gridDim.x / p.n_qt;  // heads x batch
  const int qt = p.n_qt - 1 - static_cast<int>(blockIdx.x) / hb;
  const int rem = static_cast<int>(blockIdx.x) % hb;
  const int h = rem % p.H;
  const int b = rem / p.H;
  const int hk = h / p.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp % NR, grp = warp / NR;  // row warp, key group
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qt * BQ;
  const int wq0 = q0 + 16 * rw;
  const int D16 = (p.D + 15) / 16;  // 16-column steps that hold a column < D
  const int D8 = p.D / 8;           // output tiles

  const int q_last = min(q0 + BQ, p.S) - 1;
  const int k_end = p.causal ? min(p.T, q_last + 1) : p.T;
  const int k_begin = p.has_window ? max(0, q0 - p.window + 1) : 0;
  const int kt0 = k_begin / kBK;
  const int n_tiles = k_end > kt0 * kBK ? (k_end - kt0 * kBK + kBK - 1) / kBK : 0;
  const int n_rounds = (n_tiles + KG - 1) / KG;  // KG tiles a round
  // this warp's keys: tiles wholly outside them are skipped
  const bool w_live = wq0 < p.S;
  const int w_end = p.causal ? min(p.T, min(wq0 + 15, p.S - 1) + 1) : p.T;
  const int w_begin = p.has_window ? max(0, wq0 - p.window + 1) : 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < L::kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8 * s)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // round i's tiles (KG i + group) into stage i % kStages, and q with
  // round 0, by thread 0: a box of 64 columns a slab
  auto issue = [&](int i) {
    const int st = i % L::kStages;
    const unsigned bar = bars + 8 * st;
    const unsigned stage = kv_s + st * L::kStage;
    int tiles = 0;
#pragma unroll
    for (int gi = 0; gi < KG; ++gi) tiles += KG * i + gi < n_tiles;
    const unsigned bytes = tiles * 2 * L::kKV + (i == 0 ? L::kQ : 0);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
#pragma unroll
    for (int gi = 0; gi < KG; ++gi) {
      const int tile = KG * i + gi;
      if (tile >= n_tiles) continue;
      const int k0 = (kt0 + tile) * kBK;
#pragma unroll
      for (int sl = 0; sl < NS; ++sl) {
        tma_box(stage + gi * L::kKV + sl * kBK * 128, tp.k, tp.k_hi, 64 * sl, k0, hk, b,
                bar);
        tma_box(stage + (KG + gi) * L::kKV + sl * kBK * 128, tp.v, tp.v_hi, 64 * sl, k0, hk,
                b, bar);
      }
    }
    if (i == 0) {
#pragma unroll
      for (int sl = 0; sl < NS; ++sl)
        tma_box(q_s + sl * BQ * 128, tp.q, tp.q_hi, 64 * sl, q0, h, b, bar);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < L::kStages - 1; ++i)
      if (i < n_rounds) issue(i);
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this lane's columns
  const float sl2 = p.scale * 1.4426950408889634f;  // scores in log2 units
  unsigned qf[kQRegs ? KT : 1][4];
  // lane's ldmatrix rows and 8-column chunks: q and V take row (lane % 8)
  // + 8 ((lane / 8) % 2) and chunk lane / 16, K row (lane % 8) + 8 (lane /
  // 16) and chunk (lane / 8) % 2
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_chunk = lane >> 4;
  const int k_row = (lane & 7) + 8 * (lane >> 4);
  const int k_chunk = (lane >> 3) & 1;

  for (int i = 0; i < n_rounds; ++i) {
    mbar_wait(bars + 8 * (i % L::kStages), (i / L::kStages) & 1);
    __syncthreads();  // round i is in; every reader of round i - 1 is done
    if (tid == 0 && i + L::kStages - 1 < n_rounds) issue(i + L::kStages - 1);
    if (kQRegs && i == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQRegs ? KT : 1); ++kk)
        if (kk < D16) ldsm_x4(q_s + swz<BQ>(16 * rw + a_row, 2 * kk + a_chunk), qf[kk]);
    }
    const int tile = KG * i + grp;
    const int k0 = (kt0 + tile) * kBK;
    if (tile >= n_tiles || !w_live || k0 >= w_end || k0 + kBK <= w_begin) continue;
    const unsigned ks = kv_s + (i % L::kStages) * L::kStage + grp * L::kKV;
    const unsigned vs = ks + KG * L::kKV;

    // s = q . k^T: 16 rows x 64 keys, 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk >= D16) break;
      unsigned a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int c = 0; c < 4; ++c) a[c] = qf[kk][c];
      } else {
        ldsm_x4(q_s + swz<BQ>(16 * rw + a_row, 2 * kk + a_chunk), a);
      }
      unsigned bk[4][4];
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2)
        ldsm_x4(ks + swz<kBK>(16 * j2 + k_row, 2 * kk + k_chunk), bk[j2]);
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        mma_bf16(s[2 * j2], a, bk[j2][0], bk[j2][1]);
        mma_bf16(s[2 * j2 + 1], a, bk[j2][2], bk[j2][3]);
      }
    }

    // masks (only on a tile that is not wholly valid for the warp's
    // rows), then the online softmax of rows g and g + 8 over the quad
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] *= sl2;
    const bool full = k0 + kBK <= p.T && (!p.causal || k0 + kBK - 1 <= wq0) &&
                      (!p.has_window || k0 > wq0 + 15 - p.window);
    if (!full) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qp = wq0 + g + 8 * (c >> 1);
          const int kp = k0 + 8 * j + 2 * t4 + (c & 1);
          const bool valid = kp < p.T && (!p.causal || kp <= qp) &&
                             (!p.has_window || kp > qp - p.window);
          if (!valid) s[j][c] = -INFINITY;
        }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m[hh] == -INFINITY ? 0.f : exp2_approx(m[hh] - m_safe);
      float sum0 = 0.f, sum1 = 0.f;  // a masked score gives 2^-inf = 0
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][2 * hh] = exp2_approx(s[j][2 * hh] - m_safe);
        s[j][2 * hh + 1] = exp2_approx(s[j][2 * hh + 1] - m_safe);
        sum0 += s[j][2 * hh];
        sum1 += s[j][2 * hh + 1];
      }
      l[hh] = l[hh] * corr + (sum0 + sum1);
      m[hh] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * hh] *= corr;
        o[n][2 * hh + 1] *= corr;
      }
    }

    // o += p . v, p split into three bf16 parts against the same V fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned pp[3][4];  // the parts of p: hi, mid, lo
      split_bf16(s[2 * kk][0], s[2 * kk][1], pp[0][0], pp[1][0], pp[2][0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], pp[0][1], pp[1][1], pp[2][1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], pp[0][2], pp[1][2], pp[2][2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], pp[0][3], pp[1][3], pp[2][3]);
      // two 16-column steps of V a round: their four tiles take each part
      // of p in turn
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; n2 += 2) {
        if (n2 >= D16) break;
        const bool two = NO / 2 > 1 && n2 + 1 < D16;
        unsigned bv[2][4];
        ldsm_x4_trans(vs + swz<kBK>(16 * kk + a_row, 2 * n2 + a_chunk), bv[0]);
        if (two) ldsm_x4_trans(vs + swz<kBK>(16 * kk + a_row, 2 * n2 + 2 + a_chunk), bv[1]);
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          mma_bf16(o[2 * n2], pp[part], bv[0][0], bv[0][1]);
          mma_bf16(o[2 * n2 + 1], pp[part], bv[0][2], bv[0][3]);
          if (two) {
            mma_bf16(o[2 * n2 + 2], pp[part], bv[1][0], bv[1][1]);
            mma_bf16(o[2 * n2 + 3], pp[part], bv[1][2], bv[1][3]);
          }
        }
      }
    }
  }

  // KG > 1: every group's o, m and l, lane by lane, into shared memory
  // (over the stages); then warp (g, r) merges, in group order, and
  // writes output tiles [g NO / KG, (g + 1) NO / KG) of row warp r
  int n_lo = 0, n_hi = NO;
  if constexpr (KG > 1) {
    __syncthreads();  // every warp is done with the stages
    constexpr int kSlot = 32 * (4 * NO + 4);  // floats a warp
    float* mg = reinterpret_cast<float*>(sm_bytes + L::kQ) + rw * kSlot + lane;
    constexpr int kGroup = NR * kSlot;        // floats a group
    {
      float* my = mg + grp * kGroup;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) my[32 * (4 * n + c)] = o[n][c];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        my[32 * (4 * NO + hh)] = m[hh];
        my[32 * (4 * NO + 2 + hh)] = l[hh];
      }
    }
    __syncthreads();
    n_lo = grp * (NO / KG);
    n_hi = n_lo + NO / KG;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mq[KG], m_new = -INFINITY;
#pragma unroll
      for (int q = 0; q < KG; ++q) {
        mq[q] = mg[q * kGroup + 32 * (4 * NO + hh)];
        m_new = fmaxf(m_new, mq[q]);
      }
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float lt = 0.f;
#pragma unroll
      for (int q = 0; q < KG; ++q) {
        mq[q] = exp2_approx(mq[q] - m_safe);  // the group's weight
        lt += mg[q * kGroup + 32 * (4 * NO + 2 + hh)] * mq[q];
      }
      l[hh] = lt;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (n < n_lo || n >= n_hi) continue;
#pragma unroll
        for (int c = 2 * hh; c < 2 * hh + 2; ++c) {
          float x = 0.f;
#pragma unroll
          for (int q = 0; q < KG; ++q) x += mg[q * kGroup + 32 * (4 * n + c)] * mq[q];
          o[n][c] = x;
        }
      }
    }
  }

  // out = o / l, rows < S, columns < D
  if (!w_live) return;
  bf16* ob = static_cast<bf16*>(p.out) +
             (static_cast<int64_t>(b) * p.H + h) * static_cast<int64_t>(p.S) * p.D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const float lc = fmaxf(lt, 1e-20f);
    const int qp = wq0 + g + 8 * hh;
    if (qp >= p.S) continue;
    bf16* orow = ob + static_cast<int64_t>(qp) * p.D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (n >= D8) break;
      if (n < n_lo || n >= n_hi) continue;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * hh] / lc, o[n][2 * hh + 1] / lc);
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

template <int DT, int NR, int KG>
int launch_mma(const Params& p0, int B, cudaStream_t stream) {
  using L = TcLayout<DT, NR, KG>;
  auto kernel = flash_attention_kernel_mma<DT, NR, KG>;
  TcParams tp;
  tp.p = p0;
  tp.p.n_qt = (p0.S + L::BQ - 1) / L::BQ;
  const int Hkv = p0.H / p0.G;
  cudaError_t e = encode(&tp.q, &tp.q_hi, p0.q, p0.qs, B, p0.H, p0.S, p0.D, L::BQ);
  if (e == cudaSuccess) e = encode(&tp.k, &tp.k_hi, p0.k, p0.ks, B, Hkv, p0.T, p0.D, kBK);
  if (e == cudaSuccess) e = encode(&tp.v, &tp.v_hi, p0.v, p0.vs, B, Hkv, p0.T, p0.D, kBK);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = L::kBytes;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t blocks = static_cast<int64_t>(tp.p.n_qt) * p0.H * B;
  kernel<<<static_cast<unsigned>(blocks), L::NW * 32, smem, stream>>>(tp);
  return static_cast<int>(cudaGetLastError());
}

// 8 row warps (128 rows) where that gives a block per SM; else 4 (64
// rows); and where even that leaves SMs idle and the keys span more than
// one tile, blocks of 2 row warps (32 rows, twice the blocks) in 4
// groups over alternate key tiles (2 groups at D = 128), which cuts the
// longest block's chain of tiles by as much.
template <int DT>
int launch_mma_dt(const Params& p, int B, int sms, cudaStream_t stream) {
  auto blocks = [&](int bq) {
    return static_cast<int64_t>((p.S + bq - 1) / bq) * p.H * B;
  };
  if (blocks(128) >= sms) return launch_mma<DT, 8, 1>(p, B, stream);
  if constexpr (DT <= 128) {
    if (blocks(64) < sms && p.T > kBK) return launch_mma<DT, 2, DT <= 64 ? 4 : 2>(p, B, stream);
  }
  return launch_mma<DT, 4, 1>(p, B, stream);
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
    if (p.D <= 64) return launch_mma_dt<64>(p, B, sms, stream);
    if (p.D <= 128) return launch_mma_dt<128>(p, B, sms, stream);
    return launch_mma_dt<256>(p, B, sms, stream);
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
