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
// it (4 us); at S = 2048, H = 32, D = 128, 34 GFLOP (0.5 ms).  TF32 and
// the tensor cores stay off: parity with the reference is defined in
// float32.  What bounds this kernel is the rate at which float32 FMAs
// can be fed from shared memory.
//
// Design: one block per (query tile of BQ = 16, 32 or 64 rows, head,
// batch), 256 threads; a loop inside the block over 64-key tiles
// takes the place of the TPU kernel's sequential key-tile grid
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
//     tile.  bfloat16 rows are read with 16-byte loads and converted to
//     float on the way in; rows that are not 16-byte aligned element by
//     element (the general path).  Shared memory holds float either way.
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
// The kernel takes the (batch, head, position) strides of q, k and v,
// so the engine's (B, S, H, D) projections are read through a
// transposed view with no copy; each row of D must be contiguous.  out
// is (B, H, S, D) contiguous, in q's type.
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
