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
// the 67 TFLOP/s float32 rate outside the tensor cores; the grid is
// 64 blocks, so latency sets the time.  At S = 512, D = 64 the causal
// work, 269 MFLOP, bounds it (4 us).  TF32 and the tensor cores stay
// off: parity with the reference is defined in float32.
//
// Design: one block per (query tile of 32 rows, head, batch); the TPU
// kernel's sequential key-tile grid dimension is a loop inside the
// block over 32-key tiles, starting at the first tile the window
// reaches and stopping after the causal diagonal, so tiles wholly
// masked are never loaded.  The q tile (pre-scaled), the K tile (rows
// padded by one float, so the score loop, whose threads walk K rows,
// is free of bank conflicts), the V tile, the score tile and the
// (32, D) accumulator live in shared memory as float.  Scores and p.V
// are float32 FMAs; one warp per query row runs the online-softmax
// update with shuffles (32 keys, one a lane).  The kernel takes the
// (batch, head, position) strides of q, k and v, so the engine's
// (B, S, H, D) projections are read through a transposed view with no
// copy; each row of D must be contiguous.  out is (B, H, S, D)
// contiguous, in q's type.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 32;  // query rows per block
constexpr int kBK = 32;  // keys per tile: one per lane in the softmax
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  int64_t b, h, s;
};

template <typename T>
__global__ void flash_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ out, int H, int G,
                                       int S, int T_len, int D, Strides qs,
                                       Strides ks, Strides vs, float scale,
                                       int causal, int has_window,
                                       int window) {
  extern __shared__ float smem[];
  const int KS = D + 1;
  float* q_s = smem;              // (BQ, D), pre-scaled
  float* k_s = q_s + kBQ * D;     // (BK, D + 1)
  float* v_s = k_s + kBK * KS;    // (BK, D)
  float* p_s = v_s + kBK * D;     // (BQ, BK): scores, then probabilities
  float* acc = p_s + kBQ * kBK;   // (BQ, D)
  float* m_s = acc + kBQ * D;     // (BQ,)
  float* l_s = m_s + kBQ;         // (BQ,)
  float* c_s = l_s + kBQ;         // (BQ,) correction of this tile

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    q_s[i] = q0 + r < S ? to_float(qb[(q0 + r) * qs.s + d]) * scale : 0.f;
    acc[i] = 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? min(T_len, q_last + 1) : T_len;
  const int k_begin = has_window ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    // the previous tile's readers of k_s / v_s / p_s are done
    __syncthreads();
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D;
      const int d = i % D;
      const bool in = k0 + j < T_len;
      // pad rows are zero: p = 0 there, and 0 * garbage could be NaN
      k_s[j * KS + d] = in ? to_float(kb[(k0 + j) * ks.s + d]) : 0.f;
      v_s[i] = in ? to_float(vb[(k0 + j) * vs.s + d]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK;
      const int j = i % kBK;
      const int qp = q0 + r;
      const int kp = k0 + j;
      const bool valid = kp < T_len && (!causal || kp <= qp) &&
                         (!has_window || kp > qp - window);
      float s = -INFINITY;
      if (valid) {
        const float* qr = q_s + r * D;
        const float* kr = k_s + j * KS;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        s = a;
      }
      p_s[i] = s;
    }
    __syncthreads();
    // online softmax update: one warp per query row, one key per lane
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      const float s = p_s[r * kBK + lane];
      float m_cur = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(kFull, m_cur, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, m_cur);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float p = s == -INFINITY ? 0.f : expf(s - m_safe);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      p_s[r * kBK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = m_prev == -INFINITY ? 0.f : expf(m_prev - m_safe);
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * corr + p @ v
    for (int i = tid; i < kBQ * D; i += kThreads) {
      const int r = i / D;
      const int d = i % D;
      const float* pr = p_s + r * kBK;
      float a = 0.f;
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) a = fmaf(pr[j], v_s[j * D + d], a);
      acc[i] = acc[i] * c_s[r] + a;
    }
  }
  __syncthreads();
  T* ob = out + (static_cast<int64_t>(b) * H + h) * S * D;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    if (q0 + r < S) {
      ob[static_cast<int64_t>(q0) * D + i] =
          from_float<T>(acc[i] / fmaxf(l_s[r], 1e-20f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int S, int T_len, int D, Strides qs, Strides ks,
           Strides vs, float scale, int causal, int has_window, int window,
           void* stream) {
  if (B == 0 || S == 0) return 0;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBQ) * D * 2 +
                       static_cast<size_t>(kBK) * (D + 1) +
                       static_cast<size_t>(kBK) * D +
                       static_cast<size_t>(kBQ) * kBK + 3 * kBQ);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T><<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, H / Hkv, S, T_len,
      D, qs, ks, vs, scale, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// q: (B, H, S, D), k and v: (B, Hkv, T, D), each given by its base
// pointer and (batch, head, position) strides in elements, the last
// dimension contiguous.  out: (B, H, S, D) contiguous.  D <= 256.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int B, int H,
                               int Hkv, int S, int T, int D, int64_t q_sb,
                               int64_t q_sh, int64_t q_ss, int64_t k_sb,
                               int64_t k_sh, int64_t k_ss, int64_t v_sb,
                               int64_t v_sh, int64_t v_ss, float scale,
                               int causal, int has_window, int window,
                               void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss};
  if (dtype == 0) {
    return launch<float>(q, k, v, out, B, H, Hkv, S, T, D, qs, ks, vs, scale,
                         causal, has_window, window, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, out, B, H, Hkv, S, T, D, qs, ks,
                                 vs, scale, causal, has_window, window,
                                 stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
