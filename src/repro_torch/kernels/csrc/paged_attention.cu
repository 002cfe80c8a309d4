// Paged decode attention as a CUDA kernel for Hopper.
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
// A fully masked row gives 0, never NaN: l is clamped at 1e-20 and an
// all-masked page leaves m at -inf without poisoning the running sums.
//
// Bound: bytes.  One launch reads every referenced (P, D) K and V tile
// once, B * MP * 2 * Hkv * P * D * itemsize: 2 MB for tinyllama-1.1b at
// B = MP = 8 in float32, about 0.6 us at 3.35 TB/s, against some
// 2 * B * H * MP * P * D * 2 = 4 MFLOP.  At that size launch latency,
// not bandwidth, sets the time; fusing the 22 per-layer launches of a
// decode step is later work.
//
// Design: one block per (KV head, sequence) runs the TPU kernel's
// sequential page grid dimension as a loop over the MP block-table
// entries.  Each page's K and V tiles are staged in shared memory as
// float (K rows padded by one float so the score loop, which walks K
// rows across threads, is free of bank conflicts), the G query heads
// of the group are scored against the tile, and the fp32 online
// softmax state (m, l, acc) lives in shared memory across pages.  The
// output is written in q's type.  The kernel takes the frame stride, so
// a per-layer view store[:, li] of an (F, L, Hkv, P, D) store is read in
// place with no copy.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int32_t* __restrict__ block_table,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ page_pos,
    const int32_t* __restrict__ q_pos, T* __restrict__ out, int MP, int G,
    int P, int D, int64_t k_frame_stride, int64_t v_frame_stride, float scale,
    int has_window, int window) {
  extern __shared__ float smem[];
  const int KS = D + 1;       // padded K row
  float* q_s = smem;          // (G, D), pre-scaled
  float* k_s = q_s + G * D;   // (P, D + 1)
  float* v_s = k_s + P * KS;  // (P, D)
  float* p_s = v_s + P * D;   // (G, P): scores, then probabilities
  float* acc = p_s + G * P;   // (G, D)
  float* m_s = acc + G * D;   // (G,)
  float* l_s = m_s + G;       // (G,)
  float* c_s = l_s + G;       // (G,) correction of this page

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int Hkv = gridDim.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t head0 = (static_cast<int64_t>(b) * Hkv + h) * G * D;

  for (int i = tid; i < G * D; i += nt) {
    q_s[i] = to_float(q[head0 + i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += nt) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  const bool pos_mode = page_pos != nullptr;
  const int qp = pos_mode ? q_pos[b] : 0;
  const int len = pos_mode ? 0 : lengths[b];
  const int64_t tile = static_cast<int64_t>(P) * D;

  for (int ip = 0; ip < MP; ++ip) {
    const int64_t entry = static_cast<int64_t>(b) * MP + ip;
    const int64_t frame = block_table[entry];
    const int start = pos_mode ? page_pos[entry] : ip * P;
    // the previous page's readers of k_s / v_s / p_s are done
    __syncthreads();
    const T* kt = k_pages + frame * k_frame_stride + h * tile;
    const T* vt = v_pages + frame * v_frame_stride + h * tile;
    for (int i = tid; i < P * D; i += nt) {
      k_s[(i / D) * KS + (i % D)] = to_float(kt[i]);
      v_s[i] = to_float(vt[i]);
    }
    __syncthreads();
    // scores (G, P), masked slots at -inf
    for (int i = tid; i < G * P; i += nt) {
      const int g = i / P;
      const int j = i % P;
      const int pos = start + j;
      bool valid;
      if (pos_mode) {
        valid = pos <= qp && (!has_window || pos > qp - window);
      } else {
        valid = pos < len;
      }
      float s = -INFINITY;
      if (valid) {
        const float* qr = q_s + g * D;
        const float* kr = k_s + j * KS;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        s = a;
      }
      p_s[i] = s;
    }
    __syncthreads();
    // online softmax update, one thread per query head of the group
    for (int g = tid; g < G; g += nt) {
      float* pr = p_s + g * P;
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int j = 0; j < P; ++j) m_new = fmaxf(m_new, pr[j]);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int j = 0; j < P; ++j) {
        const float p = pr[j] == -INFINITY ? 0.f : expf(pr[j] - m_safe);
        pr[j] = p;
        sum += p;
      }
      const float corr = m_prev == -INFINITY ? 0.f : expf(m_prev - m_safe);
      l_s[g] = l_s[g] * corr + sum;
      c_s[g] = corr;
      m_s[g] = m_new;
    }
    __syncthreads();
    // acc = acc * corr + p @ v
    for (int i = tid; i < G * D; i += nt) {
      const int g = i / D;
      const int d = i % D;
      const float* pr = p_s + g * P;
      float a = 0.f;
      for (int j = 0; j < P; ++j) a = fmaf(pr[j], v_s[j * D + d], a);
      acc[i] = acc[i] * c_s[g] + a;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += nt) {
    out[head0 + i] = from_float<T>(acc[i] / fmaxf(l_s[i / D], 1e-20f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bt,
           const void* lengths, const void* page_pos, const void* q_pos,
           void* out, int B, int MP, int Hkv, int G, int P, int D,
           int64_t k_fs, int64_t v_fs, float scale, int has_window,
           int window, void* stream) {
  if (B == 0) return 0;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(G) * D * 2 +
                       static_cast<size_t>(P) * (D + 1) +
                       static_cast<size_t>(P) * D +
                       static_cast<size_t>(G) * P + 3 * static_cast<size_t>(G));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(Hkv, B);
  paged_attention_kernel<T><<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(bt),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(page_pos),
      static_cast<const int32_t*>(q_pos), static_cast<T*>(out), MP, G, P, D,
      k_fs, v_fs, scale, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, K, V and out share it).
// q, out: (B, Hkv * G, D) contiguous.  k, v: frame f starts at
// f * frame_stride elements and holds a contiguous (Hkv, P, D) block.
// bt, page_pos: (B, MP) int32; lengths, q_pos: (B,) int32.  page_pos
// null selects length mode.
extern "C" int paged_attention(int dtype, const void* q, const void* k,
                               const void* v, const void* bt,
                               const void* lengths, const void* page_pos,
                               const void* q_pos, void* out, int B, int MP,
                               int Hkv, int G, int P, int D, int64_t k_fs,
                               int64_t v_fs, float scale, int has_window,
                               int window, void* stream) {
  if (dtype == 0) {
    return launch<float>(q, k, v, bt, lengths, page_pos, q_pos, out, B, MP,
                         Hkv, G, P, D, k_fs, v_fs, scale, has_window, window,
                         stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, bt, lengths, page_pos, q_pos, out,
                                 B, MP, Hkv, G, P, D, k_fs, v_fs, scale,
                                 has_window, window, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
