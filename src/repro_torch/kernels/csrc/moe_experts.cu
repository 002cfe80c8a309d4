// The expert SwiGLU of an MoE layer over the filled capacity slots only.
//
// No TPU kernel: the JAX package computes the experts as three einsums
// in XLA over all E * C capacity slots (repro/models/moe.py:127-131),
//   h  = silu(xe @ wi_gate[e]) * (xe @ wi_up[e])     (E, C, F)
//   ye = h @ wo[e]                                    (E, C, d)
// and the port ran the same einsums through cuBLAS.  Slot r of expert e
// holds a token only for r < min(counts[e], C) (moe_route places them
// first come first served), and moe_combine reads no other slot, so these
// kernels compute exactly those rows and leave the others unwritten.  At
// the drop-free capacity (C = T) that is T * k of the E * T rows.
//
// Two launches: moe_experts_gate_up reads each column slab of wi_gate[e]
// and wi_up[e] once for all of the tile's rows and writes
// h = silu(g) * u for the filled rows; moe_experts_down does h @ wo[e].
// float32: FFMA on the CUDA cores, each output a sum over k in ascending
// order within a thread (no TF32, no split sums).  bfloat16 (the _bf16
// entry points): wgmma on the tensor cores from a TMA ring, float32 sums,
// h and ye rounded to bf16 once each (moe_experts_kernel_wgmma, below).
//
// The counts stay on the device.  The grid is (column tiles, E, row
// tiles of BM) from the shapes alone; a block reads counts[e] first and
// leaves at once when its row tile holds no filled row, so an expert
// with no token reads no weight byte.  The row tile is the slowest grid
// index, so the first tiles of every expert are scheduled first and the
// blocks past the counts run last, each for a few instructions.
//
// What bounds the float32 kernel, and its two plans (the wrapper picks
// one from the mean filled rows an expert, kernels/moe_experts.py; the
// switch point and the tiles were timed on the H100, PERF.md):
// * skinny (decode and short prefills: up to 64 rows an expert).  The
//   weights are read once (phi3.5-moe: 16 x 3 x 4096 x 6400 floats,
//   5.03 GB a layer, 1.5 ms at 3.35 TB/s) and each weight is used for a
//   few rows, so the bytes bound it.  BM = 32: a block streams a slab of
//   64 columns of one expert's weights through a four-stage cp.async ring
//   in shared memory and holds all the tile's rows against it in
//   registers (eight contiguous rows a warp); a warp whose rows lie past
//   the count skips the arithmetic but still issues its share of the
//   copies.  More rows than 32 take further row tiles, each streaming the
//   slab again.
// * tiled (prefill: tens to thousands of rows an expert).  Each weight is
//   used for many rows, so the float32 FMA rate (67 TFLOP/s) bounds it.
//   BM = 64 rows x 64 columns of each of gate and up (128 columns of
//   wo), a thread 8 rows x 4 (8) columns, four stages, two blocks an SM;
//   a thread's rows interleave with its warp neighbour's so the two row
//   groups of a warp read neighbouring rows of A without a bank conflict.
//   Tiles of 128 rows were slower at every shape timed (PERF.md); the
//   last row tile of an expert is partly empty, and wider tiles waste more.
//
// Shared memory: A is stored as rows of BK (+4 padding) floats, B as BK
// rows of BN floats a matrix; the copies are 16 bytes (cp.async.cg), so
// d and F are multiples of 4 floats and every pointer 16-byte aligned
// (the wrapper checks).  Edges (k past K, columns past N, rows past the
// count) are zero-filled copies that read nothing.
//
// bfloat16 has one plan at every shape, 128 rows by 256 output columns a
// block (below): on the card it was as fast as or faster than a 32-row
// mma.sync variant at every shape timed, decode included, because a
// decode block is bound by its weight bytes whatever its rows (PERF.md).
//
// The engagement counter: with rows non-null (the gate and up launch),
// one thread an expert adds min(counts[e], C) to *rows, one atomic an
// expert a launch; the wrapper reads it on demand.

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace {

template <int BM_, int BN_, int BK_, int TM_, int TN_, int STAGES_, bool CONTIG_,
          int AV_, int MIN_BLOCKS_>
struct Cfg {
  static constexpr int BM = BM_;          // rows of a tile
  static constexpr int BN = BN_;          // columns of a tile, each matrix
  static constexpr int BK = BK_;          // depth of a stage
  static constexpr int TM = TM_;          // rows a thread
  static constexpr int TN = TN_;          // columns a thread, each matrix
  static constexpr int STAGES = STAGES_;  // stages in flight
  static constexpr bool CONTIG = CONTIG_; // a thread's rows contiguous
  static constexpr int AV = AV_;          // k values of A a shared-memory load
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int V = TN < 4 ? TN : 4;  // columns of B a shared-memory load
  static constexpr int G = TN / V;           // column groups a thread
  static constexpr int TX = BN / TN;
  static constexpr int TY = BM / TM;
  static constexpr int THREADS = TX * TY;
  static constexpr int AS = BK + 4;          // an A row in shared memory
  static_assert(BN % TN == 0 && BM % TM == 0 && BK % AV == 0 && BK % 4 == 0, "tile");
  static_assert(!CONTIG || TX % 32 == 0, "a contiguous plan gives a warp one row group");

  template <int NB>
  __host__ __device__ static constexpr int stage_floats() {
    return BM * AS + NB * BK * BN;
  }
  template <int NB>
  __host__ __device__ static constexpr int smem_bytes() {
    return STAGES * stage_floats<NB>() * static_cast<int>(sizeof(float));
  }
};

using Skinny = Cfg<32, 64, 16, 8, 2, 4, true, 4, 4>;
using TiledGateUp = Cfg<64, 64, 16, 8, 4, 4, false, 2, 2>;
using TiledDown = Cfg<64, 128, 16, 8, 8, 4, false, 2, 2>;

__device__ __forceinline__ float silu(float g) {
  return g / (1.0f + expf(-g));  // as torch's float32 silu
}

template <int N>
__device__ __forceinline__ void ld_smem(const float* p, float* x) {
  float v[N];
  ld_vec<N>(p, v);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = v[i];
}

// out[e, r, :] over the filled rows r of one (column tile, expert, row
// tile): NB = 2 is silu(a @ b0) * (a @ b1), NB = 1 is a @ b0.
// a (E, C, K), b (E, K, N), out (E, C, N), all row-major.
template <class P, int NB>
__global__ void __launch_bounds__(P::THREADS, P::MIN_BLOCKS)
    moe_experts_kernel(const float* __restrict__ a, const int* __restrict__ counts,
                       const float* __restrict__ b0, const float* __restrict__ b1,
                       float* __restrict__ out, unsigned long long* __restrict__ rows,
                       int C, int K, int N) {
  const int e = blockIdx.y;
  const int filled = min(counts[e], C);
  if (rows != nullptr && blockIdx.x == 0 && blockIdx.z == 0 && threadIdx.x == 0 &&
      filled > 0) {
    atomicAdd(rows, static_cast<unsigned long long>(filled));
  }
  const int row0 = blockIdx.z * P::BM;
  const int n = min(filled - row0, P::BM);  // filled rows of this tile
  if (n <= 0) return;
  const int col0 = blockIdx.x * P::BN;

  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = P::template stage_floats<NB>();
  const float* a_e = a + (static_cast<size_t>(e) * C + row0) * K;
  const size_t b_e = static_cast<size_t>(e) * K * N;

  auto load = [&](int kt, int slot) {
    float* as = smem + slot * kStage;
    float* bs = as + P::BM * P::AS;
    const int k0 = kt * P::BK;
    constexpr int AVEC = P::BM * (P::BK / 4);  // 16-byte vectors of the A tile
#pragma unroll
    for (int it = 0; it < (AVEC + P::THREADS - 1) / P::THREADS; ++it) {
      const int i = threadIdx.x + it * P::THREADS;
      if (AVEC % P::THREADS != 0 && i >= AVEC) break;
      const int r = i / (P::BK / 4), k = k0 + (i % (P::BK / 4)) * 4;
      const bool ok = r < n && k < K;
      cp_async16(as + r * P::AS + (k - k0), ok ? a_e + static_cast<size_t>(r) * K + k : a,
                 ok ? 16 : 0);
    }
    constexpr int BVEC = P::BK * (P::BN / 4);  // of a B tile
#pragma unroll
    for (int it = 0; it < (NB * BVEC + P::THREADS - 1) / P::THREADS; ++it) {
      const int i = threadIdx.x + it * P::THREADS;
      if (NB * BVEC % P::THREADS != 0 && i >= NB * BVEC) break;
      const int m = i / BVEC, rem = i % BVEC;
      const int kr = rem / (P::BN / 4), c = (rem % (P::BN / 4)) * 4;
      const bool ok = k0 + kr < K && col0 + c < N;
      const float* b = m == 0 ? b0 : b1;
      cp_async16(bs + (m * P::BK + kr) * P::BN + c,
                 ok ? b + b_e + static_cast<size_t>(k0 + kr) * N + col0 + c : b,
                 ok ? 16 : 0);
    }
  };

  const int tx = threadIdx.x % P::TX, ty = threadIdx.x / P::TX;
  auto row = [&](int i) { return P::CONTIG ? ty * P::TM + i : ty + i * P::TY; };
  // in a contiguous plan a warp is one row group: warp-uniform
  const bool active = !P::CONTIG || ty * P::TM < n;

  float acc[NB][P::TM][P::TN];
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int i = 0; i < P::TM; ++i)
#pragma unroll
      for (int j = 0; j < P::TN; ++j) acc[m][i][j] = 0.0f;

  const int KT = (K + P::BK - 1) / P::BK;
#pragma unroll
  for (int s = 0; s < P::STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait(P::STAGES - 2);
    __syncthreads();  // tile kt landed; every thread is done with slot kt - 1
    if (kt + P::STAGES - 1 < KT) load(kt + P::STAGES - 1, (kt + P::STAGES - 1) % P::STAGES);
    cp_async_commit();
    if (!active) continue;
    const float* as = smem + (kt % P::STAGES) * kStage;
    const float* bs = as + P::BM * P::AS;
#pragma unroll
    for (int kk = 0; kk < P::BK; kk += P::AV) {
      float av[P::TM][P::AV];
#pragma unroll
      for (int i = 0; i < P::TM; ++i) ld_smem<P::AV>(as + row(i) * P::AS + kk, av[i]);
#pragma unroll
      for (int q = 0; q < P::AV; ++q) {
        float bv[NB][P::TN];
#pragma unroll
        for (int m = 0; m < NB; ++m)
#pragma unroll
          for (int g = 0; g < P::G; ++g)
            ld_smem<P::V>(bs + (m * P::BK + kk + q) * P::BN + g * P::TX * P::V + tx * P::V,
                          &bv[m][g * P::V]);
#pragma unroll
        for (int m = 0; m < NB; ++m)
#pragma unroll
          for (int i = 0; i < P::TM; ++i)
#pragma unroll
            for (int j = 0; j < P::TN; ++j) acc[m][i][j] = fmaf(av[i][q], bv[m][j], acc[m][i][j]);
      }
    }
  }
  if (!active) return;

#pragma unroll
  for (int i = 0; i < P::TM; ++i) {
    const int r = row(i);
    if (r >= n) continue;
    float* o = out + (static_cast<size_t>(e) * C + row0 + r) * N + col0;
#pragma unroll
    for (int g = 0; g < P::G; ++g) {
      const int c = g * P::TX * P::V + tx * P::V;
      if (col0 + c >= N) continue;
      float v[P::V];
#pragma unroll
      for (int j = 0; j < P::V; ++j) {
        const int t = g * P::V + j;
        v[j] = NB == 2 ? silu(acc[0][i][t]) * acc[NB - 1][i][t] : acc[0][i][t];
      }
      st_vec<P::V>(o + c, v);
    }
  }
}

// ---- bfloat16: wgmma from a TMA ring -------------------------------------
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A block is 128 rows (two consumer warpgroups of 64) by 256 output
// columns: 128 of each of gate and up, or 256 of wo.  Each stage holds
// the A tile (128 rows x 64 k, 128-byte swizzled, as TMA writes it) and
// four 64-column slabs of B (64 k x 64 columns each, swizzled the same
// way): gate, gate, up, up, or four of wo.  A warpgroup takes two
// m64n128k16 products a k-step, from a K-major descriptor of its 64 rows
// of A and an MN-major descriptor of a slab pair (transposed by the
// instruction), and keeps one stage's products in flight while it waits
// for the next.  Thread 0 issues the loads as its warpgroup passes the
// stages.  A warpgroup whose rows all lie past the count leaves at once,
// and the stages' release barriers count only the warps that stay.
//
// The grid is (row tiles, column tiles, E), the row tile fastest: the
// row tiles of one expert's column slab run side by side, so its weights
// come from HBM once and from L2 for the other tiles.  (With the row
// tile slowest, as the float32 kernel's, each row tile read the weights
// from HBM again, 2-3 times at phi3.5's prefills: PERF.md.)
constexpr int kWgRows = 128, kWgK = 64, kWgCols = 256, kWgStages = 4;
constexpr int kWgA = kWgRows * kWgK * 2;  // bytes of the A tile
constexpr int kWgSlab = kWgK * 64 * 2;    // of a B slab
constexpr int kWgStage = kWgA + 4 * kWgSlab;
constexpr int kWgBytes = 1024 + kWgStages * kWgStage + 8 * 2 * kWgStages;  // 1 KB to align

struct WgParams {
  CUtensorMap a, b0, b1;  // (K, C, E) rows; (N, K, E) weights, b1 = b0 in the down launch
  const int* counts;
  __nv_bfloat16* out;
  unsigned long long* rows;
  int C, K, N;
};

// The box at (c0, c1, e) of a 3-d map into shared memory, completing its
// bytes on the mbarrier bar.
__device__ __forceinline__ void tma_box3(unsigned dst, const CUtensorMap& map, int c0, int c1,
                                         int e, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(e), "r"(bar)
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

// Shared-memory matrix descriptor of a tile as TMA writes it with the
// 128-byte swizzle (rows of 128 bytes, 8-row groups 1024 bytes apart,
// 1024-byte aligned).  Bits: start address >> 4 [0, 14), leading byte
// offset >> 4 [16, 30), stride byte offset >> 4 [32, 46), swizzle mode
// [62, 64) (1: 128 bytes).  K-major (A): the leading offset is not read;
// a 16-deep k-step moves the start 32 bytes along the swizzled row.
// MN-major (B): the leading offset is the distance between the two
// 64-column slabs of a 128-column product; a k-step moves the start 16
// rows (2048 bytes).
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
// point: registers that an asynchronous wgmma writes are touched only
// between the waits.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128, float32) += a (64 x 16, K-major) . b (16 x 128, MN-major),
// both bf16 from shared-memory descriptors.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(1));
}

// The bf16 kernel: NB = 2 is silu(a @ b0) * (a @ b1) on 128 columns
// of each, NB = 1 is a @ b0 on 256.  In the m64n128 accumulator warp i of
// a warpgroup holds rows 16 i + [0, 16), lane l rows l / 4 and l / 4 + 8
// of each 8-column tile j, at columns 8 j + 2 (l % 4) and + 1.  Named
// under moe_experts_kernel, so that a profile counts it with the
// wrapper's launches.
template <int NB>
__global__ void __launch_bounds__(256, 1)
    moe_experts_kernel_wgmma(const __grid_constant__ WgParams p) {
  const int e = blockIdx.z;
  const int filled = min(p.counts[e], p.C);
  if (p.rows != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 &&
      filled > 0) {
    atomicAdd(p.rows, static_cast<unsigned long long>(filled));
  }
  const int row0 = blockIdx.x * kWgRows;
  const int n = min(filled - row0, kWgRows);  // filled rows of this tile
  if (n <= 0) return;
  const int col0 = blockIdx.y * (kWgCols / NB);  // of each output
  const int groups = (n + 63) / 64;               // warpgroups with rows

  extern __shared__ __align__(16) unsigned char sm_raw[];
  const unsigned base = smem_u32(reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(sm_raw) + 1023) & ~static_cast<uintptr_t>(1023)));
  const unsigned full = base + kWgStages * kWgStage, empty = full + 8 * kWgStages;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // warp-uniform

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * groups);  // every warp that stays, every stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg >= groups) return;  // no barrier below waits for these warps

  const int KT = (p.K + kWgK - 1) / kWgK;
  // thread 0: k-tile u into stage u % kWgStages once every warp has
  // released k-tile u - kWgStages
  auto load = [&](int u) {
    const int st = u % kWgStages;
    const unsigned bar = full + 8 * st, dst = base + st * kWgStage;
    if (u >= kWgStages) mbar_wait(empty + 8 * st, (u / kWgStages - 1) & 1);
    mbar_expect(bar, kWgStage);
    const int k0 = u * kWgK;
    tma_box3(dst, p.a, k0, row0, e, bar);
#pragma unroll
    for (int sl = 0; sl < 4; ++sl) {
      const CUtensorMap& m = NB == 2 && sl >= 2 ? p.b1 : p.b0;
      const int c = NB == 2 ? col0 + 64 * (sl & 1) : col0 + 64 * sl;
      tma_box3(dst + kWgA + sl * kWgSlab, m, c, k0, e, bar);
    }
  };
  if (tid == 0)
    for (int u = 0; u < min(KT, kWgStages - 1); ++u) load(u);

  const int lane = tid & 31, wi = (tid >> 5) & 3;
  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

  for (int t = 0; t < KT; ++t) {
    const int st = t % kWgStages;
    mbar_wait(full + 8 * st, (t / kWgStages) & 1);
    const unsigned stage = base + st * kWgStage;
    const uint64_t da = desc_sw128(stage + wg * 64 * 128, 1);
    const uint64_t db0 = desc_sw128(stage + kWgA, kWgSlab >> 4);
    const uint64_t db1 = desc_sw128(stage + kWgA + 2 * kWgSlab, kWgSlab >> 4);
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgK / 16; ++kk) {
      // (a descriptor's start address is its low bits: a step adds its
      // byte offset / 16)
      wgmma_128(acc[0], da + kk * 2, db0 + kk * 128);
      wgmma_128(acc[1], da + kk * 2, db1 + kk * 128);
    }
    wgmma_commit();
    // the products of k-tile t - 1 are done: release its stage, and refill it
    wgmma_wait<1>();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    if (t > 0 && lane == 0) mbar_arrive(empty + 8 * ((t - 1) % kWgStages));
    if (tid == 0 && t + kWgStages - 1 < KT) load(t + kWgStages - 1);
    __syncwarp();
  }
  wgmma_wait<0>();
  reg_fence(acc[0]);
  reg_fence(acc[1]);

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 64 * wg + 16 * wi + g + 8 * hh;
    if (r >= n) continue;
    __nv_bfloat16* o = p.out + (static_cast<size_t>(e) * p.C + row0 + r) * p.N + col0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t4;
      float v[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        v[0][q] = acc[0][4 * j + 2 * hh + q];
        v[1][q] = acc[1][4 * j + 2 * hh + q];
      }
      if (NB == 2) {
        if (col0 + c < p.N)
          *reinterpret_cast<__nv_bfloat162*>(o + c) = __floats2bfloat162_rn(
              silu(v[0][0]) * v[1][0], silu(v[0][1]) * v[1][1]);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (col0 + 128 * h + c < p.N)
            *reinterpret_cast<__nv_bfloat162*>(o + 128 * h + c) =
                __floats2bfloat162_rn(v[h][0], v[h][1]);
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

// The map of a contiguous bf16 (outer, mid, inner) tensor at `base`, as
// dimensions (inner, mid, outer), with boxes of 64 x `rows` x 1, 128-byte
// swizzled; the hardware writes zeros where a box passes an end.
cudaError_t encode3(CUtensorMap* map, const void* base, int outer, int mid, int inner,
                    int rows) {
  auto fn = tensor_map_encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(mid),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {2ull * inner, 2ull * inner * mid};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                          dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr int kMaxDevices = 64;

// Above 48 KB of dynamic shared memory a kernel opts in, once a device.
template <class Kernel>
cudaError_t opt_in(Kernel kernel, int smem, bool (&opted)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted[dev] = true;
  }
  return cudaSuccess;
}

// One float32 launch of plan P over the (column tiles, E, row tiles) grid.
template <class P, int NB>
int launch(const float* a, const int* counts, const float* b0, const float* b1, float* out,
           unsigned long long* rows, int E, int C, int K, int N, cudaStream_t stream) {
  constexpr int smem = P::template smem_bytes<NB>();
  static bool opted[kMaxDevices] = {};
  const auto kernel = moe_experts_kernel<P, NB>;
  const cudaError_t e = opt_in(kernel, smem, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + P::BN - 1) / P::BN, E, (C + P::BM - 1) / P::BM);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, P::THREADS, smem, stream>>>(a, counts, b0, b1, out, rows, C, K, N);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 launch: a (E, C, K) rows against b0 and b1 (E, K, N).
template <int NB>
int launch_wg(const __nv_bfloat16* a, const int* counts, const __nv_bfloat16* b0,
              const __nv_bfloat16* b1, __nv_bfloat16* out, unsigned long long* rows, int E,
              int C, int K, int N, cudaStream_t stream) {
  static bool opted[kMaxDevices] = {};
  auto kernel = moe_experts_kernel_wgmma<NB>;
  cudaError_t e = opt_in(kernel, kWgBytes, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  WgParams p;
  e = encode3(&p.a, a, E, C, K, kWgRows);
  if (e == cudaSuccess) e = encode3(&p.b0, b0, E, K, N, kWgK);
  if (e == cudaSuccess) e = encode3(&p.b1, b1, E, K, N, kWgK);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.counts = counts;
  p.out = out;
  p.rows = rows;
  p.C = C;
  p.K = K;
  p.N = N;
  const int cols = kWgCols / NB;
  const dim3 grid((C + kWgRows - 1) / kWgRows, (N + cols - 1) / cols, E);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, 256, kWgBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// d and F: whole 16-byte vectors of the element (4 floats, 8 bf16)
bool shapes_ok(int E, int C, int K, int N, int vec) {
  return E > 0 && C > 0 && K > 0 && N > 0 && K % vec == 0 && N % vec == 0;
}

}  // namespace

// h (E, C, F) = silu(xe @ wi_gate[e]) * (xe @ wi_up[e]) on the filled rows;
// plan 0 skinny, 1 tiled.  rows: the engagement counter, or null.
extern "C" int moe_experts_gate_up(int plan, const float* xe, const int* counts,
                                   const float* wi_gate, const float* wi_up, float* h,
                                   unsigned long long* rows, int E, int C, int d, int F,
                                   void* stream) {
  if (!shapes_ok(E, C, d, F, 4) || !aligned16(xe) || !aligned16(wi_gate) ||
      !aligned16(wi_up) || !aligned16(h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  switch (plan) {
    case 0: return launch<Skinny, 2>(xe, counts, wi_gate, wi_up, h, rows, E, C, d, F, st);
    case 1:
      return launch<TiledGateUp, 2>(xe, counts, wi_gate, wi_up, h, rows, E, C, d, F, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ye (E, C, d) = h @ wo[e] on the filled rows.
extern "C" int moe_experts_down(int plan, const float* h, const int* counts, const float* wo,
                                float* ye, int E, int C, int F, int d, void* stream) {
  if (!shapes_ok(E, C, F, d, 4) || !aligned16(h) || !aligned16(wo) || !aligned16(ye)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  switch (plan) {
    case 0: return launch<Skinny, 1>(h, counts, wo, wo, ye, nullptr, E, C, F, d, st);
    case 1: return launch<TiledDown, 1>(h, counts, wo, wo, ye, nullptr, E, C, F, d, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 entry points: the same arguments on bf16 rows and weights, and
// no plan (one kernel at every shape).
extern "C" int moe_experts_gate_up_bf16(const __nv_bfloat16* xe, const int* counts,
                                        const __nv_bfloat16* wi_gate,
                                        const __nv_bfloat16* wi_up, __nv_bfloat16* h,
                                        unsigned long long* rows, int E, int C, int d, int F,
                                        void* stream) {
  if (!shapes_ok(E, C, d, F, 8) || !aligned16(xe) || !aligned16(wi_gate) ||
      !aligned16(wi_up) || !aligned16(h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_wg<2>(xe, counts, wi_gate, wi_up, h, rows, E, C, d, F,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int moe_experts_down_bf16(const __nv_bfloat16* h, const int* counts,
                                     const __nv_bfloat16* wo, __nv_bfloat16* ye, int E, int C,
                                     int F, int d, void* stream) {
  if (!shapes_ok(E, C, F, d, 8) || !aligned16(h) || !aligned16(wo) || !aligned16(ye)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_wg<1>(h, counts, wo, wo, ye, nullptr, E, C, F, d,
                      static_cast<cudaStream_t>(stream));
}
