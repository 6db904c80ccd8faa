// Fused low-rank product y = (x @ B) @ C for every compressed linear.
//
// Replaces the TPU kernels of repro/kernels/lowrank_matmul.py:
//   lowrank_gemv       (_gemv_kernel, decode rows M <= 64)
//   lowrank_matmul_2d  (_kernel, prefill rows)
// Both compute t = x @ B in float32, round t to C's dtype, then y = t @ C
// in float32, rounded to x's dtype on store.
//
// The TPU kernels run their grid in order on one core and carry t in VMEM
// scratch from the K steps to the N steps. Hopper runs blocks in parallel
// and in no order, so the two kernels here answer that differently.
//
// lowrank_gemv: at decode M is 1 to 64 rows, so the work is bound by
//   bytes: B and C read once, 2 (KR + RN) bytes a bf16 linear, plus x and
//   y (one SmolLM-360M decode step's 224 linears at 8 rows: 0.1528 ms at
//   3.35 TB/s). A linear's weights are 0.2-5 MB, so a launch lasts a few
//   microseconds and its fixed costs (the launch, its tail, a DRAM round
//   trip) weigh as much as its bytes. The design ("mma" in bf16, "fma" in
//   float32; gemv_stream_kernel below) answers the earlier split-K design
//   ("splitk", kept for x whose rows are not on 16-byte boundaries and for
//   comparison) on each of its four faults:
//   - three launches a linear and float32 partials in device memory: now
//     two, t = round(x @ B) then y = t @ C, and the only scratch is t in
//     the operands' dtype (11 KB at 8 rows and rank 698). A cluster of up
//     to 8 blocks splits a strip's reduction; each block sends its float32
//     partial sums by st.async to the block that owns their rows, which
//     adds them in rank order. Both launches are programmatic dependent
//     launches that wait in griddepcontrol.wait for the kernel ahead:
//     launch 2 streams its first C chunks into shared memory before that
//     (C's bytes are the larger half of an MLP linear), and the next
//     linear's launch 1 is already resident when launch 2 ends;
//   - one 2-byte load per thread: now 16-byte cp.async copies, neighbouring
//     threads on neighbouring addresses, through a ring of 5 chunks of 64
//     rows (32 KB of a bf16 weight in flight a block). At a ragged rank
//     B's rows start on no 16-byte boundary: 4-byte copies at an even rank,
//     else hopper_mma.cuh's raw words (stage_raw, unpack_raw), nothing
//     padded;
//   - every weight read M / 8 times (8 rows a block): a block now holds all
//     M <= 64 rows of x, so each weight element is read by one block, once;
//   - two float32 scratch tensors a call: now one t (its row stride rounded
//     up to 16 bytes), and no host sync, so a call can be captured in a
//     CUDA graph (measured: two replays give an eager call's bits).
//   bf16 products run on the tensor cores (mma.sync m16n8k16, x's rows the
//   16-row operand, zero past M): at 64 rows FMA on the CUDA cores would
//   need ~0.48 ms a decode step for the operations alone. float32 stays in
//   FMA on the CUDA cores (TF32 misses the 2e-5 tier).
//   Measured (chip_smoke.py and kernels/gemv_profile.py in one call on an
//   NVIDIA H100 80GB HBM3 at 700 W): one SmolLM-360M decode step's 224
//   linears take 1.55-1.64 ms at 8 rows (the three-launch design
//   3.78-3.84, multi_dot 3.69-3.90) and 2.63-2.69 ms at 64 (8.75-9.30 and
//   3.81-4.08), 10x the byte bound. What holds it is latency, not bytes:
//   in a profiler trace a linear's two launches span 7.0 us at 8 rows,
//   against 0.7 us for its bytes at the card's rate.
// lowrank_matmul_2d: at prefill M is hundreds of rows and the work is bound
//   by operations at the CUDA cores' rate, by bytes (0.3 ms a SmolLM-360M
//   prefill) at the tensor cores'. The TPU kernel keeps t whole in VMEM, so
//   it takes any rank; here t of a row tile must fit one block's shared
//   memory for t to stay on chip. Three variants, picked by the wrapper
//   from the dtype and the shapes. In the first two, as on the TPU, t never
//   leaves the chip: a cluster of blocks owns a row tile, each block
//   computes its share of t's columns over the whole of K and the blocks
//   exchange their shares through distributed shared memory before each
//   emits its share of y's columns, so nothing is recomputed:
//   - "wgmma" (bfloat16; K and N multiples of 8, x and C 16-byte aligned,
//     R <= drt_lowrank_2d_wgmma_max_rank(), 896): both products on the
//     tensor cores (hopper_mma.cuh), t[64 rows, R] in bf16, which is the
//     rounding the TPU kernel gives t. A cluster of 8 blocks owns a 64-row
//     tile. A block has a producer warp, which stages tiles by TMA into a
//     ring of slots (full/empty mbarriers), and two consumer warpgroups,
//     each computing 64-column chunks of t, then of y; the blocks push their
//     t chunks into their peers' shared memory with bulk copies that
//     complete on an mbarrier. B's rows start where its rank puts them: by
//     TMA where R % 8 == 0, else the consumers copy them (4-byte copies at
//     an even rank, raw 16-byte words shifted into place at an odd one).
//     Nothing is padded in memory.
//     What bounds it on this card, measured at SmolLM-360M's shapes: the
//     rate at which an SM takes in tiles from L2, ~35-40 GB/s a block (a
//     phase's time does not move with the ring's depth or with the MMAs
//     taken out). Each cluster streams all of B and C through its 8 SMs,
//     and at 512 rows only 64 SMs work (8 row tiles x 8). Clusters of 16
//     would use 128, but the card holds 7 of them at once (one a GPC)
//     against 15 of 8: measured slower at 512 and 2048 rows. The consumers
//     issue every wgmma on a warp-uniform path: a wgmma on a path that
//     diverges inside the warpgroup (a TMA issued by one of its threads, a
//     branch around the MMA) is serialized by the compiler.
//   - "simt" (float32, and the shapes above that the tensor-core kernel
//     does not take): a cluster of 8 blocks owns a 32-row tile, float32 FMA
//     on the CUDA cores, 2 x 4 outputs a thread, t[32, R] in float32
//     rounded to C's dtype (R <= drt_lowrank_2d_max_rank(), 1600). float32
//     stays here because TF32 products miss the 2e-5 float32 tier.
//   - "split" (any rank): two launches, t = round(x @ B) into an (M, R)
//     tensor of x's dtype, then y = t @ C, each a plain tiled product over
//     every SM, t crossing between them through L2 (1.2 MB at 512 rows and
//     rank 1200 in bf16). bfloat16 operands with K and N multiples of 8
//     run both on the tensor cores (the 2-D kernel's phase-1 mainloop
//     without the cluster: a producer warp stages the operand both
//     warpgroups share by TMA, each warpgroup its own tile of B or of t by
//     TMA at R % 8 == 0, else by the raw-word copies, so a ragged rank such
//     as gemma3-12b's 2457 stays on the tensor cores); every other operand,
//     float32 included, runs a 64 x 64 CUDA-core tile a block. Measured on
//     the card it is 13.8-19.8x faster than "simt" at bf16 rank 1585, so
//     the wrapper prefers it above rank 896; in float32 its tiles spread
//     over more SMs than "simt"'s clusters and it is faster from 512 rows
//     (1.3-1.8x a SmolLM prefill), slower at 128 and 256, so the wrapper
//     prefers it from 512 rows (PERF.md). Both CUDA-core forms sum each
//     output as one float32 FMA chain in k order: they give the same bits.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper_mma.cuh"

namespace drt {
namespace {

// ---------------------------------------------------------------------------
// Decode shape, the earlier design ("splitk"): split-reduction products
// ---------------------------------------------------------------------------
// Blocks tile the output columns (64 a block, one a thread) and 8 rows, and
// split the reduction into up to 16 slices, each block writing a float32
// partial; four thread groups take interleaved rows of a staged chunk. The
// partials of x @ B are summed and rounded while phase 2 stages t; a third
// launch sums phase 2's partials into y, in slice order.
constexpr int GV_CT = 64;        // output columns per block, one per thread
constexpr int GV_KG = 4;         // thread groups splitting a staged chunk
constexpr int GV_THREADS = GV_CT * GV_KG;
constexpr int GV_MT = 8;         // rows per block
constexpr int GV_KC = 64;        // reduction values staged in shared memory
constexpr int GV_MAX_SLICES = 16;

// Sum of the first n (<= GV_MAX_SLICES) values p[0], p[stride], ... with
// all loads issued together.
__device__ __forceinline__ float sum_slices(const float* __restrict__ p,
                                            size_t stride, int n) {
  float v[GV_MAX_SLICES];
#pragma unroll
  for (int t = 0; t < GV_MAX_SLICES; ++t) v[t] = t < n ? p[t * stride] : 0.f;
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < GV_MAX_SLICES; ++t) acc += v[t];
  return acc;
}

// part[s, m, c] = sum over k in slice s of X(m, k) * W[k, c], where X is x
// (kPartIn false) or, rounded to T, the sum of `sin` float32 partials.
// Thread group g of the block takes the rows g, g + 4, ... of each staged
// chunk, so four rows of W are in flight per column; the groups' sums meet
// in shared memory at the end.
template <typename T, bool kPartIn>
__global__ void __launch_bounds__(GV_THREADS) splitk_kernel(
    const T* __restrict__ x, const float* __restrict__ xpart, int sin,
    const T* __restrict__ W, float* __restrict__ part,
    int M, int K, int N, int kper) {
  __shared__ float xs[GV_MT][GV_KC];
  __shared__ float red[GV_KG - 1][GV_MT][GV_CT];
  const int col = threadIdx.x % GV_CT, g = threadIdx.x / GV_CT;
  const int c = blockIdx.x * GV_CT + col;
  const int m0 = blockIdx.y * GV_MT;
  const int s = blockIdx.z;
  const int kbeg = s * kper;
  const int kend = min(K, kbeg + kper);
  float acc[GV_MT];
#pragma unroll
  for (int i = 0; i < GV_MT; ++i) acc[i] = 0.f;
  for (int k0 = kbeg; k0 < kend; k0 += GV_KC) {
    const int kc = min(GV_KC, kend - k0);
#pragma unroll
    for (int j = 0; j < GV_MT * GV_KC / GV_THREADS; ++j) {
      const int i = threadIdx.x + j * GV_THREADS;
      const int mm = i / GV_KC, kk = i % GV_KC;
      const int m = m0 + mm;
      float v = 0.f;
      if (m < M && kk < kc) {
        if constexpr (kPartIn) {
          v = round_to<T>(sum_slices(xpart + (size_t)m * K + k0 + kk,
                                     (size_t)M * K, sin));
        } else {
          v = ld(x + (size_t)m * K + k0 + kk);
        }
      }
      xs[mm][kk] = v;
    }
    __syncthreads();
    if (c < N) {
      const T* wp = W + (size_t)k0 * N + c;
      float w[GV_KC / GV_KG];
#pragma unroll
      for (int j = 0; j < GV_KC / GV_KG; ++j) {
        const int kk = g + GV_KG * j;
        w[j] = kk < kc ? ld(wp + (size_t)kk * N) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < GV_KC / GV_KG; ++j) {
        const int kk = g + GV_KG * j;
#pragma unroll
        for (int mm = 0; mm < GV_MT; ++mm) acc[mm] += xs[mm][kk] * w[j];
      }
    }
    __syncthreads();
  }
  if (g > 0) {
#pragma unroll
    for (int mm = 0; mm < GV_MT; ++mm) red[g - 1][mm][col] = acc[mm];
  }
  __syncthreads();
  if (g == 0 && c < N) {
#pragma unroll
    for (int mm = 0; mm < GV_MT; ++mm) {
      float v = acc[mm];
#pragma unroll
      for (int h = 0; h < GV_KG - 1; ++h) v += red[h][mm][col];
      if (m0 + mm < M) part[((size_t)s * M + m0 + mm) * N + c] = v;
    }
  }
}

// y[i] = sum over s of part[s, i], rounded to T.
template <typename T>
__global__ void reduce_kernel(const float* __restrict__ part,
                              T* __restrict__ y, int S, int MN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  y[i] = cvt<T>(sum_slices(part + i, (size_t)MN, S));
}

template <typename T>
int launch_gemv(const void* x, const void* B, const void* C, void* y,
                float* tpart, float* ypart, int M, int K, int R, int N,
                int s1, int kper1, int s2, int kper2, cudaStream_t st) {
  if (s1 > GV_MAX_SLICES || s2 > GV_MAX_SLICES)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 g1(cdiv(R, GV_CT), cdiv(M, GV_MT), s1);
  splitk_kernel<T, false><<<g1, GV_THREADS, 0, st>>>(
      static_cast<const T*>(x), nullptr, 0, static_cast<const T*>(B),
      tpart, M, K, R, kper1);
  const dim3 g2(cdiv(N, GV_CT), cdiv(M, GV_MT), s2);
  splitk_kernel<T, true><<<g2, GV_THREADS, 0, st>>>(
      nullptr, tpart, s1, static_cast<const T*>(C), ypart, M, R, N, kper2);
  const int mn = M * N;
  reduce_kernel<T><<<cdiv(mn, 256), 256, 0, st>>>(ypart, static_cast<T*>(y),
                                                   s2, mn);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Decode shape: the weights streamed once, two launches a linear
// ---------------------------------------------------------------------------
// One launch computes out (M x ncols) = round_T(A (M x kred) @ W (kred x
// ncols)), all row-major: launch 1 is t = x @ B (out t, row stride
// gv2_t_stride), launch 2 is y = t @ C. A cluster of blocks owns a strip of
// GV2_WS output columns; its blocks split the reduction rows into whole
// GV2_KC-row chunks, block r of the cluster taking chunks [r per, (r + 1)
// per). Each block holds all M rows of A, so every weight element is read
// by exactly one block; it streams its chunks of W and of A through a ring
// of GV2_STAGES slots by cp.async and sums its slice in float32 (bf16: the
// tensor cores, mma.sync m16n8k16 with A's rows as the 16-row operand;
// float32: FMA on the CUDA cores). The blocks' float32 partials meet in
// distributed shared memory: row m goes to block m % cluster, which sums
// the cluster's partials of its rows in rank order, rounds once to T and
// stores them. No value is summed by atomics, so two calls give the same
// bits.
constexpr int GV2_WS = 64;               // output columns a block (a strip)
constexpr int GV2_KC = 64;               // reduction rows a staged chunk
constexpr int GV2_THREADS = 128;         // four warps
constexpr int GV2_STAGES = 5;            // ring slots; 4 chunks in flight
constexpr int GV2_MAX_CLUSTER = 8;       // blocks splitting a strip's rows
constexpr int GV2_MAX_ROWS = 64;         // rows of A a block holds
constexpr int GV2_RED = GV2_WS + 4;      // padded row of the partial sums
static_assert(GV2_THREADS == 2 * GV2_WS, "fma: two row halves a column");

// Rows a block's A tile holds: M rounded up to 16, 32 or 64.
__host__ __device__ constexpr int gv2_rows_tile(int M) {
  return M <= 16 ? 16 : M <= 32 ? 32 : 64;
}

// Row stride of t, in values: R rounded up to 16 bytes, so that launch 2
// stages t's rows by 16-byte copies at any rank. The padding is never
// written or read.
__host__ __device__ constexpr int gv2_t_stride(int R, int esize) {
  return (R + 16 / esize - 1) / (16 / esize) * (16 / esize);
}

// Dynamic shared memory of a block with `mt` rows of A and `esize`-byte
// values: per ring slot the weight chunk (bf16: the raw words of
// mma::stage_raw, or the swizzled tile in their first 8 KB; float32: 64 x
// 64 values) and the A chunk (mt rows of 64 values); bf16 also the tile
// the raw words are unpacked into; the region the cluster's partial sums
// of this block's rows land in (at most mt + GV2_MAX_CLUSTER rows of
// GV2_RED float32); 128 bytes to align the base. float32 sums its two row
// halves over the ring.
__host__ __device__ constexpr size_t gv2_smem_bytes(int esize, int mt) {
  return 128 +
         (size_t)GV2_STAGES *
             ((esize == 2 ? mma::RAW_BYTES : GV2_KC * GV2_WS * 4) +
              (size_t)mt * GV2_KC * esize) +
         (esize == 2 ? mma::TILE_BYTES : 0) +
         (size_t)(mt + GV2_MAX_CLUSTER) * GV2_RED * 4;
}
static_assert(GV2_MAX_ROWS * GV2_RED <= GV2_STAGES * GV2_KC * GV2_WS,
              "float32's row halves fit the ring");

// The geometry of one launch over a (kred x ncols) weight: strips of
// GV2_WS columns, clusters of `cluster` blocks, `per` chunks a block. The
// caller gives the blocks the launch aims at (the wrapper: what the card
// holds at once at this shared memory, from its SM count, halved for a
// small weight; kernels/lowrank_matmul.py, _gemv_target_blocks); the
// cluster is as large as that allows (at most GV2_MAX_CLUSTER and the
// chunk count), then shrunk so that no block is left without a chunk.
struct Gv2Launch {
  int strips, cluster, per;
};
inline Gv2Launch gv2_launch_plan(int kred, int ncols, int blocks) {
  const int nch = cdiv(kred, GV2_KC), strips = cdiv(ncols, GV2_WS);
  int cs = blocks / strips;
  cs = cs < GV2_MAX_CLUSTER ? cs : GV2_MAX_CLUSTER;
  cs = cs < nch ? cs : nch;
  cs = cs > 1 ? cs : 1;
  const int per = cdiv(nch, cs);
  return {strips, cdiv(nch, per), per};
}

// The cluster barrier in two halves: arrive (no ordering) at the start,
// wait before the first access to a peer's shared memory, which is then
// known to have started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Asynchronous stores into a peer's shared memory (shared::cluster
// addresses, mapa), each completing `bytes` on the peer's mbarrier.
__device__ __forceinline__ void st_async2(uint32_t dst, float a, float b,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(dst),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async1(uint32_t dst, float a,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(dst),
      "f"(a), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8; .trans hands each thread the transposed
// elements (the "col" B operand of mma.sync from a row-major k x n tile).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// d[16 x 8] += a[16 x 16] @ b[16 x 8], bf16 in, float32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + ROWS) x columns [c0, c0 + 64) of the row-major (rows x
// cols) matrix m (row stride ld; rows on 16-byte boundaries) into shared
// memory at `dst` by 16-byte cp.async copies, zeros outside the matrix:
// bf16 rows of 128 bytes in the swizzled layout of hopper_mma.cuh, float32
// rows of 256 bytes in order.
template <typename T, int ROWS>
__device__ __forceinline__ void gv2_stage16(uint32_t dst, const T* m, int ld,
                                            int rows, int cols, int r0,
                                            int c0, int t) {
  constexpr int E = 16 / sizeof(T);         // values a copy
  constexpr int CPR = 64 / E;               // copies a row
  static_assert(ROWS * CPR % GV2_THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int j = 0; j < ROWS * CPR / GV2_THREADS; ++j) {
    const int q = t + j * GV2_THREADS;
    const int r = q / CPR, c = q % CPR, gr = r0 + r, gc = c0 + E * c;
    int n = gr < rows ? cols - gc : 0;
    n = n < 0 ? 0 : n > E ? E : n;
    const uint32_t off = sizeof(T) == 2
                             ? mma::swz_offset(r, c)
                             : static_cast<uint32_t>(r * 256 + 16 * c);
    mma::cp_async16(dst + off, n > 0 ? m + (size_t)gr * ld + gc : m,
                    n * static_cast<int>(sizeof(T)));
  }
}

// The same for a float32 weight whose rows are not on 16-byte boundaries:
// 4-byte copies, 64 rows.
__device__ __forceinline__ void gv2_stage4(uint32_t dst, const float* m,
                                           int ld, int rows, int cols,
                                           int r0, int c0, int t) {
#pragma unroll 8
  for (int j = 0; j < 64 * 64 / GV2_THREADS; ++j) {
    const int q = t + j * GV2_THREADS;
    const int r = q / 64, c = q % 64;
    const bool ok = r0 + r < rows && c0 + c < cols;
    mma::cp_async4(dst + r * 256 + 4 * c,
                   ok ? m + (size_t)(r0 + r) * ld + c0 + c : m, ok ? 4 : 0);
  }
}

// acc += A chunk (MT x 64, swizzled at `at`) @ W chunk (64 x 64, swizzled
// at `wt`) on the tensor cores: warp w owns the strip's columns 16 w ..
// 16 w + 15 (two n8 tiles) for every m16 tile of A. The fragments of a
// chunk's four k16 steps are loaded together before their MMAs.
template <int MT>
__device__ __forceinline__ void gv2_mma_chunk(float (&acc)[MT / 16][2][4],
                                              uint32_t wt, uint32_t at,
                                              int warp, int lane) {
  constexpr int KS = GV2_KC / 16;
  const int r = (lane & 7) + 8 * ((lane >> 3) & 1), h = lane >> 4;
  uint32_t b[KS][4];   // k 0-7 and 8-15 of columns +0..7, then of +8..15
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4_trans(b[kk], wt + mma::swz_offset(16 * kk + r, 2 * warp + h));
#pragma unroll
  for (int i = 0; i < MT / 16; ++i) {
    uint32_t a[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldsm_x4(a[kk], at + mma::swz_offset(16 * i + r, 2 * kk + h));
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      mma_16816(acc[i][0], a[kk], b[kk][0], b[kk][1]);
      mma_16816(acc[i][1], a[kk], b[kk][2], b[kk][3]);
    }
  }
}

// acc[m] += A chunk (MT x 64) @ W chunk (64 x 64) in float32 FMA: thread t
// owns column t % 64 and the chunk's rows 32 (t / 64) .. +31, four at a
// time, each row of A read as a float4 that a warp shares.
template <int MT>
__device__ __forceinline__ void gv2_fma_chunk(float (&acc)[MT],
                                              const float* wt,
                                              const float* at, int t) {
  const int c = t % GV2_WS, k0 = (t / GV2_WS) * (GV2_KC / 2);
#pragma unroll 2
  for (int k = k0; k < k0 + GV2_KC / 2; k += 4) {
    const float w0 = wt[k * GV2_WS + c], w1 = wt[(k + 1) * GV2_WS + c];
    const float w2 = wt[(k + 2) * GV2_WS + c], w3 = wt[(k + 3) * GV2_WS + c];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float4 a = *reinterpret_cast<const float4*>(at + m * GV2_KC + k);
      acc[m] = fmaf(a.x, w0, acc[m]);
      acc[m] = fmaf(a.y, w1, acc[m]);
      acc[m] = fmaf(a.z, w2, acc[m]);
      acc[m] = fmaf(a.w, w3, acc[m]);
    }
  }
}

// How a weight's chunks are staged: 16-byte copies straight into place
// (rows on 16-byte boundaries); for bf16 rows on 4-byte boundaries (an
// even rank) 4-byte copies of column pairs straight into the tile
// (mma::stage_tile_pairs), else raw 16-byte words shifted into place
// (mma::stage_raw / unpack_raw); float32 otherwise 4-byte copies.
enum Gv2WMode : int { W_ROWS16 = 0, W_RAW = 1, W_FOUR = 2, W_PAIRS = 3 };

// One launch of the decode product (see above). A launch with programmatic
// stream serialization may start before the kernel ahead of it in the
// stream has finished: griddepcontrol.wait returns once that kernel is
// complete and its writes visible (at once for a plain launch). Nothing
// written by an earlier kernel is read before the wait, except W with
// early_w (launch 2: C, which no kernel between the caller's last write
// and launch 1's wait can have touched, since launch 2 cannot start before
// launch 1 passes its wait). Past the wait every block lets the next
// launch start (launch_dependents): launch 2 then streams its first chunks
// of C while launch 1 still works.
template <typename T, int MT>
__global__ void __launch_bounds__(GV2_THREADS) gemv_stream_kernel(
    const T* __restrict__ A, int lda, const T* __restrict__ W,
    T* __restrict__ out, int ldo, int M, int kred, int ncols, int per,
    int wmode, int early_w) {
  namespace cg = cooperative_groups;
  constexpr bool kBF16 = sizeof(T) == 2;
  constexpr size_t WSLOT = kBF16 ? mma::RAW_BYTES : GV2_KC * GV2_WS * 4;
  constexpr size_t ASLOT = (size_t)MT * GV2_KC * sizeof(T);
  extern __shared__ unsigned char gv2_smem[];
  __shared__ __align__(8) uint64_t gv2_rbar;   // the peers' partials landed
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // this block's rows of the output: m = rank, rank + cs, ...
  const int own = M > rank ? cdiv(M - rank, cs) : 0;
  const uint32_t rbar = mma::smem_u32(&gv2_rbar);
  if (threadIdx.x == 0) {
    mma::mbar_init(rbar, 1);
    mma::mbar_arrive_expect(rbar, (cs - 1) * own * GV2_WS * 4);
  }
  cluster_arrive_relaxed();   // waited for before the first remote store
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gv2_smem) + 127) & ~uintptr_t(127));
  unsigned char* wring = base;
  unsigned char* aring = base + GV2_STAGES * WSLOT;
  unsigned char* utile = aring + GV2_STAGES * ASLOT;   // bf16 only
  float* recv = reinterpret_cast<float*>(
      utile + (kBF16 ? mma::TILE_BYTES : 0));        // peers' partials
  const int col0 = blockIdx.x * GV2_WS;
  const int cbeg = rank * per;
  int nk = cdiv(kred, GV2_KC) - cbeg;
  nk = nk < per ? nk : per;

  auto load_w = [&](int i) {
    const int k0 = (cbeg + i) * GV2_KC;
    const uint32_t dst = mma::smem_u32(wring + (i % GV2_STAGES) * WSLOT);
    if constexpr (kBF16) {
      if (wmode == W_RAW)
        mma::stage_raw<GV2_THREADS>(dst, W, ncols, kred, k0, col0, tid);
      else if (wmode == W_PAIRS)
        mma::stage_tile_pairs<GV2_THREADS>(dst, W, ncols, kred, ncols, k0,
                                           col0, tid);
      else
        gv2_stage16<T, GV2_KC>(dst, W, ncols, kred, ncols, k0, col0, tid);
    } else {
      if (wmode == W_FOUR)
        gv2_stage4(dst, W, ncols, kred, ncols, k0, col0, tid);
      else
        gv2_stage16<T, GV2_KC>(dst, W, ncols, kred, ncols, k0, col0, tid);
    }
  };
  auto load_a = [&](int i) {
    gv2_stage16<T, MT>(mma::smem_u32(aring + (i % GV2_STAGES) * ASLOT), A,
                       lda, M, kred, 0, (cbeg + i) * GV2_KC, tid);
  };

  // The ring's first chunks of W, one commit group each (with early_w
  // before the wait), then the same chunks of A as one more group.
  auto prologue_w = [&] {
#pragma unroll
    for (int i = 0; i < GV2_STAGES - 1; ++i) {
      if (i < nk) load_w(i);
      mma::cp_async_commit();
    }
  };
  if (early_w) prologue_w();
  griddep_wait();
  griddep_launch_dependents();
  if (!early_w) prologue_w();
#pragma unroll
  for (int i = 0; i < GV2_STAGES - 1; ++i)
    if (i < nk) load_a(i);
  mma::cp_async_commit();

  float acc[kBF16 ? MT / 16 : 1][2][4] = {};   // bf16: [m16 tile][n8 tile]
  float facc[kBF16 ? 1 : MT] = {};             // float32: [row]
  for (int i = 0; i < nk; ++i) {
    if (i == 0)
      mma::cp_async_wait<0>();
    else
      mma::cp_async_wait<GV2_STAGES - 2>();
    __syncthreads();   // chunk i landed; chunk i - 1's slot is free
    if (i + GV2_STAGES - 1 < nk) {
      load_w(i + GV2_STAGES - 1);
      load_a(i + GV2_STAGES - 1);
    }
    mma::cp_async_commit();
    const unsigned char* wt = wring + (i % GV2_STAGES) * WSLOT;
    const unsigned char* at = aring + (i % GV2_STAGES) * ASLOT;
    if constexpr (kBF16) {
      if (wmode == W_RAW) {
        mma::unpack_raw<GV2_THREADS>(reinterpret_cast<char*>(utile),
                                     reinterpret_cast<const char*>(wt), W,
                                     ncols, kred, ncols,
                                     (cbeg + i) * GV2_KC, col0, tid);
        __syncthreads();
        wt = utile;
      }
      gv2_mma_chunk<MT>(acc, mma::smem_u32(wt), mma::smem_u32(at), warp,
                        lane);
    } else {
      gv2_fma_chunk<MT>(facc, reinterpret_cast<const float*>(wt),
                        reinterpret_cast<const float*>(at), tid);
    }
  }

  // Each row's partial sums go to the block that owns the row: row m to
  // rank m % cs, into its receive region at [this rank][m / cs]: its own
  // rows by plain stores, a peer's by st.async, which completes the bytes
  // on the peer's mbarrier (rbar, armed with the bytes every peer sends).
  mma::cp_async_wait<0>();
  const int lr = cdiv(M, cs);         // rows a block owns, at most
  const uint32_t recv_a = mma::smem_u32(recv);
  // m / cs for m < 1024 as a multiply and a shift (exact: the rounding of
  // 2^16 / cs stays below 1 / cs over that range)
  const uint32_t inv = (65536u + cs - 1) / cs;
  // Row m's n (2: a float2 at v, 1: v.x) partial sums from column c on, to
  // the block that owns the row.
  auto put = [&](int m, int c0, float2 v0, int c1, float2 v1, int n) {
    const int q = static_cast<int>((m * inv) >> 16), o = m - q * cs;
    const int off = (rank * lr + q) * GV2_RED;
    if (o == rank) {
      float* dst = recv + off;
      if (n == 2) {
        *reinterpret_cast<float2*>(dst + c0) = v0;
        *reinterpret_cast<float2*>(dst + c1) = v1;
      } else {
        dst[c0] = v0.x;
      }
    } else {
      const uint32_t d = mma::peer_addr(recv_a + 4 * off, o);
      const uint32_t bar = mma::peer_addr(rbar, o);
      if (n == 2) {
        st_async2(d + 4 * c0, v0.x, v0.y, bar);
        st_async2(d + 4 * c1, v1.x, v1.y, bar);
      } else {
        st_async1(d + 4 * c0, v0.x, bar);
      }
    }
  };
  cluster_wait();                     // every block of the cluster runs
  if constexpr (kBF16) {
    const int g = lane >> 2, col = 16 * warp + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < MT / 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // rows 16 i + g and 16 i + g + 8
        const int row = 16 * i + g + 8 * h;
        if (row < M)
          put(row, col, make_float2(acc[i][0][2 * h], acc[i][0][2 * h + 1]),
              col + 8, make_float2(acc[i][1][2 * h], acc[i][1][2 * h + 1]),
              2);
      }
  } else {               // the column's two row halves, first one first
    float* half1 = reinterpret_cast<float*>(base);   // over the ring
    const int c = tid % GV2_WS, half = tid / GV2_WS;
    __syncthreads();
    if (half == 1) {
#pragma unroll
      for (int m = 0; m < MT; ++m) half1[m * GV2_RED + c] = facc[m];
    }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m < M)
          put(m, c, make_float2(facc[m] + half1[m * GV2_RED + c], 0.f), c,
              make_float2(0.f, 0.f), 1);
    }
  }
  __syncthreads();                    // this block's own partials
  mma::mbar_wait(rbar, 0);            // and every peer's
  // This block's rows: the cluster's partials in rank order, rounded once.
  // No block touches a peer's memory from here on.
  for (int e = tid; e < own * (GV2_WS / 4); e += GV2_THREADS) {
    const int l = e / (GV2_WS / 4), c = 4 * (e % (GV2_WS / 4));
    float4 v[GV2_MAX_CLUSTER];        // every rank's four sums, loaded first
#pragma unroll
    for (int r = 0; r < GV2_MAX_CLUSTER; ++r)
      if (r < cs)
        v[r] = *reinterpret_cast<const float4*>(
            recv + (r * lr + l) * GV2_RED + c);
    float4 sum = v[0];
#pragma unroll
    for (int r = 1; r < GV2_MAX_CLUSTER; ++r)
      if (r < cs) {
        sum.x += v[r].x;
        sum.y += v[r].y;
        sum.z += v[r].z;
        sum.w += v[r].w;
      }
    T* o = out + (size_t)(rank + l * cs) * ldo + col0 + c;
    const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (col0 + c + q < ncols) o[q] = cvt<T>(s4[q]);
  }
}

// Both launches are programmatic dependent launches: each waits in
// griddepcontrol.wait for the kernel ahead of it instead of in the stream.
template <typename T, int MT>
cudaError_t gv2_launch(const T* A, int lda, const T* W, T* out, int ldo,
                       int M, int kred, int ncols, int blocks, bool early_w,
                       cudaStream_t st) {
  const size_t smem = gv2_smem_bytes(sizeof(T), MT);
  static const cudaError_t configured = [smem] {
    const cudaError_t e = cudaFuncSetAttribute(
        gemv_stream_kernel<T, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(gemv_stream_kernel<T, MT>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }();
  if (configured != cudaSuccess) return configured;
  const Gv2Launch p = gv2_launch_plan(kred, ncols, blocks);
  const bool rows16 = reinterpret_cast<uintptr_t>(W) % 16 == 0 &&
                      (size_t)ncols * sizeof(T) % 16 == 0;
  const bool rows4 = reinterpret_cast<uintptr_t>(W) % 4 == 0 &&
                     (size_t)ncols * sizeof(T) % 4 == 0;
  const int wmode = rows16            ? W_ROWS16
                    : sizeof(T) == 4  ? W_FOUR
                    : rows4           ? W_PAIRS
                                      : W_RAW;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(p.strips, p.cluster, 1);
  cfg.blockDim = dim3(GV2_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = p.cluster;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, gemv_stream_kernel<T, MT>, A, lda, W, out,
                            ldo, M, kred, ncols, p.per, wmode,
                            static_cast<int>(early_w));
}

// t = round(x @ B) into t (M x gv2_t_stride(R)), then y = t @ C, launch 2
// overlapping launch 1's tail; each launch aims at blocks1 / blocks2
// blocks. x's rows on 16-byte boundaries; B and C any.
template <typename T, int MT>
cudaError_t gv2_pair(const T* x, const T* B, const T* C, T* y, T* t, int M,
                     int K, int R, int N, int blocks1, int blocks2,
                     cudaStream_t st) {
  const int rp = gv2_t_stride(R, sizeof(T));
  cudaError_t e =
      gv2_launch<T, MT>(x, K, B, t, rp, M, K, R, blocks1, false, st);
  if (e == cudaSuccess)
    e = gv2_launch<T, MT>(t, rp, C, y, N, M, R, N, blocks2, true, st);
  return e;
}

template <typename T>
int launch_gemv_stream(const void* x, const void* B, const void* C, void* y,
                       void* t, int M, int K, int R, int N, int blocks1,
                       int blocks2, cudaStream_t st) {
  if (M < 1 || M > GV2_MAX_ROWS || K < 1 || R < 1 || N < 1 ||
      blocks1 < 1 || blocks2 < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 || (size_t)K * sizeof(T) % 16 ||
      reinterpret_cast<uintptr_t>(t) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto xp = static_cast<const T*>(x);
  auto bp = static_cast<const T*>(B);
  auto cp = static_cast<const T*>(C);
  auto yp = static_cast<T*>(y);
  auto tp = static_cast<T*>(t);
  const int mt = gv2_rows_tile(M);
  const cudaError_t e =
      mt == 16   ? gv2_pair<T, 16>(xp, bp, cp, yp, tp, M, K, R, N, blocks1,
                                   blocks2, st)
      : mt == 32 ? gv2_pair<T, 32>(xp, bp, cp, yp, tp, M, K, R, N, blocks1,
                                   blocks2, st)
                 : gv2_pair<T, 64>(xp, bp, cp, yp, tp, M, K, R, N, blocks1,
                                   blocks2, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Prefill shape: one cluster per row tile, t shared across the cluster
// ---------------------------------------------------------------------------
constexpr int MM_BM = 32;        // rows of x per cluster
constexpr int MM_BN = 64;        // columns of t or y per tile
constexpr int MM_TK = 64;        // reduction values staged per step
constexpr int MM_CL = 8;         // blocks per cluster
constexpr int MM_THREADS = 256;  // 16 x 16 threads, 2 rows x 4 columns each
constexpr int MM_XS = MM_BM + 1; // padded row of the staged x tile
constexpr size_t MM_SMEM_MAX = 232448;   // a block's shared memory on sm_90

// Dynamic shared memory: t (Rp x BM, transposed), one staged weight tile
// (TK x BN) and one staged x tile (TK x (BM + 1)), all float32.
__host__ __device__ constexpr size_t mm_smem_bytes(int Rp) {
  return sizeof(float) * ((size_t)Rp * MM_BM + MM_TK * MM_BN + MM_TK * MM_XS);
}

// acc[2][4] += A-columns (2 rows) x W tile row (4 columns) over TK steps;
// the A value of row r at step k is a_at(k, r).
template <typename AFn>
__device__ __forceinline__ void mm_step(float (&acc)[2][4], const float* ws,
                                        int tx, int ty, AFn a_at) {
#pragma unroll 8
  for (int kk = 0; kk < MM_TK; ++kk) {
    const float4 b = *reinterpret_cast<const float4*>(ws + kk * MM_BN + tx * 4);
    const float a0 = a_at(kk, ty * 2), a1 = a_at(kk, ty * 2 + 1);
    acc[0][0] += a0 * b.x; acc[0][1] += a0 * b.y;
    acc[0][2] += a0 * b.z; acc[0][3] += a0 * b.w;
    acc[1][0] += a1 * b.x; acc[1][1] += a1 * b.y;
    acc[1][2] += a1 * b.z; acc[1][3] += a1 * b.w;
  }
}

constexpr int MM_WPT = MM_TK * MM_BN / MM_THREADS;   // staged W per thread
constexpr int MM_XPT = MM_BM * MM_TK / MM_THREADS;   // staged x per thread

// Load this thread's share of rows [k0, k0 + TK) x columns [c0, c0 + BN) of
// the row-major (rows x cols) matrix W into registers, zero outside it. The
// loads of one tile are issued together, and the next tile's loads run
// while the current one is multiplied (register double buffering).
template <typename T>
__device__ __forceinline__ void mm_load_w(float (&r)[MM_WPT], const T* W,
                                          int rows, int cols, int k0,
                                          int c0) {
#pragma unroll
  for (int j = 0; j < MM_WPT; ++j) {
    const int i = threadIdx.x + j * MM_THREADS;
    const int k = k0 + i / MM_BN, c = c0 + i % MM_BN;
    r[j] = (k < rows && c < cols) ? ld(W + (size_t)k * cols + c) : 0.f;
  }
}

__device__ __forceinline__ void mm_store_w(float* ws,
                                           const float (&r)[MM_WPT]) {
#pragma unroll
  for (int j = 0; j < MM_WPT; ++j) ws[threadIdx.x + j * MM_THREADS] = r[j];
}

// The same for rows [m0, m0 + BM) x columns [k0, k0 + TK) of x (M x K),
// stored transposed: xs[k * (BM + 1) + m].
template <typename T>
__device__ __forceinline__ void mm_load_x(float (&r)[MM_XPT], const T* x,
                                          int M, int K, int m0, int k0) {
#pragma unroll
  for (int j = 0; j < MM_XPT; ++j) {
    const int i = threadIdx.x + j * MM_THREADS;
    const int m = m0 + i / MM_TK, k = k0 + i % MM_TK;
    r[j] = (m < M && k < K) ? ld(x + (size_t)m * K + k) : 0.f;
  }
}

__device__ __forceinline__ void mm_store_x(float* xs,
                                           const float (&r)[MM_XPT]) {
#pragma unroll
  for (int j = 0; j < MM_XPT; ++j) {
    const int i = threadIdx.x + j * MM_THREADS;
    xs[(i % MM_TK) * MM_XS + i / MM_TK] = r[j];
  }
}

// y[m0:m0+BM, :] = round_T(x[m0:m0+BM, :] @ B) @ C for the row tile of this
// cluster. Phase 1: block c of the cluster computes the 64-column chunks
// c, c + CL, ... of t over the whole of K and keeps them, rounded to T, in
// its shared memory. After a cluster barrier every block copies the other
// chunks from its peers' shared memory (distributed shared memory), so t
// never leaves the chip. Phase 2: block c emits the 64-column chunks c,
// c + CL, ... of y from the whole of t.
template <typename T>
__global__ void __cluster_dims__(MM_CL, 1, 1) __launch_bounds__(MM_THREADS)
lowrank_2d_kernel(const T* __restrict__ x, const T* __restrict__ B,
                  const T* __restrict__ C, T* __restrict__ y, int M, int K,
                  int R, int N) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float smem[];
  const int Rp = cdiv(R, MM_BN) * MM_BN;
  float* ts = smem;                          // [Rp][BM]: ts[r * BM + m]
  float* ws = ts + (size_t)Rp * MM_BM;       // [TK][BN]
  float* xs = ws + MM_TK * MM_BN;            // [TK][BM + 1]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * MM_BM;
  const int nrc = Rp / MM_BN;

  // ---- phase 1: this block's chunks of t = x @ B ------------------------
  for (int rc = rank; rc < nrc; rc += MM_CL) {
    const int r0 = rc * MM_BN;
    float acc[2][4] = {};
    float xr[MM_XPT], wr[MM_WPT];
    mm_load_x(xr, x, M, K, m0, 0);
    mm_load_w(wr, B, K, R, 0, r0);
    for (int k0 = 0; k0 < K; k0 += MM_TK) {
      mm_store_x(xs, xr);
      mm_store_w(ws, wr);
      __syncthreads();
      if (k0 + MM_TK < K) {
        mm_load_x(xr, x, M, K, m0, k0 + MM_TK);
        mm_load_w(wr, B, K, R, k0 + MM_TK, r0);
      }
      mm_step(acc, ws, tx, ty,
              [&](int kk, int r) { return xs[kk * MM_XS + r]; });
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)   // columns past R stay exact zeros
        ts[(size_t)(r0 + tx * 4 + j) * MM_BM + ty * 2 + i] =
            round_to<T>(acc[i][j]);
  }

  // ---- gather the peers' chunks of t through distributed shared memory --
  cluster.sync();
  for (int rc = 0; rc < nrc; ++rc) {
    const int owner = rc % MM_CL;
    if (owner == rank) continue;
    const float4* src = reinterpret_cast<const float4*>(
        cluster.map_shared_rank(ts + (size_t)rc * MM_BN * MM_BM, owner));
    float4* dst = reinterpret_cast<float4*>(ts + (size_t)rc * MM_BN * MM_BM);
    for (int i = tid; i < MM_BN * MM_BM / 4; i += MM_THREADS) dst[i] = src[i];
  }
  cluster.sync();   // no block leaves while a peer still reads its chunks

  // ---- phase 2: this block's chunks of y = t @ C ------------------------
  const int nnc = cdiv(N, MM_BN);
  for (int nc = rank; nc < nnc; nc += MM_CL) {
    const int n0 = nc * MM_BN;
    float acc[2][4] = {};
    float wr[MM_WPT];
    mm_load_w(wr, C, R, N, 0, n0);
    for (int k0 = 0; k0 < Rp; k0 += MM_TK) {
      mm_store_w(ws, wr);
      __syncthreads();
      if (k0 + MM_TK < Rp) mm_load_w(wr, C, R, N, k0 + MM_TK, n0);
      const float* tk = ts + (size_t)k0 * MM_BM;
      mm_step(acc, ws, tx, ty,
              [&](int kk, int r) { return tk[kk * MM_BM + r]; });
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + ty * 2 + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < N) y[(size_t)m * N + n] = cvt<T>(acc[i][j]);
      }
    }
  }
}

template <typename T>
int launch_2d(const void* x, const void* B, const void* C, void* y, int M,
              int K, int R, int N, cudaStream_t st) {
  const int Rp = cdiv(R, MM_BN) * MM_BN;
  const size_t smem = mm_smem_bytes(Rp);
  if (smem > MM_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        lowrank_2d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(MM_SMEM_MAX));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(MM_CL, cdiv(M, MM_BM));
  lowrank_2d_kernel<T><<<grid, MM_THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), M, K, R, N);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Prefill shape, bfloat16 on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int WG_T = mma::TILE;               // rows a cluster, t/y columns
constexpr int WG_GROUPS = 2;                  // warpgroups a block
constexpr int WG_BLOCK = WG_GROUPS * mma::WG_THREADS;
constexpr int WG_CL = 8;                      // blocks a cluster
// Ring slots of phase 1 (a tile of x and a raw tile of B per warpgroup) and
// of phase 2 (a tile of C per warpgroup), in one region of shared memory.
#ifndef DRT_WG_S2   // a profiling build may set phase 2's ring depth
#define DRT_WG_S2 6
#endif
constexpr int WG_S1 = 3, WG_S2 = DRT_WG_S2;
constexpr int WG_SLOT1 = mma::TILE_BYTES + WG_GROUPS * mma::RAW_BYTES;
constexpr int WG_SLOT2 = WG_GROUPS * mma::TILE_BYTES;
constexpr int WG_BSW = 2 * WG_GROUPS * mma::TILE_BYTES;   // unpacked B
// How the kernel stages B (K x R), by where its rows start (bmode).
enum BStage : int { B_RAW = 0, B_TMA = 1, B_PAIRS = 2 };
// Dynamic shared memory, from a 1024-byte-aligned base: t (nrc tiles of
// 64 rows x 64 ranks, K-major), then the ring region, which holds phase
// 1's slots and the unpacked B tiles (two per warpgroup), and later phase
// 2's slots; plus the alignment slack.
__host__ __device__ constexpr size_t wg_smem_bytes(int nrc) {
  return 1024 + (size_t)nrc * mma::TILE_BYTES +
         ((size_t)WG_S1 * WG_SLOT1 + WG_BSW > (size_t)WG_S2 * WG_SLOT2
              ? (size_t)WG_S1 * WG_SLOT1 + WG_BSW
              : (size_t)WG_S2 * WG_SLOT2);
}
// The dynamic shared memory a block may take beside the kernel's static
// mbarrier (with room to spare).
constexpr size_t WG_SMEM_MAX = MM_SMEM_MAX - 1024;

// y[m0:m0+64, :] = round_bf16(x[m0:m0+64, :] @ B) @ C for the row tile of
// this cluster, both products on wgmma. A block has two consumer
// warpgroups and one producer warp. The producer's lane 0 fills a ring of
// slots by TMA (the x tile; the B tiles where B's rows start on 16-byte
// boundaries; the C tiles), each slot with a "full" mbarrier (the bytes to
// expect) and an "empty" one (the consumers release it after the wgmma that
// read it); the consumers only wait, multiply and store, so nothing
// divergent runs beside their wgmma (the compiler would serialize them).
// Phase 1: warpgroup w of block c of the cluster computes t's 64-column
// chunks c + CL w, c + CL (2 + w), ... over the whole of K (A = the x tile,
// K-major, shared by both; B = the factor's tile, MN-major), rounds each to
// bf16, stores it as a K-major tile of t and pushes it into every peer's
// shared memory (one bulk copy per peer, completing on the peer's tbar).
// Where B's rows are not 16-byte aligned each warpgroup stages its own B
// tiles by cp.async, WG_S1 - 2 steps ahead (bmode B_PAIRS: 4-byte copies
// of rows on 4-byte boundaries; B_RAW: raw words, shifted into place
// before the MMA).
// Phase 2: warpgroup w emits y's 64-column chunks c + CL w, c + CL (2 + w),
// ... from the whole of t (A = t, K-major; B = C's tile, MN-major), once
// the peers' chunks have landed.
__global__ void __launch_bounds__(WG_BLOCK + 32, 1) lowrank_2d_wgmma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ B,
    const bf16* __restrict__ C, bf16* __restrict__ y, int M, int K, int R,
    int N, int bmode, const __grid_constant__ CUtensorMap tmx,
    const __grid_constant__ CUtensorMap tmb,
    const __grid_constant__ CUtensorMap tmc) {
  namespace cg = cooperative_groups;
  using namespace mma;
  extern __shared__ __align__(16) char smem_in[];
  // full and empty barriers of both rings, then tbar: the peers' chunks of
  // t have landed
  __shared__ __align__(8) uint64_t bars[2 * (WG_S1 + WG_S2) + 1];
  char* ts = smem_in + ((1024 - (smem_u32(smem_in) & 1023)) & 1023);
  const int nrc = cdiv(R, WG_T);
  char* ring = ts + (size_t)nrc * TILE_BYTES;
  char* bsw = ring + WG_S1 * WG_SLOT1;
  const uint32_t ts_a = smem_u32(ts), ring_a = smem_u32(ring);
  const uint32_t bsw_a = smem_u32(bsw);
  const uint32_t full1 = smem_u32(bars), empty1 = full1 + 8 * WG_S1;
  const uint32_t full2 = empty1 + 8 * WG_S1, empty2 = full2 + 8 * WG_S2;
  const uint32_t tbar = empty2 + 8 * WG_S2;

  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // 0, 1: consumer warpgroups; 2: the producer warp (a warp-uniform value
  // the compiler can see as such)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0);
  const int wt = threadIdx.x % WG_THREADS;
  const int m0 = blockIdx.y * WG_T;
  const int nk = cdiv(K, WG_T), nnc = cdiv(N, WG_T);
  const int steps1 =
      rank < nrc ? cdiv(nrc - rank, WG_GROUPS * CL) * nk : 0;
  const int steps2 =
      rank < nnc ? cdiv(nnc - rank, WG_GROUPS * CL) * nrc : 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < WG_S1; ++i) {
      mbar_init(full1 + 8 * i, 1);
      mbar_init(empty1 + 8 * i, WG_BLOCK);
    }
    for (int i = 0; i < WG_S2; ++i) {
      mbar_init(full2 + 8 * i, 1);
      mbar_init(empty2 + 8 * i, WG_BLOCK);
    }
    // Each block pushes every chunk of t it computes into its peers'
    // shared memory and waits here for the chunks its peers compute.
    const int own = rank < nrc ? cdiv(nrc - rank, CL) : 0;
    mbar_init(tbar, 1);
    mbar_arrive_expect(tbar, (nrc - own) * TILE_BYTES);
  }
  const int slot_id = blockIdx.y * 16 + rank;   // profiling builds only
  prof_stamp(slot_id, 0);
  cluster.sync();   // every barrier is ready before any peer pushes into it
  prof_stamp(slot_id, 1);

  // ---- phase 1: this block's chunks of t = x @ B -------------------------
  if (wg == WG_GROUPS) {
    // producer: the x tiles, and B's where aligned; lane 0 arms the slot's
    // barrier, then lanes 0-2 issue one TMA each (an issue takes ~100
    // cycles, so they go in parallel)
    const int lane = wt % 32;
    if (lane == 0) {
      tma_prefetch(&tmx);
      if (bmode == B_TMA) tma_prefetch(&tmb);
    }
    for (int q = 0; q < steps1; ++q) {
      const int slot = q % WG_S1, k0 = (q % nk) * WG_T;
      const int rc = rank + CL * WG_GROUPS * (q / nk);
      const uint32_t s = ring_a + slot * WG_SLOT1, bar = full1 + 8 * slot;
      const int nb = bmode == B_TMA ? (rc < nrc) + (rc + CL < nrc) : 0;
      if (lane == 0) {
        if (q >= WG_S1) mbar_wait(empty1 + 8 * slot, (q / WG_S1 - 1) & 1);
        mbar_arrive_expect(bar, TILE_BYTES * (1 + nb));
      }
      __syncwarp();
      if (lane == 0) tma_load_2d(s, &tmx, k0, m0, bar);
      if (lane >= 1 && lane <= nb)
        tma_load_2d(s + TILE_BYTES + (lane - 1) * RAW_BYTES, &tmb,
                    (rc + CL * (lane - 1)) * WG_T, k0, bar);
    }
  } else {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    auto chunk = [&](int q) {   // this warpgroup's t chunk at step q
      return rank + CL * (WG_GROUPS * (q / nk) + wg);
    };
    auto stage_b = [&](int q) {   // this warpgroup's own B tile by cp.async
      const int rc = chunk(q), k0 = (q % nk) * WG_T;
      if (rc >= nrc) return;
      const uint32_t b =
          ring_a + (q % WG_S1) * WG_SLOT1 + TILE_BYTES + wg * RAW_BYTES;
      if (bmode == B_PAIRS)
        stage_tile_pairs<WG_THREADS>(b, B, R, K, R, k0, rc * WG_T, wt);
      else
        stage_raw<WG_THREADS>(b, B, R, K, k0, rc * WG_T, wt);
    };
    const bool own_b = bmode != B_TMA;
    if (own_b) {
#pragma unroll
      for (int p = 0; p < WG_S1 - 2; ++p) {
        if (p < steps1) stage_b(p);
        cp_async_commit();
      }
    }
    for (int q = 0; q < steps1; ++q) {
      const int slot = q % WG_S1, rc = chunk(q), k0 = (q % nk) * WG_T;
      mbar_wait(full1 + 8 * slot, (q / WG_S1) & 1);
      uint32_t b = ring_a + slot * WG_SLOT1 + TILE_BYTES + wg * RAW_BYTES;
      if (own_b) {
        cp_async_wait<WG_S1 - 3>();
        fence_proxy_async();
        // this warpgroup's B copies of step q are visible to it, and its
        // MMA of step q - 2 has completed in every warp
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG_THREADS)
                     : "memory");
        if (q + WG_S1 - 2 < steps1) stage_b(q + WG_S1 - 2);
        cp_async_commit();
        if (bmode == B_RAW) {
          if (rc < nrc)
            unpack_raw<WG_THREADS>(bsw + (2 * wg + (q & 1)) * TILE_BYTES,
                                   ring + slot * WG_SLOT1 + TILE_BYTES +
                                       wg * RAW_BYTES,
                                   B, R, K, R, k0, rc * WG_T, wt);
          fence_proxy_async();
          asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG_THREADS)
                       : "memory");
          b = bsw_a + (2 * wg + (q & 1)) * TILE_BYTES;
        }
      }
      // A warpgroup without a chunk multiplies stale tiles and stores
      // nothing: a wgmma on a divergent path is serialized.
      const uint32_t a = ring_a + slot * WG_SLOT1;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16<0, 1>(acc, desc_kmajor(a, kk), desc_mnmajor(b, kk),
                              !(q % nk == 0 && kk == 0));
      wgmma_commit();
      wgmma_wait<1>();
      if (q > 0) mbar_arrive(empty1 + 8 * ((q - 1) % WG_S1));
      if (q % nk != nk - 1 || rc >= nrc) continue;
      // the chunk is done: round it into t, then push it to every peer
      wgmma_wait<0>();
      hold_regs(acc);
      char* t = ts + (size_t)rc * TILE_BYTES;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = acc_row(wt, i), c = acc_col(wt, i);
        *reinterpret_cast<__nv_bfloat162*>(t + swz_offset(r, c / 8) +
                                           2 * (c % 8)) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
      fence_proxy_async();
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG_THREADS)
                   : "memory");
      if (wt == 0) {
        for (int p = 1; p < CL; ++p)
          push_to_peer(smem_u32(t), tbar, TILE_BYTES, (rank + p) % CL);
        bulk_commit();
      }
    }
    wgmma_wait<0>();
    cp_async_wait<0>();
    prof_stamp(slot_id, 2);
  }
  // phase 1's slots are read out before phase 2's tiles land in the region
  __syncthreads();

  // ---- phase 2: this block's chunks of y = t @ C -------------------------
  if (wg == WG_GROUPS) {
    // producer: both warpgroups' C tiles, lanes 0 and 1 one each
    const int lane = wt % 32;
    if (lane == 0) tma_prefetch(&tmc);
    for (int q = 0; q < steps2; ++q) {
      const int slot = q % WG_S2, nc0 = rank + CL * WG_GROUPS * (q / nrc);
      const int n = (nc0 < nnc) + (nc0 + CL < nnc);
      if (lane == 0) {
        if (q >= WG_S2) mbar_wait(empty2 + 8 * slot, (q / WG_S2 - 1) & 1);
        mbar_arrive_expect(full2 + 8 * slot, TILE_BYTES * n);
      }
      __syncwarp();
      if (lane < n)
        tma_load_2d(ring_a + slot * WG_SLOT2 + lane * TILE_BYTES, &tmc,
                    (nc0 + CL * lane) * WG_T, (q % nrc) * WG_T,
                    full2 + 8 * slot);
    }
  } else {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    prof_stamp(slot_id, 3);
    mbar_wait(tbar, 0);   // t complete; no peer pushes into this block later
    for (int q = 0; q < steps2; ++q) {
      const int slot = q % WG_S2, j = q % nrc;
      const int nc = rank + CL * (WG_GROUPS * (q / nrc) + wg);
      mbar_wait(full2 + 8 * slot, (q / WG_S2) & 1);
      // t past R and C's rows past R are zeros; a warpgroup without a
      // chunk multiplies stale tiles and stores nothing
      const uint32_t a = ts_a + j * TILE_BYTES;
      const uint32_t b = ring_a + slot * WG_SLOT2 + wg * TILE_BYTES;
#ifndef DRT_PROFILE_NO_MMA2   // a profiling build may leave them out
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16<0, 1>(acc, desc_kmajor(a, kk), desc_mnmajor(b, kk),
                              !(j == 0 && kk == 0));
      wgmma_commit();
      wgmma_wait<1>();
#endif
      if (q > 0) mbar_arrive(empty2 + 8 * ((q - 1) % WG_S2));
      if (j != nrc - 1 || nc >= nnc) continue;
      wgmma_wait<0>();
      hold_regs(acc);
      const int n0 = nc * WG_T;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {   // N % 8 == 0: pairs are in or out
        const int m = m0 + acc_row(wt, i), n = n0 + acc_col(wt, i);
        if (m < M && n < N)
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + n) =
              __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
    }
    wgmma_wait<0>();
    prof_stamp(slot_id, 4);
    if (wt == 0) bulk_wait_read();   // the pushes have read this block's t
  }
}

// Both attributes before the first launch or query: the shared memory
// beyond 48 KB, and clusters of more than 8 blocks (for the query).
cudaError_t wg_configure() {
  static const cudaError_t status = [] {
    cudaError_t e = cudaFuncSetAttribute(
        lowrank_2d_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(WG_SMEM_MAX));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(lowrank_2d_wgmma_kernel,
                                cudaFuncAttributeNonPortableClusterSizeAllowed,
                                1);
  }();
  return status;
}

void wg_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int M,
               size_t smem, int cluster, cudaStream_t st) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(cluster, cdiv(M, WG_T), 1);
  cfg.blockDim = dim3(WG_BLOCK + 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

int launch_2d_wgmma(const void* x, const void* B, const void* C, void* y,
                    int M, int K, int R, int N, cudaStream_t st) {
  const size_t smem = wg_smem_bytes(cdiv(R, WG_T));
  if (R < 1 || K < 8 || K % 8 || N % 8 || smem > WG_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = wg_configure();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  wg_config(cfg, attr, M, smem, WG_CL, st);
  // x and C by TMA; B too where its rows start on 16-byte boundaries, else
  // by cp.async (a profiling build with DRT_B_RAW takes raw words for every
  // such B, to time them against the 4-byte copies)
  const uintptr_t b = reinterpret_cast<uintptr_t>(B);
  int bmode = B_RAW;
  if (R % 8 == 0 && b % 16 == 0) bmode = B_TMA;
#ifndef DRT_B_RAW
  else if (R % 2 == 0 && b % 4 == 0) bmode = B_PAIRS;
#endif
  CUtensorMap tmx, tmb, tmc;
  e = mma::make_tmap(&tmx, x, K, M, 2ull * K);
  if (e == cudaSuccess) e = mma::make_tmap(&tmc, C, N, R, 2ull * N);
  tmb = tmx;
  if (e == cudaSuccess && bmode == B_TMA)
    e = mma::make_tmap(&tmb, B, R, K, 2ull * R);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(&cfg, lowrank_2d_wgmma_kernel,
                         static_cast<const bf16*>(x),
                         static_cast<const bf16*>(B),
                         static_cast<const bf16*>(C), static_cast<bf16*>(y),
                         M, K, R, N, bmode, tmx, tmb, tmc);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Prefill shape, any rank: two launches through an (M, R) t in device memory
// ---------------------------------------------------------------------------
// out (M x N) = round_T(A (M x K) @ W (K x N)), all row-major: launch 1 is
// t = x @ B, launch 2 is y = t @ C, so t is rounded to T between the two
// products exactly as the fused kernels round it on chip.

// CUDA cores, any dtype and shape: a 64 x 64 output tile a block, 256
// threads of 4 x 4 float32 sums, the reduction staged 16 values at a time
// in shared memory (A transposed, so both operands are read as float4s).
constexpr int SG_T = 64, SG_K = 16, SG_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(SG_THREADS) gemm_simt_kernel(
    const T* __restrict__ A, const T* __restrict__ W, T* __restrict__ out,
    int M, int K, int N) {
  __shared__ __align__(16) float as[SG_K][SG_T + 4];   // as[k][m]
  __shared__ __align__(16) float ws[SG_K][SG_T];       // ws[k][n]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * SG_T, n0 = blockIdx.x * SG_T;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += SG_K) {
#pragma unroll
    for (int j = 0; j < SG_T * SG_K / SG_THREADS; ++j) {
      const int i = threadIdx.x + j * SG_THREADS;
      const int am = i / SG_K, ak = i % SG_K;       // A: k fastest
      const int wk = i / SG_T, wn = i % SG_T;       // W: n fastest
      as[ak][am] = (m0 + am < M && k0 + ak < K)
                       ? ld(A + (size_t)(m0 + am) * K + k0 + ak) : 0.f;
      ws[wk][wn] = (k0 + wk < K && n0 + wn < N)
                       ? ld(W + (size_t)(k0 + wk) * N + n0 + wn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SG_K; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float a4[4] = {a.x, a.y, a.z, a.w};
      const float w4[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a4[i] * w4[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(size_t)m * N + n] = cvt<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch_split_simt(const void* x, const void* B, const void* C, void* y,
                      void* t, int M, int K, int R, int N, cudaStream_t st) {
  gemm_simt_kernel<T><<<dim3(cdiv(R, SG_T), cdiv(M, SG_T)), SG_THREADS, 0,
                        st>>>(static_cast<const T*>(x),
                              static_cast<const T*>(B), static_cast<T*>(t),
                              M, K, R);
  gemm_simt_kernel<T><<<dim3(cdiv(N, SG_T), cdiv(M, SG_T)), SG_THREADS, 0,
                        st>>>(static_cast<const T*>(t),
                              static_cast<const T*>(C), static_cast<T*>(y),
                              M, R, N);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 on the tensor cores: the 2-D kernel's phase 1 without the
// cluster. A block has two consumer warpgroups and a producer warp; each
// warpgroup owns a 64 x 64 tile of the output and loops over K in steps of
// 64 through a ring of SP_S slots, one float32 accumulation. The two
// warpgroups share one operand tile a step, which the producer stages by
// TMA ("shared"), and each has its own tile of the other ("own"):
//   OWN_B (launch 1, t = x @ B): a 64 x 128 block tile; shared = the x tile
//     (K-major A), own = warpgroup w's B tile (columns n0 + 64 w, MN-major);
//   !OWN_B (launch 2, y = t @ C): a 128 x 64 block tile; shared = the C
//     tile (MN-major B), own = warpgroup w's t tile (rows m0 + 64 w,
//     K-major A).
// The own operand is the one whose row stride is the rank (B: 2R bytes, t:
// 2R bytes), so it has a tensor map only at R % 8 == 0: then the producer
// stages it too; at a ragged rank each warpgroup copies the aligned 16-byte
// words that cover its tile by cp.async, SP_S - 2 steps ahead, and shifts
// them into place (stage_raw, unpack_raw) before the MMA, as the 2-D
// kernel's B. Nothing is padded: t is (M, R) with row stride R. The blocks
// tile the whole output, so both launches spread over every SM (at 512
// rows: 160 blocks for t at R 2457, 960 for y at N 15360).
constexpr int SP_S = 4;                                   // ring slots
constexpr int SP_SLOT = mma::TILE_BYTES + WG_GROUPS * mma::RAW_BYTES;
constexpr int SP_BSW = 2 * WG_GROUPS * mma::TILE_BYTES;   // unpacked own
constexpr int SP_SMEM = 1024 + SP_S * SP_SLOT + SP_BSW;

template <bool OWN_B>
__global__ void __launch_bounds__(WG_BLOCK + 32, 1) split_wgmma_kernel(
    const bf16* __restrict__ own, bf16* __restrict__ out, int M, int K, int N,
    int own_tma, const __grid_constant__ CUtensorMap tms,
    const __grid_constant__ CUtensorMap tmo) {
  using namespace mma;
  extern __shared__ __align__(16) char smem_in[];
  __shared__ __align__(8) uint64_t bars[2 * SP_S];   // full, then empty
  char* ring = smem_in + ((1024 - (smem_u32(smem_in) & 1023)) & 1023);
  char* bsw = ring + SP_S * SP_SLOT;
  const uint32_t ring_a = smem_u32(ring), bsw_a = smem_u32(bsw);
  const uint32_t full = smem_u32(bars), empty = full + 8 * SP_S;
  // 0, 1: consumer warpgroups; 2: the producer warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0);
  const int wt = threadIdx.x % WG_THREADS;
  const int m0 = blockIdx.y * (OWN_B ? WG_T : 2 * WG_T);
  const int n0 = blockIdx.x * (OWN_B ? 2 * WG_T : WG_T);
  const int nk = cdiv(K, WG_T);
  // the own operand (row-major, rows x cols, row stride cols): B (K x N) or
  // t (M x K); tile w starts at row or0(w), column oc0(w, k0)
  const int orows = OWN_B ? K : M, ocols = OWN_B ? N : K;
  auto or0 = [&](int w, int k0) { return OWN_B ? k0 : m0 + w * WG_T; };
  auto oc0 = [&](int w, int k0) { return OWN_B ? n0 + w * WG_T : k0; };
  auto own_ok = [&](int w) {   // the tile lies (partly) inside the output
    return OWN_B ? n0 + w * WG_T < N : m0 + w * WG_T < M;
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < SP_S; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, WG_BLOCK);
    }
  }
  __syncthreads();

  if (wg == WG_GROUPS) {
    // producer: lane 0 arms the slot and issues the shared tile, lanes 1-2
    // the own tiles where they have a tensor map
    const int lane = wt % 32;
    if (lane == 0) {
      tma_prefetch(&tms);
      if (own_tma) tma_prefetch(&tmo);
    }
    const int no = own_tma ? own_ok(0) + own_ok(1) : 0;
    for (int q = 0; q < nk; ++q) {
      const int slot = q % SP_S, k0 = q * WG_T;
      const uint32_t s = ring_a + slot * SP_SLOT, bar = full + 8 * slot;
      if (lane == 0) {
        if (q >= SP_S) mbar_wait(empty + 8 * slot, (q / SP_S - 1) & 1);
        mbar_arrive_expect(bar, TILE_BYTES * (1 + no));
      }
      __syncwarp();
      if (lane == 0) {
        if (OWN_B) tma_load_2d(s, &tms, k0, m0, bar);      // x (M x K)
        else tma_load_2d(s, &tms, n0, k0, bar);            // C (K x N)
      }
      if (lane >= 1 && lane <= no) {
        const int w = lane - 1;
        tma_load_2d(s + TILE_BYTES + w * RAW_BYTES, &tmo, oc0(w, k0),
                    or0(w, k0), bar);
      }
    }
  } else {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    const bool ok = own_ok(wg);
    auto stage_own = [&](int q) {
      if (!ok) return;
      stage_raw<WG_THREADS>(
          ring_a + (q % SP_S) * SP_SLOT + TILE_BYTES + wg * RAW_BYTES, own,
          ocols, orows, or0(wg, q * WG_T), oc0(wg, q * WG_T), wt);
    };
    if (!own_tma) {
#pragma unroll
      for (int p = 0; p < SP_S - 2; ++p) {
        if (p < nk) stage_own(p);
        cp_async_commit();
      }
    }
    for (int q = 0; q < nk; ++q) {
      const int slot = q % SP_S, k0 = q * WG_T;
      mbar_wait(full + 8 * slot, (q / SP_S) & 1);
      uint32_t o = ring_a + slot * SP_SLOT + TILE_BYTES + wg * RAW_BYTES;
      if (!own_tma) {
        cp_async_wait<SP_S - 3>();
        fence_proxy_async();
        // this warpgroup's copies of step q are visible to it, and its MMA
        // of step q - 2 has completed in every warp
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG_THREADS)
                     : "memory");
        if (q + SP_S - 2 < nk) stage_own(q + SP_S - 2);
        cp_async_commit();
        if (ok)
          unpack_raw<WG_THREADS>(bsw + (2 * wg + (q & 1)) * TILE_BYTES,
                                 ring + slot * SP_SLOT + TILE_BYTES +
                                     wg * RAW_BYTES,
                                 own, ocols, orows, ocols, or0(wg, k0),
                                 oc0(wg, k0), wt);
        fence_proxy_async();
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG_THREADS)
                     : "memory");
        o = bsw_a + (2 * wg + (q & 1)) * TILE_BYTES;
      }
      // A warpgroup whose tile lies past the output multiplies stale tiles
      // and stores nothing: a wgmma on a divergent path is serialized.
      const uint32_t sh = ring_a + slot * SP_SLOT;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (OWN_B)
          wgmma_m64n64k16<0, 1>(acc, desc_kmajor(sh, kk), desc_mnmajor(o, kk),
                                !(q == 0 && kk == 0));
        else
          wgmma_m64n64k16<0, 1>(acc, desc_kmajor(o, kk), desc_mnmajor(sh, kk),
                                !(q == 0 && kk == 0));
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (q > 0) mbar_arrive(empty + 8 * ((q - 1) % SP_S));
    }
    wgmma_wait<0>();
    cp_async_wait<0>();
    hold_regs(acc);
    const int r0 = m0 + (OWN_B ? 0 : wg * WG_T);
    const int c0 = n0 + (OWN_B ? wg * WG_T : 0);
    if (N % 2 == 0) {     // pairs of columns are wholly in or out
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int m = r0 + acc_row(wt, i), n = c0 + acc_col(wt, i);
        if (m < M && n < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
              __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int m = r0 + acc_row(wt, i), n = c0 + acc_col(wt, i);
        if (m < M && n < N) out[(size_t)m * N + n] = __float2bfloat16(acc[i]);
      }
    }
  }
}

template <bool OWN_B>
int launch_split_gemm(const bf16* own, bf16* out, int M, int K, int N,
                      int own_tma, const CUtensorMap& tms,
                      const CUtensorMap& tmo, cudaStream_t st) {
  static const cudaError_t configured = cudaFuncSetAttribute(
      split_wgmma_kernel<OWN_B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SP_SMEM);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid = OWN_B ? dim3(cdiv(N, 2 * WG_T), cdiv(M, WG_T))
                          : dim3(cdiv(N, WG_T), cdiv(M, 2 * WG_T));
  split_wgmma_kernel<OWN_B><<<grid, WG_BLOCK + 32, SP_SMEM, st>>>(
      own, out, M, K, N, own_tma, tms, tmo);
  return static_cast<int>(cudaGetLastError());
}

int launch_split_wgmma(const void* x, const void* B, const void* C, void* y,
                       void* t, int M, int K, int R, int N, cudaStream_t st) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ca = reinterpret_cast<uintptr_t>(C);
  const uintptr_t ta = reinterpret_cast<uintptr_t>(t);
  if (R < 1 || K < 8 || K % 8 || N % 8 || xa % 16 || ca % 16 || ta % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // B and t have tensor maps where their rows (2R bytes) start on 16-byte
  // boundaries; else the consumers copy their words
  const int own_tma =
      R % 8 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0 ? 1 : 0;
  CUtensorMap tmx, tmb, tmc, tmt;
  cudaError_t e = mma::make_tmap(&tmx, x, K, M, 2ull * K);
  if (e == cudaSuccess) e = mma::make_tmap(&tmc, C, N, R, 2ull * N);
  tmb = tmx;
  tmt = tmc;
  if (e == cudaSuccess && own_tma) e = mma::make_tmap(&tmb, B, R, K, 2ull * R);
  if (e == cudaSuccess && own_tma) e = mma::make_tmap(&tmt, t, R, M, 2ull * R);
  if (e != cudaSuccess) return static_cast<int>(e);
  int rc = launch_split_gemm<true>(static_cast<const bf16*>(B),
                                   static_cast<bf16*>(t), M, K, R, own_tma,
                                   tmx, tmb, st);
  if (rc != 0) return rc;
  return launch_split_gemm<false>(static_cast<const bf16*>(t),
                                  static_cast<bf16*>(y), M, R, N, own_tma,
                                  tmc, tmt, st);
}

}  // namespace
}  // namespace drt

extern "C" {

// Largest rank the tensor-core prefill kernel takes: t (64 rows, the rank
// rounded up to 64, bf16) and the ring must fit one block's shared memory.
int drt_lowrank_2d_wgmma_max_rank() {
  int n = 0;
  while (drt::wg_smem_bytes(n + 1) <= drt::WG_SMEM_MAX) ++n;
  return n * drt::WG_T;
}

// Clusters of `cluster` blocks of the tensor-core prefill kernel at rank R
// that the card can hold at once (cudaOccupancyMaxActiveClusters), or a
// negative CUDA error: what chose WG_CL.
int drt_lowrank_2d_wgmma_clusters(int R, int cluster) {
  cudaError_t e = drt::wg_configure();
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  drt::wg_config(cfg, attr, drt::WG_T, drt::wg_smem_bytes(drt::cdiv(R, 64)),
                 cluster, nullptr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, drt::lowrank_2d_wgmma_kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// bfloat16 x (M, K), B (K, R), C (R, N), y (M, N) on the tensor cores; K and
// N multiples of 8, x and C 16-byte aligned (B any), R at most
// drt_lowrank_2d_wgmma_max_rank().
int drt_lowrank_matmul_2d_wgmma(const void* x, const void* B, const void* C,
                                void* y, int M, int K, int R, int N,
                                void* stream) {
  return drt::launch_2d_wgmma(x, B, C, y, M, K, R, N,
                              static_cast<cudaStream_t>(stream));
}

// x (M, K), B (K, R), C (R, N), y (M, N) of one dtype, any rank: two
// launches through t (M, R), scratch of the same dtype. bfloat16 with K
// and N multiples of 8 and x, C and t 16-byte aligned runs on the tensor
// cores (tensor_cores != 0); every other operand on the CUDA cores.
int drt_lowrank_matmul_2d_split(const void* x, const void* B, const void* C,
                                void* y, void* t, int M, int K, int R, int N,
                                int dtype, int tensor_cores, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (tensor_cores)
    return dtype == drt::kBFloat16
               ? drt::launch_split_wgmma(x, B, C, y, t, M, K, R, N, st)
               : static_cast<int>(cudaErrorInvalidValue);
  if (dtype == drt::kFloat32)
    return drt::launch_split_simt<float>(x, B, C, y, t, M, K, R, N, st);
  if (dtype == drt::kBFloat16)
    return drt::launch_split_simt<__nv_bfloat16>(x, B, C, y, t, M, K, R, N,
                                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Largest rank the CUDA-core prefill kernel takes: t (rank rounded up to 64,
// times 32 rows, float32) plus its staging tiles must fit one block's shared
// memory.
int drt_lowrank_2d_max_rank() {
  int r = 0;
  while (drt::mm_smem_bytes(r + drt::MM_BN) <= drt::MM_SMEM_MAX)
    r += drt::MM_BN;
  return r;
}

// x (M, K), B (K, R), C (R, N), y (M, N) of one dtype; tpart (s1, M, R) and
// ypart (s2, M, N) float32 scratch.
int drt_lowrank_gemv(const void* x, const void* B, const void* C, void* y,
                     void* tpart, void* ypart, int M, int K, int R, int N,
                     int s1, int kper1, int s2, int kper2, int dtype,
                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto tp = static_cast<float*>(tpart);
  auto yp = static_cast<float*>(ypart);
  if (dtype == drt::kFloat32)
    return drt::launch_gemv<float>(x, B, C, y, tp, yp, M, K, R, N, s1, kper1,
                                   s2, kper2, st);
  if (dtype == drt::kBFloat16)
    return drt::launch_gemv<__nv_bfloat16>(x, B, C, y, tp, yp, M, K, R, N,
                                           s1, kper1, s2, kper2, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x (M, K), B (K, R), C (R, N), y (M, N) of one dtype, 1 <= M <= 64: the
// two-launch decode product through t, scratch of x's dtype and shape (M,
// gv2_t_stride(R)), launch 1 aiming at blocks1 blocks and launch 2 at
// blocks2. x and t start on 16-byte boundaries and K * the value size is a
// multiple of 16; B and C may start anywhere.
int drt_lowrank_gemv_stream(const void* x, const void* B, const void* C,
                            void* y, void* t, int M, int K, int R, int N,
                            int blocks1, int blocks2, int dtype,
                            void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == drt::kFloat32)
    return drt::launch_gemv_stream<float>(x, B, C, y, t, M, K, R, N, blocks1,
                                          blocks2, st);
  if (dtype == drt::kBFloat16)
    return drt::launch_gemv_stream<__nv_bfloat16>(x, B, C, y, t, M, K, R, N,
                                                  blocks1, blocks2, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The card the block targets of drt_lowrank_gemv_stream are planned for:
// out[0] its SMs, out[1] the shared memory of one SM in bytes (the current
// device, from the driver).
int drt_lowrank_gemv_card(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &out[1], cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  return static_cast<int>(e);
}

// The launch geometry of drt_lowrank_gemv_stream for these operands and
// block targets, into out[0..10]: rows of A a block holds, ring slots, t's
// row stride, then for launch 1 (x @ B) and launch 2 (t @ C) each: strips,
// cluster size, chunks a block, dynamic shared memory bytes.
// kernels/lowrank_matmul.py's gemv_plan mirrors it.
int drt_lowrank_gemv_plan(int M, int K, int R, int N, int blocks1,
                          int blocks2, int dtype, int* out) {
  const int es = dtype == drt::kBFloat16 ? 2 : 4;
  const int mt = drt::gv2_rows_tile(M);
  out[0] = mt;
  out[1] = drt::GV2_STAGES;
  out[2] = drt::gv2_t_stride(R, es);
  const int dims[2][3] = {{K, R, blocks1}, {R, N, blocks2}};
  for (int l = 0; l < 2; ++l) {
    const drt::Gv2Launch p =
        drt::gv2_launch_plan(dims[l][0], dims[l][1], dims[l][2]);
    out[3 + 4 * l] = p.strips;
    out[4 + 4 * l] = p.cluster;
    out[5 + 4 * l] = p.per;
    out[6 + 4 * l] = static_cast<int>(drt::gv2_smem_bytes(es, mt));
  }
  return 0;
}

// x (M, K), B (K, R), C (R, N), y (M, N), one dtype; R at most
// drt_lowrank_2d_max_rank().
int drt_lowrank_matmul_2d(const void* x, const void* B, const void* C,
                          void* y, int M, int K, int R, int N, int dtype,
                          void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == drt::kFloat32)
    return drt::launch_2d<float>(x, B, C, y, M, K, R, N, st);
  if (dtype == drt::kBFloat16)
    return drt::launch_2d<__nv_bfloat16>(x, B, C, y, M, K, R, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
