// Gram matrix G = X^T X over the token axis, accumulated in float32: the
// statistic the streaming calibrator folds for every captured linear.
//
// Replaces the TPU kernel gram_blocked (repro/kernels/gram.py, _kernel):
// x (N, D) -> G (D, D) float32. x is float32 or bfloat16; a bfloat16 value
// is widened to float32 exactly, so the result is the TPU kernel's on
// x.astype(float32).
//
// What bounds it. The calibration feeds bfloat16 activations, and a
// bfloat16 x bfloat16 product is exact in float32, so a bf16 wgmma with
// float32 accumulation computes the same function at the tensor cores'
// rate; there one calibration batch's Grams (N = 1024 rows, D of 960 and
// 2560) are bound by bytes: the float32 accumulators read and written once.
// Two variants, picked by the wrapper from the dtype and the shape:
// - "wgmma" (bfloat16, D % 8 == 0, x and G 16-byte aligned): one warpgroup
//   owns a 64 x 64 tile of the upper triangle and loops over N in steps of
//   64 rows; a ring of 6 slots takes the two 64-column panels of each step
//   by TMA (zero rows past N), both MN-major operands of wgmma
//   (hopper_mma.cuh; one panel as both on a diagonal tile). The float32
//   sums of 1024 rows meet the 2e-5 tier in one tensor-core accumulation
//   (chip_smoke.py logs the error).
//   The epilogue reads its part of the accumulator in rows of 4 floats, all
//   loads in flight before the adds, so the read-modify-write of G costs
//   one round trip; it and the 120-block grid at D = 960 bound the kernel.
// - "simt" (float32 inputs, and the shapes above that the tensor-core
//   kernel does not take): float32 FMA on the CUDA cores (67 TFLOP/s).
//   float32 inputs cannot take TF32 products (they keep ~1e-3 of a value,
//   against the 1e-4 tier of the fp64 oracle) and would need a 3xTF32 or a
//   bf16 x3 split.
//
// Design of the CUDA-core variant. The TPU kernel walks a (D/bi, D/bj,
// N/bn) grid with the token step innermost and the output tile resident in
// VMEM across token steps. Here the token loop runs inside the block: one
// block owns a 64 x 64 output tile and loops over N in steps of 32 rows. G
// is symmetric, so only the tiles with i0 <= j0 are computed and each
// off-diagonal tile also writes its mirror: nt (nt + 1) / 2 blocks of the
// nt^2 tiles (the tensor-core variant shares this schedule). Each step
// stages the two column panels x[n:n+32, i0:i0+64] and x[n:n+32, j0:j0+64]
// in shared memory as float32 (one panel on a diagonal tile); each of 256
// threads keeps a 4 x 4 micro-tile of float32 sums and reads its operands as
// float4s. The next step's panels are loaded into registers while the
// current ones are multiplied (double buffering through registers, not
// cp.async): a bfloat16 value is widened once, when it is staged, rather
// than by each of the 16 threads that read it. Ragged N and D are masked in
// the loads (zeros) and the stores; nothing is padded. Rows of 16 aligned
// bytes are read as 16-byte vectors, other shapes value by value. The tile
// leaves through shared memory, so both it and its mirror are written in
// coalesced rows. With accumulate != 0 both variants add G into the output
// (the calibrator's accumulator) instead of overwriting it; neither splits
// the token axis or uses atomics, so the result is deterministic.
#include <stdint.h>

#include "common.cuh"
#include "hopper_mma.cuh"

namespace drt {
namespace {

constexpr int GT = 64;                      // output tile edge
constexpr int GK = 32;                      // token rows staged per step
constexpr int G_THREADS = 256;              // 16 x 16 threads, 4 x 4 sums each
constexpr int G_PER = GK * GT / G_THREADS;  // panel values a thread stages
constexpr int G_ROW = GT / G_PER;           // threads per staged panel row

// The G_PER values of rows n0.., columns c0.. of x that this thread stages:
// row n0 + t / 8, columns c0 + (t % 8) * 8 .. + 7; zero outside N x D.
template <typename T, bool kVec>
__device__ __forceinline__ void load_panel(const T* __restrict__ x, int N,
                                           int D, int n0, int c0,
                                           float (&v)[G_PER]) {
  const int n = n0 + threadIdx.x / G_ROW;
  const int col = c0 + (threadIdx.x % G_ROW) * G_PER;
  const T* p = x + (size_t)n * D + col;
  if constexpr (kVec && sizeof(T) == 4) {
    // D % 4 == 0: each half of 4 floats is wholly inside or outside D
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < N && col + 4 * h < D)
        q = *reinterpret_cast<const float4*>(p + 4 * h);
      v[4 * h] = q.x; v[4 * h + 1] = q.y; v[4 * h + 2] = q.z;
      v[4 * h + 3] = q.w;
    }
  } else if constexpr (kVec) {
    // D % 8 == 0: the 8 bfloat16 values are wholly inside or outside D
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (n < N && col < D) q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < G_PER; ++j)
      v[j] = (n < N && col + j < D) ? ld(p + j) : 0.f;
  }
}

__device__ __forceinline__ void store_panel(float (*s)[GT],
                                            const float (&v)[G_PER]) {
  float* d = &s[threadIdx.x / G_ROW][(threadIdx.x % G_ROW) * G_PER];
  reinterpret_cast<float4*>(d)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(d)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Tile (ti, tj) of the upper triangle for block b, row by row.
__device__ __forceinline__ void upper_tile(int b, int nt, int& ti, int& tj) {
  ti = 0;
  while (b >= nt - ti) {
    b -= nt - ti;
    ++ti;
  }
  tj = ti + b;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(G_THREADS) gram_kernel(
    const T* __restrict__ x, float* __restrict__ g, int N, int D, int nt,
    int accumulate) {
  // [buffer][panel i, panel j][token row][column]: 32 KB
  __shared__ __align__(16) float sm[2][2][GK][GT];
  int ti, tj;
  upper_tile(blockIdx.x, nt, ti, tj);
  const int i0 = ti * GT, j0 = tj * GT;
  const bool diag = ti == tj;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  float vi[G_PER], vj[G_PER];
  const int steps = cdiv(N, GK);
  if (steps > 0) {
    load_panel<T, kVec>(x, N, D, 0, i0, vi);
    store_panel(sm[0][0], vi);
    if (!diag) {
      load_panel<T, kVec>(x, N, D, 0, j0, vj);
      store_panel(sm[0][1], vj);
    }
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < steps;
    if (more) {
      load_panel<T, kVec>(x, N, D, (s + 1) * GK, i0, vi);
      if (!diag) load_panel<T, kVec>(x, N, D, (s + 1) * GK, j0, vj);
    }
    const float (*pa)[GT] = sm[buf][0];
    const float (*pb)[GT] = diag ? sm[buf][0] : sm[buf][1];
#pragma unroll
    for (int k = 0; k < GK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&pa[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&pb[k][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += a4[a] * b4[b];
    }
    if (more) {
      store_panel(sm[buf ^ 1][0], vi);
      if (!diag) store_panel(sm[buf ^ 1][1], vj);
    }
    __syncthreads();
  }

  // the tile through shared memory (row stride 65: the transposed reads of
  // the mirror hit 32 banks), then coalesced rows of the tile and its mirror
  float (*cs)[GT + 1] = reinterpret_cast<float (*)[GT + 1]>(&sm[0][0][0][0]);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) cs[ty * 4 + a][tx * 4 + b] = acc[a][b];
  __syncthreads();
  for (int idx = threadIdx.x; idx < GT * GT; idx += G_THREADS) {
    const int r = idx / GT, c = idx % GT;
    if (i0 + r < D && j0 + c < D) {
      const size_t o = (size_t)(i0 + r) * D + j0 + c;
      g[o] = accumulate ? g[o] + cs[r][c] : cs[r][c];
    }
    if (!diag && j0 + r < D && i0 + c < D) {
      const size_t o = (size_t)(j0 + r) * D + i0 + c;
      g[o] = accumulate ? g[o] + cs[c][r] : cs[c][r];
    }
  }
}

template <typename T>
int launch_gram(const void* x, float* g, int N, int D, int accumulate,
                cudaStream_t st) {
  if (D <= 0) return static_cast<int>(cudaSuccess);
  const int nt = cdiv(D, GT);
  const int tiles = nt * (nt + 1) / 2;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   ((size_t)D * sizeof(T)) % 16 == 0;
  if (vec)
    gram_kernel<T, true><<<tiles, G_THREADS, 0, st>>>(
        static_cast<const T*>(x), g, N, D, nt, accumulate);
  else
    gram_kernel<T, false><<<tiles, G_THREADS, 0, st>>>(
        static_cast<const T*>(x), g, N, D, nt, accumulate);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int GW_S = 6;                               // ring slots
constexpr int GW_SLOT = 2 * mma::TILE_BYTES;          // panels i and j
constexpr int GW_SMEM = 1024 + GW_S * GW_SLOT;        // + alignment slack

// The same function as gram_kernel for bfloat16 x with D % 8 == 0, on wgmma:
// one warpgroup owns a 64 x 64 output tile of the upper triangle and loops
// over N in steps of 64 token rows through a ring of GW_S slots. Thread 0
// fills slot q % GW_S with step q's panels x[n:n+64, i0:i0+64] and
// x[n:n+64, j0:j0+64] (one on a diagonal tile) by TMA, GW_S - 2 steps
// ahead, arriving on the slot's mbarrier with the bytes to expect; rows
// past N land as zeros. A = the i panel, B = the j panel, both MN-major,
// four k16 steps; one float32 accumulation over all of N. While step q is
// multiplied, step q - 1's MMA may still run; a slot is refilled only after
// the barrier that follows every warp's wait for the MMA that read it.
__global__ void __launch_bounds__(mma::WG_THREADS) gram_wgmma_kernel(
    const bf16* __restrict__ x, float* __restrict__ g, int N, int D, int nt,
    int accumulate, const __grid_constant__ CUtensorMap tm) {
  using namespace mma;
  extern __shared__ __align__(16) char smem_in[];
  __shared__ __align__(8) uint64_t bars[GW_S];
  char* ring = smem_in + ((1024 - (smem_u32(smem_in) & 1023)) & 1023);
  const uint32_t ring_a = smem_u32(ring), bars_a = smem_u32(bars);
  if (threadIdx.x == 0) {
    tma_prefetch(&tm);
    for (int i = 0; i < GW_S; ++i) mbar_init(bars_a + 8 * i, 1);
  }
  __syncthreads();
  int ti, tj;
  upper_tile(blockIdx.x, nt, ti, tj);
  const int i0 = ti * GT, j0 = tj * GT;
  const bool diag = ti == tj;
  const int tid = threadIdx.x;
  const int steps = cdiv(N, TILE);
  prof_stamp(blockIdx.x, 0);   // profiling builds only

  auto issue = [&](int q) {
    if (tid != 0) return;
    const uint32_t s = ring_a + (q % GW_S) * GW_SLOT;
    const uint32_t bar = bars_a + 8 * (q % GW_S);
    mbar_arrive_expect(bar, TILE_BYTES * (diag ? 1 : 2));
    tma_load_2d(s, &tm, i0, q * TILE, bar);
    if (!diag) tma_load_2d(s + TILE_BYTES, &tm, j0, q * TILE, bar);
  };
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int q = 0; q < GW_S - 2 && q < steps; ++q) issue(q);
  for (int q = 0; q < steps; ++q) {
    mbar_wait(bars_a + 8 * (q % GW_S), (q / GW_S) & 1);
    __syncthreads();
    if (q + GW_S - 2 < steps) issue(q + GW_S - 2);
    const uint32_t a = ring_a + (q % GW_S) * GW_SLOT;
    const uint32_t b = diag ? a : a + TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16<1, 1>(acc, desc_mnmajor(a, kk), desc_mnmajor(b, kk),
                            !(q == 0 && kk == 0));
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  hold_regs(acc);
  __syncthreads();   // every warp is done with the ring
  prof_stamp(blockIdx.x, 1);

  // The tile through shared memory (row stride 65), then rows of 4 floats
  // of the tile and of its mirror (D % 8 == 0: a group of 4 is wholly
  // inside or outside D). Every thread issues all its loads of the
  // accumulator before it adds and stores, so the read-modify-write of the
  // output costs one round trip to memory, not one per element.
  float (*cs)[GT + 1] = reinterpret_cast<float (*)[GT + 1]>(ring);
#pragma unroll
  for (int i = 0; i < 32; ++i) cs[acc_row(tid, i)][acc_col(tid, i)] = acc[i];
  __syncthreads();
  constexpr int PER = GT * GT / 4 / WG_THREADS;   // groups of 4 a thread
  float4 old[2][PER];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = tid + k * WG_THREADS, r = idx / (GT / 4),
                c = 4 * (idx % (GT / 4));
      const int row = (h ? j0 : i0) + r, col = (h ? i0 : j0) + c;
      old[h][k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (accumulate && row < D && col < D && (h == 0 || !diag))
        old[h][k] = *reinterpret_cast<const float4*>(g + (size_t)row * D +
                                                     col);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = tid + k * WG_THREADS, r = idx / (GT / 4),
                c = 4 * (idx % (GT / 4));
      const int row = (h ? j0 : i0) + r, col = (h ? i0 : j0) + c;
      if (row >= D || col >= D || (h == 1 && diag)) continue;
      // tile: G[i0 + r][j0 + c..]; mirror: G[j0 + r][i0 + c..] = cs[c..][r]
      float4 v = old[h][k];
      v.x += h ? cs[c][r] : cs[r][c];
      v.y += h ? cs[c + 1][r] : cs[r][c + 1];
      v.z += h ? cs[c + 2][r] : cs[r][c + 2];
      v.w += h ? cs[c + 3][r] : cs[r][c + 3];
      *reinterpret_cast<float4*>(g + (size_t)row * D + col) = v;
    }
#ifdef DRT_PROFILE
  __syncthreads();
  prof_stamp(blockIdx.x, 2);
#endif
}

int launch_gram_wgmma(const void* x, float* g, int N, int D, int accumulate,
                      cudaStream_t st) {
  if (D % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(g) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 0) return static_cast<int>(cudaSuccess);
  static const cudaError_t configured = cudaFuncSetAttribute(
      gram_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GW_SMEM);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  CUtensorMap tm;   // rows past N (and at N == 0, every row) are not read
  const cudaError_t e = mma::make_tmap(&tm, x, D, N > 0 ? N : 1, 2ull * D);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nt = cdiv(D, GT);
  gram_wgmma_kernel<<<nt * (nt + 1) / 2, mma::WG_THREADS, GW_SMEM, st>>>(
      static_cast<const bf16*>(x), g, N, D, nt, accumulate, tm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace drt

extern "C" {

// x (N, D) float32 or bfloat16; g (D, D) float32, overwritten with X^T X,
// or X^T X added into it when accumulate != 0.
int drt_gram(const void* x, void* g, int N, int D, int dtype, int accumulate,
             void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto out = static_cast<float*>(g);
  if (dtype == drt::kFloat32)
    return drt::launch_gram<float>(x, out, N, D, accumulate, st);
  if (dtype == drt::kBFloat16)
    return drt::launch_gram<__nv_bfloat16>(x, out, N, D, accumulate, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bfloat16 x (N, D), D % 8 == 0, x and g 16-byte aligned; g as drt_gram.
int drt_gram_wgmma(const void* x, void* g, int N, int D, int accumulate,
                   void* stream) {
  return drt::launch_gram_wgmma(x, static_cast<float*>(g), N, D, accumulate,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
