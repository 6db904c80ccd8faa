// Gram matrix G = X^T X over the token axis, accumulated in float32: the
// statistic the streaming calibrator folds for every captured linear.
//
// Replaces the TPU kernel gram_blocked (repro/kernels/gram.py, _kernel):
// x (N, D) -> G (D, D) float32. x is float32 or bfloat16; a bfloat16 value
// is widened to float32 exactly, so the result is the TPU kernel's on
// x.astype(float32).
//
// What bounds it: this kernel multiplies in float32 on the CUDA cores
// (67 TFLOP/s). The calibration feeds it bfloat16 activations, and a
// bfloat16 x bfloat16 product is exact in float32, so a bf16 wgmma with
// float32 accumulation computes the same function at the tensor cores'
// 989 TFLOP/s. At that rate one calibration batch's Grams (N = 1024 rows,
// D of 960 and 2560) are bound by bytes: the float32 accumulators read and
// written once. This kernel is far from that bound; the unsplit bf16 wgmma
// form is the next design. float32 inputs cannot take TF32 products (they
// keep ~1e-3 of a value, against the 1e-4 tier of the fp64 oracle) and
// would need a 3xTF32 or a bf16 x3 split.
//
// Design. The TPU kernel walks a (D/bi, D/bj, N/bn) grid with the token
// step innermost and the output tile resident in VMEM across token steps.
// Here the token loop runs inside the block: one block owns a 64 x 64
// output tile and loops over N in steps of 32 rows. G is symmetric, so only
// the tiles with i0 <= j0 are computed and each off-diagonal tile also
// writes its mirror: nt (nt + 1) / 2 blocks of the nt^2 tiles. Each step
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
// coalesced rows. With accumulate != 0 the kernel adds G into the output
// (the calibrator's accumulator) instead of overwriting it.
#include <stdint.h>

#include "common.cuh"

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

template <typename T, bool kVec>
__global__ void __launch_bounds__(G_THREADS) gram_kernel(
    const T* __restrict__ x, float* __restrict__ g, int N, int D, int nt,
    int accumulate) {
  // [buffer][panel i, panel j][token row][column]: 32 KB
  __shared__ __align__(16) float sm[2][2][GK][GT];
  // block b -> tile (ti, tj) of the upper triangle, row by row
  int ti = 0, rem = blockIdx.x;
  while (rem >= nt - ti) {
    rem -= nt - ti;
    ++ti;
  }
  const int tj = ti + rem;
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

}  // extern "C"
