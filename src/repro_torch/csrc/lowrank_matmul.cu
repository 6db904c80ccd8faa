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
// lowrank_gemv: at decode M is a handful of rows, so the work is bound by
//   the bytes of B and C (read once each) and by latency: one matrix is
//   ~1 MB, too little to keep 3.35 TB/s in flight from a few SMs. The
//   design spreads each weight over many blocks: blocks tile the output
//   columns (64 a block, coalesced rows of B or C) and split the reduction
//   axis into up to 16 slices, each block writing a float32 partial; inside
//   a block four thread groups take interleaved rows and issue 16 row loads
//   each at once, to keep more bytes in flight. So each phase is its own
//   launch, and t crosses between them as M x R x 4-byte partials that
//   stay in the 50 MB L2. Phase 2 sums
//   phase 1's partials and rounds t while staging it in shared memory; a
//   third small launch sums phase 2's partials into y. The sums run in a
//   fixed order, so the result is deterministic.
// lowrank_matmul_2d: at prefill M is hundreds of rows and the work is bound
//   by operations. As on the TPU, t[32 rows, R] never leaves the chip: a
//   cluster of 8 blocks owns a 32-row tile, each block computes its share
//   of t's columns over the whole of K (float32 FMA on the CUDA cores,
//   2 x 4 outputs a thread), rounds it to C's dtype into shared memory, and
//   reads the other shares from its peers' shared memory (Hopper's
//   distributed shared memory) before emitting its share of y's columns.
//   So nothing is recomputed and 8 SMs work on each row tile: 16 row tiles
//   (512 prefill rows) keep 128 of 132 SMs busy. Each step stages 64
//   reduction values of x and of the weight; the next step's loads are in
//   flight while the current one is multiplied. t takes R_64 x 128 bytes
//   of shared memory (90 KB at SmolLM's largest rank, 698), which bounds
//   the rank at drt_lowrank_2d_max_rank() (1600). Tensor-core (wgmma)
//   tiles and TMA staging are later work.
#include <cooperative_groups.h>

#include "common.cuh"

namespace drt {
namespace {

// ---------------------------------------------------------------------------
// Decode shape: split-reduction products
// ---------------------------------------------------------------------------
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

}  // namespace
}  // namespace drt

extern "C" {

// Largest rank the prefill kernel takes: t (rank rounded up to 64, times 32
// rows, float32) plus its staging tiles must fit one block's shared memory.
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
