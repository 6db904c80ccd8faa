// Prefill attention with an online softmax: causal, sliding window, logit
// softcap, ragged key length and grouped-query heads.
//
// Replaces the TPU kernel flash_attention_bh (repro/kernels/flash_attention.py,
// body _kernel). Same arithmetic: scores in float32, scaled AFTER the QK
// product, softcap as cap * tanh(s / cap), masked scores set to -1e30 (never
// -inf), p rounded to v's dtype before the PV product while the denominator
// sums the unrounded p, and the denominator floored at 1e-30.
//
// Layout: q (B, S, H, hd), k/v (B, T, KV, hd), o (B, S, H, hd), read in
// place: no transpose, no padding copy; ragged S and T are masked here.
// One block per (32 query rows, head); query head h reads kv head h / G, so
// repeated K/V never exist (G need not be a power of two).
//
// Bound: at the prefill shapes of the main path (S of 64 to 128, hd 64) the
// work is small and bound by operations on the CUDA cores. Each block keeps
// its q tile and one 64-key K/V tile in shared memory (float32) and skips
// the key tiles that the causal or window mask empties for all its rows, the
// block skipping the TPU kernel leaves to a later iteration. Four threads
// share a query row: each scores 16 keys, the row max and sum are reduced
// with warp shuffles, and each owns a quarter of the output dims. Tensor-core
// tiles (wgmma) are later work.
#include "common.cuh"

namespace drt {
namespace {

constexpr int FA_BQ = 32;        // query rows per block
constexpr int FA_BK = 64;        // keys per tile
constexpr int FA_THREADS = 128;  // 4 threads per query row
constexpr int FA_KPT = FA_BK / 4;

template <int HD>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (FA_BQ * (HD + 1) + 2 * FA_BK * (HD + 1) +
                          FA_BQ * (FA_BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int S, int Tk, int H,
    int KV, float scale, int causal, int window, float softcap) {
  extern __shared__ float smem[];
  float* qs = smem;                              // [FA_BQ][HD + 1]
  float* ks = qs + FA_BQ * (HD + 1);             // [FA_BK][HD + 1]
  float* vs = ks + FA_BK * (HD + 1);             // [FA_BK][HD + 1]
  float* ps = vs + FA_BK * (HD + 1);             // [FA_BQ][FA_BK + 1]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int G = H / KV;
  const int kvh = h / G;
  const int q0 = blockIdx.x * FA_BQ;
  const int tid = threadIdx.x;
  const int row = tid / 4, sub = tid % 4;
  const int qpos = q0 + row;

  for (int i = tid; i < FA_BQ * HD; i += FA_THREADS) {
    const int r = i / HD, d = i % HD;
    const int qi = q0 + r;
    qs[r * (HD + 1) + d] =
        qi < S ? ld(q + (((size_t)b * S + qi) * H + h) * HD + d) : 0.f;
  }

  // key tiles that hold a live entry for some row of this block
  int kv_end = Tk;
  if (causal) kv_end = min(Tk, q0 + FA_BQ);
  int kv_beg = 0;
  if (window) kv_beg = max(0, q0 - window + 1);
  kv_beg = (kv_beg / FA_BK) * FA_BK;

  float m = NEG_INF, l = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) acc[i] = 0.f;

  for (int k0 = kv_beg; k0 < kv_end; k0 += FA_BK) {
    __syncthreads();   // previous tile fully consumed (and q tile stored)
    for (int i = tid; i < FA_BK * HD; i += FA_THREADS) {
      const int r = i / HD, d = i % HD;
      const int kj = k0 + r;
      const size_t off = (((size_t)b * Tk + kj) * KV + kvh) * HD + d;
      ks[r * (HD + 1) + d] = kj < Tk ? ld(k + off) : 0.f;
      vs[r * (HD + 1) + d] = kj < Tk ? ld(v + off) : 0.f;
    }
    __syncthreads();

    float s[FA_KPT];
    float mx = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < FA_KPT; ++jj) {
      const int j = sub + 4 * jj;
      const float* qr = qs + row * (HD + 1);
      const float* kr = ks + j * (HD + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot += qr[d] * kr[d];
      dot *= scale;
      if (softcap != 0.f) dot = softcap * tanhf(dot / softcap);
      const int kpos = k0 + j;
      bool ok = kpos < Tk;
      if (causal) ok = ok && kpos <= qpos;
      if (window) ok = ok && kpos > qpos - window;
      s[jj] = ok ? dot : NEG_INF;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < FA_KPT; ++jj) {
      const float p = expf(s[jj] - m_new);
      psum += p;
      ps[row * (FA_BK + 1) + sub + 4 * jj] = round_to<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();      // a row's four threads share one warp
    const float* pr = ps + row * (FA_BK + 1);
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) acc[i] *= alpha;
    for (int j = 0; j < FA_BK; ++j) {
      const float pj = pr[j];
      const float* vr = vs + j * (HD + 1);
#pragma unroll
      for (int i = 0; i < HD / 4; ++i) acc[i] += pj * vr[sub + 4 * i];
    }
  }

  if (qpos < S) {
    const float lf = fmaxf(l, 1e-30f);
    T* orow = o + (((size_t)b * S + qpos) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) orow[sub + 4 * i] = cvt<T>(acc[i] / lf);
  }
}

template <typename T, int HD>
int launch_flash(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int Tk, int H, int KV, float scale, int causal,
                 int window, float softcap, cudaStream_t st) {
  constexpr size_t smem = flash_smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(cdiv(S, FA_BQ), B * H);
  flash_kernel<T, HD><<<grid, FA_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, KV, scale,
      causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Tk, int H, int KV, int hd, float scale, int causal,
                int window, float softcap, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_flash<T, 16>(q, k, v, o, B, S, Tk, H, KV, scale,
                                        causal, window, softcap, st);
    case 32: return launch_flash<T, 32>(q, k, v, o, B, S, Tk, H, KV, scale,
                                        causal, window, softcap, st);
    case 64: return launch_flash<T, 64>(q, k, v, o, B, S, Tk, H, KV, scale,
                                        causal, window, softcap, st);
    case 128: return launch_flash<T, 128>(q, k, v, o, B, S, Tk, H, KV, scale,
                                          causal, window, softcap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace drt

extern "C" {

// q (B, S, H, hd); k/v (B, T, KV, hd); o (B, S, H, hd); one dtype.
int drt_flash_attention(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int H, int KV, int hd,
                        float scale, int causal, int window, float softcap,
                        int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == drt::kFloat32)
    return drt::dispatch_hd<float>(q, k, v, o, B, S, T, H, KV, hd, scale,
                                   causal, window, softcap, st);
  if (dtype == drt::kBFloat16)
    return drt::dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, T, H, KV, hd,
                                           scale, causal, window, softcap,
                                           st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
