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
// Query head h reads kv head h / G, so repeated K/V never exist (G need not
// be a power of two). Both variants skip the key tiles that the causal or
// window mask empties for every row of a block, the block skipping the TPU
// kernel leaves to a later iteration; a skipped tile would only have added
// p = exp(-1e30 - m) = 0 to every row.
//
// What bounds it. At the main path's prefill shapes (S 64, hd 64; gemma3's
// S ~1100, hd 256) the bytes are small (q, k, v and o read or written once:
// 25 us at SmolLM's prefill) and the work is two products per key tile: on
// the CUDA cores it is bound by their float32 rate (67 TFLOP/s) and ran 33x
// over its bound. Two variants, picked by the wrapper:
// - "wgmma" (bfloat16, hd in {16, 32, 64, 128, 256}, q/k/v 16-byte
//   aligned): both products on the tensor cores. A block is one consumer
//   warpgroup, which owns 64 query rows of one head, and a producer warp,
//   which stages the q tile once and the K and V tiles of each 64-key step
//   by TMA (4-D tensor maps over the (B, T, heads, hd) layout, 64-column
//   boxes: 1, 2 or 4 of them by hd; columns past hd < 64 land as zeros)
//   into a ring of slots with full and empty mbarriers. S = q K^T is a
//   wgmma with q as the K-major A operand and the K tile as the K-major B
//   operand (hd / 16 k16 steps). The masks take each accumulator element's
//   (row, key) from the m64n64 accumulator layout (acc_row, acc_col); a
//   row's max and sum are reduced over the 4 threads that hold it (two
//   shuffles). O += P V is a wgmma with P as the register A operand: the S
//   accumulator, exponentiated, rounded to bf16 in place (a_frag), which is
//   exactly the TPU kernel's rounding of p to v's dtype; V is the MN-major
//   B operand, one m64n64 product per 64 columns of hd. At hd 256 the O
//   accumulator is 128 registers a thread, S 32 and P 16: the key tile stays
//   64 and the ring 2 slots deep (160 KB of shared memory). Every wgmma is
//   issued unconditionally by the whole warpgroup and TMA is issued only by
//   the producer warp, whose role is a warp-uniform shuffle broadcast (the
//   compiler serializes wgmma next to divergent code).
// - "simt" (float32, and operands the tensor-core kernel does not take):
//   one block per (32 query rows, head), q/K/V tiles in shared memory as
//   float32 (172 KB at hd 256), four threads a query row: each scores 16
//   keys, the row max and sum are reduced with warp shuffles, and each owns
//   a quarter of the output dims.
//
// LSE (a template flag of both variants; the C entry points take it as a
// non-null lse pointer): each query row also writes its float32
// log-sum-exp, m + log(max(l, 1e-30)), to lse (B, H, S), what JAX's
// _flash_fwd_pass keeps for the tiled FlashAttention-2 backward of its
// model (repro/models/attention.py, _flash_bwd_rule), which recomputes the
// probabilities from (q, k, lse). The wrapper asks for it only where that
// backward runs.
#include "common.cuh"
#include "hopper_mma.cuh"

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

template <typename T, int HD, bool LSE>
__global__ void __launch_bounds__(FA_THREADS) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int S, int Tk, int H, int KV, float scale, int causal, int window,
    float softcap) {
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
    if (LSE && sub == 0) lse[((size_t)b * H + h) * S + qpos] = m + logf(lf);
  }
}

template <typename T, int HD, bool LSE>
int launch_flash_as(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int S, int Tk, int H, int KV,
                    float scale, int causal, int window, float softcap,
                    cudaStream_t st) {
  constexpr size_t smem = flash_smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(cdiv(S, FA_BQ), B * H);
  flash_kernel<T, HD, LSE><<<grid, FA_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, Tk, H, KV, scale,
      causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// the LSE flag's instantiation by whether lse is given
template <typename T, int HD>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int S, int Tk, int H, int KV, float scale,
                 int causal, int window, float softcap, cudaStream_t st) {
  return lse ? launch_flash_as<T, HD, true>(q, k, v, o, lse, B, S, Tk, H, KV,
                                            scale, causal, window, softcap,
                                            st)
             : launch_flash_as<T, HD, false>(q, k, v, o, lse, B, S, Tk, H,
                                             KV, scale, causal, window,
                                             softcap, st);
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int Tk, int H, int KV, int hd,
                float scale, int causal, int window, float softcap,
                cudaStream_t st) {
  switch (hd) {
    case 16: return launch_flash<T, 16>(q, k, v, o, lse, B, S, Tk, H, KV,
                                        scale, causal, window, softcap, st);
    case 32: return launch_flash<T, 32>(q, k, v, o, lse, B, S, Tk, H, KV,
                                        scale, causal, window, softcap, st);
    case 64: return launch_flash<T, 64>(q, k, v, o, lse, B, S, Tk, H, KV,
                                        scale, causal, window, softcap, st);
    case 128: return launch_flash<T, 128>(q, k, v, o, lse, B, S, Tk, H, KV,
                                          scale, causal, window, softcap, st);
    case 256: return launch_flash<T, 256>(q, k, v, o, lse, B, S, Tk, H, KV,
                                          scale, causal, window, softcap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int FW_T = mma::TILE;                       // query rows, keys a tile
constexpr int FW_THREADS = mma::WG_THREADS + 32;      // + the producer warp

template <int HD>
struct FlashWg {
  static constexpr int NSUB = HD >= 64 ? HD / 64 : 1;  // 64-column boxes
  static constexpr int KSTEPS = HD / 16;               // k16 steps of q K^T
  static constexpr int STAGES = HD >= 256 ? 2 : 3;     // ring slots
  static constexpr int SLOT = 2 * NSUB * mma::TILE_BYTES;   // K, then V
  static constexpr int SMEM = 1024 + NSUB * mma::TILE_BYTES + STAGES * SLOT;
};

template <int HD, bool LSE>
__global__ void __launch_bounds__(FW_THREADS, 1) flash_wgmma_kernel(
    bf16* __restrict__ o, float* __restrict__ lse, int S, int Tk, int H,
    int KV, float scale,
    int causal, int window, float softcap,
    const __grid_constant__ CUtensorMap tmq,
    const __grid_constant__ CUtensorMap tmk,
    const __grid_constant__ CUtensorMap tmv) {
  using namespace mma;
  using F = FlashWg<HD>;
  extern __shared__ __align__(16) char smem_in[];
  // full and empty barriers of the ring, then the q tile's
  __shared__ __align__(8) uint64_t bars[2 * F::STAGES + 1];
  char* qs = smem_in + ((1024 - (smem_u32(smem_in) & 1023)) & 1023);
  const uint32_t qs_a = smem_u32(qs);
  const uint32_t ring_a = qs_a + F::NSUB * TILE_BYTES;
  const uint32_t full = smem_u32(bars), empty = full + 8 * F::STAGES;
  const uint32_t qbar = empty + 8 * F::STAGES;

  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / (H / KV);
  const int q0 = blockIdx.x * FW_T;
  // the key tiles that hold a live entry for some row of this block
  const int kv_end = causal ? min(Tk, q0 + FW_T) : Tk;
  const int kv_beg = (window ? max(0, q0 - window + 1) : 0) / FW_T * FW_T;
  const int nt = kv_end > kv_beg ? cdiv(kv_end - kv_beg, FW_T) : 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < F::STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, WG_THREADS);
    }
    mbar_init(qbar, 1);
  }
  __syncthreads();
  // 0: the consumer warpgroup; 1: the producer warp (warp-uniform)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0);
  const int wt = threadIdx.x % WG_THREADS;

  if (role == 1) {
    const int lane = wt % 32;
    if (lane == 0) {
      tma_prefetch(&tmq);
      tma_prefetch(&tmk);
      tma_prefetch(&tmv);
      mbar_arrive_expect(qbar, F::NSUB * TILE_BYTES);
    }
    __syncwarp();
    if (lane < F::NSUB)
      tma_load_4d(qs_a + lane * TILE_BYTES, &tmq, lane * 64, h, q0, b, qbar);
    for (int j = 0; j < nt; ++j) {
      const int slot = j % F::STAGES, k0 = kv_beg + j * FW_T;
      const uint32_t s = ring_a + slot * F::SLOT, bar = full + 8 * slot;
      if (lane == 0) {
        if (j >= F::STAGES)
          mbar_wait(empty + 8 * slot, (j / F::STAGES - 1) & 1);
        mbar_arrive_expect(bar, F::SLOT);
      }
      __syncwarp();
      if (lane < 2 * F::NSUB) {   // lanes 0.. the K boxes, then the V boxes
        const int c = lane % F::NSUB;
        tma_load_4d(s + lane * TILE_BYTES, lane < F::NSUB ? &tmk : &tmv,
                    c * 64, kvh, k0, b, bar);
      }
    }
    return;
  }

  float oacc[F::NSUB][32];
#pragma unroll
  for (int c = 0; c < F::NSUB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[c][i] = 0.f;
  // this thread's two query rows (acc_row of elements 0 and 2)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int qp0 = q0 + acc_row(wt, 0);
  mbar_wait(qbar, 0);
  for (int j = 0; j < nt; ++j) {
    const int slot = j % F::STAGES, k0 = kv_beg + j * FW_T;
    const uint32_t ka = ring_a + slot * F::SLOT;
    const uint32_t va = ka + F::NSUB * TILE_BYTES;
    mbar_wait(full + 8 * slot, (j / F::STAGES) & 1);
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F::KSTEPS; ++kk)
      wgmma_m64n64k16<0, 0>(s, desc_kmajor(qs_a + (kk / 4) * TILE_BYTES, kk % 4),
                            desc_kmajor(ka + (kk / 4) * TILE_BYTES, kk % 4),
                            kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    hold_regs(s);

    // scale, softcap, mask; the running max of each of the two rows
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale;
      if (softcap != 0.f) x = softcap * tanhf(x / softcap);
      const int qp = qp0 + 8 * ((i / 2) % 2), kp = k0 + acc_col(wt, i);
      bool ok = kp < Tk;
      if (causal) ok = ok && kp <= qp;
      if (window) ok = ok && kp > qp - window;
      s[i] = ok ? x : NEG_INF;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = expf(s[i] - mx[(i / 2) % 2]);
      ps[(i / 2) % 2] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
      l[r] = l[r] * alpha[r] + ps[r];
    }
#pragma unroll
    for (int c = 0; c < F::NSUB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[c][i] *= alpha[(i / 2) % 2];
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(pa[kk], s, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < F::NSUB; ++c)
        wgmma_m64n64k16_rs<1>(oacc[c], pa[kk],
                              desc_mnmajor(va + c * TILE_BYTES, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < F::NSUB; ++c) hold_regs(oacc[c]);
    mbar_arrive(empty + 8 * slot);
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) den[r] = fmaxf(l[r], 1e-30f);
#pragma unroll
  for (int c = 0; c < F::NSUB; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int qp = qp0 + 8 * ((i / 2) % 2), d = c * 64 + acc_col(wt, i);
      if (qp < S && d < HD)   // hd even: a pair is wholly in or out
        *reinterpret_cast<__nv_bfloat162*>(
            o + (((size_t)b * S + qp) * H + h) * HD + d) =
            __floats2bfloat162_rn(oacc[c][i] / den[(i / 2) % 2],
                                  oacc[c][i + 1] / den[(i / 2) % 2]);
    }
  // a row's m and l are its quad's (the four threads of acc_row)
  if (LSE && wt % 4 == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qp0 + 8 * r < S)
        lse[((size_t)b * H + h) * S + qp0 + 8 * r] = m[r] + logf(den[r]);
}

template <int HD, bool LSE>
int launch_flash_wgmma_as(const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int S, int Tk, int H,
                          int KV, float scale, int causal, int window,
                          float softcap, cudaStream_t st) {
  using F = FlashWg<HD>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  CUtensorMap tmq, tmk, tmv;
  cudaError_t e = mma::make_tmap_bshd(&tmq, q, HD, H, S, B);
  // at Tk == 0 no key tile is read; a map needs one row all the same
  const int rows = Tk > 0 ? Tk : 1;
  if (e == cudaSuccess) e = mma::make_tmap_bshd(&tmk, k, HD, KV, rows, B);
  if (e == cudaSuccess) e = mma::make_tmap_bshd(&tmv, v, HD, KV, rows, B);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(cdiv(S, FW_T), B * H);
  flash_wgmma_kernel<HD, LSE><<<grid, FW_THREADS, F::SMEM, st>>>(
      static_cast<bf16*>(o), lse, S, Tk, H, KV, scale, causal, window,
      softcap, tmq, tmk, tmv);
  return static_cast<int>(cudaGetLastError());
}

// the LSE flag's instantiation by whether lse is given
template <int HD>
int launch_flash_wgmma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int S, int Tk, int H, int KV,
                       float scale, int causal, int window, float softcap,
                       cudaStream_t st) {
  return lse ? launch_flash_wgmma_as<HD, true>(q, k, v, o, lse, B, S, Tk, H,
                                               KV, scale, causal, window,
                                               softcap, st)
             : launch_flash_wgmma_as<HD, false>(q, k, v, o, lse, B, S, Tk, H,
                                                KV, scale, causal, window,
                                                softcap, st);
}

int dispatch_wgmma(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int Tk, int H, int KV, int hd,
                   float scale, int causal, int window, float softcap,
                   cudaStream_t st) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch_flash_wgmma<16>(q, k, v, o, lse, B, S, Tk, H, KV,
                                           scale, causal, window, softcap, st);
    case 32: return launch_flash_wgmma<32>(q, k, v, o, lse, B, S, Tk, H, KV,
                                           scale, causal, window, softcap, st);
    case 64: return launch_flash_wgmma<64>(q, k, v, o, lse, B, S, Tk, H, KV,
                                           scale, causal, window, softcap, st);
    case 128: return launch_flash_wgmma<128>(q, k, v, o, lse, B, S, Tk, H,
                                             KV, scale, causal, window,
                                             softcap, st);
    case 256: return launch_flash_wgmma<256>(q, k, v, o, lse, B, S, Tk, H,
                                             KV, scale, causal, window,
                                             softcap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace drt

extern "C" {

// q (B, S, H, hd); k/v (B, T, KV, hd); o (B, S, H, hd); one dtype; lse
// (B, H, S) float32 or null (not written).
int drt_flash_attention(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int S, int T, int H, int KV, int hd,
                        float scale, int causal, int window, float softcap,
                        int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto ls = static_cast<float*>(lse);
  if (dtype == drt::kFloat32)
    return drt::dispatch_hd<float>(q, k, v, o, ls, B, S, T, H, KV, hd, scale,
                                   causal, window, softcap, st);
  if (dtype == drt::kBFloat16)
    return drt::dispatch_hd<__nv_bfloat16>(q, k, v, o, ls, B, S, T, H, KV,
                                           hd, scale, causal, window,
                                           softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}


// bfloat16 q, k, v, o as drt_flash_attention, 16-byte aligned, on the
// tensor cores.
int drt_flash_attention_wgmma(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int S, int T, int H,
                              int KV, int hd, float scale, int causal,
                              int window, float softcap, void* stream) {
  return drt::dispatch_wgmma(q, k, v, o, static_cast<float*>(lse), B, S, T,
                             H, KV, hd, scale, causal, window, softcap,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
