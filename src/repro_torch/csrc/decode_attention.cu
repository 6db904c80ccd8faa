// Ragged single-token decode attention over the KV cache pool.
//
// Replaces the TPU kernel decode_attention_bkgh (repro/kernels/
// decode_attention.py, body _kernel), in both of its cache layouts:
//   full (window == 0): slot s holds position s, live iff s < len;
//   ring (window > 0):  slot s (< window) holds the latest position p with
//                       p = s mod window, live iff
//                       (len - 1 - s) mod window < min(len, window).
// Same arithmetic: the query is scaled BEFORE the QK product, softcap as
// cap * tanh(s / cap), p rounded to v's dtype for PV while the denominator
// sums unrounded p, denominator floored at 1e-30, and a dead slot (len 0)
// emits exact zeros.
//
// Layout: q (B, KV, G, hd), k/v (B, L, KV, hd), lengths (B,) int32,
// o (B, KV, G, hd). One block per (slot, kv head) scores all G grouped
// query heads against that kv head, so repeated K/V never exist.
//
// Bound: bytes. Each live cache row is read once; nothing past a slot's
// length is read. The TPU kernel gets the lengths by scalar prefetch and
// clamps its block index so dead blocks are never copied; here each block
// reads its own length and loops over its live rows only. The 8 warps of a
// block take interleaved groups of 4 rows (lanes across hd: 128-byte
// coalesced rows), issue the loads of a group together to hide latency,
// keep a per-warp online softmax (a masked row is skipped, which is exactly
// what the -1e30 sentinel contributes), and merge the warps' states in
// shared memory at the end. The grid is B x KV blocks, 40 at batch 8 for
// SmolLM: low occupancy by design here; splitting L across blocks is later
// work.
#include "common.cuh"

namespace drt {
namespace {

constexpr int DA_WARPS = 8;
constexpr int DA_THREADS = DA_WARPS * 32;
constexpr int DA_GMAX = 8;       // largest GQA group served
constexpr int DA_UNROLL = 4;     // cache rows a warp loads together

template <typename T, int HD>
__global__ void __launch_bounds__(DA_THREADS) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    T* __restrict__ o, int L, int KV, int G, float scale, int window,
    float softcap) {
  constexpr int PER = (HD + 31) / 32;   // dims per lane
  __shared__ float qs[DA_GMAX][HD];
  __shared__ float ms[DA_WARPS][DA_GMAX];
  __shared__ float ls[DA_WARPS][DA_GMAX];
  __shared__ float accs[DA_WARPS][DA_GMAX][HD];

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ln = lengths[b];
  const size_t qoff = ((size_t)b * KV + kvh) * G * HD;

  for (int i = threadIdx.x; i < G * HD; i += DA_THREADS)
    qs[i / HD][i % HD] = ld(q + qoff + i) * scale;
  __syncthreads();

  float m[DA_GMAX], l[DA_GMAX], acc[DA_GMAX][PER];
#pragma unroll
  for (int g = 0; g < DA_GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[g][i] = 0.f;
  }

  // rows that may be live: the live prefix (full) or the ring (window)
  int nrows = 0;
  if (ln > 0) nrows = window ? min(L, window) : min(ln, L);
  const int span = min(ln, window);

  for (int j0 = warp * DA_UNROLL; j0 < nrows; j0 += DA_WARPS * DA_UNROLL) {
    float kr[DA_UNROLL][PER], vr[DA_UNROLL][PER];
    bool live[DA_UNROLL];
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      const int j = j0 + u;
      bool ok = j < nrows;
      if (window && ok) {
        const int age = ((ln - 1 - j) % window + window) % window;
        ok = age < span;
      }
      live[u] = ok;
      const size_t off = (((size_t)b * L + j) * KV + kvh) * HD;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int d = lane + 32 * i;
        const bool in = ok && d < HD;
        kr[u][i] = in ? ld(k + off + d) : 0.f;
        vr[u][i] = in ? ld(v + off + d) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      if (!live[u]) continue;           // uniform across the warp
#pragma unroll
      for (int g = 0; g < DA_GMAX; ++g) {
        if (g >= G) break;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int d = lane + 32 * i;
          if (d < HD) dot += qs[g][d] * kr[u][i];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (softcap != 0.f) dot = softcap * tanhf(dot / softcap);
        const float m_new = fmaxf(m[g], dot);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(dot - m_new);
        l[g] = l[g] * alpha + p;
        const float pr = round_to<T>(p);
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[g][i] = acc[g][i] * alpha + pr * vr[u][i];
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < DA_GMAX; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      ms[warp][g] = m[g];
      ls[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) accs[warp][g][d] = acc[g][i];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * HD; i += DA_THREADS) {
    const int g = i / HD, d = i % HD;
    float mx = NEG_INF;
    for (int w = 0; w < DA_WARPS; ++w) mx = fmaxf(mx, ms[w][g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < DA_WARPS; ++w) {
      const float sc = expf(ms[w][g] - mx);
      lsum += ls[w][g] * sc;
      a += accs[w][g][d] * sc;
    }
    const float out = ln > 0 ? a / fmaxf(lsum, 1e-30f) : 0.f;
    o[qoff + i] = cvt<T>(out);
  }
}

template <typename T, int HD>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* lengths, void* o, int B, int L, int KV, int G,
                  float scale, int window, float softcap, cudaStream_t st) {
  decode_kernel<T, HD><<<B * KV, DA_THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), L, KV, G, scale,
      window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v,
                const int* lengths, void* o, int B, int L, int KV, int G,
                int hd, float scale, int window, float softcap,
                cudaStream_t st) {
  if (G < 1 || G > DA_GMAX) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch_decode<T, 16>(q, k, v, lengths, o, B, L, KV, G,
                                         scale, window, softcap, st);
    case 32: return launch_decode<T, 32>(q, k, v, lengths, o, B, L, KV, G,
                                         scale, window, softcap, st);
    case 64: return launch_decode<T, 64>(q, k, v, lengths, o, B, L, KV, G,
                                         scale, window, softcap, st);
    case 128: return launch_decode<T, 128>(q, k, v, lengths, o, B, L, KV, G,
                                           scale, window, softcap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace drt

extern "C" {

// q (B, KV, G, hd); k/v (B, L, KV, hd); lengths (B,) int32; o like q.
int drt_decode_attention(const void* q, const void* k, const void* v,
                         const void* lengths, void* o, int B, int L, int KV,
                         int G, int hd, float scale, int window,
                         float softcap, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto len = static_cast<const int*>(lengths);
  if (dtype == drt::kFloat32)
    return drt::dispatch_hd<float>(q, k, v, len, o, B, L, KV, G, hd, scale,
                                   window, softcap, st);
  if (dtype == drt::kBFloat16)
    return drt::dispatch_hd<__nv_bfloat16>(q, k, v, len, o, B, L, KV, G, hd,
                                           scale, window, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
