// Ragged single-token decode attention over the KV cache pool.
//
// Replaces two TPU kernels of repro/kernels/decode_attention.py:
// decode_attention_bkgh (body _kernel), in both of its cache layouts,
//   full (window == 0): slot s holds position s, live iff s < len;
//   ring (window > 0):  slot s (< window) holds the latest position p with
//                       p = s mod window, live iff
//                       (len - 1 - s) mod window < min(len, window);
// and decode_attention_paged_bkgh (body _paged_kernel): the full layout
// read through a block table out of one arena of fixed-size blocks shared
// by every slot, see "Paged" below.
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
//
// Paged (template flag PAGED): k/v are an arena (P, bk, KV, hd) whose
// block 0 is a never-written null block, and table (B, NB) int32 maps
// logical block j of slot b to arena block table[b, j]. The row address is
// the ONLY difference from the full layout: cache row s of slot b is read
// at arena row table[b, s / bk] * bk + s % bk instead of b * L + s (with
// L = NB * bk). Each block first stages the live part of its slot's table
// row (ceil(len / bk) entries) in shared memory; the loop over live rows,
// the 8-warp interleaving, the online softmax and the merge are unchanged,
// so on the same cache values the paged kernel's output is bit-identical
// to the full-layout kernel's. A warp's group of 4 rows may straddle a
// block boundary, so the address is computed per row. An entry outside
// [0, P) reads the null block rather than past the arena. The TPU kernel
// visits only live blocks by clamping its block index; here only live rows
// are visited, as in the full layout. Bound: bytes, each live row's k and
// v read once (1280 B per row and layer at SmolLM's 5 kv heads of 64 in
// bf16), plus the table entries.
#include "common.cuh"

namespace drt {
namespace {

constexpr int DA_WARPS = 8;
constexpr int DA_THREADS = DA_WARPS * 32;
constexpr int DA_GMAX = 8;       // largest GQA group served
constexpr int DA_UNROLL = 4;     // cache rows a warp loads together

// table/NB/bk/P are read only when PAGED (then L == NB * bk, window == 0).
template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(DA_THREADS) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    const int* __restrict__ table, T* __restrict__ o, int L, int KV, int G,
    float scale, int window, float softcap, int NB, int bk, int P) {
  constexpr int PER = (HD + 31) / 32;   // dims per lane
  __shared__ float qs[DA_GMAX][HD];
  __shared__ float ms[DA_WARPS][DA_GMAX];
  __shared__ float ls[DA_WARPS][DA_GMAX];
  __shared__ float accs[DA_WARPS][DA_GMAX][HD];
  extern __shared__ int tbl[];          // PAGED: the slot's live blocks

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ln = lengths[b];
  const size_t qoff = ((size_t)b * KV + kvh) * G * HD;

  for (int i = threadIdx.x; i < G * HD; i += DA_THREADS)
    qs[i / HD][i % HD] = ld(q + qoff + i) * scale;
  if (PAGED && ln > 0) {
    const int nlive = cdiv(min(ln, L), bk);
    for (int i = threadIdx.x; i < nlive; i += DA_THREADS) {
      const int e = table[(size_t)b * NB + i];
      tbl[i] = (e >= 0 && e < P) ? e : 0;
    }
  }
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
      size_t row;
      if (PAGED)
        row = ok ? (size_t)tbl[j / bk] * bk + j % bk : 0;
      else
        row = (size_t)b * L + j;
      const size_t off = (row * KV + kvh) * HD;
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

template <typename T, int HD, bool PAGED>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* lengths, const int* table, void* o, int B,
                  int L, int KV, int G, float scale, int window,
                  float softcap, int NB, int bk, int P, cudaStream_t st) {
  auto kern = decode_kernel<T, HD, PAGED>;
  const size_t smem = PAGED ? (size_t)NB * sizeof(int) : 0;
  if (smem > 8 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<B * KV, DA_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, table, static_cast<T*>(o), L, KV,
      G, scale, window, softcap, NB, bk, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PAGED>
int dispatch_hd(const void* q, const void* k, const void* v,
                const int* lengths, const int* table, void* o, int B, int L,
                int KV, int G, int hd, float scale, int window, float softcap,
                int NB, int bk, int P, cudaStream_t st) {
  if (G < 1 || G > DA_GMAX) return static_cast<int>(cudaErrorInvalidValue);
#define DA_CASE(H)                                                         \
  case H:                                                                  \
    return launch_decode<T, H, PAGED>(q, k, v, lengths, table, o, B, L,    \
                                      KV, G, scale, window, softcap, NB,   \
                                      bk, P, st);
  switch (hd) {
    DA_CASE(16)
    DA_CASE(32)
    DA_CASE(64)
    DA_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DA_CASE
}

template <bool PAGED>
int dispatch_dtype(const void* q, const void* k, const void* v,
                   const void* lengths, const void* table, void* o, int B,
                   int L, int KV, int G, int hd, float scale, int window,
                   float softcap, int NB, int bk, int P, int dtype,
                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto len = static_cast<const int*>(lengths);
  auto tb = static_cast<const int*>(table);
  if (dtype == kFloat32)
    return dispatch_hd<float, PAGED>(q, k, v, len, tb, o, B, L, KV, G, hd,
                                     scale, window, softcap, NB, bk, P, st);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16, PAGED>(q, k, v, len, tb, o, B, L, KV,
                                             G, hd, scale, window, softcap,
                                             NB, bk, P, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace drt

extern "C" {

// q (B, KV, G, hd); k/v (B, L, KV, hd); lengths (B,) int32; o like q.
int drt_decode_attention(const void* q, const void* k, const void* v,
                         const void* lengths, void* o, int B, int L, int KV,
                         int G, int hd, float scale, int window,
                         float softcap, int dtype, void* stream) {
  return drt::dispatch_dtype<false>(q, k, v, lengths, nullptr, o, B, L, KV,
                                    G, hd, scale, window, softcap, 0, 1, 0,
                                    dtype, stream);
}

// q (B, KV, G, hd); k/v (P, bk, KV, hd) arena; lengths (B,) int32;
// table (B, NB) int32; o like q.
int drt_decode_attention_paged(const void* q, const void* k, const void* v,
                               const void* lengths, const void* table,
                               void* o, int B, int NB, int bk, int P, int KV,
                               int G, int hd, float scale, float softcap,
                               int dtype, void* stream) {
  if (NB < 1 || bk < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return drt::dispatch_dtype<true>(q, k, v, lengths, table, o, B, NB * bk,
                                   KV, G, hd, scale, 0, softcap, NB, bk, P,
                                   dtype, stream);
}

}  // extern "C"
