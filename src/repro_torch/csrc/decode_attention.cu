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
// o (B, KV, G, hd). A block scores all G grouped query heads of one kv
// head, so repeated K/V never exist.
//
// Bound: bytes. Each live cache row is read once; nothing past a slot's
// length is read. At decode the bytes are few (one step of SmolLM's batcher
// reads ~1.2 MB a layer), so what costs time is latency: the dependent
// rounds of row loads a block makes, and blocks left idle. The TPU kernel
// gets the lengths by scalar prefetch and clamps its block index so dead
// blocks are never copied. Here a slot's rows are split across blocks:
// the grid is (B x KV, chunks), chunks = ceil(L / DA_CHUNK) from the pool's
// shape on the host (no length is read there), and block (slot, kv head,
// c) takes rows [c DA_CHUNK, (c + 1) DA_CHUNK) of the slot's rows that may
// be live (the live prefix, or the whole ring); a block whose chunk lies
// past them exits at once, so at batch 8 SmolLM's batcher puts ~165 blocks
// on the card where one block a (slot, kv head) put 40. Inside a chunk the
// 8 warps take interleaved groups of 4 rows (lanes across hd: coalesced
// rows), issue the loads of a group together, keep a per-warp online
// softmax (a masked ring row is skipped, which is exactly what the -1e30
// sentinel contributes) and merge in shared memory, sized by G and hd, into
// the block's partial (m, l, acc[G][hd]) in float32. A second launch merges
// a (slot, kv head)'s partials in chunk order, applies the 1e-30 floor and
// writes zeros for a dead slot. The chunks are fixed by DA_CHUNK and the
// slot's length alone, never by L, so two pools of different L visit a
// slot's rows in the same chunks and the same order.
//
// Paged (template flag PAGED): k/v are an arena (P, bk, KV, hd) whose
// block 0 is a never-written null block, and table (B, NB) int32 maps
// logical block j of slot b to arena block table[b, j]. The row address is
// the ONLY difference from the full layout: cache row s of slot b is read
// at arena row table[b, s / bk] * bk + s % bk instead of b * L + s (with
// L = NB * bk). Each block first stages the table entries its chunk spans
// (at most DA_CHUNK / bk + 1) in shared memory; chunks, the 8-warp
// interleaving, the online softmax and both merges are unchanged, so on
// the same cache values the paged kernel's output is bit-identical to the
// full-layout kernel's. A warp's group of 4 rows may straddle a block
// boundary, so the address is computed per row. An entry outside [0, P)
// reads the null block rather than past the arena. Bound: bytes, each live
// row's k and v read once (1280 B per row and layer at SmolLM's 5 kv heads
// of 64 in bf16), plus the table entries.
#include "common.cuh"

namespace drt {
namespace {

constexpr int DA_WARPS = 8;
constexpr int DA_THREADS = DA_WARPS * 32;
constexpr int DA_GMAX = 8;       // largest GQA group served
constexpr int DA_UNROLL = 4;     // cache rows a warp loads together
constexpr int DA_STRIDE = DA_WARPS * DA_UNROLL;   // rows a round of loads
// Rows a block takes: one round of loads.
constexpr int DA_CHUNK = 32;
static_assert(DA_CHUNK % DA_STRIDE == 0, "a chunk is whole rounds of loads");
constexpr int DA_COMBINE_THREADS = 256;

// Dynamic shared memory of the partial kernel: the scaled queries, then
// each warp's running max, sum and accumulator, float32.
__host__ __device__ constexpr size_t da_smem_bytes(int G, int HD) {
  return sizeof(float) * ((size_t)G * HD + 2 * DA_WARPS * G +
                          (size_t)DA_WARPS * G * HD);
}

// Rows of slot b that may be live: the live prefix (full) or the ring.
__device__ __forceinline__ int live_rows(int ln, int L, int window) {
  if (ln <= 0) return 0;
  return window ? min(L, window) : min(ln, L);
}

// The partial softmax of chunk blockIdx.y of (slot, kv head) blockIdx.x:
// m, l (B*KV, chunks, G) and acc (B*KV, chunks, G, HD), float32.
// table/NB/bk/P are read only when PAGED (then L == NB * bk, window == 0).
template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(DA_THREADS) decode_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    const int* __restrict__ table, float* __restrict__ pm,
    float* __restrict__ pl, float* __restrict__ pacc, int L, int KV, int G,
    float scale, int window, float softcap, int NB, int bk, int P) {
  constexpr int PER = (HD + 31) / 32;   // dims per lane
  extern __shared__ __align__(16) float da_smem[];
  float* qs = da_smem;                           // [G][HD]
  float* ms = qs + G * HD;                       // [DA_WARPS][G]
  float* ls = ms + DA_WARPS * G;                 // [DA_WARPS][G]
  float* accs = ls + DA_WARPS * G;               // [DA_WARPS][G][HD]
  __shared__ int tbl[DA_CHUNK + 1];     // PAGED: the blocks the chunk spans

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int ln = lengths[b];
  const int nrows = live_rows(ln, L, window);
  const int c0 = blockIdx.y * DA_CHUNK;
  if (c0 >= nrows) return;              // past the slot's live rows
  const int c1 = min(nrows, c0 + DA_CHUNK);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qoff = ((size_t)b * KV + kvh) * G * HD;

  for (int i = threadIdx.x; i < G * HD; i += DA_THREADS)
    qs[i] = ld(q + qoff + i) * scale;
  const int tb0 = c0 / bk;
  if (PAGED) {
    for (int i = threadIdx.x; i <= (c1 - 1) / bk - tb0; i += DA_THREADS) {
      const int e = table[(size_t)b * NB + tb0 + i];
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

  const int span = min(ln, window);
  for (int j0 = c0 + warp * DA_UNROLL; j0 < c1; j0 += DA_STRIDE) {
    float kr[DA_UNROLL][PER], vr[DA_UNROLL][PER];
    bool live[DA_UNROLL];
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      const int j = j0 + u;
      bool ok = j < c1;
      if (window && ok) {
        const int age = ((ln - 1 - j) % window + window) % window;
        ok = age < span;
      }
      live[u] = ok;
      size_t row;
      if (PAGED)
        row = ok ? (size_t)tbl[j / bk - tb0] * bk + j % bk : 0;
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
          if (d < HD) dot += qs[g * HD + d] * kr[u][i];
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
      ms[warp * G + g] = m[g];
      ls[warp * G + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) accs[(warp * G + g) * HD + d] = acc[g][i];
    }
  }
  __syncthreads();

  // merge the warps' states into the block's partial
  const size_t part = (size_t)blockIdx.x * gridDim.y + blockIdx.y;
  for (int i = threadIdx.x; i < G * HD; i += DA_THREADS) {
    const int g = i / HD, d = i % HD;
    float mx = NEG_INF;
    for (int w = 0; w < DA_WARPS; ++w) mx = fmaxf(mx, ms[w * G + g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < DA_WARPS; ++w) {
      const float sc = expf(ms[w * G + g] - mx);
      lsum += ls[w * G + g] * sc;
      a += accs[(w * G + g) * HD + d] * sc;
    }
    pacc[part * G * HD + i] = a;
    if (d == 0) {
      pm[part * G + g] = mx;
      pl[part * G + g] = lsum;
    }
  }
}

// o of (slot, kv head) blockIdx.x from its live chunks' partials, merged in
// chunk order; zeros for a dead slot.
template <typename T>
__global__ void __launch_bounds__(DA_COMBINE_THREADS) decode_combine_kernel(
    const int* __restrict__ lengths, const float* __restrict__ pm,
    const float* __restrict__ pl, const float* __restrict__ pacc,
    T* __restrict__ o, int L, int KV, int G, int HD, int window,
    int chunks) {
  const int b = blockIdx.x / KV;
  const int ln = lengths[b];
  const int nc = cdiv(live_rows(ln, L, window), DA_CHUNK);
  const size_t part0 = (size_t)blockIdx.x * chunks;
  const size_t ooff = (size_t)blockIdx.x * G * HD;
  for (int i = threadIdx.x; i < G * HD; i += DA_COMBINE_THREADS) {
    const int g = i / HD;
    float mx = NEG_INF;
    for (int c = 0; c < nc; ++c) mx = fmaxf(mx, pm[(part0 + c) * G + g]);
    float lsum = 0.f, a = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float sc = expf(pm[(part0 + c) * G + g] - mx);
      lsum += pl[(part0 + c) * G + g] * sc;
      a += pacc[(part0 + c) * G * HD + i] * sc;
    }
    const float out = ln > 0 ? a / fmaxf(lsum, 1e-30f) : 0.f;
    o[ooff + i] = cvt<T>(out);
  }
}

template <typename T, int HD, bool PAGED>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* lengths, const int* table, void* o, float* part,
                  int B, int L, int KV, int G, float scale, int window,
                  float softcap, int NB, int bk, int P, cudaStream_t st) {
  auto kern = decode_partial_kernel<T, HD, PAGED>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(da_smem_bytes(DA_GMAX, HD)));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int chunks = cdiv(L, DA_CHUNK);
  const size_t n = (size_t)B * KV * chunks * G;
  float* pm = part;
  float* pl = pm + n;
  float* pacc = pl + n;
  kern<<<dim3(B * KV, chunks), DA_THREADS, da_smem_bytes(G, HD), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, table, pm, pl, pacc, L, KV, G,
      scale, window, softcap, NB, bk, P);
  decode_combine_kernel<T><<<B * KV, DA_COMBINE_THREADS, 0, st>>>(
      lengths, pm, pl, pacc, static_cast<T*>(o), L, KV, G, HD, window,
      chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PAGED>
int dispatch_hd(const void* q, const void* k, const void* v,
                const int* lengths, const int* table, void* o, float* part,
                int B, int L, int KV, int G, int hd, float scale, int window,
                float softcap, int NB, int bk, int P, cudaStream_t st) {
  if (G < 1 || G > DA_GMAX || L < 1 || cdiv(L, DA_CHUNK) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
#define DA_CASE(H)                                                         \
  case H:                                                                  \
    return launch_decode<T, H, PAGED>(q, k, v, lengths, table, o, part, B, \
                                      L, KV, G, scale, window, softcap,    \
                                      NB, bk, P, st);
  switch (hd) {
    DA_CASE(16)
    DA_CASE(32)
    DA_CASE(64)
    DA_CASE(128)
    DA_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DA_CASE
}

template <bool PAGED>
int dispatch_dtype(const void* q, const void* k, const void* v,
                   const void* lengths, const void* table, void* o,
                   void* part, int B, int L, int KV, int G, int hd,
                   float scale, int window, float softcap, int NB, int bk,
                   int P, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto len = static_cast<const int*>(lengths);
  auto tb = static_cast<const int*>(table);
  auto pt = static_cast<float*>(part);
  if (dtype == kFloat32)
    return dispatch_hd<float, PAGED>(q, k, v, len, tb, o, pt, B, L, KV, G,
                                     hd, scale, window, softcap, NB, bk, P,
                                     st);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16, PAGED>(q, k, v, len, tb, o, pt, B, L,
                                             KV, G, hd, scale, window,
                                             softcap, NB, bk, P, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace drt

extern "C" {

// Rows of a slot each block of the partial kernel takes.
int drt_decode_chunk() { return drt::DA_CHUNK; }

// q (B, KV, G, hd); k/v (B, L, KV, hd); lengths (B,) int32; o like q;
// part float32 scratch of B * KV * ceil(L / drt_decode_chunk()) * G *
// (hd + 2) values.
int drt_decode_attention(const void* q, const void* k, const void* v,
                         const void* lengths, void* o, void* part, int B,
                         int L, int KV, int G, int hd, float scale,
                         int window, float softcap, int dtype, void* stream) {
  return drt::dispatch_dtype<false>(q, k, v, lengths, nullptr, o, part, B, L,
                                    KV, G, hd, scale, window, softcap, 0, 1,
                                    0, dtype, stream);
}

// q (B, KV, G, hd); k/v (P, bk, KV, hd) arena; lengths (B,) int32;
// table (B, NB) int32; o like q; part as drt_decode_attention's at
// L = NB * bk.
int drt_decode_attention_paged(const void* q, const void* k, const void* v,
                               const void* lengths, const void* table,
                               void* o, void* part, int B, int NB, int bk,
                               int P, int KV, int G, int hd, float scale,
                               float softcap, int dtype, void* stream) {
  if (NB < 1 || bk < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return drt::dispatch_dtype<true>(q, k, v, lengths, table, o, part, B,
                                   NB * bk, KV, G, hd, scale, 0, softcap, NB,
                                   bk, P, dtype, stream);
}

}  // extern "C"
