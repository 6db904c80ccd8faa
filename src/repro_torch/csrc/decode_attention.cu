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
// cap * tanh(s / cap), fp32 accumulation, p rounded to v's dtype for PV
// while the denominator sums unrounded p, denominator floored at 1e-30,
// and a dead slot (len 0) emits exact zeros. A masked row contributes
// nothing, which is exactly what the -1e30 sentinel gives.
//
// Layout: q (B, KV, G, hd), k/v (B, L, KV, hd), lengths (B,) int32,
// o (B, KV, G, hd). All G grouped query heads of a kv head are scored
// together, so repeated K/V never exist.
//
// What bounds it. Each live cache row is read once (2 hd bytes of k and of
// v a kv head in bf16); nothing past a slot's live rows is read. At the
// main path's shapes (SmolLM-360M, B 8, ~80-160 rows a slot) that is
// ~0.2-0.4 MB a layer, under a microsecond of HBM time, so what costs is
// launch latency and the fixed cost of each block: the earlier design paid
// two dependent launches a call (partials into float32 scratch, then a
// merge kernel) and a block a 32-row chunk. At long caches (thousands of
// rows a slot) the bytes bound it, and the card has to keep enough loads in
// flight to stream K/V at HBM rate from few (slot, kv head) pairs.
//
// The design: ONE launch a call, no scratch, no merge kernel. Each (slot,
// kv head) is a thread-block cluster of DA_CL blocks (grid B * KV * DA_CL,
// nothing taken from L). The slot's live rows, a prefix in both layouts
// (da_live_rows), are cut into tiles of DA_TILE rows; block (cluster
// rank) r takes tiles r, r + DA_CL, r + 2 DA_CL, ... in that order and
// keeps one online softmax over them. Which rows a rank takes, and every
// merge order below, are functions of the slot's length (and window)
// alone, never of L, B, NB, bk or the table: a slot gives the same bits in
// pools of any L, contiguous or paged, eager or in a graph.
//   Loads. A lane loads 16 bytes (8 bf16 or 4 float32 values) of a row;
// LPR = hd * size / 16 lanes (at most 32) cover a row, so one warp load
// covers 32 / LPR rows (4 at hd 64 in bf16), and the dot product is
// reduced over log2(LPR) lanes. Each warp streams its rows of the rank's
// tiles through its own ring of DA_STAGES slots in shared memory by
// cp.async, DA_STAGES - 1 slots in flight; a lane reads back only what it
// copied, so the ring needs no barrier; rows past the live ones are
// zero-filled, not read. The G query heads stay in registers, loaded once
// a block; a slot of the ring (4 rows a lane group) is folded into the
// running max, sum and accumulator of each head at once.
//   Launch. A programmatic dependent launch: the blocks become resident
// while the kernel ahead ends and wait for it in griddepcontrol.wait, and
// release the next kernel's blocks once their loads are done, which hides
// most of the launch latency that bounds the main path.
//   Merge. The lane groups of a warp merge by xor shuffles, the 4 warps of
// a block through shared memory in warp order, and the cluster's blocks
// through distributed shared memory (mapa / ld.shared::cluster) in rank
// order: each block merges a slice of the G * hd outputs, applies the
// floor and writes o. A block with no live rows takes part with an empty
// state (max -1e30, sum 0). Two cluster barriers: before the peers' states
// are read, and before any block exits.
//   Why clusters and not a last-block-merges counter: the merge stays on
// chip in one launch, with no global scratch and no counter to reset
// under graph replay. DA_CL is 8, the portable cluster size: 16 cuts a
// B 1 long cache's time by a third but nearly doubles the main path's,
// and the plan may not depend on B. Build switches time the alternatives
// (scripts/torch_decode_attention.py --define): -DDRT_DA_CL=16
// (non-portable clusters), -DDRT_DA_NO_PDL (an ordinary launch).
//
// Paged (a table is given): k/v are an arena (P, bk, KV, hd) whose
// block 0 is a never-written null block, and table (B, NB) int32 maps
// logical block j of slot b to arena block table[b, j]. The row address is
// the ONLY difference from the full layout: cache row s of slot b is read
// at arena row table[b, s / bk] * bk + s % bk instead of b * L + s (with
// L = NB * bk). Each block first stages, in shared memory, the table
// entries its tiles span (at most (DA_TILE - 1) / bk + 2 a tile); tiles,
// rings and merges are unchanged, so on the same cache values the paged
// kernel's output is bit-identical to the full-layout kernel's. An entry
// outside [0, P) reads the null block rather than past the arena.
//
// State out (STATE = true, drt_decode_attention_state, full layout only):
// the same plan, loads and merges, but the cluster writes the merged
// softmax state in float32 in place of o: acc (B, KV, G, hd), the
// unnormalised sum a of the last merge, and m, l (B, KV, G), its max and
// denominator, before the floor. A caller that holds a slot's rows split
// over several processes (a cache sequence-split over a mesh's model
// ranks) runs it on each block with the block's live-row count and merges
// the states as the cluster does (kernels/ref.py merge_states): a rank
// that rounded a normalised output to bf16 first would add an error that
// one process never makes. A block with no live rows writes m = -1e30,
// l = 0, acc = 0; one state merged alone gives o bit for bit.
#include "common.cuh"

#ifndef DRT_DA_CL
#define DRT_DA_CL 8
#endif

namespace drt {
namespace {

constexpr int DA_CL = DRT_DA_CL;          // blocks a (slot, kv head)
constexpr int DA_TILE = 64;               // rows a rank takes a turn
constexpr int DA_WARPS = 4;
constexpr int DA_THREADS = DA_WARPS * 32;
constexpr int DA_STAGES = 4;              // ring slots a warp
constexpr int DA_VECS = 4;     // 16-byte vectors of k (and of v) a lane
                               // copies into one ring slot
constexpr int DA_GMAX = 8;     // largest GQA group served
constexpr int DA_SLOT_BYTES = 32 * DA_VECS * 2 * 16;        // a warp's slot
constexpr int DA_WARP_BYTES = DA_STAGES * DA_SLOT_BYTES;    // a warp's ring
constexpr int DA_RING_BYTES = DA_WARPS * DA_WARP_BYTES;
constexpr int DA_SMEM_MAX = 232448;       // a block's shared memory, sm_90
static_assert(DA_CL >= 1 && DA_CL <= 16, "a cluster holds 1-16 blocks");
static_assert(DA_GMAX * 256 * 4 + 2 * DA_GMAX * 4 <= DA_WARP_BYTES,
              "the largest warp state fits the warp's ring");

// The lane geometry of a row of hd values of T.
template <typename T, int HD>
struct DaGeo {
  static constexpr int VEC = 16 / sizeof(T);       // values a 16-byte load
  static constexpr int NV = HD / VEC;              // 16-byte vectors a row
  static constexpr int LPR = NV < 32 ? NV : 32;    // lanes a row
  static constexpr int VPL = NV / LPR;             // vectors a lane of a row
  static constexpr int E = VPL * VEC;              // values a lane of a row
  static constexpr int RPW = 32 / LPR;             // rows one warp load
  static constexpr int U = DA_VECS / VPL;          // rows a lane, a slot
  static constexpr int GPW = DA_TILE / (RPW * DA_WARPS);  // groups a warp
  static_assert(NV >= 2 && NV % LPR == 0 && DA_VECS % VPL == 0, "hd");
  static_assert(GPW >= 1 && DA_TILE % (RPW * DA_WARPS) == 0, "tile");
};

// ---------------------------------------------------------------------------
// The plan, shared by the kernel and the host (drt_decode_plan)
// ---------------------------------------------------------------------------
// The live rows of a slot: always a prefix, never past the pool's rows.
// Full layout: rows [0, len). Ring: row s < window is live iff (len - 1 -
// s) mod window < min(len, window), which holds for every s < window once
// len >= window and exactly for s < len before, so the live rows are
// [0, min(len, window)) and a dead ring row is never visited.
__host__ __device__ __forceinline__ int da_live_rows(int ln, int rows,
                                                     int window) {
  if (ln <= 0) return 0;
  const int n = window > 0 && window < ln ? window : ln;
  return n < rows ? n : rows;
}

// Tiles rank r of the cluster takes of n rows: r, r + DA_CL, ...
__host__ __device__ __forceinline__ int da_rank_tiles(int n, int rank) {
  const int nt = cdiv(n, DA_TILE);
  return nt > rank ? cdiv(nt - rank, DA_CL) : 0;
}

// Table entries a tile of rows can span at block size bk.
__host__ __device__ __forceinline__ int da_tile_entries(int bk) {
  return (DA_TILE - 1) / bk + 2;
}

// Dynamic shared memory of a launch: the warps' rings, the block's merged
// state (acc [G][hd], m [G], l [G]), and when paged the table entries of
// rank 0's tiles (the most any rank takes) in a pool of `rows` rows.
__host__ __device__ __forceinline__ size_t da_smem_bytes(int G, int hd,
                                                        bool paged, int rows,
                                                        int bk) {
  size_t s = DA_RING_BYTES + sizeof(float) * ((size_t)G * hd + 2 * G);
  if (paged)
    s += sizeof(int) * (size_t)da_rank_tiles(rows, 0) * da_tile_entries(bk);
  return s;
}

// ---------------------------------------------------------------------------
// Device helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch (the launch sets
// cudaLaunchAttributeProgrammaticStreamSerialization): wait until the
// grids ahead on the stream have ended and their writes are visible; let
// the next grid's blocks be scheduled (they wait in the same way).
__device__ __forceinline__ void grid_dependency_wait() {
#ifndef DRT_DA_NO_PDL
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#endif
}
__device__ __forceinline__ void grid_launch_dependents() {
#ifndef DRT_DA_NO_PDL
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
#endif
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
// Full cluster barrier: every block's earlier shared-memory writes are
// visible to every block after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// A float of block `rank`'s shared memory at the address of `local`.
__device__ __forceinline__ float ld_peer(const float* local, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(local)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a)
               : "memory");
  return v;
}

// The VEC values of a 16-byte vector, as float.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& r, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& r, float* f) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& r,
                                                        float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------
// Block (cluster rank r) of (slot b, kv head kvh) = blockIdx.x / DA_CL.
// GB >= G query heads are held in registers and scored without a branch
// (heads past G have a zero query and are never written); `table` is null
// for the full layout, else the block table (then L == NB * bk, window ==
// 0). Nothing in the loop over the ring branches on G, the softcap or a
// row's liveness, so the compiler interleaves the rows' and heads'
// independent dot products, shuffles and exponentials.
// With STATE the merged state goes to sacc, sm and sl (float32) instead of
// o (see "State out" above).
template <typename T, int HD, int GB, bool STATE>
__global__ void __launch_bounds__(DA_THREADS, GB > 4 ? 2 : 3) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    const int* __restrict__ table, T* __restrict__ o,
    float* __restrict__ sacc, float* __restrict__ sm,
    float* __restrict__ sl, int L, int KV, int G, float scale, int window,
    float softcap, int NB, int bk, int P) {
  using Geo = DaGeo<T, HD>;
  constexpr int VEC = Geo::VEC, LPR = Geo::LPR, VPL = Geo::VPL;
  constexpr int E = Geo::E, RPW = Geo::RPW, U = Geo::U, GPW = Geo::GPW;
  extern __shared__ __align__(128) unsigned char da_smem[];
  float* cacc = reinterpret_cast<float*>(da_smem + DA_RING_BYTES);
  float* cm = cacc + G * HD;                  // the block's merged state
  float* cl = cm + G;
  int* tbl = reinterpret_cast<int*>(cl + G);  // paged: its tiles' blocks
  const bool paged = table != nullptr;
  // a programmatic dependent launch: the blocks may be resident before the
  // kernels ahead of this one on the stream end; nothing is read before
  // they have
  grid_dependency_wait();

  const int rank = cluster_rank();
  const int pair = blockIdx.x / DA_CL;
  const int b = pair / KV, kvh = pair % KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lg = lane / LPR, li = lane % LPR;
  const int ln = lengths[b];
  const int n = da_live_rows(ln, L, window);
  const int ntr = da_rank_tiles(n, rank);
  const int ept = paged ? da_tile_entries(bk) : 0;

  // the query heads, scaled, in registers (zero past G)
  float qr[GB][E];
  const T* qp = q + (size_t)pair * G * HD;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      float f[VEC];
      uint4 r = make_uint4(0, 0, 0, 0);
      if (g < G)
        r = *reinterpret_cast<const uint4*>(qp + g * HD +
                                            (li + LPR * j) * VEC);
      unpack16<T>(r, f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][j * VEC + e] = f[e] * scale;
    }
  }
  if (paged) {
    for (int i = threadIdx.x; i < ntr * ept; i += DA_THREADS) {
      const int r0 = (rank + i / ept * DA_CL) * DA_TILE;
      const int blk = r0 / bk + i % ept;
      int e = 0;
      if (blk <= (min(n, r0 + DA_TILE) - 1) / bk) {
        e = table[(size_t)b * NB + blk];
        e = (e >= 0 && e < P) ? e : 0;
      }
      tbl[i] = e;
    }
    __syncthreads();
  }

  // Element kk of this warp's stream: row group w + DA_WARPS (kk % GPW) of
  // its rank's tile kk / GPW; this lane's row of it, or -1 past the live
  // rows.
  const int nk = ntr * GPW;
  auto row_of = [&](int kk) -> int {
    const int r = (rank + kk / GPW * DA_CL) * DA_TILE +
                  (warp + DA_WARPS * (kk % GPW)) * RPW + lg;
    return kk < nk && r < n ? r : -1;
  };
  // the address of live row r of element kk
  auto offset = [&](int kk, int r) -> size_t {
    size_t row;
    if (paged) {
      const int t0 = (rank + kk / GPW * DA_CL) * DA_TILE;
      row = (size_t)tbl[kk / GPW * ept + r / bk - t0 / bk] * bk + r % bk;
    } else {
      row = (size_t)b * L + r;
    }
    return (row * KV + kvh) * HD;
  };
  unsigned char* ring = da_smem + warp * DA_WARP_BYTES;
  const uint32_t ring_u32 = smem_u32(ring);
  // ring slot layout: [vector c < DA_VECS][lane] of k, then the same of v
  const int nst = cdiv(nk, U);      // the same for every warp of the block
  auto issue = [&](int s) {
    if (s < nst) {                  // past the stream: an empty group
      const uint32_t slot = ring_u32 + (s % DA_STAGES) * DA_SLOT_BYTES;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = row_of(s * U + u);
        const size_t off = r >= 0 ? offset(s * U + u, r) : 0;
        const int bytes = r >= 0 ? 16 : 0;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const int c = u * VPL + j;
          const size_t at = off + (size_t)(li + LPR * j) * VEC;
          cp_async16(slot + (c * 32 + lane) * 16, k + at, bytes);
          cp_async16(slot + ((DA_VECS + c) * 32 + lane) * 16, v + at,
                     bytes);
        }
      }
    }
    cp_async_commit();
  };

  float m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < DA_STAGES - 1; ++s) issue(s);
  for (int s = 0; s < nst; ++s) {
    __syncwarp();                   // slot (s - 1) % DA_STAGES was read
    issue(s + DA_STAGES - 1);
    cp_async_wait<DA_STAGES - 1>();
    const unsigned char* slot = ring + (s % DA_STAGES) * DA_SLOT_BYTES;
    float sc[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
#pragma unroll
      for (int j = 0; j < VPL; ++j)
        unpack16<T>(*reinterpret_cast<const uint4*>(
                        slot + ((u * VPL + j) * 32 + lane) * 16),
                    kf + j * VEC);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot += qr[g][e] * kf[e];
        sc[u][g] = dot;
      }
    }
#pragma unroll
    for (int x = LPR / 2; x > 0; x >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GB; ++g)
          sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], x);
    if (softcap != 0.f) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GB; ++g)
          sc[u][g] = softcap * tanhf(sc[u][g] / softcap);
    }
    // fold the slot's rows into each head's running state; a row past the
    // live ones takes no part in the max, its p is 0 and its zero-filled v
    // adds nothing
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) ok[u] = row_of(s * U + u) >= 0;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        mx = fmaxf(mx, ok[u] ? sc[u][g] : NEG_INF);
      const float alpha = expf(m[g] - mx);
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
#pragma unroll
      for (int j = 0; j < VPL; ++j)
        unpack16<T>(*reinterpret_cast<const uint4*>(
                        slot + ((DA_VECS + u * VPL + j) * 32 + lane) * 16),
                    vf + j * VEC);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float p = ok[u] ? expf(sc[u][g] - m[g]) : 0.f;
        l[g] += p;
        const float pr = round_to<T>(p);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += pr * vf[e];
      }
    }
  }
  cp_async_wait<0>();
  grid_launch_dependents();         // the next kernel's blocks may start

  // merge the warp's lane groups (xor shuffles over whole rows)
#pragma unroll
  for (int x = LPR; x < 32; x <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], x);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], x);
      float a2[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        a2[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], x);
      const float mx = fmaxf(m[g], m2);
      const float a = expf(m[g] - mx), c = expf(m2 - mx);
      l[g] = l[g] * a + l2 * c;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = acc[g][e] * a + a2[e] * c;
      m[g] = mx;
    }
  }
  // the warps' states, lane group 0's, over each warp's own ring
  __syncwarp();
  float* wacc = reinterpret_cast<float*>(ring);
  float* wm = wacc + G * HD;
  float* wl = wm + G;
  if (lg == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int j = 0; j < VPL; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          wacc[g * HD + (li + LPR * j) * VEC + e] = acc[g][j * VEC + e];
      if (li == 0) {
        wm[g] = m[g];
        wl[g] = l[g];
      }
    }
  }
  __syncthreads();
  // the block's state: the warps' merged in warp order
  for (int i = threadIdx.x; i < G * HD; i += DA_THREADS) {
    const int g = i / HD;
    float wmv[DA_WARPS], wlv[DA_WARPS], wav[DA_WARPS];
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) {
      const float* wa = reinterpret_cast<const float*>(
          da_smem + w * DA_WARP_BYTES);
      wmv[w] = wa[G * HD + g];
      wlv[w] = wa[G * HD + G + g];
      wav[w] = wa[i];
    }
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) mx = fmaxf(mx, wmv[w]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) {
      const float sw = expf(wmv[w] - mx);
      lsum += wlv[w] * sw;
      a += wav[w] * sw;
    }
    cacc[i] = a;
    if (i % HD == 0) {
      cm[g] = mx;
      cl[g] = lsum;
    }
  }
  cluster_sync();
  // the cluster's states merged in rank order, a slice of o a block; each
  // peer's values are loaded before any is used
  T* op = STATE ? nullptr : o + (size_t)pair * G * HD;
  for (int i = rank * DA_THREADS + threadIdx.x; i < G * HD;
       i += DA_CL * DA_THREADS) {
    const int g = i / HD;
    float mr[DA_CL], lr[DA_CL], ar[DA_CL];
#pragma unroll
    for (int c = 0; c < DA_CL; ++c) {
      mr[c] = ld_peer(cm + g, c);
      lr[c] = ld_peer(cl + g, c);
      ar[c] = ld_peer(cacc + i, c);
    }
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < DA_CL; ++c) mx = fmaxf(mx, mr[c]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int c = 0; c < DA_CL; ++c) {
      const float sw = expf(mr[c] - mx);
      lsum += lr[c] * sw;
      a += ar[c] * sw;
    }
    if constexpr (STATE) {
      sacc[(size_t)pair * G * HD + i] = a;
      if (i % HD == 0) {
        sm[(size_t)pair * G + g] = mx;
        sl[(size_t)pair * G + g] = lsum;
      }
    } else {
      op[i] = cvt<T>(ln > 0 ? a / fmaxf(lsum, 1e-30f) : 0.f);
    }
  }
  cluster_sync();                   // no block leaves while peers read it
}

// Query heads a launch holds: G itself up to 4, then 8.
__host__ __device__ constexpr int da_group_bound(int G) {
  return G <= 4 ? G : 8;
}

// The merged state's outputs of a STATE launch (null otherwise).
struct DaState {
  float* acc;
  float* m;
  float* l;
};

template <typename T, int HD, int GB, bool STATE>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* lengths, const int* table, void* o, DaState so,
                  int B, int L, int KV, int G, float scale, int window,
                  float softcap, int NB, int bk, int P, cudaStream_t st) {
  auto kern = decode_kernel<T, HD, GB, STATE>;
  static const cudaError_t configured = [kern] {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, DA_SMEM_MAX);
    if (e == cudaSuccess && DA_CL > 8)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const size_t smem = da_smem_bytes(G, HD, table != nullptr, L, bk);
  if (smem > (size_t)DA_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(B * KV * DA_CL, 1, 1);
  cfg.blockDim = dim3(DA_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = DA_CL;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
#ifdef DRT_DA_NO_PDL
  cfg.numAttrs = 1;
#else
  cfg.numAttrs = 2;
#endif
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, table, static_cast<T*>(o), so.acc,
      so.m, so.l, L, KV, G, scale, window, softcap, NB, bk, P);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_g(const void* q, const void* k, const void* v,
               const int* lengths, const int* table, void* o, DaState so,
               int B, int L, int KV, int G, float scale, int window,
               float softcap, int NB, int bk, int P, cudaStream_t st) {
#define DA_G(GB)                                                           \
  case GB:                                                                 \
    return so.acc != nullptr                                               \
               ? launch_decode<T, HD, GB, true>(                           \
                     q, k, v, lengths, table, o, so, B, L, KV, G, scale,   \
                     window, softcap, NB, bk, P, st)                       \
               : launch_decode<T, HD, GB, false>(                          \
                     q, k, v, lengths, table, o, so, B, L, KV, G, scale,   \
                     window, softcap, NB, bk, P, st);
  switch (da_group_bound(G)) {
    DA_G(1)
    DA_G(2)
    DA_G(3)
    DA_G(4)
    DA_G(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DA_G
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v,
                const int* lengths, const int* table, void* o, DaState so,
                int B, int L, int KV, int G, int hd, float scale, int window,
                float softcap, int NB, int bk, int P, cudaStream_t st) {
  if (G < 1 || G > DA_GMAX || L < 1 || B < 1 || KV < 1 ||
      (size_t)B * KV * DA_CL > 0x7fffffffu)
    return static_cast<int>(cudaErrorInvalidValue);
#define DA_CASE(H)                                                         \
  case H:                                                                  \
    return dispatch_g<T, H>(q, k, v, lengths, table, o, so, B, L, KV, G,   \
                            scale, window, softcap, NB, bk, P, st);
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

int dispatch_dtype(const void* q, const void* k, const void* v,
                   const void* lengths, const void* table, void* o,
                   DaState so, int B, int L, int KV, int G, int hd,
                   float scale, int window, float softcap, int NB, int bk,
                   int P, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto len = static_cast<const int*>(lengths);
  auto tb = static_cast<const int*>(table);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(so.acc) |
       reinterpret_cast<uintptr_t>(so.m) |
       reinterpret_cast<uintptr_t>(so.l)) %
      16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (dtype == kFloat32)
    return dispatch_hd<float>(q, k, v, len, tb, o, so, B, L, KV, G, hd,
                              scale, window, softcap, NB, bk, P, st);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, len, tb, o, so, B, L, KV, G,
                                      hd, scale, window, softcap, NB, bk, P,
                                      st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace drt

extern "C" {

// The plan's constants: cluster size, tile rows, warps a block, ring slots
// a warp, ring bytes a block (kernels/decode_attention.py mirrors them).
int drt_decode_config(int* out) {
  out[0] = drt::DA_CL;
  out[1] = drt::DA_TILE;
  out[2] = drt::DA_WARPS;
  out[3] = drt::DA_STAGES;
  out[4] = drt::DA_RING_BYTES;
  return 0;
}

// The rows rank `rank` of a slot's cluster visits, in order, for a slot of
// `length` (pos + 1) in a pool of `rows` rows a slot: up to `cap` [start,
// end) pairs into out; returns how many there are.
int drt_decode_plan(int length, int rows, int window, int rank, int* out,
                    int cap) {
  const int n = drt::da_live_rows(length, rows, window);
  const int nt = drt::da_rank_tiles(n, rank);
  for (int i = 0; i < nt && i < cap; ++i) {
    const int t0 = (rank + i * drt::DA_CL) * drt::DA_TILE;
    out[2 * i] = t0;
    out[2 * i + 1] = t0 + drt::DA_TILE < n ? t0 + drt::DA_TILE : n;
  }
  return nt;
}

// Dynamic shared memory bytes of a launch (the wrappers' bound).
int drt_decode_smem(int G, int hd, int paged, int rows, int bk) {
  const size_t s = drt::da_smem_bytes(G, hd, paged != 0, rows, bk);
  return s > 0x7fffffff ? -1 : static_cast<int>(s);
}

// q (B, KV, G, hd); k/v (B, L, KV, hd); lengths (B,) int32; o like q. One
// launch; q, k, v and o on 16-byte boundaries.
int drt_decode_attention(const void* q, const void* k, const void* v,
                         const void* lengths, void* o, int B, int L, int KV,
                         int G, int hd, float scale, int window,
                         float softcap, int dtype, void* stream) {
  return drt::dispatch_dtype(q, k, v, lengths, nullptr, o,
                             drt::DaState{nullptr, nullptr, nullptr}, B, L,
                             KV, G, hd, scale, window, softcap, 0, 1, 0,
                             dtype, stream);
}

// The state-out variant: q (B, KV, G, hd); k/v (B, L, KV, hd); lengths
// (B,) int32, each slot's live rows, a prefix of its L (full layout);
// acc (B, KV, G, hd), m and l (B, KV, G) float32. One launch; q, k, v,
// acc, m and l on 16-byte boundaries.
int drt_decode_attention_state(const void* q, const void* k, const void* v,
                               const void* lengths, void* acc, void* m,
                               void* l, int B, int L, int KV, int G, int hd,
                               float scale, float softcap, int dtype,
                               void* stream) {
  if (acc == nullptr || m == nullptr || l == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return drt::dispatch_dtype(
      q, k, v, lengths, nullptr, nullptr,
      drt::DaState{static_cast<float*>(acc), static_cast<float*>(m),
                   static_cast<float*>(l)},
      B, L, KV, G, hd, scale, 0, softcap, 0, 1, 0, dtype, stream);
}

// q (B, KV, G, hd); k/v (P, bk, KV, hd) arena; lengths (B,) int32;
// table (B, NB) int32; o like q. One launch.
int drt_decode_attention_paged(const void* q, const void* k, const void* v,
                               const void* lengths, const void* table,
                               void* o, int B, int NB, int bk, int P, int KV,
                               int G, int hd, float scale, float softcap,
                               int dtype, void* stream) {
  if (NB < 1 || bk < 1 || P < 1 || (long long)NB * bk > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (table == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return drt::dispatch_dtype(q, k, v, lengths, table, o,
                             drt::DaState{nullptr, nullptr, nullptr}, B,
                             NB * bk, KV, G, hd, scale, 0, softcap, NB, bk,
                             P, dtype, stream);
}

}  // extern "C"
