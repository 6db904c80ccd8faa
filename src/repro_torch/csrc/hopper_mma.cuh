// Hopper tensor-core building blocks shared by the bf16 kernels: warpgroup
// MMA (wgmma) through inline PTX, its shared-memory matrix descriptors, and
// the staging of (64 rows x 64 bf16) tiles into the 128-byte swizzled
// layout those descriptors name. sm_90a only.
//
// The tile. Every operand tile in shared memory is 64 rows of 64 bf16
// (128 bytes a row, 8 KB), at a 1024-byte-aligned address. The 16-byte
// chunk c (columns 8c..8c+7) of row r lives at byte
//     r * 128 + ((c ^ (r % 8)) * 16)
// (swz_offset): the 128-byte swizzle that TMA's SWIZZLE_128B writes and a
// descriptor with layout type 1 reads. Eight rows form one 1024-byte
// swizzle atom; atoms follow each other every 1024 bytes, which is the
// descriptor's stride byte offset (SBO) in both majors.
//
// The two majors, and who passes which:
//   K-major (trans 0): the tile's rows are M (or N) and its columns are K.
//     One k16 step is 32 bytes along the row, so the descriptor of step kk
//     starts 32 * kk bytes into the tile (the hardware applies the swizzle
//     to the address, so an offset inside the atom is exact). LBO is not
//     used for swizzled K-major operands (set to 16 bytes).
//       - x (M x K, row-major) as A of t = x @ B;
//       - t (64 rows x R, kept on chip or read back) as A of y = t @ C;
//       - attention's q (64 query rows x hd) as A and a K tile (64 keys x
//         hd) as B of S = q K^T.
//   MN-major (trans 1): the tile's rows are K and its columns are M (or N).
//     One k16 step is 16 rows, so the descriptor of step kk starts
//     2048 * kk bytes into the tile. A tile is one swizzle atom wide along
//     MN (64 columns), so LBO, the stride between atoms along MN, is not
//     reached; it is set to the tile's size.
//       - B (K x R, row-major) as B of t = x @ B;
//       - C (R x N, row-major) as B of y = t @ C;
//       - the Gram's panels of x (N x D, row-major): A = x[:, i-panel]^T
//         and B = x[:, j-panel], both MN-major; on a diagonal tile one
//         panel serves as both;
//       - attention's V tile (64 keys x hd) as B of O += P V, where P, the
//         softmax of an accumulator, is the register A operand (a_frag).
//
// Staging. Three ways, all into the swizzled tile above, zero outside the
// matrix, nothing padded in device memory:
//   - TMA (make_tmap, tma_load_2d): a 64 x 64 box of a row-major matrix
//     whose rows start on 16-byte boundaries; the 128-byte swizzle of the
//     tensor map writes exactly this layout. One thread issues it and
//     arrives on the slot's mbarrier with the bytes to expect. The
//     attention kernels' (batch, rows, heads, hd) arrays take a rank-4 map
//     (make_tmap_bshd, tma_load_4d) whose box is one head's 64 rows.
//   - raw words (stage_raw, then unpack_raw), for any row stride: the
//     factor B at a rank R % 8 != 0 (its row stride, 2R bytes, is no
//     multiple of 16, so no tensor map exists). The aligned 16-byte words
//     that cover each row's 64 columns (9 words, 144 bytes a row) are
//     copied by cp.async, then shifted into place through registers, with
//     the columns past the matrix masked.
//   - 4-byte cp.async copies (stage_tile_pairs), where rows start on 4-byte
//     boundaries (B at an even rank): straight into the tile, no shift
//     pass, so they are kept beside the raw words for those ranks
//     (measured faster at rank 698: kernels/tc_profile.py, copy b_raw).
// The cp.async helpers take the calling thread's index among the NT
// threads that share the tile.
//
// Build switches, for debugging and profiling only (the wrappers' builds
// set none; kernels/tc_profile.py builds a copy with each): DRT_MBAR_TRAP
// makes mbar_wait trap when a copy never lands; DRT_PROFILE makes
// prof_stamp record %globaltimer per block, read back by drt_prof_read.
//
// Ordering. Data written by cp.async or by ordinary stores is read by
// wgmma through the async proxy: each writer runs fence_proxy_async()
// before the barrier that precedes the wgmma. Data written by TMA or by a
// bulk copy from a peer block is in the async proxy already and is waited
// for on an mbarrier. wgmma_fence() comes before the first wgmma after the
// accumulators were touched by other instructions; hold_regs() keeps the
// compiler from moving accumulator reads above wgmma_wait. A wgmma issued
// on a path that diverges inside a warpgroup, or with divergent code
// between it and its wait, is serialized by the compiler (ptxas C7518,
// C7520): the callers issue every wgmma unconditionally.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace drt {
namespace mma {

constexpr int TILE = 64;                     // rows and bf16 columns
constexpr int TILE_BYTES = TILE * TILE * 2;  // 8 KB
constexpr int RAW_WORDS = TILE / 8 + 1;      // 16-byte words a raw row
constexpr int RAW_BYTES = TILE * RAW_WORDS * 16;   // 9 KB
constexpr int WG_THREADS = 128;              // one warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int swz_offset(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// --- descriptors -----------------------------------------------------------
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);                      // layout type 1: 128-byte swizzle
}

// Descriptor of k16 step kk of a tile at shared address `tile`.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + 32 * kk, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + 2048 * kk, TILE_BYTES, 1024);
}

// --- warpgroup MMA ---------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void hold_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] (+)= A[64 x 16] @ B[16 x 64], bf16 in, float32 accumulators.
// scale_d 0 overwrites d. TA / TB: 0 K-major, 1 MN-major.
//
// Accumulator layout (thread t of the warpgroup, warp w = t / 32, lane l):
// d[i] holds row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
// 2 (l % 4) + i % 2.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 x 64] += A[64 x 16] @ B[16 x 64] with A in registers: a[0..3] hold
// bf16 pairs in the layout of a float32 accumulator's columns 16 kk ..
// 16 kk + 15 (a_frag), so a product's accumulator becomes the next
// product's A operand without passing through shared memory. TB as above.
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// The A fragment of k16 step kk from a float32 accumulator p[32] (columns
// 16 kk .. 16 kk + 15 of its 64), rounded to bf16 (round to nearest even):
// the accumulator's elements 8 kk .. 8 kk + 7 in order, two to a register.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&p)[32],
                                       int kk) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h =
        __floats2bfloat162_rn(p[8 * kk + 2 * e], p[8 * kk + 2 * e + 1]);
    a[e] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

// Row and column of accumulator element i (0..31) for thread t.
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i / 4) + 2 * (t % 4) + (i % 2);
}

// --- cp.async ----------------------------------------------------------------
// 16 bytes from global src to shared dst; only the first src_bytes are read,
// the rest is zero-filled (src_bytes 0: a row or column outside the matrix).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4 bytes, the same way (src_bytes 0 or 4).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The cp.async staging helpers below are called by NT threads (128 or
// 256), thread `t` of them taking every NT-th copy.
//
// Stage rows [r0, r0 + 64) x columns [c0, c0 + 64) of the row-major
// (rows x cols) bf16 matrix m (row stride ld) into the swizzled tile at
// shared address `tile`, zeros outside the matrix, where its rows start on
// 4-byte boundaries (m and ld even, cols even): 4-byte copies of column
// pairs, a warp per row.
template <int NT>
__device__ __forceinline__ void stage_tile_pairs(uint32_t tile,
                                                 const __nv_bfloat16* m,
                                                 int ld, int rows, int cols,
                                                 int r0, int c0, int t) {
  const int p = t % 32, gc = c0 + 2 * p;
#pragma unroll
  for (int j = 0; j < TILE * 32 / NT; ++j) {
    const int r = t / 32 + j * (NT / 32), gr = r0 + r;
    const bool ok = gr < rows && gc < cols;
    cp_async4(tile + swz_offset(r, p / 4) + 4 * (p % 4),
              ok ? m + (size_t)gr * ld + gc : m, ok ? 4 : 0);
  }
}

// Stage the aligned 16-byte words that cover rows [r0, r0 + 64) x columns
// [c0, c0 + 64) of the row-major (rows x ld) bf16 matrix m, for any row
// stride: raw row r holds the RAW_WORDS words from the one containing
// element (r0 + r, c0) on. Words at or past the matrix's end are zeros; a
// word is never read past the 16-byte boundary that follows the last
// element, so no page is crossed. m may start anywhere: a zero word names
// the 16-byte boundary at or before m, and reads nothing.
template <int NT>
__device__ __forceinline__ void stage_raw(uint32_t raw,
                                          const __nv_bfloat16* m, int ld,
                                          int rows, int r0, int c0, int t) {
  const uintptr_t end = reinterpret_cast<uintptr_t>(m + (size_t)rows * ld);
  const void* none = reinterpret_cast<const void*>(
      reinterpret_cast<uintptr_t>(m) & ~uintptr_t(15));
#pragma unroll
  for (int j = 0; j < (TILE * RAW_WORDS + NT - 1) / NT; ++j) {
    const int q = t + j * NT;
    if (q >= TILE * RAW_WORDS) break;
    const int r = q / RAW_WORDS, w = q % RAW_WORDS;
    const uintptr_t a = reinterpret_cast<uintptr_t>(
        m + (size_t)(r0 + r) * ld + c0);
    const uintptr_t word = (a & ~uintptr_t(15)) + 16 * w;
    const bool ok = r0 + r < rows && word < end;
    cp_async16(raw + 16 * (r * RAW_WORDS + w),
               ok ? reinterpret_cast<const void*>(word) : none, ok ? 16 : 0);
  }
}

// Shift the raw words of stage_raw into the swizzled tile at `tile` (a
// generic pointer to shared memory): tile row r, chunk c holds columns
// c0 + 8c .. c0 + 8c + 7 of matrix row r0 + r, zero past `cols` columns
// or `rows` rows.
template <int NT>
__device__ __forceinline__ void unpack_raw(char* tile, const char* raw,
                                           const __nv_bfloat16* m, int ld,
                                           int rows, int cols, int r0,
                                           int c0, int t) {
#pragma unroll
  for (int j = 0; j < TILE * TILE / 8 / NT; ++j) {
    const int q = t + j * NT;
    const int r = q / 8, c = q % 8;
    const int s = static_cast<int>(reinterpret_cast<uintptr_t>(
                      m + (size_t)(r0 + r) * ld + c0) & 15);
    const uint4* src = reinterpret_cast<const uint4*>(
        raw + 16 * (r * RAW_WORDS + c));
    const uint4 lo = src[0], hi = src[1];
    uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    if (s & 8) {                            // shift by two words
#pragma unroll
      for (int i = 0; i < 6; ++i) w[i] = w[i + 2];
    }
    if (s & 4) {                            // shift by one word
#pragma unroll
      for (int i = 0; i < 5; ++i) w[i] = w[i + 1];
    }
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)             // and by one bf16 if s % 4 == 2
      o[i] = (s & 2) ? __funnelshift_r(w[i], w[i + 1], 16) : w[i];
    const int col = c0 + 8 * c;
    if (r0 + r >= rows || col >= cols) {
      o[0] = o[1] = o[2] = o[3] = 0u;
    } else if (col + 8 > cols) {            // the matrix's last columns
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (col + e >= cols) o[e / 2] &= (e & 1) ? 0x0000FFFFu : 0xFFFF0000u;
    }
    *reinterpret_cast<uint4*>(tile + swz_offset(r, c)) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// --- mbarriers and bulk copies between the blocks of a cluster ------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` more to land.
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// One arrival (each of the barrier's `count` threads arrives once a phase).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Until the barrier's phase of this parity has completed. With
// DRT_MBAR_TRAP a copy that never lands (2^22 polls, seconds) traps, so a
// debugging build fails the launch instead of hanging; a trap ends the
// whole CUDA context, so the wrappers' builds poll without a limit.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
#ifdef DRT_MBAR_TRAP
  for (int i = 0; !mbar_try(bar, parity); ++i)
    if (i == (1 << 22)) __trap();
#else
  while (!mbar_try(bar, parity)) {
  }
#endif
}
// The address of the same shared location in block `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(local), "r"(rank));
  return r;
}
// `bytes` from this block's shared memory to block `rank`'s, at the same
// offsets; the copy completes on that block's mbarrier `bar`.
__device__ __forceinline__ void push_to_peer(uint32_t local, uint32_t bar,
                                             int bytes, int rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(peer_addr(local, rank)),
      "r"(local), "r"(bytes), "r"(peer_addr(bar, rank))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until this thread's bulk copies have read their source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// --- TMA --------------------------------------------------------------------
// The CUDA driver's tensor-map encoder, reached through the runtime so that
// nothing links against libcuda (null if the driver lacks it).
inline PFN_cuTensorMapEncodeTiled tmap_encoder() {
  static PFN_cuTensorMapEncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }();
  return encode;
}

// A tensor map over a row-major (dim1 x dim0) bf16 matrix with a row stride
// of `stride1` bytes (a multiple of 16, base 16-byte aligned): 64 x 64 boxes
// with the 128-byte swizzle, so a box lands as the tile described at the
// top; reads outside the matrix land as zeros.
inline cudaError_t make_tmap(CUtensorMap* map, const void* base,
                             uint64_t dim0, uint64_t dim1, uint64_t stride1) {
  const PFN_cuTensorMapEncodeTiled encode = tmap_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {dim0, dim1};
  const cuuint64_t strides[1] = {stride1};
  const cuuint32_t box[2] = {TILE, TILE};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
      dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Fetch a tensor map into the TMA unit's cache ahead of its first use.
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* m) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(m))
               : "memory");
}

// The box at (c0, r0) (innermost first) of a rank-2 map into shared memory
// at `dst` (1024-byte aligned), completing on mbarrier `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* m,
                                            int c0, int r0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(r0), "r"(bar)
      : "memory");
}

// A tensor map over a (batch, rows, heads, hd) bf16 array, the attention
// kernels' layout, read for one (batch, head) at a time: 64-column x 64-row
// boxes (dims hd, heads, rows, batch innermost first; box 64 x 1 x 64 x 1)
// with the 128-byte swizzle, so a box lands as the tile described at the
// top. Columns past hd (hd < 64) and rows past `rows` land as zeros. The
// base must be 16-byte aligned and hd a multiple of 8.
inline cudaError_t make_tmap_bshd(CUtensorMap* map, const void* base,
                                  uint64_t hd, uint64_t heads, uint64_t rows,
                                  uint64_t batch) {
  const PFN_cuTensorMapEncodeTiled encode = tmap_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {hd, heads, rows, batch};
  const cuuint64_t strides[3] = {2 * hd, 2 * hd * heads, 2 * hd * heads * rows};
  const cuuint32_t box[4] = {TILE, 1, TILE, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The box at (c0, c1, c2, c3) (innermost first) of a rank-4 map into shared
// memory at `dst` (1024-byte aligned), completing on mbarrier `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* m,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// --- profiling -------------------------------------------------------------
// prof_stamp(b, i): thread 0 of the calling block records %globaltimer as
// stamp i of block slot b (DRT_PROFILE builds only; otherwise it is empty).
constexpr int PROF_BLOCKS = 8192, PROF_STAMPS = 6;
#ifdef DRT_PROFILE
__device__ unsigned long long g_prof[PROF_BLOCKS][PROF_STAMPS];
__device__ __forceinline__ void prof_stamp(int b, int i) {
  if (threadIdx.x != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_prof[b][i] = t;
}
#else
__device__ __forceinline__ void prof_stamp(int, int) {}
#endif

}  // namespace mma
}  // namespace drt

#ifdef DRT_PROFILE
// Every stamp (PROF_BLOCKS x PROF_STAMPS nanosecond counters) into `out` on
// the host. Each library is one source, so this is defined once in each.
extern "C" int drt_prof_read(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, drt::mma::g_prof,
                                               sizeof(drt::mma::g_prof)));
}
#endif
