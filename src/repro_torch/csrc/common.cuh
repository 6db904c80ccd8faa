// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every kernel takes float32 or bfloat16 operands (dtype code 0 or 1),
// loads them into float32 registers, accumulates in float32 and rounds on
// store with round-to-nearest-even, the rounding that PyTorch's and JAX's
// casts use.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace drt {

constexpr float NEG_INF = -1e30f;   // masked-score sentinel, never -inf

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T> __device__ __forceinline__ float ld(const T* p);
template <> __device__ __forceinline__ float ld<float>(const float* p) {
  return *p;
}
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ T cvt(float v);
template <> __device__ __forceinline__ float cvt<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// Value of v after a round trip through T (identity for float).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  T r = cvt<T>(v);
  return ld<T>(&r);
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

}  // namespace drt
