// Shared helpers of the port's hand-written Hopper kernels.
//
// Every entry point takes raw device pointers, its sizes and the CUDA
// stream to launch on, launches asynchronously, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for arguments it
// refuses) so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with repro_torch/kernels/_build.py
enum ReproDType { REPRO_F32 = 0, REPRO_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive elements starting at p (16-byte aligned for fp32,
// 8-byte aligned for bf16), widened to fp32.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Whether rows of a (n, d) buffer can be read four columns at a time.
template <typename T>
inline bool vec4_ok(const void* x, long long d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
}
