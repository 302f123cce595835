// K3 · streamed coefficient combine r = c X of a (n, D) worker stack.
//
// Replaces the TPU kernel repro/kernels/combine/kernel.py::combine_pallas
// (body _combine_kernel).  The gram rules (average, krum, multikrum, gm,
// autogm, mda, with NNM folded in as c^T M) reduce to this one linear
// combination.  As in _combine_kernel and combine_ref, c is first rounded
// to X's dtype and then widened to fp32; products and sums are fp32 and
// the output is (D,) fp32 — the bf16-transport contract.
//
// Each thread owns four consecutive columns (16-byte fp32 / 8-byte bf16
// loads, neighbouring threads on neighbouring columns) and walks the n
// rows with fp32 accumulators; c sits in shared memory.  Bound on this
// card: bytes (n*D reads, D fp32 writes, 2 FLOP per read element).
//
// Lane axis (the fleet's gram-rule lanes: combine_pallas under jax.vmap,
// one call per bucket-round): x (B, n, D), c (B, n), r (B, D), blockIdx.y
// the lane.  Each column's sum runs over the rows in order whatever the
// grid, so lane b equals the single-lane kernel on lane b bit for bit; a
// single stack is lane 0 of a one-lane launch.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const T* __restrict__ x, const float* __restrict__ coeff,
               int n, long long d, float* __restrict__ out) {
  extern __shared__ float c[];
  const long long lane = blockIdx.y;
  x += lane * n * d;
  coeff += lane * n;
  out += lane * d;
  for (int i = threadIdx.x; i < n; i += THREADS) c[i] = round_to<T>(coeff[i]);
  __syncthreads();
  constexpr int W = VEC ? 4 : 1;
  const long long units = d / W;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long u = (long long)blockIdx.x * THREADS + threadIdx.x; u < units;
       u += stride) {
    const long long col = u * W;
    float acc[W];
#pragma unroll
    for (int k = 0; k < W; ++k) acc[k] = 0.f;
    for (int i = 0; i < n; ++i) {
      float v[W];
      if constexpr (VEC) load4(x + (long long)i * d + col, v);
      else v[0] = to_f32(x[(long long)i * d + col]);
#pragma unroll
      for (int k = 0; k < W; ++k) acc[k] = fmaf(c[i], v[k], acc[k]);
    }
    if constexpr (VEC)
      *reinterpret_cast<float4*>(out + col) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    else
      out[col] = acc[0];
  }
}

template <typename T>
int launch(const void* xv, const float* coeff, int lanes, int n, long long d,
           float* out, int blocks, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const size_t smem = sizeof(float) * n;
  const dim3 grid(blocks, lanes);
  if (vec4_ok<T>(xv, d) && reinterpret_cast<uintptr_t>(out) % 16 == 0)
    combine_kernel<T, true><<<grid, THREADS, smem, s>>>(x, coeff, n, d, out);
  else
    combine_kernel<T, false><<<grid, THREADS, smem, s>>>(x, coeff, n, d, out);
  return cudaGetLastError();
}

}  // namespace

// x: (lanes, n, d) stacks (a single stack is one lane), coeff: (lanes, n)
// fp32, out: (lanes, d) fp32; blocks: column blocks per lane.
extern "C" int repro_combine(const void* x, int dtype, const float* coeff,
                             int lanes, int n, long long d, float* out,
                             int blocks, void* stream) {
  if (lanes < 1 || lanes > 65535 || n < 1 || n > 12000 || d < 1 ||
      blocks < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch<float>(x, coeff, lanes, n, d, out, blocks, s);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(x, coeff, lanes, n, d, out, blocks, s);
  return cudaErrorInvalidValue;
}
