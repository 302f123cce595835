// K2 · fused NNM mix + coordinate-wise trimmed mean / median, static f:
// the C entry point.  The kernels and their design notes are in
// mixtrim.cuh; K4 (csrc/mixtrim_dyn.cu) shares only its n > 64 kernel.
#include "mixtrim.cuh"

using namespace mixtrim_detail;

extern "C" int repro_mixtrim_max_n() { return MAX_N; }

// m: (n, n) fp32 mixing matrix or NULL (no mix); med: 0 = trim, 1 = median.
extern "C" int repro_mixtrim(const void* x, int dtype, const float* m, int n,
                             long long d, int f, int med, float* out,
                             int blocks, void* stream) {
  if (n < 1 || n > MAX_N || d < 1 || blocks < 1) return cudaErrorInvalidValue;
  if (!med && (f < 0 || n - 2 * f < 1)) return cudaErrorInvalidValue;
  const Args a{m, 1, n, d, f, nullptr, med, out, blocks,
               static_cast<cudaStream_t>(stream)};
  return dispatch(x, dtype, a);
}

