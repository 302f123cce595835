// K2 · fused NNM mix + coordinate-wise trimmed mean / median, static f:
// the C entry point.  The kernels and their design notes are in
// mixtrim.cuh; 64 < n <= 1024 goes to csrc/mixtrim_select.cu (shared with
// K4), and K4 (csrc/mixtrim_dyn.cu) shares mixtrim.cuh's n > 1024 kernel.
#include "mixtrim.cuh"

using namespace mixtrim_detail;

extern "C" int repro_mixtrim_max_n() { return MAX_N; }

// m: (n, n) fp32 mixing matrix or NULL (no mix); mt: (n, n) fp32 scratch
// for M^T, needed with m for 64 < n <= 1024 (else unused, may be NULL);
// med: 0 = trim, 1 = median.
extern "C" int repro_mixtrim(const void* x, int dtype, const float* m,
                             float* mt, int n, long long d, int f, int med,
                             float* out, int blocks, void* stream) {
  if (n < 1 || n > MAX_N || d < 1 || blocks < 1) return cudaErrorInvalidValue;
  if (!med && (f < 0 || n - 2 * f < 1)) return cudaErrorInvalidValue;
  const Args a{x, dtype, m, mt, 1, n, d, f, nullptr, med, out, blocks,
               static_cast<cudaStream_t>(stream)};
  if (n > SMALL_N && n <= mixtrim_select::MAX_N) return mixtrim_select::launch(a);
  if (dtype == REPRO_F32) return launch<float>(x, a);
  if (dtype == REPRO_BF16) return launch<__nv_bfloat16>(x, a);
  return cudaErrorInvalidValue;
}
