// K2 · fused NNM mix + coordinate-wise trimmed mean / median, static f:
// the C entry point.  n <= 64 runs the body K2 shares with K4
// (csrc/mixtrim_dyn.cuh, launched through mixtrim_dyn.cu's launch_small
// with f as an argument), 64 < n <= 1024 the one of csrc/mixtrim_select.cu
// (also shared with K4), n > 1024 mixtrim.cuh's mixtrim_big.  Design notes
// are in each body's header.
#include "mixtrim.cuh"
#include "mixtrim_dyn.cuh"

using namespace mixtrim_detail;

extern "C" int repro_mixtrim_max_n() { return MAX_N; }

// m: (n, n) fp32 mixing matrix or NULL (no mix); mt: (n, n) fp32 scratch
// for M^T, needed with m for 64 < n <= 1024 (else unused, may be NULL);
// med: 0 = trim, 1 = median; blocks: column blocks, at most (each body
// caps it at what one wave of resident blocks needs).
extern "C" int repro_mixtrim(const void* x, int dtype, const float* m,
                             float* mt, int n, long long d, int f, int med,
                             float* out, int blocks, void* stream) {
  if (n < 1 || n > MAX_N || d < 1 || blocks < 1) return cudaErrorInvalidValue;
  if (!med && (f < 0 || n - 2 * f < 1)) return cudaErrorInvalidValue;
  if (dtype != REPRO_F32 && dtype != REPRO_BF16) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= SMALL_N)
    return mixtrim_dyn_detail::launch_small(
        {x, dtype, m, 1, n, d, nullptr, f, med, out, blocks, s});
  const Args a{x, dtype, m, mt, 1, n, d, f, nullptr, med, out, blocks, s};
  if (n <= mixtrim_select::MAX_N) return mixtrim_select::launch(a);
  if (dtype == REPRO_F32) return launch_large<float, false>(a);
  return launch_large<__nv_bfloat16, false>(a);
}
