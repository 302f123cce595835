// K2 and K4 for 64 < n <= 1024 workers: the entry point of the register-
// tiled mix and the rank selection (kernels and design notes in
// mixtrim_select.cuh).  The fp32 and no-mix instances are compiled here,
// the bf16 mix instances in mixtrim_select_bf16.cu, so that nvcc builds
// them in parallel.
#include "mixtrim_select.cuh"

namespace mixtrim_select {

extern template int launch_mix_n<__nv_bfloat16>(const Args&);

int launch(const Args& j) {
  if (j.n <= mixtrim_detail::SMALL_N || j.n > MAX_N || j.lanes < 1 ||
      j.d < 1 || j.blocks < 1)
    return cudaErrorInvalidValue;
  const bool bf16 = j.dtype == REPRO_BF16;
  if (!bf16 && j.dtype != REPRO_F32) return cudaErrorInvalidValue;
  if (!j.m) return bf16 ? launch_nomix<__nv_bfloat16>(j) : launch_nomix<float>(j);
  if (!j.mt) return cudaErrorInvalidValue;
  return bf16 ? launch_mix_n<__nv_bfloat16>(j) : launch_mix_n<float>(j);
}

}  // namespace mixtrim_select

// Floats a lane of the M^T scratch takes for n (0 outside the body's
// range): the wrapper allocates it, the launch fills it.
extern "C" long long repro_mixtrim_select_scratch(int n) {
  using namespace mixtrim_select;
  if (n <= mixtrim_detail::SMALL_N || n > MAX_N) return 0;
  return by_tile(n, [&](auto c) { return packed_words<decltype(c)>(n); });
}
