// K4 · fused NNM mix + coordinate-wise trim / median with f an int32
// read on the device, one per lane of a (B, n, D) stack: the C entry
// point, and the n <= 64 launch K2 shares (launch_small).  n <= 64 runs
// the body of csrc/mixtrim_dyn.cuh (design notes there), compiled at one
// height per n up to 32 and at 48 and 64 above; the heights are
// instantiated here (n <= 8) and in mixtrim_dyn_n9.cu, _n17.cu, _n25.cu
// and _n33.cu, so that nvcc builds them in parallel.  64 < n <= 1024 runs
// the register-tiled mix and rank selection of csrc/mixtrim_select.cuh,
// 1024 < n <= 16384 the shared-memory sort of csrc/mixtrim.cuh
// (mixtrim_big, DYN = true); their notes are there.
#include "mixtrim.cuh"
#include "mixtrim_dyn.cuh"

namespace mixtrim_dyn_detail {

template int launch_n<1>(const Args&);
template int launch_n<2>(const Args&);
template int launch_n<3>(const Args&);
template int launch_n<4>(const Args&);
template int launch_n<5>(const Args&);
template int launch_n<6>(const Args&);
template int launch_n<7>(const Args&);
template int launch_n<8>(const Args&);
#define REPRO_EXTERN(N) extern template int launch_n<N>(const Args&);
REPRO_EXTERN(9) REPRO_EXTERN(10) REPRO_EXTERN(11) REPRO_EXTERN(12)
REPRO_EXTERN(13) REPRO_EXTERN(14) REPRO_EXTERN(15) REPRO_EXTERN(16)
REPRO_EXTERN(17) REPRO_EXTERN(18) REPRO_EXTERN(19) REPRO_EXTERN(20)
REPRO_EXTERN(21) REPRO_EXTERN(22) REPRO_EXTERN(23) REPRO_EXTERN(24)
REPRO_EXTERN(25) REPRO_EXTERN(26) REPRO_EXTERN(27) REPRO_EXTERN(28)
REPRO_EXTERN(29) REPRO_EXTERN(30) REPRO_EXTERN(31) REPRO_EXTERN(32)
REPRO_EXTERN(48) REPRO_EXTERN(64)
#undef REPRO_EXTERN

using LaunchFn = int (*)(const Args&);
// By n: the exact height up to 32, then 48 and 64.
constexpr LaunchFn BY_N[EXACT_MAX_N + 1] = {
    nullptr,      launch_n<1>,  launch_n<2>,  launch_n<3>,  launch_n<4>,
    launch_n<5>,  launch_n<6>,  launch_n<7>,  launch_n<8>,  launch_n<9>,
    launch_n<10>, launch_n<11>, launch_n<12>, launch_n<13>, launch_n<14>,
    launch_n<15>, launch_n<16>, launch_n<17>, launch_n<18>, launch_n<19>,
    launch_n<20>, launch_n<21>, launch_n<22>, launch_n<23>, launch_n<24>,
    launch_n<25>, launch_n<26>, launch_n<27>, launch_n<28>, launch_n<29>,
    launch_n<30>, launch_n<31>, launch_n<32>};

int launch_small(const Args& a) {
  if (a.n <= EXACT_MAX_N) return BY_N[a.n](a);
  if (a.n <= 48) return launch_n<48>(a);
  return launch_n<64>(a);
}

}  // namespace mixtrim_dyn_detail

using namespace mixtrim_dyn_detail;

// K4.  x: (lanes, n, d); m: (lanes, n, n) fp32 or NULL; mt: scratch as m
// for M^T, needed with m for 64 < n <= 1024 (else unused, may be NULL);
// f: (lanes,) int32 on the device; out: (lanes, d) fp32; blocks: column
// blocks per lane, at most (each body caps it at what one wave of
// resident blocks needs).
extern "C" int repro_mixtrim_dyn(const void* x, int dtype, const float* m,
                                 float* mt, int lanes, int n, long long d,
                                 const int* f, int med, float* out,
                                 int blocks, void* stream) {
  if (lanes < 1 || lanes > 65535 || n < 1 || n > mixtrim_detail::MAX_N ||
      d < 1 || blocks < 1 || f == nullptr)
    return cudaErrorInvalidValue;
  if (dtype != REPRO_F32 && dtype != REPRO_BF16) return cudaErrorInvalidValue;
  const Args a{x, dtype, m, lanes, n, d, f, 0, med, out, blocks,
               static_cast<cudaStream_t>(stream)};
  if (n <= mixtrim_detail::SMALL_N) return launch_small(a);
  const mixtrim_detail::Args big{x, dtype, m, mt, lanes, n, d, 0, f, med,
                                 out, blocks, a.s};
  if (n <= mixtrim_select::MAX_N) return mixtrim_select::launch(big);
  if (dtype == REPRO_F32) return mixtrim_detail::launch_large<float, true>(big);
  return mixtrim_detail::launch_large<__nv_bfloat16, true>(big);
}
