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

// The f the bodies above 64 workers read for the median lanes, which pass
// none: zeros (unread by the median), one a lane.  Those bodies take a
// per-lane f as their sign that the launch has lanes.
__device__ int lane_zeros[65535];

// What a K4 launch at one shape passes besides its pointers and stream;
// the wrapper fills one per shape once (kernels/mixtrim/ops.py::DynPlan)
// and passes its address.  d: columns; dtype: REPRO_F32 / REPRO_BF16;
// med: 1 = the median (f unread, may be NULL), 0 = trim; threads: block
// size of the n <= 64 body (a multiple of 32 up to 128); blocks: column
// blocks per lane, at most (each body caps it at one wave of resident
// blocks); sms: the card's SM count.
struct ReproMixtrimDynPlan {
  long long d;
  int dtype, lanes, n, med, threads, blocks, sms;
};

// K4 and the median lanes.  x: (lanes, n, d); m: (lanes, n, n) fp32 or
// NULL; mt: scratch as m for M^T, needed with m for 64 < n <= 1024 (else
// unused, may be NULL); f: (lanes,) int32 on the device, NULL with the
// median flag; out: (lanes, d) fp32.
extern "C" int repro_mixtrim_dyn(const void* x, const float* m, float* mt,
                                 const int* f, float* out,
                                 const ReproMixtrimDynPlan* plan,
                                 void* stream) {
  const ReproMixtrimDynPlan p = *plan;
  if (p.lanes < 1 || p.lanes > 65535 || p.n < 1 ||
      p.n > mixtrim_detail::MAX_N || p.d < 1 || p.blocks < 1 || p.sms < 1 ||
      (f == nullptr && !p.med))
    return cudaErrorInvalidValue;
  if (p.dtype != REPRO_F32 && p.dtype != REPRO_BF16) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.n <= mixtrim_detail::SMALL_N) {
    if (p.threads < 32 || p.threads > THREADS || p.threads % 32)
      return cudaErrorInvalidValue;
    return launch_small({x, p.dtype, m, p.lanes, p.n, p.d, f, 0, p.med, out,
                         p.blocks, s, p.threads, p.sms});
  }
  if (f == nullptr) {                   // the address on the current card
    void* zeros = nullptr;
    cudaError_t err = cudaGetSymbolAddress(&zeros, lane_zeros);
    if (err != cudaSuccess) return err;
    f = static_cast<const int*>(zeros);
  }
  const mixtrim_detail::Args big{x, p.dtype, m, mt, p.lanes, p.n, p.d, 0, f,
                                 p.med, out, p.blocks, s};
  if (p.n <= mixtrim_select::MAX_N) return mixtrim_select::launch(big);
  if (p.dtype == REPRO_F32) return mixtrim_detail::launch_large<float, true>(big);
  return mixtrim_detail::launch_large<__nv_bfloat16, true>(big);
}
