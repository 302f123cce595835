// K4 · fused NNM mix + coordinate-wise trim / median with f an int32
// read on the device, one per lane of a (B, n, D) stack: the C entry
// point.  The kernels (DYN = true) and their design notes are in
// mixtrim.cuh, shared with K2 (csrc/mixtrim.cu).
#include "mixtrim.cuh"

using namespace mixtrim_detail;

// K4.  x: (lanes, n, d); m: (lanes, n, n) fp32 or NULL; f: (lanes,) int32
// on the device; out: (lanes, d) fp32; blocks: column blocks per lane.
extern "C" int repro_mixtrim_dyn(const void* x, int dtype, const float* m,
                                 int lanes, int n, long long d, const int* f,
                                 int med, float* out, int blocks,
                                 void* stream) {
  if (lanes < 1 || lanes > 65535 || n < 1 || n > MAX_N || d < 1 ||
      blocks < 1 || f == nullptr)
    return cudaErrorInvalidValue;
  const Args a{m, lanes, n, d, 0, f, med, out, blocks,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(x, dtype, a);
}
