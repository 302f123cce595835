// K3 · streamed coefficient combine r = c X of a (n, D) worker stack.
//
// Replaces the TPU kernel repro/kernels/combine/kernel.py::combine_pallas
// (body _combine_kernel).  The gram rules (average, krum, multikrum, gm,
// autogm, mda, with NNM folded in as c^T M) reduce to this one linear
// combination.  As in _combine_kernel and combine_ref, c is first rounded
// to X's dtype and then widened to fp32; products and sums are fp32 and
// the output is (D,) fp32 — the bf16-transport contract.
//
// Bound on this card: bytes (n*D reads, D fp32 writes, 2 FLOP per read
// element).  Its callers give it two kinds of stack: the trainer's, of
// hundreds of millions of columns, and the fleet's and the fed rounds',
// a few thousand columns (the grid's (5, 17, 2842) lanes: under 1 MB,
// read in well under a microsecond at the card's rate).  At that size the
// time is latency: each thread's loads in turn, and how many threads the
// grid spreads them over.  So:
//   - a thread owns V consecutive columns (one "unit") and reads each row
//     of them with one load of V elements: V = 4, else 2, else 1, the
//     widest that every row start allows (the wrapper picks it, this file
//     refuses a misaligned one).  D = 2842 fp32 takes 8-byte loads;
//   - it walks the rows in groups of ROWS: all of a group's loads (and
//     its coefficients, read through the read-only cache) are in flight
//     before the group's fmafs start, so a group costs one memory latency
//     and not ROWS of them;
//   - the wrapper sizes the block (32..256 threads) and the column blocks
//     per lane from D so that a lane of a few thousand columns is spread
//     over the card one unit a thread; a large D keeps 256 threads and at
//     most 16 blocks an SM per lane, striding over the units.
// Each column's sum is one thread's fmaf chain over the rows in order
// (acc = fmaf(c_i, x_i, acc), i = 0 .. n-1, from 0) whatever V, the block
// size, the block count or the lane count: the bits do not depend on the
// geometry.
//
// Lane axis (the fleet's gram-rule lanes: combine_pallas under jax.vmap,
// one call per bucket-round): x (B, n, D), c (B, n), r (B, D), blockIdx.y
// the lane, so lane b equals the single-lane kernel on lane b bit for bit;
// a single stack is lane 0 of a one-lane launch.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int ROWS = 8;

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// V consecutive elements at p (aligned to V elements), widened to fp32.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (V == 4) {
    load4(p, v);
  } else if constexpr (V == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 4) {
    load4(p, v);
  } else if constexpr (V == 2) {
    const unsigned int raw = __ldg(reinterpret_cast<const unsigned int*>(p));
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    p[0] = v[0];
}

// Rows [i0, i0 + ROWS) of one unit (FULL), or the rows of them below n:
// every load first, then the fmafs in row order.
template <bool FULL, int V, typename T>
__device__ __forceinline__ void row_group(const T* __restrict__ p,
                                          const float* __restrict__ coeff,
                                          int i0, int n, long long d,
                                          float* acc) {
  float v[ROWS][V];
  float c[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    if (FULL || i0 + k < n) {
      load_vec<V>(p + (long long)(i0 + k) * d, v[k]);
      c[k] = round_to<T>(__ldg(coeff + i0 + k));
    }
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    if (FULL || i0 + k < n) {
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(c[k], v[k][j], acc[j]);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
combine_kernel(const T* __restrict__ x, const float* __restrict__ coeff,
               int n, long long d, float* __restrict__ out) {
  const long long lane = blockIdx.y;
  x += lane * n * d;
  coeff += lane * n;
  out += lane * d;
  const long long units = d / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < units; u += stride) {
    const T* p = x + u * V;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    int i0 = 0;
    for (; i0 + ROWS <= n; i0 += ROWS)
      row_group<true, V>(p, coeff, i0, n, d, acc);
    if (i0 < n) row_group<false, V>(p, coeff, i0, n, d, acc);
    store_vec<V>(out + u * V, acc);
  }
}

template <typename T, int V>
int launch_v(const void* x, const float* coeff, int lanes, int n,
             long long d, float* out, int threads, int blocks,
             cudaStream_t s) {
  combine_kernel<T, V><<<dim3(blocks, lanes), threads, 0, s>>>(
      static_cast<const T*>(x), coeff, n, d, out);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const float* coeff, int lanes, int n, long long d,
           float* out, int vec, int threads, int blocks, cudaStream_t s) {
  if ((vec != 1 && vec != 2 && vec != 4) || d % vec != 0 ||
      reinterpret_cast<uintptr_t>(x) % (vec * sizeof(T)) != 0 ||
      reinterpret_cast<uintptr_t>(out) % (vec * sizeof(float)) != 0)
    return cudaErrorInvalidValue;
  switch (vec) {
    case 4: return launch_v<T, 4>(x, coeff, lanes, n, d, out, threads, blocks, s);
    case 2: return launch_v<T, 2>(x, coeff, lanes, n, d, out, threads, blocks, s);
    case 1: return launch_v<T, 1>(x, coeff, lanes, n, d, out, threads, blocks, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// What a launch at one shape passes besides its pointers and stream; the
// wrapper fills one per shape once (kernels/combine/ops.py::Plan) and
// passes its address, which keeps the ctypes call at five arguments.
// d: columns; dtype: REPRO_F32 / REPRO_BF16; vec: elements a thread loads
// at once (4, 2 or 1, dividing d, x and out aligned to it); threads: per
// block, a multiple of 32 up to 256; blocks: column blocks per lane.
struct ReproCombinePlan {
  long long d;
  int dtype, lanes, n, vec, threads, blocks;
};

// x: (lanes, n, d) stacks (a single stack is one lane), coeff: (lanes, n)
// fp32, out: (lanes, d) fp32.
extern "C" int repro_combine(const void* x, const float* coeff, float* out,
                             const ReproCombinePlan* plan, void* stream) {
  const ReproCombinePlan p = *plan;
  if (p.lanes < 1 || p.lanes > 65535 || p.n < 1 || p.d < 1 || p.blocks < 1 ||
      p.threads < 32 || p.threads > MAX_THREADS || p.threads % 32)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.dtype == REPRO_F32)
    return launch<float>(x, coeff, p.lanes, p.n, p.d, out, p.vec, p.threads,
                         p.blocks, s);
  if (p.dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(x, coeff, p.lanes, p.n, p.d, out, p.vec,
                                 p.threads, p.blocks, s);
  return cudaErrorInvalidValue;
}
