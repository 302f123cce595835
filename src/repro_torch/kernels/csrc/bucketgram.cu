// K6 / K7 · bucket means Y = B X of a (n, D) worker stack, and (K6) their
// Gram G = Y Y^T, fp32 accumulation.
//
// Replaces the TPU kernels repro/kernels/bucketgram/kernel.py::
// bucketgram_pallas (bodies _bucketgram_kernel, with_gram=True, and
// _bucketmeans_kernel, with_gram=False).  The TPU kernel contracts the
// dense (n_b, n) assignment matrix B on the MXU, walking the n sweep in
// order and folding each finished (n_b, BLK_D) means block into G.
//
// B has one non-zero per column (worker i belongs to one bucket, weight
// 1/|bucket|), so this kernel does n FMAs per column instead of n_b * n:
// the caller passes the workers sorted by bucket (`order`, stable, so each
// bucket's members come in worker order), the bucket offsets `start` and
// each position's weight.  One thread owns four consecutive columns
// (16-byte fp32 / 8-byte bf16 loads, neighbouring threads on neighbouring
// columns) and reads every row of X exactly once.
//
// Non-finite semantics of the dense contraction: 0 * inf = NaN, so in the
// dense B @ X a non-finite X[i, c] makes EVERY bucket other than i's NaN
// in column c (and its own bucket inf or NaN by the usual sums).  Skipping
// B's zeros would lose that, so each thread tracks, per column, which
// bucket holds its non-finite values (none / one / several) and writes NaN
// to every other bucket.  B's exact zeros change nothing finite.
//
// Gram fold:
//   * n_b <= 8 (the trainer's shape): the 36 upper-triangle sums of the
//     thread's finished fp32 columns stay in registers, as K1 does; a
//     fixed-order shuffle + shared-memory reduction writes one partial per
//     block and bucketgram_reduce sums the partials in block order, so runs
//     are bitwise repeatable;
//   * n_b > 8: per-block (n_b, n_b) partials do not fit, so this file only
//     writes the fp32 means and the wrapper folds G from them with the K1
//     gram kernel (a second launch, counted by K1's own counter).
//
// Lane axis (the fleet's form: bucketgram_pallas under jax.vmap, one call
// per bucket-round): a (B, n, D) stack with each lane's own order / weight
// (B, n) and start (B, n_b + 1); blockIdx.y carries the lane, and every
// kernel below offsets its pointers by it, so a single stack is lane 0 of
// a one-lane launch.  The column grid (blockIdx.x) is the single-lane
// launch's, which depends on D and n_b only: lane b's means, its partials
// and so its register Gram equal the single-lane kernel's on lane b bit
// for bit.  The non-finite spread reads and writes lane b only, so a NaN
// in one lane never reaches another.  Above 8 buckets the wrapper takes
// the lanes' Gram with K5 (gram_batched), as the single-lane form takes K1.
//
// Bound on this card: bytes.  n*D reads, n_b*D writes of the stack dtype
// (~2 FLOP per read element for the means, n_b + 1 more per column for
// the Gram).  Simple and coalesced; a later PR may make it faster.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NB = 8;                       // register-fold bucket limit
constexpr int NPAIR = NB * (NB + 1) / 2;    // upper-triangle Gram entries

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&a);
  raw.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int W>
__device__ __forceinline__ void store_cols(T* p, const float v[W]) {
  if constexpr (W == 4) store4(p, v);
  else store1(p, v[0]);
}

// Sum bucket b's members (in worker order) into acc; note the bucket of
// any non-finite value in `bad` (-1 none, b one bucket, -2 several).
template <typename T, int W>
__device__ __forceinline__ void bucket_sum(
    const T* __restrict__ x, long long d, long long col,
    const int* __restrict__ order, const float* __restrict__ weight, int p0,
    int p1, int b, float acc[W], int bad[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) acc[k] = 0.f;
  for (int p = p0; p < p1; ++p) {
    const long long row = __ldg(order + p);
    const float w = __ldg(weight + p);
    float v[W];
    if constexpr (W == 4) load4(x + row * d + col, v);
    else v[0] = to_f32(x[row * d + col]);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (!isfinite(v[k])) bad[k] = (bad[k] == -1 || bad[k] == b) ? b : -2;
      acc[k] = fmaf(w, v[k], acc[k]);
    }
  }
}

// n_b <= 8: means in registers, optional register Gram fold.
template <typename T, bool VEC, bool GRAM>
__global__ void __launch_bounds__(THREADS)
bucket_reg(const T* __restrict__ x, int n, long long d,
           const int* __restrict__ order, const int* __restrict__ start,
           const float* __restrict__ weight, int nb, T* __restrict__ y,
           float* __restrict__ partial) {
  constexpr int W = VEC ? 4 : 1;
  const long long lane = blockIdx.y;
  x += lane * n * d;
  order += lane * n;
  weight += lane * n;
  start += lane * (nb + 1);
  y += lane * nb * d;
  if constexpr (GRAM) partial += lane * gridDim.x * NPAIR;
  const long long units = d / W;
  const long long stride = (long long)gridDim.x * THREADS;
  float g[NPAIR];
#pragma unroll
  for (int e = 0; e < NPAIR; ++e) g[e] = 0.f;

  for (long long u = (long long)blockIdx.x * THREADS + threadIdx.x; u < units;
       u += stride) {
    const long long col = u * W;
    float acc[NB][W];
    int bad[W];
#pragma unroll
    for (int k = 0; k < W; ++k) bad[k] = -1;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < nb) {
        bucket_sum<T, W>(x, d, col, order, weight, __ldg(start + b),
                         __ldg(start + b + 1), b, acc[b], bad);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k) acc[b][k] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (bad[k] != -1)
#pragma unroll
        for (int b = 0; b < NB; ++b)
          if (b < nb && bad[k] != b) acc[b][k] = __int_as_float(0x7fffffff);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < nb) store_cols<T, W>(y + (long long)b * d + col, acc[b]);
    if constexpr (GRAM) {
      int e = 0;
#pragma unroll
      for (int a = 0; a < NB; ++a)
#pragma unroll
        for (int b = a; b < NB; ++b, ++e)
#pragma unroll
          for (int k = 0; k < W; ++k) g[e] = fmaf(acc[a][k], acc[b][k], g[e]);
    }
  }

  if constexpr (GRAM) {
    // Fixed-order block reduction of the NPAIR accumulators.
    __shared__ float red[THREADS / 32][NPAIR];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int e = 0; e < NPAIR; ++e) {
      float v = g[e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][e] = v;
    }
    __syncthreads();
    if (threadIdx.x < NPAIR) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) s += red[w][threadIdx.x];
      partial[(long long)blockIdx.x * NPAIR + threadIdx.x] = s;
    }
  }
}

// Sums the per-block partials in block order into the (nb, nb) Gram; one
// block per lane (blockIdx.x).
__global__ void bucketgram_reduce(const float* __restrict__ partial,
                                  int blocks, int nb, float* __restrict__ g) {
  const int e = threadIdx.x;
  partial += (long long)blockIdx.x * blocks * NPAIR;
  g += (long long)blockIdx.x * nb * nb;
  if (e >= NPAIR) return;
  int a = 0, r = e;
  while (r >= NB - a) { r -= NB - a; ++a; }
  const int b = a + r;
  if (b >= nb) return;
  float s = 0.f;
  for (int k = 0; k < blocks; ++k) s += partial[(long long)k * NPAIR + e];
  g[a * nb + b] = s;
  g[b * nb + a] = s;
}

// Any n_b: one thread per (bucket, column group), so a small D with many
// buckets (the reference's scale shapes: 640 buckets of 64 columns) still
// fills the card.  Means are written as they finish (also as fp32 into yf
// when given); each thread that meets a non-finite value notes its bucket
// in bad[col] (-1 none, b one bucket, -2 several, by atomics), and
// bucket_nan_spread then writes NaN to the other buckets of those columns.
__device__ __forceinline__ void note_bad(int* bad, int b) {
  const int old = atomicCAS(bad, -1, b);
  if (old != -1 && old != b) atomicExch(bad, -2);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
bucket_any(const T* __restrict__ x, int n, long long d,
           const int* __restrict__ order, const int* __restrict__ start,
           const float* __restrict__ weight, int nb, T* __restrict__ y,
           float* __restrict__ yf, int* __restrict__ bad) {
  constexpr int W = VEC ? 4 : 1;
  const long long lane = blockIdx.y;
  x += lane * n * d;
  order += lane * n;
  weight += lane * n;
  start += lane * (nb + 1);
  y += lane * nb * d;
  if (yf) yf += lane * nb * d;
  bad += lane * d;
  const long long units = d / W;
  const long long total = units * nb;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < total;
       t += stride) {
    const int b = (int)(t / units);
    const long long col = (t - (long long)b * units) * W;
    int nf[W];
#pragma unroll
    for (int k = 0; k < W; ++k) nf[k] = -1;
    float acc[W];
    bucket_sum<T, W>(x, d, col, order, weight, __ldg(start + b),
                     __ldg(start + b + 1), b, acc, nf);
    store_cols<T, W>(y + (long long)b * d + col, acc);
    if (yf) store_cols<float, W>(yf + (long long)b * d + col, acc);
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (nf[k] != -1) note_bad(bad + col + k, b);
  }
}

__global__ void bucket_nan_spread(const int* __restrict__ bad, long long d,
                                  int nb, void* __restrict__ yv, int bf16,
                                  float* __restrict__ yf) {
  const long long lane = blockIdx.y;
  bad += lane * d;
  if (yf) yf += lane * nb * d;
  yv = bf16 ? static_cast<void*>(static_cast<__nv_bfloat16*>(yv) + lane * nb * d)
            : static_cast<void*>(static_cast<float*>(yv) + lane * nb * d);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < d;
       c += stride) {
    const int v = bad[c];
    if (v == -1) continue;
    const float qnan = __int_as_float(0x7fffffff);
    for (int b = 0; b < nb; ++b) {
      if (b == v) continue;
      if (bf16) store1(static_cast<__nv_bfloat16*>(yv) + (long long)b * d + c, qnan);
      else store1(static_cast<float*>(yv) + (long long)b * d + c, qnan);
      if (yf) yf[(long long)b * d + c] = qnan;
    }
  }
}

template <typename T>
int launch(const void* xv, int lanes, int n, long long d, const int* order,
           const int* start, const float* weight, int nb, void* yv,
           float* yf, float* partial, float* g, int* bad, int blocks,
           cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const bool vec = vec4_ok<T>(xv, d) && vec4_ok<T>(yv, d) &&
                   (!yf || vec4_ok<float>(yf, d));
  const dim3 grid(blocks, lanes);
  if (nb <= NB && !yf) {
    if (g) {
      if (vec)
        bucket_reg<T, true, true><<<grid, THREADS, 0, s>>>(
            x, n, d, order, start, weight, nb, y, partial);
      else
        bucket_reg<T, false, true><<<grid, THREADS, 0, s>>>(
            x, n, d, order, start, weight, nb, y, partial);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      bucketgram_reduce<<<lanes, 64, 0, s>>>(partial, blocks, nb, g);
    } else if (vec) {
      bucket_reg<T, true, false><<<grid, THREADS, 0, s>>>(
          x, n, d, order, start, weight, nb, y, nullptr);
    } else {
      bucket_reg<T, false, false><<<grid, THREADS, 0, s>>>(
          x, n, d, order, start, weight, nb, y, nullptr);
    }
    return cudaGetLastError();
  }
  if (g || !bad) return cudaErrorInvalidValue;   // n_b > 8: G from K1 / K5
  cudaError_t err =
      cudaMemsetAsync(bad, 0xFF, sizeof(int) * d * lanes, s);  // -1
  if (err != cudaSuccess) return err;
  if (vec)
    bucket_any<T, true><<<grid, THREADS, 0, s>>>(x, n, d, order, start,
                                                 weight, nb, y, yf, bad);
  else
    bucket_any<T, false><<<grid, THREADS, 0, s>>>(x, n, d, order, start,
                                                  weight, nb, y, yf, bad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long spread = (d + THREADS - 1) / THREADS;
  bucket_nan_spread<<<dim3((unsigned)(spread < blocks ? spread : blocks), lanes),
                      THREADS, 0, s>>>(bad, d, nb, y, sizeof(T) == 2, yf);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_bucketgram_reg_nb() { return NB; }
extern "C" int repro_bucketgram_npair() { return NPAIR; }

// x: (lanes, n, d) stacks (a single stack is one lane); order / weight:
// (lanes, n) each lane's workers sorted by bucket and their B weights;
// start: (lanes, nb + 1) bucket offsets into order; y: (lanes, nb, d)
// means in x's dtype; yf: optional fp32 copy of the means; partial:
// lanes*blocks*NPAIR fp32 scratch and g: (lanes, nb, nb) fp32 Grams, both
// NULL for means only (K7); a Gram needs nb <= 8 and no yf; bad: (lanes,
// d) int32 scratch, needed for nb > 8; blocks: column blocks per lane (the
// same count for any lane count, so that each lane equals a one-lane
// launch bit for bit).  Launches bucket_reg (+ bucketgram_reduce) for
// nb <= 8, else bucket_any + bucket_nan_spread.
extern "C" int repro_bucketgram(const void* x, int dtype, int lanes, int n,
                                long long d, const int* order,
                                const int* start, const float* weight, int nb,
                                void* y, float* yf, float* partial, float* g,
                                int* bad, int blocks, void* stream) {
  if (lanes < 1 || lanes > 65535 || n < 1 || d < 1 || nb < 1 || blocks < 1)
    return cudaErrorInvalidValue;
  if (g && (!partial || nb > NB || yf)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch<float>(x, lanes, n, d, order, start, weight, nb, y, yf,
                         partial, g, bad, blocks, s);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(x, lanes, n, d, order, start, weight, nb, y,
                                 yf, partial, g, bad, blocks, s);
  return cudaErrorInvalidValue;
}
