// K1 · Gram matrix G = X X^T of a (n, D) worker stack, fp32 accumulation.
//
// Replaces the TPU kernel repro/kernels/gram/kernel.py::gram_pallas
// (body _gram_kernel), which walks D in order on one core and accumulates
// into its output block.  Blocks of a GPU run in no order, so the design
// is split-K over D in two launches:
//   1. gram_partial: block b streams its contiguous D-chunk of an 8-row
//      tile pair (ti, tj), four columns per thread with 16-byte (fp32) or
//      8-byte (bf16) loads, neighbouring threads on neighbouring columns,
//      and accumulates the tile's 8x8 products in fp32 registers (upper
//      triangle only on diagonal tiles).  A fixed-order shuffle + shared
//      memory reduction writes one 64-entry partial per block to scratch.
//   2. gram_reduce: one thread per G entry sums the partials over chunks
//      in chunk order.  No fp32 atomics: repeated runs agree bit for bit.
// Bound on this card: bytes.  It reads n*D elements once per tile pair
// (once in all for n <= 8, the main path) and does ~n/2 FLOP per byte, far
// below the H100's ridge; the design keeps every load coalesced and wide
// and the compute in registers.  For n > 8 rows are re-read once per tile
// pair they belong to (ceil(n/8) times); the main path's n = 8 reads once.
//
// K5 above 32 workers · the lane-batched Gram, (B, n, D) -> (B, n, n),
// replacing repro/kernels/gram/kernel.py::gram_batched_pallas for n > 32
// (n <= 32, the fleet's shapes, runs the staged kernel of
// csrc/gram_batched.cu, which reads each lane once).  Here the same two
// launches take a third grid axis, blockIdx.z = lane: every lane gets its
// own split-K partials and its own fixed-order reduction (bitwise
// repeatable), and one launch pair covers the whole fleet bucket with no
// host loop.  Bound: bytes, B*n*D elements; rows are re-read per tile
// pair, as K1's.
#include "common.cuh"

namespace {

constexpr int TR = 8;          // rows per tile
constexpr int THREADS = 256;   // threads per block

__device__ __forceinline__ void pair_of(int p, int tiles, bool diag,
                                        int* ti, int* tj) {
  if (diag) { *ti = p; *tj = p; return; }
  int a = 0;
  while (p >= tiles - 1 - a) { p -= tiles - 1 - a; ++a; }
  *ti = a; *tj = a + 1 + p;
}

template <typename T, bool VEC, bool DIAG>
__global__ void __launch_bounds__(THREADS)
gram_partial(const T* __restrict__ x, int n, long long d, int tiles,
             int chunks, int pair_base, int pairs_total,
             float* __restrict__ partial) {
  constexpr int W = VEC ? 4 : 1;
  x += (long long)blockIdx.z * n * d;                       // this lane's stack
  partial += (long long)blockIdx.z * chunks * pairs_total * TR * TR;
  int ti, tj;
  pair_of(blockIdx.y, tiles, DIAG, &ti, &tj);
  const long long units = VEC ? d / 4 : d;
  const long long per = (units + chunks - 1) / chunks;
  const long long u0 = (long long)blockIdx.x * per;
  const long long u1 = min(u0 + per, units);

  float acc[TR][TR];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;

  for (long long u = u0 + threadIdx.x; u < u1; u += THREADS) {
    const long long col = u * W;
    float a[TR][W];
    float b[DIAG ? 1 : TR][W];
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int row = ti * TR + r;
      if (row < n) {
        if constexpr (VEC) load4(x + (long long)row * d + col, a[r]);
        else a[r][0] = to_f32(x[(long long)row * d + col]);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k) a[r][k] = 0.f;
      }
    }
    if constexpr (!DIAG) {
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const int row = tj * TR + r;
        if (row < n) {
          if constexpr (VEC) load4(x + (long long)row * d + col, b[r]);
          else b[r][0] = to_f32(x[(long long)row * d + col]);
        } else {
#pragma unroll
          for (int k = 0; k < W; ++k) b[r][k] = 0.f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        if (DIAG && j < i) continue;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          if constexpr (DIAG) acc[i][j] = fmaf(a[i][k], a[j][k], acc[i][j]);
          else acc[i][j] = fmaf(a[i][k], b[j][k], acc[i][j]);
        }
      }
  }

  // Fixed-order block reduction of the 64 accumulators.
  __shared__ float red[THREADS / 32][TR * TR];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      float v = acc[i][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][i * TR + j] = v;
    }
  __syncthreads();
  if (threadIdx.x < TR * TR) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += red[w][threadIdx.x];
    const long long slot =
        ((long long)blockIdx.x * pairs_total + pair_base + blockIdx.y);
    partial[slot * TR * TR + threadIdx.x] = s;
  }
}

__global__ void gram_reduce(const float* __restrict__ partial, int n,
                            int tiles, int chunks, int pairs_total,
                            float* __restrict__ g) {
  partial += (long long)blockIdx.y * chunks * pairs_total * TR * TR;
  g += (long long)blockIdx.y * n * n;                     // blockIdx.y = lane
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * n) return;
  const int i = e / n, j = e % n;
  if (i > j) return;                       // the (j, i) thread writes both
  const int ti = i / TR, tj = j / TR;
  int p = ti;                              // diagonal pairs come first
  if (ti != tj) {
    p = tiles;
    for (int a = 0; a < ti; ++a) p += tiles - 1 - a;
    p += tj - ti - 1;
  }
  const int slot = (i % TR) * TR + (j % TR);
  float s = 0.f;
  for (int c = 0; c < chunks; ++c)
    s += partial[((long long)c * pairs_total + p) * TR * TR + slot];
  g[(long long)i * n + j] = s;
  g[(long long)j * n + i] = s;
}

template <typename T>
int launch(const void* xv, int lanes, int n, long long d, float* partial,
           int chunks, float* g, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const int tiles = (n + TR - 1) / TR;
  const int off = tiles * (tiles - 1) / 2;
  const int pairs_total = tiles + off;
  const bool vec = vec4_ok<T>(xv, d);
  dim3 gd(chunks, tiles, lanes), go(chunks, off, lanes);
  if (vec) {
    gram_partial<T, true, true><<<gd, THREADS, 0, stream>>>(
        x, n, d, tiles, chunks, 0, pairs_total, partial);
    if (off)
      gram_partial<T, true, false><<<go, THREADS, 0, stream>>>(
          x, n, d, tiles, chunks, tiles, pairs_total, partial);
  } else {
    gram_partial<T, false, true><<<gd, THREADS, 0, stream>>>(
        x, n, d, tiles, chunks, 0, pairs_total, partial);
    if (off)
      gram_partial<T, false, false><<<go, THREADS, 0, stream>>>(
          x, n, d, tiles, chunks, tiles, pairs_total, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gram_reduce<<<dim3((n * n + 255) / 256, lanes), 256, 0, stream>>>(
      partial, n, tiles, chunks, pairs_total, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_gram_pairs(int n) {
  const int tiles = (n + TR - 1) / TR;
  return tiles + tiles * (tiles - 1) / 2;
}

// partial: lanes * chunks * repro_gram_pairs(n) * 64 fp32 scratch;
// g: (lanes, n, n).  lanes = 1 is K1; K5 comes here for n > 32.
extern "C" int repro_gram(const void* x, int dtype, int lanes, int n,
                          long long d, float* partial, int chunks, float* g,
                          void* stream) {
  if (lanes < 1 || lanes > 65535 || n < 1 || d < 1 || chunks < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch<float>(x, lanes, n, d, partial, chunks, g, s);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(x, lanes, n, d, partial, chunks, g, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
