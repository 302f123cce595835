// K5 · the lane-batched Gram, (B, n, D) -> (B, n, n) fp32, for n <= 32.
//
// Replaces the TPU kernel repro/kernels/gram/kernel.py::gram_batched_pallas
// (body _gram_batched_kernel), which walks a (lane, D-block) grid in order
// and accumulates into its output block.  n > 32 takes the register-tiled
// product of csrc/gram.cu with a lane grid axis.  K1 at 8 < n <= 32 comes
// here as one lane.
//
// Bound on this card: bytes.  B * n * D elements must be read once; the
// upper triangle's n (n + 1) / 2 products a column are ~n FLOP per
// element read, far below the ridge (at (8, 17, 2^24): 9.13 GB, 2.72 ms at
// 3.35 TB/s, against 0.6 ms of fp32 FMAs at 67 TFLOP/s).  So the design
// reads every element of each lane's stack from HBM exactly once:
//   - grid (chunks, lanes): block (c, b) owns a contiguous run of 256-
//     column tiles of lane b, all n rows of them;
//   - each tile is staged in shared memory by cp.async 16-byte copies
//     (zero-filled past D) in a ring of four stages, so three tiles are in
//     flight while the block computes on the fourth; a misaligned pointer
//     or a D that is no multiple of 16 bytes stages with plain loads.
//     (At (8, 17, 2^24), scripts/torch_kernel_variants.py: 128-column
//     tiles in three stages 3.83 ms, four 3.83, 256 columns in three
//     3.18, in four 3.14 on an H100 80GB HBM3 at 700 W);
//   - the 16 warps split the upper triangle into 4 x 4 row-block pairs
//     (n = 17: rows padded to 20, 15 pairs, one a warp); a lane takes four
//     columns of each 128 of the tile, reads each of its eight rows there
//     as one 16-byte (8-byte for bf16) shared load and does 16 fp32 FMAs
//     per row of the pair's second block (a diagonal pair reads its four
//     rows once).
//     No TF32: every product and sum is an fp32 FMA;
//   - at the end a warp sums its pairs over its 32 lanes in a fixed
//     shuffle order and writes one partial Gram per (lane, chunk); a
//     second launch sums the partials over chunks in chunk order.  No
//     atomics: repeated runs agree bit for bit.
// The chunk count gives one wave of resident blocks (two a SM up to
// n = 20, one above), each an equal share of tiles.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int TC = 256;                 // columns per tile, a multiple of 128
constexpr int STAGES = 4;
constexpr int MAX_N = 32;               // row blocks of 4: NB <= 8

__host__ __device__ constexpr int pairs_of(int nb) { return nb * (nb + 1) / 2; }
__host__ __device__ constexpr int per_warp(int nb) {
  return (pairs_of(nb) + WARPS - 1) / WARPS;
}
// Two resident blocks a SM while a warp owns one pair (<= 64 registers).
__host__ __device__ constexpr int blocks_per_sm(int nb) {
  return per_warp(nb) == 1 ? 2 : 1;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four staged columns of one row, widened to fp32.
__device__ __forceinline__ void lds4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Row blocks (bi, bj), bi <= bj, of upper-triangle pair p (row-major).
__device__ __forceinline__ void pair_blocks(int p, int nb, int* bi, int* bj) {
  int a = 0;
  while (p >= nb - a) { p -= nb - a; ++a; }
  *bi = a; *bj = a + p;
}

// ASYNC: stage T with cp.async (16-byte aligned rows); else stage fp32
// with plain loads.  partial: (lanes, chunks, NP, NP), upper blocks only.
template <typename T, int NB, bool ASYNC>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(NB))
gram_staged(const T* __restrict__ x, int n, long long d, long long tiles,
            int chunks, float* __restrict__ partial) {
  using S = typename std::conditional<ASYNC, T, float>::type;
  constexpr int NP = 4 * NB;
  constexpr int PPW = per_warp(NB);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* stage = reinterpret_cast<S*>(smem_raw);          // [STAGES][NP][TC]

  x += (long long)blockIdx.y * n * d;
  partial += ((long long)blockIdx.y * chunks + blockIdx.x) * NP * NP;
  const long long per = (tiles + chunks - 1) / chunks;
  const long long t0 = (long long)blockIdx.x * per;
  const long long t1 = min(t0 + per, tiles);
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;

  // Pad rows n .. NP - 1 are zero in every stage and never copied to.
  for (int e = threadIdx.x; e < STAGES * (NP - n) * TC; e += THREADS) {
    const int s = e / ((NP - n) * TC), rem = e - s * (NP - n) * TC;
    stage[((long long)s * NP + n + rem / TC) * TC + rem % TC] = S(0.f);
  }

  auto issue = [&](long long t, int s) {
    if (t < t1) {
      const long long c0 = t * TC;
      S* dst0 = stage + (long long)s * NP * TC;
      if constexpr (ASYNC) {
        constexpr int EPV = 16 / sizeof(T);   // elements per copy
        constexpr int VPR = TC / EPV;         // copies per row
        for (int e = threadIdx.x; e < n * VPR; e += THREADS) {
          const int r = e / VPR, v = e - r * VPR;
          const long long col = c0 + (long long)v * EPV;
          const bool in = col < d;            // D is a multiple of EPV
          cp_async16(dst0 + r * TC + v * EPV,
                     in ? x + (long long)r * d + col : x, in ? 16 : 0);
        }
      } else {
        for (int e = threadIdx.x; e < n * TC; e += THREADS) {
          const int r = e / TC, c = e - r * TC;
          const long long col = c0 + c;
          dst0[r * TC + c] = col < d ? to_f32(x[(long long)r * d + col]) : 0.f;
        }
      }
    }
    cp_async_commit();                    // one group per tile slot
  };

  int bi[PPW], bj[PPW];
  bool live[PPW];
#pragma unroll
  for (int q = 0; q < PPW; ++q) {
    const int p = warp + q * WARPS;
    live[q] = p < pairs_of(NB);
    pair_blocks(live[q] ? p : 0, NB, &bi[q], &bj[q]);
  }
  float acc[PPW][4][4];
#pragma unroll
  for (int q = 0; q < PPW; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(t0 + s, s);

  int slot = 0;
  for (long long t = t0; t < t1; ++t) {
    cp_async_wait<STAGES - 2>();          // tile t has landed (own copies)
    __syncthreads();                      // ... everyone's; slot t-1 is free
    issue(t + STAGES - 1, slot == 0 ? STAGES - 1 : slot - 1);
#pragma unroll
    for (int h = 0; h < TC / 128; ++h) {  // 128 columns: 4 a lane
      const S* st = stage + (long long)slot * NP * TC + h * 128 + ln * 4;
#pragma unroll
      for (int q = 0; q < PPW; ++q) {
        if (!live[q]) continue;
        float a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) lds4(st + (bi[q] * 4 + i) * TC, a[i]);
        if (bi[q] == bj[q]) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = i; j < 4; ++j)
#pragma unroll
              for (int k = 0; k < 4; ++k)
                acc[q][i][j] = fmaf(a[i][k], a[j][k], acc[q][i][j]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float b[4];
            lds4(st + (bj[q] * 4 + j) * TC, b);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int k = 0; k < 4; ++k)
                acc[q][i][j] = fmaf(a[i][k], b[k], acc[q][i][j]);
          }
        }
      }
    }
    slot = slot == STAGES - 1 ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  // Fixed-order warp sums; lane 0 writes the pair's 4 x 4 block.
#pragma unroll
  for (int q = 0; q < PPW; ++q) {
    if (!live[q]) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[q][i][j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, off);
        if (ln == 0) partial[(bi[q] * 4 + i) * NP + bj[q] * 4 + j] = v;
      }
  }
}

// One thread per (lane, i <= j): the sum over chunks in chunk order.
__global__ void gram_staged_reduce(const float* __restrict__ partial, int n,
                                   int np, int chunks, float* __restrict__ g) {
  partial += (long long)blockIdx.y * chunks * np * np;
  g += (long long)blockIdx.y * n * n;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * n) return;
  const int i = e / n, j = e % n;
  if (i > j) return;                       // the (j, i) thread writes both
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(long long)c * np * np + i * np + j];
  g[(long long)i * n + j] = s;
  g[(long long)j * n + i] = s;
}

template <typename T, int NB, bool ASYNC>
int launch_staged(const T* x, int lanes, int n, long long d, float* partial,
                  int chunks, float* g, cudaStream_t s) {
  using S = typename std::conditional<ASYNC, T, float>::type;
  constexpr int NP = 4 * NB;
  const size_t smem = sizeof(S) * STAGES * NP * TC;
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        gram_staged<T, NB, ASYNC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const long long tiles = (d + TC - 1) / TC;
  gram_staged<T, NB, ASYNC><<<dim3(chunks, lanes), THREADS, smem, s>>>(
      x, n, d, tiles, chunks, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gram_staged_reduce<<<dim3((n * n + 255) / 256, lanes), 256, 0, s>>>(
      partial, n, NP, chunks, g);
  return cudaGetLastError();
}

template <typename T, bool ASYNC>
int launch_nb(const void* xv, int lanes, int n, long long d, float* partial,
              int chunks, float* g, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  switch ((n + 3) / 4) {
    case 1: return launch_staged<T, 1, ASYNC>(x, lanes, n, d, partial, chunks, g, s);
    case 2: return launch_staged<T, 2, ASYNC>(x, lanes, n, d, partial, chunks, g, s);
    case 3: return launch_staged<T, 3, ASYNC>(x, lanes, n, d, partial, chunks, g, s);
    case 4: return launch_staged<T, 4, ASYNC>(x, lanes, n, d, partial, chunks, g, s);
    case 5: return launch_staged<T, 5, ASYNC>(x, lanes, n, d, partial, chunks, g, s);
    case 6: return launch_staged<T, 6, ASYNC>(x, lanes, n, d, partial, chunks, g, s);
    case 7: return launch_staged<T, 7, ASYNC>(x, lanes, n, d, partial, chunks, g, s);
    case 8: return launch_staged<T, 8, ASYNC>(x, lanes, n, d, partial, chunks, g, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* x, int lanes, int n, long long d, float* partial,
           int chunks, float* g, cudaStream_t s) {
  const bool async = (d * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (async) return launch_nb<T, true>(x, lanes, n, d, partial, chunks, g, s);
  return launch_nb<T, false>(x, lanes, n, d, partial, chunks, g, s);
}

}  // namespace

extern "C" int repro_gram_staged_max_n() { return MAX_N; }

// fp32 scratch floats per (lane, chunk): one padded NP x NP partial Gram.
extern "C" int repro_gram_batched_slots(int n) {
  const int np = 4 * ((n + 3) / 4);
  return np * np;
}

// Chunks per lane: one wave of resident blocks, at most one tile each.
extern "C" int repro_gram_batched_chunks(int lanes, int n, long long d,
                                         int sms) {
  const long long tiles = (d + TC - 1) / TC;
  long long c = (long long)blocks_per_sm((n + 3) / 4) * sms / lanes;
  if (c > tiles) c = tiles;
  return c < 1 ? 1 : (int)c;
}

// K5 for n <= repro_gram_staged_max_n().  x: (lanes, n, d); partial:
// lanes * chunks * repro_gram_batched_slots(n) fp32; g: (lanes, n, n).
extern "C" int repro_gram_batched(const void* x, int dtype, int lanes, int n,
                                  long long d, float* partial, int chunks,
                                  float* g, void* stream) {
  if (lanes < 1 || lanes > 65535 || n < 1 || n > MAX_N || d < 1 ||
      chunks < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch<float>(x, lanes, n, d, partial, chunks, g, s);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(x, lanes, n, d, partial, chunks, g, s);
  return cudaErrorInvalidValue;
}
