// K1 · Gram matrix G = X X^T of a (n, D) worker stack, fp32 accumulation,
// and K5 above 32 workers · the lane-batched Gram (B, n, D) -> (B, n, n).
//
// Replaces the TPU kernels repro/kernels/gram/kernel.py::gram_pallas (body
// _gram_kernel) and, for n > 32, gram_batched_pallas (_gram_batched_kernel).
// The TPU kernel runs one MXU dot_general of an (n, block_d) tile with
// itself per grid step and accumulates into its (n, n) output over a grid
// walked in order.  Blocks of a GPU run in no order on 132 SMs, so every
// route here is split-K over D with a second launch that sums the partial
// Grams in chunk order: no float atomics, so repeated runs agree bit for
// bit.  Every product and sum is an fp32 FMA (no TF32, no tensor cores):
// NNM's neighbour choices at n = 640 sit on near-ties.  The upper triangle
// is summed once and mirrored, so G is exactly symmetric.
//
// Routes by n (kernels/gram/ops.py picks them):
//   n <= 8 (the main path, n = 8 at D = 361,821,120): gram_rows, below.
//     Bound: bytes.  The tile's 36 products a column are ~n/2 FLOP per byte
//     read, far below the ridge, so block b streams one contiguous D-chunk
//     of all rows once, four columns a thread with 16-byte (fp32) or
//     8-byte (bf16) loads, and keeps the 8 x 8 products in registers; a
//     fixed-order shuffle + shared-memory sum writes one partial a block.
//   8 < n <= 32: the staged kernel of csrc/gram_batched.cu at lanes = 1.
//     Bound: bytes (~n FLOP per element read); it reads each row once.
//   n > 32: gram_tiled, below.  Bound: bytes below n ~ 80, operations
//     above (n (n + 1) D FLOP against 4 n D bytes: (n + 1) / 4 FLOP a byte
//     against the card's 20 of fp32 FMAs); at n = 640, D = 2^20,
//     6.42 ms at 67 TFLOP/s.  So the design buys FMAs per byte moved, from
//     HBM / L2 into shared memory and from shared memory into registers:
//       - output tiles of TM x TM over the upper triangle's tile pairs only
//         (a diagonal pair stages its rows once and computes its tile
//         whole: skipping the entries below its diagonal was tried and ran
//         slower); TM by n, the fastest measured (tile_for);
//       - 256 threads, each an R x R micro-tile (R = TM / 16: 8 x 8 at
//         TM = 128) of fp32 accumulators, its rows and columns strided by
//         16, a warp 8 threads along the columns by 4 along the rows, so
//         that a warp's reads of one staged column group hit distinct banks;
//       - both row blocks stream through a ring of shared-memory stages of
//         KT columns (TM = 128: 4 stages of 32) by cp.async 16-byte copies
//         (zero-filled past D and past n), so STAGES - 1 tiles are in
//         flight while the block computes on one; rows are padded by 16
//         bytes (pitch KT + 4 fp32) against bank conflicts.  A misaligned
//         base or a D that is no multiple of 16 bytes stages with plain
//         loads;
//       - a thread reads its R rows of the first block at four consecutive
//         columns as one 16-byte (bf16: 8-byte) shared load each, then each
//         of its R rows of the second block and R x 4 FMAs on it: 2R loads
//         per 4R^2 FMAs (16 per 256 at TM = 128);
//       - every 256 columns the accumulators are added to a second-level
//         sum (TM = 128: in shared memory, which frees registers for the
//         product), so no fp32 chain runs over more than 256 products:
//         a chain over a chunk of ~10^4 columns drifted past 1e-5 of G;
//       - split-K: tile pairs x chunks blocks (x lanes for K5), chunks
//         chosen so that the blocks fill whole waves of the SMs
//         (n = 640: 15 pairs x 44 chunks = 5 waves of 132); the partial
//         tiles are summed by gram_tiled_reduce in chunk order.
//     K5 above 32 workers is the same kernel with blockIdx.z = lane.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// n <= 8: one 8-row tile.
// ---------------------------------------------------------------------------

constexpr int TR = 8;          // rows of the tile
constexpr int ROW_THREADS = 256;

template <typename T, bool VEC>
__global__ void __launch_bounds__(ROW_THREADS)
gram_rows(const T* __restrict__ x, int n, long long d, int chunks,
          float* __restrict__ partial) {
  constexpr int W = VEC ? 4 : 1;
  const long long units = VEC ? d / 4 : d;
  const long long per = (units + chunks - 1) / chunks;
  const long long u0 = (long long)blockIdx.x * per;
  const long long u1 = min(u0 + per, units);

  float acc[TR][TR];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;

  for (long long u = u0 + threadIdx.x; u < u1; u += ROW_THREADS) {
    const long long col = u * W;
    float a[TR][W];
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      if (r < n) {
        if constexpr (VEC) load4(x + (long long)r * d + col, a[r]);
        else a[r][0] = to_f32(x[(long long)r * d + col]);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k) a[r][k] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = i; j < TR; ++j)
#pragma unroll
        for (int k = 0; k < W; ++k) acc[i][j] = fmaf(a[i][k], a[j][k], acc[i][j]);
  }

  // Fixed-order block reduction of the 64 accumulators.
  __shared__ float red[ROW_THREADS / 32][TR * TR];
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
    for (int w = 0; w < ROW_THREADS / 32; ++w) s += red[w][threadIdx.x];
    partial[(long long)blockIdx.x * TR * TR + threadIdx.x] = s;
  }
}

__global__ void gram_rows_reduce(const float* __restrict__ partial, int n,
                                 int chunks, float* __restrict__ g) {
  const int e = threadIdx.x;
  if (e >= n * n) return;
  const int i = e / n, j = e % n;
  if (i > j) return;                       // the (j, i) thread writes both
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(long long)c * TR * TR + i * TR + j];
  g[i * n + j] = s;
  g[j * n + i] = s;
}

template <typename T>
int launch_rows(const void* xv, int n, long long d, float* partial,
                int chunks, float* g, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  if (vec4_ok<T>(xv, d))
    gram_rows<T, true><<<chunks, ROW_THREADS, 0, stream>>>(x, n, d, chunks, partial);
  else
    gram_rows<T, false><<<chunks, ROW_THREADS, 0, stream>>>(x, n, d, chunks, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gram_rows_reduce<<<1, TR * TR, 0, stream>>>(partial, n, chunks, g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// n > 32: register-tiled symmetric product over upper-triangle tile pairs.
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;   // 16 x 16 threads, a warp 8 (columns) x 4 (rows)
// Columns summed into a register accumulator before it is added to a
// second-level sum: fp32 sums of ~10^4 products in one chain drift by
// ~1e-5 of the result, chains of 256 by ~1e-6.
constexpr int FLUSH_COLS = 256;

// KT: columns a stage; STAGES: ring depth (scripts/torch_kernel_variants.py
// times other values at TM = 128); BLOCKS: resident blocks a SM (TM <= 64:
// <= 128 registers a thread, two rings of ~104 KB); SUM_SMEM: the
// second-level sums in shared memory (TM = 128: 64 KB beside a 144 KB
// ring; it frees 64 registers for the product and ran faster than
// registers).
template <int TM> struct Cfg;
template <> struct Cfg<128> {
  static constexpr int KT = 32, STAGES = 4, BLOCKS = 1;
  static constexpr bool SUM_SMEM = true;
};
template <> struct Cfg<64> {
  static constexpr int KT = 64, STAGES = 3, BLOCKS = 2;
  static constexpr bool SUM_SMEM = false;
};
template <> struct Cfg<32> {
  static constexpr int KT = 128, STAGES = 3, BLOCKS = 2;
  static constexpr bool SUM_SMEM = false;
};

// Staged row pitch in elements: 16 bytes of pad (a multiple of 16 bytes,
// for cp.async; 4 words mod 32 for fp32 KT in {32, 64, 128}).
template <typename T, int TM>
__host__ __device__ constexpr int pitch() {
  return Cfg<TM>::KT + 16 / (int)sizeof(T);
}
template <typename T, int TM>
constexpr size_t smem_bytes() {
  return sizeof(T) * Cfg<TM>::STAGES * 2 * TM * pitch<T, TM>() +
         (Cfg<TM>::SUM_SMEM ? sizeof(float) * TM * TM : 0);
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

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Row tiles (ti, tj), ti <= tj, of upper-triangle pair p (row-major).
__device__ __forceinline__ void pair_tiles(int p, int tiles, int* ti, int* tj) {
  int a = 0;
  while (p >= tiles - a) { p -= tiles - a; ++a; }
  *ti = a; *tj = a + p;
}

// ASYNC: 16-byte aligned rows, staged by cp.async; else by plain loads.
// Grid (pairs, chunks, lanes); partial: (lanes, chunks, pairs, TM, TM).
// A thread owns rows ty + 16 i and columns tx + 16 j (i, j < R) of the
// output tile; a warp is 8 threads along the columns by 4 along the rows,
// so its reads of one staged column group touch 8 + 4 rows whose 16-byte
// words lie on distinct banks (pitch = 4 words mod 32).
template <typename T, int TM, bool ASYNC>
__global__ void __launch_bounds__(THREADS, Cfg<TM>::BLOCKS)
gram_tiled(const T* __restrict__ x, int n, long long d, int tiles,
           long long ktiles, int chunks, float* __restrict__ partial) {
  constexpr int KT = Cfg<TM>::KT, STAGES = Cfg<TM>::STAGES;
  constexpr int R = TM / 16, P = pitch<T, TM>();
  constexpr int OPER = TM * P;                 // elements of one staged operand
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);   // [STAGES][2][TM][P]

  const int pairs = gridDim.x;
  x += (long long)blockIdx.z * n * d;
  partial += (((long long)blockIdx.z * chunks + blockIdx.y) * pairs + blockIdx.x)
             * TM * TM;
  int ti, tj;
  pair_tiles(blockIdx.x, tiles, &ti, &tj);
  const bool diag = ti == tj;
  const long long per = (ktiles + chunks - 1) / chunks;
  const long long t0 = (long long)blockIdx.y * per;
  const long long t1 = min(t0 + per, ktiles);

  // cp.async: a thread copies 16 bytes at column v * EPV of rows r0,
  // r0 + RSTEP, ... of each staged block.
  constexpr int EPV = 16 / sizeof(T);          // elements a copy
  constexpr int VPR = KT / EPV;                // copies a row
  constexpr int RSTEP = THREADS / VPR;
  static_assert(THREADS % VPR == 0 && TM % RSTEP == 0, "copy geometry");
  const int v = threadIdx.x % VPR, r0 = threadIdx.x / VPR;
  const T* src[2] = {x + (long long)(ti * TM + r0) * d + v * EPV,
                     x + (long long)(tj * TM + r0) * d + v * EPV};

  auto issue = [&](long long t, int s) {
    if (t < t1) {
      const long long c0 = t * KT;
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        if (o == 1 && diag) break;             // one staged block serves both
        const int row0 = (o == 0 ? ti : tj) * TM;
        T* dst = stage + ((long long)s * 2 + o) * OPER;
        if constexpr (ASYNC) {
          const bool col_in = c0 + v * EPV < d;        // D: a multiple of EPV
#pragma unroll
          for (int q = 0; q < TM / RSTEP; ++q) {
            const int r = r0 + q * RSTEP;
            const bool in = col_in && row0 + r < n;
            cp_async16(dst + r * P + v * EPV,
                       in ? src[o] + (long long)q * RSTEP * d + c0 : x,
                       in ? 16 : 0);
          }
        } else {
          for (int e = threadIdx.x; e < TM * KT; e += THREADS) {
            const int r = e / KT, c = e - r * KT;
            const long long col = c0 + c;
            dst[r * P + c] = row0 + r < n && col < d
                                 ? x[(long long)(row0 + r) * d + col]
                                 : zero<T>();
          }
        }
      }
    }
    cp_async_commit();                         // one group a tile slot
  };

  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int tx = (warp & 1) * 8 + (ln & 7);
  const int ty = (warp >> 1) * 4 + (ln >> 3);

  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
  // sum[e * STRIDE]: this thread's second-level sum of acc[e / R][e % R],
  // in registers or in its own column of a shared-memory array.
  constexpr bool SMEM_SUM = Cfg<TM>::SUM_SMEM;
  constexpr int STRIDE = SMEM_SUM ? THREADS : 1;
  float sum_regs[SMEM_SUM ? 1 : R * R];
  float* sum = SMEM_SUM
      ? reinterpret_cast<float*>(stage + STAGES * 2 * OPER) + threadIdx.x
      : sum_regs;
#pragma unroll
  for (int e = 0; e < R * R; ++e) sum[e * STRIDE] = 0.f;
  constexpr int FLUSH = FLUSH_COLS / KT > 0 ? FLUSH_COLS / KT : 1;   // stages
  int since = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(t0 + s, s);

  int slot = 0;
  for (long long t = t0; t < t1; ++t) {
    cp_async_wait<STAGES - 2>();               // tile t has landed (own copies)
    __syncthreads();                           // ... everyone's; slot t-1 is free
    issue(t + STAGES - 1, slot == 0 ? STAGES - 1 : slot - 1);
    const T* sa = stage + (long long)slot * 2 * OPER + ty * P;
    const T* sb = stage + ((long long)slot * 2 + (diag ? 0 : 1)) * OPER + tx * P;
    // Four columns a step, one row of the second block at a time; each
    // accumulator sums its columns in ascending order.
#pragma unroll
    for (int k = 0; k < KT; k += 4) {
      float a[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i) lds4(sa + 16 * i * P + k, a[i]);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float b[4];
        lds4(sb + 16 * j * P + k, b);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < R; ++i)
            acc[i][j] = fmaf(a[i][q], b[q], acc[i][j]);
      }
    }
    if (++since == FLUSH) {
      since = 0;
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          sum[(i * R + j) * STRIDE] += acc[i][j];
          acc[i][j] = 0.f;
        }
    }
    slot = slot == STAGES - 1 ? 0 : slot + 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j)
      partial[(ty + 16 * i) * TM + tx + 16 * j] = sum[(i * R + j) * STRIDE] + acc[i][j];
}

// One thread per (lane, i <= j): the sum over chunks in chunk order.
__global__ void gram_tiled_reduce(const float* __restrict__ partial, int n,
                                  int tm, int tiles, int chunks,
                                  float* __restrict__ g) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)n * n) return;
  const int i = (int)(e / n), j = (int)(e % n);
  if (i > j) return;                       // the (j, i) thread writes both
  const int pairs = tiles * (tiles + 1) / 2;
  const int ti = i / tm, tj = j / tm;
  const int p = ti * tiles - ti * (ti - 1) / 2 + (tj - ti);
  const long long tt = (long long)tm * tm;
  partial += (long long)blockIdx.y * chunks * pairs * tt
             + (long long)p * tt + (i % tm) * tm + (j % tm);
  g += (long long)blockIdx.y * n * n;                     // blockIdx.y = lane
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(long long)c * pairs * tt];
  g[(long long)i * n + j] = s;
  g[(long long)j * n + i] = s;
}

// The tile height for n workers: the fastest at D = 2^20 on an H100
// (scripts/torch_gram_ab.py --tiles; PERF.md).
int tile_for(int n) { return n <= 64 ? 64 : n <= 96 ? 32 : n <= 384 ? 64 : 128; }

int kt_for(int tm) {
  return tm == 32 ? Cfg<32>::KT : tm == 64 ? Cfg<64>::KT : Cfg<128>::KT;
}
int blocks_for(int tm) {
  return tm == 32 ? Cfg<32>::BLOCKS : tm == 64 ? Cfg<64>::BLOCKS : Cfg<128>::BLOCKS;
}
int pairs_for(int n, int tm) {
  const int tiles = (n + tm - 1) / tm;
  return tiles * (tiles + 1) / 2;
}

template <typename T, int TM, bool ASYNC>
int launch_tiled_tm(const T* x, int lanes, int n, long long d, float* partial,
                    int chunks, float* g, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<T, TM>();
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        gram_tiled<T, TM, ASYNC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const int tiles = (n + TM - 1) / TM;
  const int pairs = tiles * (tiles + 1) / 2;
  const long long ktiles = (d + Cfg<TM>::KT - 1) / Cfg<TM>::KT;
  gram_tiled<T, TM, ASYNC><<<dim3(pairs, chunks, lanes), THREADS, smem, s>>>(
      x, n, d, tiles, ktiles, chunks, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long nn = (long long)n * n;
  gram_tiled_reduce<<<dim3((unsigned)((nn + 255) / 256), lanes), 256, 0, s>>>(
      partial, n, TM, tiles, chunks, g);
  return cudaGetLastError();
}

template <typename T, bool ASYNC>
int launch_tiled_async(const void* xv, int lanes, int n, long long d, int tm,
                       float* partial, int chunks, float* g, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  switch (tm) {
    case 32: return launch_tiled_tm<T, 32, ASYNC>(x, lanes, n, d, partial, chunks, g, s);
    case 64: return launch_tiled_tm<T, 64, ASYNC>(x, lanes, n, d, partial, chunks, g, s);
    case 128: return launch_tiled_tm<T, 128, ASYNC>(x, lanes, n, d, partial, chunks, g, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int launch_tiled(const void* x, int lanes, int n, long long d, int tm,
                 float* partial, int chunks, float* g, cudaStream_t s) {
  const bool async = (d * (long long)sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (async)
    return launch_tiled_async<T, true>(x, lanes, n, d, tm, partial, chunks, g, s);
  return launch_tiled_async<T, false>(x, lanes, n, d, tm, partial, chunks, g, s);
}

}  // namespace

// ---- n <= 8 -----------------------------------------------------------------

extern "C" int repro_gram_rows_max_n() { return TR; }

// partial: chunks * 64 fp32 scratch; g: (n, n).
extern "C" int repro_gram(const void* x, int dtype, int n, long long d,
                          float* partial, int chunks, float* g, void* stream) {
  if (n < 1 || n > TR || d < 1 || chunks < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch_rows<float>(x, n, d, partial, chunks, g, s);
  if (dtype == REPRO_BF16)
    return launch_rows<__nv_bfloat16>(x, n, d, partial, chunks, g, s);
  return cudaErrorInvalidValue;
}

// ---- n > 32 -----------------------------------------------------------------

// The tile height the tiled kernel takes for n workers.
extern "C" int repro_gram_tiled_tm(int n) { return tile_for(n); }

// Chunks of D a tile pair is split into: the count that minimises waves of
// resident blocks x (KT-column tiles a chunk + 4 tiles of fixed cost a
// block), the smaller on a tie, with at most 8 waves of blocks unless the
// tile pairs alone make more (that caps the scratch).  tm: 32, 64 or 128.
extern "C" int repro_gram_tiled_chunks(int lanes, int n, long long d, int tm,
                                       int sms) {
  const long long ktiles = (d + kt_for(tm) - 1) / kt_for(tm);
  const long long blocks = (long long)pairs_for(n, tm) * lanes;
  const long long wave = (long long)blocks_for(tm) * sms;
  long long best = 1, cost = -1;
  long long top = (8 * wave + blocks - 1) / blocks;
  if (top > ktiles) top = ktiles;
  for (long long c = 1; c <= top && c <= 65535; ++c) {
    const long long waves = (blocks * c + wave - 1) / wave;
    const long long v = waves * ((ktiles + c - 1) / c + 4);
    if (cost < 0 || v < cost) { cost = v; best = c; }
  }
  return (int)best;
}

// fp32 scratch floats: one TM x TM partial tile per (lane, chunk, pair).
extern "C" long long repro_gram_tiled_scratch(int lanes, int n, int tm,
                                              int chunks) {
  return (long long)lanes * chunks * pairs_for(n, tm) * tm * tm;
}

// x: (lanes, n, d); g: (lanes, n, n).  lanes = 1 is K1; K5 comes here for
// n > 32.
extern "C" int repro_gram_tiled(const void* x, int dtype, int lanes, int n,
                                long long d, int tm, float* partial,
                                int chunks, float* g, void* stream) {
  if (lanes < 1 || lanes > 65535 || n < 1 || d < 1 || chunks < 1 ||
      chunks > 65535 || (tm != 32 && tm != 64 && tm != 128))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch_tiled<float>(x, lanes, n, d, tm, partial, chunks, g, s);
  if (dtype == REPRO_BF16)
    return launch_tiled<__nv_bfloat16>(x, lanes, n, d, tm, partial, chunks, g, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
