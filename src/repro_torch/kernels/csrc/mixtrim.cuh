// K2 · fused NNM mix + coordinate-wise trimmed mean / median, static f:
// the kernels above 1024 workers, and the launch arguments and NaN-last
// keys shared with the bodies for fewer workers.
//
// Replaces the TPU kernel repro/kernels/mixtrim/kernel.py::mixtrim_pallas
// (body _make_kernel).  Per column c of a (n, D) stack it computes
// y = M x[:, c] (skipped when M is absent), sorts y along the worker axis
// and reduces it to the mean of ranks [f, n-f) ("trim"; the plain mean
// when f == 0) or the median ("med"), writing one fp32 value.  Values sort
// with every NaN last, the order torch.sort and jnp.sort give, so n = 17
// and the nan / inf attack stacks take the same ranks as the plain
// version; the TPU kernel's fp32-max sentinel would sort below +inf.
//
// K2 routes by n (mixtrim.cu), sharing each body with K4 (f on the device):
//   - n <= 64: csrc/mixtrim_dyn.cuh, one body for K2 and K4 (C columns a
//     thread, M read as float4 shared broadcasts, Batcher's network cut to
//     the real n, compiled per n to 32 and at 48 and 64; K2 passes f as
//     an argument and takes the slice of ranks [f, n - f), K4 the rank
//     mask);
//   - 64 < n <= 1024: csrc/mixtrim_select.cuh (a register-tiled mix and a
//     rank selection);
//   - n > 1024 (mixtrim_big below, up to MAX_N = 16384).
//
// Bound on this card: bytes (n*D reads, D fp32 writes; ~2n FLOP per read
// element for the mix plus the sort) for small n; the mix's 2n^2 FLOP
// per column take over as n grows.
//
// mixtrim_big: n values per column no longer fit in registers.  A block
// takes a tile of TC columns (TC * NP <= 16384 keys, NP the next power of
// two >= n, at most 64 columns), stages it in shared memory — rows read TC
// consecutive columns at a time, so a warp's loads coalesce — and sorts
// order-preserving uint32 keys (every NaN above +inf, the NP - n pad keys
// above every NaN) with a shared-memory bitonic network, all TC columns at
// once.  With a mix, the X tile is staged as fp32 and one warp per output
// row reads M's row (coalesced, through L1/L2) against it; Y exists only
// as the tile's keys, never in global memory.  Both shared arrays use an
// odd pitch so that column-strided accesses hit distinct banks.
//
// K4 above 1024 workers is mixtrim_big with DYN = true, replacing
// repro/kernels/mixtrim/kernel.py::mixtrim_dyn_pallas (body
// _make_dyn_kernel) there: f is a runtime int32 read on the device, one
// per lane of a (B, n, D) stack (grid: column blocks x lanes, blockIdx.y =
// lane, each lane with its own optional (n, n) M), so one build serves
// every f and the host never reads f.  The trim is the reference's rank
// mask: the sum over ALL n real ranks of ys[r] * keep[r], keep = (r >= f)
// & (r < n - f), divided by max(n - 2f, 1).  A +-inf or NaN in a trimmed
// rank therefore makes the column NaN (inf * 0), as mixtrim_dyn_ref does,
// where K2's slice [f, n - f) would skip it; f >= n/2 keeps nothing and
// gives 0 (or NaN).  The pad keys lie at ranks >= n and are never read.
// "med" ignores f.
#pragma once

#include "common.cuh"

namespace mixtrim_detail {

constexpr int SMALL_N = 64;            // limit of csrc/mixtrim_dyn.cuh's body
constexpr int MAX_N = 16384;           // shared-memory kernel limit
constexpr int BIG_THREADS = 512;
constexpr int KEY_BUDGET = 16384;      // keys per block tile
constexpr int MAX_TC = 64;             // columns per block tile
constexpr unsigned NAN_KEY = 0xFFFFFFFEu;
constexpr unsigned PAD_KEY = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned key_of(float v) {
  if (isnan(v)) return NAN_KEY;
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// NAN_KEY decodes to a NaN bit pattern (0x7FFFFFFE); PAD_KEY is never read.
__device__ __forceinline__ float val_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// Columns per tile for a sort of height np (a power of two).
inline int big_tc(int np) {
  int tc = KEY_BUDGET / np;
  if (tc < 1) tc = 1;
  if (tc > MAX_TC) tc = MAX_TC;
  return tc;
}

inline size_t big_smem(int n, int np, int tc, bool mix) {
  return sizeof(unsigned) * (size_t)tc * (np + 1) +
         (mix ? sizeof(float) * (size_t)tc * (n | 1) : 0);
}

template <typename T, bool MIX, bool DYN>
__global__ void __launch_bounds__(BIG_THREADS)
mixtrim_big(const T* __restrict__ x, const float* __restrict__ m, int n,
            int np, int tc, long long d, int f, const int* __restrict__ fdev,
            int med, float* __restrict__ out) {
  if constexpr (DYN) {                   // this lane's stack, M, f, output
    x += (long long)blockIdx.y * n * d;
    if constexpr (MIX) m += (long long)blockIdx.y * n * n;
    out += (long long)blockIdx.y * d;
    f = fdev[blockIdx.y];
  }
  extern __shared__ unsigned smem_keys[];
  const int kp = np + 1;                 // odd key pitch
  const int xp = n | 1;                  // odd staging pitch
  unsigned* keys = smem_keys;            // tc columns x kp
  float* xs = reinterpret_cast<float*>(keys + (size_t)tc * kp);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int WARPS = BIG_THREADS / 32;
  const int half = np >> 1;
  const int lh = 31 - __clz(half);
  const long long tiles = (d + tc - 1) / tc;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long c0 = t * tc;
    const int w = (int)min((long long)tc, d - c0);
    // 1. Stage the tile: consecutive threads on consecutive columns.
    for (int e = threadIdx.x; e < n * tc; e += BIG_THREADS) {
      const int i = e / tc, c = e - i * tc;
      const float v = (c < w) ? to_f32(x[(long long)i * d + c0 + c]) : 0.f;
      if constexpr (MIX) xs[c * xp + i] = v;
      else keys[c * kp + i] = key_of(v);
    }
    for (int e = threadIdx.x; e < (np - n) * tc; e += BIG_THREADS) {
      const int c = e / (np - n), i = n + (e - c * (np - n));
      keys[c * kp + i] = PAD_KEY;
    }
    __syncthreads();
    // 2. Mix: one warp per output row i, lanes over j, four columns at once.
    if constexpr (MIX) {
      for (int i = warp; i < n; i += WARPS) {
        const float* mrow = m + (long long)i * n;
        for (int cb = 0; cb < tc; cb += 4) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int j = lane; j < n; j += 32) {
            const float mij = __ldg(mrow + j);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (cb + k < tc) acc[k] = fmaf(mij, xs[(cb + k) * xp + j], acc[k]);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
          }
          if (lane == 0) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (cb + k < tc) keys[(cb + k) * kp + i] = key_of(acc[k]);
          }
        }
      }
      __syncthreads();
    }
    // 3. Bitonic sort of every column of the tile (the plain mean needs none).
    if (med || f > 0) {
      for (int k = 2; k <= np; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int e = threadIdx.x; e < tc * half; e += BIG_THREADS) {
            const int c = e >> lh, p = e & (half - 1);
            const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
            unsigned* col = keys + c * kp;
            const unsigned a = col[i], b = col[i | j];
            if ((a > b) == ((i & k) == 0)) { col[i] = b; col[i | j] = a; }
          }
          __syncthreads();
        }
      }
    }
    // 4. One warp per column: trimmed mean over ranks [f, n - f) or median.
    for (int c = warp; c < w; c += WARPS) {
      const unsigned* col = keys + c * kp;
      if (med) {
        if (lane == 0) {
          const float lo = val_of(col[(n - 1) / 2]), hi = val_of(col[n / 2]);
          out[c0 + c] = (n & 1) ? hi : 0.5f * (lo + hi);
        }
      } else if constexpr (DYN) {
        // The rank mask over every real rank (unsorted when f <= 0: the
        // sum is the same set of values).
        float s = 0.f;
        for (int r = lane; r < n; r += 32)
          s += val_of(col[r]) * ((r >= f && r < n - f) ? 1.f : 0.f);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) out[c0 + c] = s / (float)max(n - 2 * f, 1);
      } else {
        float s = 0.f;
        for (int r = f + lane; r < n - f; r += 32) s += val_of(col[r]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) out[c0 + c] = s / (float)(n - 2 * f);
      }
    }
    __syncthreads();                     // the next tile reuses the arrays
  }
}

// Launch arguments of the bodies above 64 workers, shared by K2 (lanes =
// 1, f on the host, fdev NULL) and K4 (lanes >= 1, fdev = the (lanes,) int32 f on the
// device).
struct Args {
  const void* x;                         // (lanes, n, d) of dtype
  int dtype;
  const float* m;                        // (lanes, n, n) fp32 or NULL
  float* mt;                             // scratch for M^T (mixtrim_select)
  int lanes, n;
  long long d;
  int f;
  const int* fdev;
  int med;
  float* out;                            // (lanes, d) fp32
  int blocks;                            // column blocks per lane, at most
  cudaStream_t s;
};

template <typename T, bool MIX, bool DYN>
int launch_big(const T* x, const Args& a) {
  int np = 128;
  while (np < a.n) np <<= 1;
  const int tc = big_tc(np);
  const size_t smem = big_smem(a.n, np, tc, MIX);
  cudaError_t err = cudaFuncSetAttribute(
      mixtrim_big<T, MIX, DYN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (a.d + tc - 1) / tc;
  const int grid = (int)(tiles < a.blocks ? tiles : a.blocks);
  mixtrim_big<T, MIX, DYN><<<dim3(grid, a.lanes), BIG_THREADS, smem, a.s>>>(
      x, a.m, a.n, np, tc, a.d, a.f, a.fdev, a.med, a.out);
  return cudaGetLastError();
}

// n > 1024: mixtrim_big, for K2 (DYN = false, f in a.f) and K4 (DYN =
// true, f per lane in a.fdev).
template <typename T, bool DYN>
int launch_large(const Args& a) {
  const T* x = static_cast<const T*>(a.x);
  if (a.m) return launch_big<T, true, DYN>(x, a);
  return launch_big<T, false, DYN>(x, a);
}

}  // namespace mixtrim_detail

// 64 < n <= 1024, for K2 and K4 alike: the register-tiled mix and the
// rank selection of csrc/mixtrim_select.cuh (entry point in
// mixtrim_select.cu).
namespace mixtrim_select {
constexpr int MAX_N = 1024;
int launch(const mixtrim_detail::Args& a);
}  // namespace mixtrim_select
