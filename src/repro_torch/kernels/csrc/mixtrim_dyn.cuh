// K2 and K4 · fused NNM mix + coordinate-wise trim / median: the body for
// n <= 64 that both kernels share (K2 with f from the host, K4 with f read
// on the device, one per lane of a (B, n, D) stack).
//
// Replaces, for n <= 64, the TPU kernels repro/kernels/mixtrim/kernel.py::
// mixtrim_pallas (body _make_kernel; K2) and ::mixtrim_dyn_pallas (body
// _make_dyn_kernel; K4).  Per column c of lane b, y = M_b x_b[:, c]
// (skipped without M), sorted with NaN last; then:
//   - "trim", K2 (fdev == nullptr: f is an argument, one lane): the sorted
//     values of ranks [f, n - f) summed in ascending rank, over n - 2f
//     (mixtrim_ref's slice).  A +-inf in a trimmed rank is skipped, and
//     the column is NaN only when it holds more than f NaNs: only then
//     does a NaN reach a kept rank;
//   - "trim", K4 (f read from fdev, one per lane, so one build serves
//     every f): the sum over ALL n ranks of ys[r] * keep[r], keep =
//     (r >= f) & (r < n - f), over max(n - 2f, 1) (mixtrim_dyn_ref's rank
//     mask), so a +-inf or NaN in a trimmed rank gives NaN (inf * 0), and
//     a NaN anywhere in the column makes it NaN;
//   - "med": the median (f unused).
// f <= 0 keeps every rank: the column's sum in index order, no sort.  Which
// trim runs is a runtime flag, uniform over the grid, so one set of
// instances serves both kernels: both sum the kept ranks, and only the
// test that makes a column NaN differs.  At equal f on finite data the two
// agree bit for bit (the mask's other terms are exact zeros added to a sum
// that is never -0).
//
// What bounds it on this card.  At the dense main path's shape (n = 8,
// D = 361,821,120) the bytes (n reads and one fp32 write a column: 3.888 ms
// in fp32, 2.160 in bf16 at 3.35 TB/s) are above the mix's 64 FMAs a
// column; at (8, 17, 2^24) the bytes are 2.9 ms and the mix's 289 FMAs a
// column 1.2 ms.  The first body, which K2 and K4 both ran at first,
// issued far more than that: one shared load per FMA of the mix, a
// bitonic network over the next power of two on uint32 keys (240
// compare-exchanges for 17 values) and per-column arrays in local memory,
// and took the same time in bf16 as in fp32.  This body is designed to
// issue few instructions and to keep every row's loads in flight:
//   - each thread owns C consecutive columns (C = 4 for n <= 8, 2 for
//     n <= 20, else 1), read with one 8- or 16-byte load per row where D
//     and the pointer allow (a scalar path otherwise);
//   - M sits in shared memory with rows padded to a multiple of four and
//     is read as float4 broadcasts: one shared load feeds 4 * C FMAs.
//     Each mixed value's FMA chain runs in ascending j from 0 in fp32;
//   - the sort is Batcher's odd-even merge network cut to the real n
//     (csrc/sortnet.cuh: 85 comparators at n = 17) on fp32 values with
//     fminf / fmaxf.  A NaN is counted and replaced by +inf first: the
//     counted NaNs are the top ranks (torch.sort's NaN-last order), and a
//     median rank among them is NaN;
//   - the instance is compiled per n for n <= 32 (n = 33..48 and 49..64
//     share the 48- and 64-high instances, with +inf pads above n that
//     the cut network never moves), so every register array is indexed
//     by compile-time constants: no local frame.  With one column a
//     thread (n > 20) the mix keeps the stack in registers and stages the
//     mixed rows in shared memory (each thread its own slots), so the
//     stack and the mixed stack are not both live: the 48- and 64-high
//     instances spilled hundreds of bytes without it and took 1.3-1.8x
//     as long;
//   - every row's loads sit in one branch (vector loads, or element by
//     element for a row's last columns), so they all issue before the
//     first bf16 widening waits on one, and before the mix and the
//     sorting network start; with a branch a row each bf16 row waited for
//     its load before the next was issued, and bf16 took longer than fp32;
//   - the block size comes from the caller (32 to 128 threads): the
//     fleet's launch-sized lanes ((5, 17, 2842): 1421 two-column units a
//     lane) took 12 blocks of 128 a lane, 60 blocks on 132 SMs, and now
//     take 45 of 32 (kernels/_common.py::launch_geometry), one unit a
//     thread; a large D keeps 128 threads and one wave of resident
//     blocks.  The SM count comes with the launch, and each block size's
//     occupancy is asked once, so a launch asks the runtime nothing.
//     Each column is one thread's work whatever the geometry: its bits
//     do not depend on it.
#pragma once

#include "common.cuh"
#include "sortnet.cuh"

namespace mixtrim_dyn_detail {

constexpr int THREADS = 128;
constexpr int EXACT_MAX_N = 32;          // instances compiled per n up to here
// Columns a thread owns at n <= 8 in bf16 (one 8-byte load per row at 4).
constexpr int SMALL_C_BF16 = 4;
// Whether the mix instances with one column a thread (n > 20) stage the
// mixed rows in shared memory (else the stack and the mixed stack both sit
// in registers).
constexpr bool STAGE_MIX = true;
// Entries of M a thread loads before storing them to shared memory.
constexpr int M_CHUNK = 16;

// Columns per thread: enough to amortise M's reads, few enough that the
// stack and the mixed stack (2 * N * C values) stay in registers.
__host__ __device__ constexpr int cols_per_thread(int n, int bytes) {
  return n <= 8 ? (bytes == 2 ? SMALL_C_BF16 : 4) : (n <= 20 ? 2 : 1);
}

struct Args {
  const void* x;
  int dtype;
  const float* m;                        // (lanes, n, n) fp32 or NULL
  int lanes, n;
  long long d;
  const int* f;                          // K4: (lanes,) int32 on the device;
                                         // K2: NULL (f in fh, one lane)
  int fh;
  int med;
  float* out;                            // (lanes, d) fp32
  int blocks;                            // column blocks per lane, at most
  cudaStream_t s;
  int threads;                           // per block, 32..THREADS; 0: THREADS
  int sms;                               // the card's SMs; 0: asked at launch
};

// A bf16 (its bits in h) or a pair of them (w, low half first) as fp32:
// a bf16 is the high half of the fp32 of the same value.
__device__ __forceinline__ float widen1(unsigned short h) {
  return __uint_as_float((unsigned)h << 16);
}
__device__ __forceinline__ void widen2(unsigned w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// C consecutive elements from p widened to fp32, by vector loads (16
// bytes at most each; p aligned to C elements).
template <typename T, int C>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[C]) {
  if constexpr (sizeof(T) == 4) {
    const float* q = reinterpret_cast<const float*>(p);
    if constexpr (C == 1) {
      v[0] = __ldg(q);
    } else if constexpr (C == 2) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(q));
      v[0] = t.x; v[1] = t.y;
    } else {
#pragma unroll
      for (int k = 0; k < C; k += 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(q + k));
        v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
      }
    }
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    if constexpr (C == 1) {
      v[0] = widen1(__ldg(h));
    } else if constexpr (C == 2) {
      widen2(__ldg(reinterpret_cast<const unsigned*>(h)), v[0], v[1]);
    } else if constexpr (C == 4) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(h));
      widen2(t.x, v[0], v[1]);
      widen2(t.y, v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < C; k += 8) {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(h + k));
        widen2(t.x, v[k], v[k + 1]);
        widen2(t.y, v[k + 2], v[k + 3]);
        widen2(t.z, v[k + 4], v[k + 5]);
        widen2(t.w, v[k + 6], v[k + 7]);
      }
    }
  }
}

// The first min(left, C) elements from p widened to fp32 one by one (the
// rest 0): a row's last columns, or a stack the vector loads cannot take.
template <typename T, int C>
__device__ __forceinline__ void load_tail(const T* p, long long left,
                                          float (&v)[C]) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    if constexpr (sizeof(T) == 4)
      v[k] = (k < left) ? reinterpret_cast<const float*>(p)[k] : 0.f;
    else
      v[k] = (k < left) ? widen1(reinterpret_cast<const unsigned short*>(p)[k]) : 0.f;
  }
}

template <int C>
__device__ __forceinline__ void store_cols(float* p, long long left, bool vec,
                                           const float (&r)[C]) {
  if (vec && C % 4 == 0 && left >= C) {
#pragma unroll
    for (int k = 0; k < C; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(r[k], r[k + 1], r[k + 2], r[k + 3]);
  } else if (vec && C == 2 && left >= 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (k < left) p[k] = r[k];
  }
}

// Four entries of M from shared memory.  The load is volatile so that it
// stays inside the column loop: hoisted out of it, all of M would sit in
// registers (ptxas spilled kilobytes so for the bf16 n > 20 instances).
__device__ __forceinline__ float4 lds_m4(const float* p) {
  float4 v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

// Row i of the mix for C columns: sum_j M[i, j] y[j], j ascending from 0.
template <int N, int C, int N4>
__device__ __forceinline__ void mix_row(const float* smi,
                                        const float (&y)[N][C],
                                        float (&s)[C]) {
#pragma unroll
  for (int k = 0; k < C; ++k) s[k] = 0.f;
#pragma unroll
  for (int j4 = 0; j4 < N4; j4 += 4) {
    const float4 q = lds_m4(smi + j4);
    const float mq[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (j4 + t < N) {
#pragma unroll
        for (int k = 0; k < C; ++k) s[k] = fmaf(mq[t], y[j4 + t][k], s[k]);
      }
    }
  }
}

// Grid: (column blocks, lanes); blockIdx.y = lane.  N: the compiled
// height (the real n when EXACT).  vec: D and x allow C-wide loads.
// fdev: K4's per-lane f, or NULL for K2 (f = fh, the slice).
template <typename T, int N, bool MIX>
__global__ void __launch_bounds__(THREADS)
mixtrim_dyn_small(const T* __restrict__ x, const float* __restrict__ m,
                  int n, long long d, bool vec, const int* __restrict__ fdev,
                  int fh, int med, float* __restrict__ out) {
  constexpr int C = cols_per_thread(N, sizeof(T));
  constexpr int N4 = (N + 3) & ~3;
  constexpr bool EXACT = N <= EXACT_MAX_N;
  constexpr bool STAGE = MIX && C == 1 && STAGE_MIX;
  const int nr = EXACT ? N : n;
  const int lane = blockIdx.y;
  x += (long long)lane * nr * d;
  out += (long long)lane * d;
  const bool slice = fdev == nullptr;
  const int f = slice ? fh : fdev[lane];
  const int keep_lo = f, keep_hi = nr - f;
  const float denom = (float)max(nr - 2 * f, 1);

  __shared__ __align__(16) float sm[MIX ? N * N4 : 4];
  __shared__ float sz[STAGE ? N * THREADS * C : 1];
  if constexpr (MIX) {
    // M to shared memory, a thread's M_CHUNK loads all issued before its
    // first store: a small block's threads stage many entries each (11 a
    // thread at n = 17 in blocks of 32), and one at a time they cost as
    // much as the column's work.
    m += (long long)lane * nr * nr;
    for (int e0 = 0; e0 < N * N4; e0 += M_CHUNK * (int)blockDim.x) {
      float mv[M_CHUNK];
#pragma unroll
      for (int q = 0; q < M_CHUNK; ++q) {
        const int e = e0 + q * (int)blockDim.x + threadIdx.x;
        const int i = e / N4, j = e - i * N4;
        mv[q] = (e < N * N4 && i < nr && j < nr) ? __ldg(m + i * nr + j) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < M_CHUNK; ++q) {
        const int e = e0 + q * (int)blockDim.x + threadIdx.x;
        if (e < N * N4) sm[e] = mv[q];
      }
    }
    __syncthreads();
  }

  const long long stride = (long long)gridDim.x * blockDim.x * C;
  for (long long c0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * C;
       c0 < d; c0 += stride) {
    const long long left = d - c0;
    // Every row's loads sit in one branch, so all of them issue before the
    // first bf16 widening waits on one: behind a branch a row, each row's
    // widening would hold back the next row's load.  Above 32 workers the
    // pad rows re-read row n - 1 (a cache hit) and are zeroed after.
    float y[N][C];
    if (vec && left >= C) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        load_vec<T, C>(x + (long long)(EXACT ? i : min(i, nr - 1)) * d + c0, y[i]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i)
        load_tail<T, C>(x + (long long)(EXACT ? i : min(i, nr - 1)) * d + c0,
                        left, y[i]);
    }
    if constexpr (!EXACT) {
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int k = 0; k < C; ++k)
          if (i >= nr) y[i][k] = 0.f;
    }
    if constexpr (STAGE) {
      // Each mixed row to this thread's own shared slots (no conflicts,
      // no barrier), then back over the stack once every row is mixed.
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float s[C];
        mix_row<N, C, N4>(&sm[i * N4], y, s);
#pragma unroll
        for (int k = 0; k < C; ++k) sz[(i * C + k) * THREADS + threadIdx.x] = s[k];
      }
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int k = 0; k < C; ++k) y[i][k] = sz[(i * C + k) * THREADS + threadIdx.x];
    } else if constexpr (MIX) {
      float z[N][C];
#pragma unroll
      for (int i = 0; i < N; ++i) mix_row<N, C, N4>(&sm[i * N4], y, z[i]);
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int k = 0; k < C; ++k) y[i][k] = z[i][k];
    }

    float r[C];
    if (!med && f <= 0) {
      // Every rank kept: the sum in index order, no sort needed.
#pragma unroll
      for (int k = 0; k < C; ++k) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i)
          if (EXACT || i < nr) s += y[i][k];
        r[k] = s / denom;
      }
    } else {
      int nans[C];
#pragma unroll
      for (int k = 0; k < C; ++k) nans[k] = 0;
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const float v = y[i][k];
          const bool pad = !EXACT && i >= nr;
          nans[k] += (!pad && isnan(v)) ? 1 : 0;
          y[i][k] = (pad || isnan(v)) ? __int_as_float(0x7f800000) : v;
        }
      sortnet::sort_net<N, C>(y);
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (med) {
          // Ranks nr - nans .. nr - 1 hold the NaNs.
          const int rlo = (nr - 1) / 2, rhi = nr / 2;
          float lo = 0.f, hi = 0.f;
#pragma unroll
          for (int i = 0; i < N; ++i) {
            if (i == rlo) lo = y[i][k];
            if (i == rhi) hi = y[i][k];
          }
          if (rlo >= nr - nans[k]) lo = __int_as_float(0x7fffffff);
          if (rhi >= nr - nans[k]) hi = __int_as_float(0x7fffffff);
          r[k] = (nr & 1) ? hi : 0.5f * (lo + hi);
        } else {
          // The kept ranks [f, n - f) in ascending order.
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < N; ++i)
            if ((EXACT || i < nr) && i >= keep_lo && i < keep_hi) s += y[i][k];
          // K2's slice is NaN once a NaN reaches a kept rank: more than f
          // NaNs.  K4's mask adds ys[r] * 0 for each trimmed rank, NaN for
          // a NaN or an inf there; f >= 1 trims rank 0 and rank n - 1, so
          // that is a -inf at rank 0 or a +inf (a NaN counts as one) at
          // rank n - 1.  Its other terms are exact zeros added to a sum
          // that is never -0: the same bits as the slice.
          bool bad;
          if (slice) {
            bad = nans[k] > f;
          } else {
            float top = y[N - 1][k];
            if constexpr (!EXACT) {
#pragma unroll
              for (int i = 0; i < N; ++i)
                if (i == nr - 1) top = y[i][k];
            }
            bad = y[0][k] == -__int_as_float(0x7f800000) ||
                  top == __int_as_float(0x7f800000);
          }
          r[k] = bad ? __int_as_float(0x7fffffff) : s / denom;
        }
      }
    }
    store_cols<C>(out + c0, left, vec, r);
  }
}

template <typename T, int N, bool MIX>
int launch_typed(const Args& a) {
  constexpr int C = cols_per_thread(N, sizeof(T));
  auto kernel = mixtrim_dyn_small<T, N, MIX>;
  const int threads = a.threads > 0 ? a.threads : THREADS;
  if (threads % 32 || threads > THREADS) return cudaErrorInvalidValue;
  // Resident blocks per SM at 32, 64 and 128 threads, asked once each.
  static int per_sm[THREADS / 32 + 1] = {};
  int& occ = per_sm[threads / 32];
  if (occ == 0) {
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, 0);
    if (err != cudaSuccess) return err;
  }
  int sms = a.sms;
  if (sms <= 0) {                        // K2's entry: asked here
    int dev = 0;
    cudaGetDevice(&dev);
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  // At most one wave of resident blocks, each walking an equal share of
  // columns; a launch-sized lane gets what the caller's geometry gives it
  // (kernels/_common.py::launch_geometry: small blocks, one unit a thread).
  const long long need = (a.d + (long long)threads * C - 1) / ((long long)threads * C);
  const long long wave = (long long)occ * sms / a.lanes > 0 ? (long long)occ * sms / a.lanes : 1;
  long long grid = need < a.blocks ? need : a.blocks;
  if (grid > wave) grid = wave;
  kernel<<<dim3((unsigned)grid, a.lanes), threads, 0, a.s>>>(
      static_cast<const T*>(a.x), a.m, a.n, a.d,
      a.d % C == 0 && reinterpret_cast<uintptr_t>(a.x) % (C * sizeof(T)) == 0,
      a.f, a.fh, a.med, a.out);
  return cudaGetLastError();
}

template <typename T, int N>
int launch_dtype(const Args& a) {
  return a.m ? launch_typed<T, N, true>(a) : launch_typed<T, N, false>(a);
}

// The n <= 64 launch at compiled height N; instantiated in
// mixtrim_dyn_n*.cu so that nvcc builds the heights in parallel.
template <int N>
int launch_n(const Args& a) {
  if (a.dtype == REPRO_F32) return launch_dtype<float, N>(a);
  if (a.dtype == REPRO_BF16) return launch_dtype<__nv_bfloat16, N>(a);
  return cudaErrorInvalidValue;
}

// n <= 64 for K2 (a.f NULL, one lane) and K4: the launch at the height
// for a.n (defined in mixtrim_dyn.cu).
int launch_small(const Args& a);

}  // namespace mixtrim_dyn_detail
