// K4 · fused NNM mix + coordinate-wise trim / median with f read on the
// device, one per lane of a (B, n, D) stack: the body for n <= 64.
//
// Replaces the TPU kernel repro/kernels/mixtrim/kernel.py::
// mixtrim_dyn_pallas (body _make_dyn_kernel).  Semantics are those of
// mixtrim_dyn_ref (kernels/mixtrim/ops.py): per column c of lane b,
// y = M_b x_b[:, c] (skipped without M), sorted with NaN last; "trim" is
// the sum over ALL n ranks of ys[r] * keep[r], keep = (r >= f) &
// (r < n - f), over max(n - 2f, 1), so a +-inf or NaN in a trimmed rank
// gives NaN (inf * 0); "med" is the median and ignores f.  f is read from
// device memory, so one build serves every f.
//
// What bounds it on this card.  At (8, 17, 2^24) the bytes (9.7 GB, 2.9 ms
// at 3.35 TB/s) and the mix's 289 FMAs a column (1.2 ms) are below what
// the earlier body (K2's with f on the device) issued: one shared load
// per FMA of the mix, a 32-high bitonic network (240 compare-exchanges on
// uint32 keys for 17 values) and per-column arrays in local memory.  This
// body is bound by instruction issue and is designed to issue few:
//   - each thread owns C consecutive columns (C = 4 for n <= 8, 2 for
//     n <= 20, else 1), read with one 8- or 16-byte load per row where D
//     and the pointer allow (a scalar path otherwise);
//   - M sits in shared memory with rows padded to a multiple of four and
//     is read as float4 broadcasts: one shared load feeds 4 * C FMAs.
//     Each mixed value's FMA chain runs in ascending j from 0 in fp32, as
//     K2's does, so at equal f K4 and K2 mix to the same bits;
//   - the sort is Batcher's odd-even merge network cut to the real n
//     (csrc/sortnet.cuh: 85 comparators at n = 17) on fp32 values with
//     fminf / fmaxf.  A NaN is counted and replaced by +inf first: the
//     counted NaNs are the top ranks (torch.sort's NaN-last order), a trim
//     over a column with a NaN is NaN whatever f is, and a median rank
//     among the top ones is NaN;
//   - the instance is compiled per n for n <= 32 (n = 33..48 and 49..64
//     share the 48- and 64-high instances, with +inf pads above n that
//     the cut network never moves), so every register array is indexed
//     by compile-time constants: no local frame.
// f <= 0 keeps every rank: the column's sum in index order, no sort, as
// K2 does at f = 0.
#pragma once

#include "common.cuh"
#include "sortnet.cuh"

namespace mixtrim_dyn_detail {

constexpr int THREADS = 128;
constexpr int EXACT_MAX_N = 32;          // instances compiled per n up to here

// Columns per thread: enough to amortise M's reads, few enough that the
// stack and the mixed stack (2 * N * C values) stay in registers.
__host__ __device__ constexpr int cols_per_thread(int n) {
  return n <= 8 ? 4 : (n <= 20 ? 2 : 1);
}

struct Args {
  const void* x;
  int dtype;
  const float* m;                        // (lanes, n, n) fp32 or NULL
  int lanes, n;
  long long d;
  const int* f;                          // (lanes,) int32 on the device
  int med;
  float* out;                            // (lanes, d) fp32
  int blocks;                            // column blocks per lane, at most
  cudaStream_t s;
};

// C consecutive elements from p (left = columns remaining in the row),
// widened to fp32; vec: one 4 * C- (fp32) or 2 * C-byte (bf16) load.
template <typename T, int C>
__device__ __forceinline__ void load_cols(const T* p, long long left,
                                          bool vec, float (&v)[C]) {
  if (vec && left >= C) {
    if constexpr (C == 1) {
      v[0] = to_f32(__ldg(p));
    } else if constexpr (sizeof(T) == 4 && C == 4) {
      load4(reinterpret_cast<const float*>(p), v);
    } else if constexpr (sizeof(T) == 4 && C == 2) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = q.x; v[1] = q.y;
    } else if constexpr (C == 4) {
      load4(reinterpret_cast<const __nv_bfloat16*>(p), v);
    } else {
      const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(p));
      const float2 q =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
      v[0] = q.x; v[1] = q.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < C; ++k) v[k] = (k < left) ? to_f32(p[k]) : 0.f;
  }
}

template <int C>
__device__ __forceinline__ void store_cols(float* p, long long left, bool vec,
                                           const float (&r)[C]) {
  if (vec && C == 4 && left >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
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

// Grid: (column blocks, lanes); blockIdx.y = lane.  N: the compiled
// height (the real n when EXACT).  vec: D and x allow C-wide loads.
template <typename T, int N, bool MIX>
__global__ void __launch_bounds__(THREADS)
mixtrim_dyn_small(const T* __restrict__ x, const float* __restrict__ m,
                  int n, long long d, bool vec, const int* __restrict__ fdev,
                  int med, float* __restrict__ out) {
  constexpr int C = cols_per_thread(N);
  constexpr int N4 = (N + 3) & ~3;
  constexpr bool EXACT = N <= EXACT_MAX_N;
  const int nr = EXACT ? N : n;
  const int lane = blockIdx.y;
  x += (long long)lane * nr * d;
  out += (long long)lane * d;
  const int f = fdev[lane];
  const int keep_lo = f, keep_hi = nr - f;
  const float denom = (float)max(nr - 2 * f, 1);

  __shared__ __align__(16) float sm[MIX ? N * N4 : 4];
  if constexpr (MIX) {
    m += (long long)lane * nr * nr;
    for (int e = threadIdx.x; e < N * N4; e += THREADS) {
      const int i = e / N4, j = e - i * N4;
      sm[e] = (i < nr && j < nr) ? m[i * nr + j] : 0.f;
    }
    __syncthreads();
  }

  const long long stride = (long long)gridDim.x * THREADS * C;
  for (long long c0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * C;
       c0 < d; c0 += stride) {
    const long long left = d - c0;
    float y[N][C];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (EXACT || i < nr) {
        load_cols<T, C>(x + (long long)i * d + c0, left, vec, y[i]);
      } else {
#pragma unroll
        for (int k = 0; k < C; ++k) y[i][k] = 0.f;
      }
    }
    if constexpr (MIX) {
      float z[N][C];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float s[C];
#pragma unroll
        for (int k = 0; k < C; ++k) s[k] = 0.f;
#pragma unroll
        for (int j4 = 0; j4 < N4; j4 += 4) {
          const float4 q = lds_m4(&sm[i * N4 + j4]);
          const float mq[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (j4 + t < N) {
#pragma unroll
              for (int k = 0; k < C; ++k) s[k] = fmaf(mq[t], y[j4 + t][k], s[k]);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < C; ++k) z[i][k] = s[k];
      }
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
          // The rank mask over every real rank: inf * 0 = NaN is kept,
          // and a NaN anywhere in the column makes the sum NaN.
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < N; ++i)
            if (EXACT || i < nr)
              s += y[i][k] * ((i >= keep_lo && i < keep_hi) ? 1.f : 0.f);
          r[k] = nans[k] ? __int_as_float(0x7fffffff) : s / denom;
        }
      }
    }
    store_cols<C>(out + c0, left, vec, r);
  }
}

template <typename T, int N, bool MIX>
int launch_typed(const Args& a) {
  constexpr int C = cols_per_thread(N);
  auto kernel = mixtrim_dyn_small<T, N, MIX>;
  static int per_sm = 0;                 // resident blocks per SM
  if (per_sm == 0) {
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // One wave of resident blocks, each walking an equal share of columns.
  const long long need = (a.d + (long long)THREADS * C - 1) / ((long long)THREADS * C);
  const long long wave = per_sm * sms / a.lanes > 0 ? per_sm * sms / a.lanes : 1;
  long long grid = need < a.blocks ? need : a.blocks;
  if (grid > wave) grid = wave;
  kernel<<<dim3((unsigned)grid, a.lanes), THREADS, 0, a.s>>>(
      static_cast<const T*>(a.x), a.m, a.n, a.d,
      a.d % C == 0 && reinterpret_cast<uintptr_t>(a.x) % (C * sizeof(T)) == 0,
      a.f, a.med, a.out);
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

}  // namespace mixtrim_dyn_detail
