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
// 1/|bucket|), so this kernel does n FMAs per column instead of n_b * n.
// It walks a plan: `order`, the workers sorted by bucket (stable, so each
// bucket's members come in worker order), the bucket offsets `start` and
// each position's weight.  The wrapper builds the plan from bucket ids
// (kernels/bucketgram/ops.py::plan_arrays), or hands over each lane's
// permutation and the bucket size s and the register path builds it in
// each block's prologue (stage_plan): bucket k holds the workers at
// permutation positions [k s, k s + s), sorted, weights 1 / their count
// (the ragged tail's included).  So the fleet's call reads nothing back
// and runs no torch op but its outputs' allocations.
//
// Non-finite semantics of the dense contraction: 0 * inf = NaN, so in the
// dense B @ X a non-finite X[i, c] makes EVERY bucket other than i's NaN
// in column c (and its own bucket inf or NaN by the usual sums).  Skipping
// B's zeros would lose that, so each thread tracks, per column, which
// bucket holds its non-finite values (none / one / several) and writes NaN
// to every other bucket.  B's exact zeros change nothing finite.
//
// Bound on this card: bytes (n*D reads, n_b*D writes of the stack dtype;
// ~2 FLOP per read element for the means, n_b + 1 more per column for the
// Gram).  Its callers give it the trainer's stacks, of hundreds of
// millions of columns, the fleet's (8, 17, 2^24) lanes, and the grid's
// launch-sized lanes ((5, 17, 2842): 0.97 MB, a 0.3 us bound).  The first
// body read one row at a time inside a runtime loop a bucket, 8 bytes a
// row in bf16, so few bytes were in flight: bf16 took 84 % of fp32's time
// (36 % of its bound).  The register path (bucket_reg) therefore:
//   - loads each row segment as wide as D and the row starts allow: V =
//     8 bf16 or 4 fp32 columns (16 bytes), else 4 / 2 / 1 elements (the
//     wrapper picks V; this file refuses one the pointers do not allow);
//   - walks the plan's n positions in groups of G = 8: a group's row
//     loads are in flight before its first fmaf, whatever the bucket
//     boundaries inside it (24 a group, tried for the 8-byte rows of the
//     grid's lanes, took 15 % longer there).  The plan sits in shared memory (each position's row,
//     weight and bucket), so no load waits on another load from device
//     memory;
//   - keeps one running sum a column; at each bucket boundary the sum is
//     that bucket's mean (stored, or kept in registers for the Gram) and
//     restarts from 0, so each column's fmaf chain over its bucket's
//     members runs in worker order from 0, as before: the means' bits do
//     not change, nor depend on V, G or the geometry;
//   - takes its block size and column blocks from the wrapper
//     (kernels/_common.py::launch_geometry: a launch-sized lane spreads
//     over the card one unit a thread; a large D keeps 256 threads, 128
//     with the Gram, and 16 blocks an SM).  The lane count does not enter,
//     so lane b equals the single-lane kernel on lane b bit for bit.
//
// Gram fold:
//   * n_b <= 8 (the trainer's shape, the fleet's s = 3): the 36
//     upper-triangle sums of the thread's finished fp32 columns are
//     folded into its shared-memory slots (its registers hold the 8
//     buckets' means; blocks of up to 128 threads, so that more of them
//     fit an SM's registers); a fixed-order shuffle + shared-memory
//     reduction writes
//     one partial per block and bucketgram_reduce sums the partials in
//     block order, so runs are bitwise repeatable.  A thread's partial
//     folds its V columns in order: the Gram's bits depend on V and the
//     geometry (the same for a lane and its single-lane launch);
//   * n_b > 8: per-block (n_b, n_b) partials do not fit, so this file only
//     writes the means (fp32 into yf for a bf16 stack) and the wrapper
//     folds G from them with K1 / K5 (a second launch, counted by their
//     own counters).
// Up to MEANS_NB buckets the means without the register Gram take the
// register path too (each bucket's mean stored as it finishes, NaN
// written over after the column's last bucket when a non-finite value
// asks for it).  Above it, or above REG_MAX_N workers (the plan's
// shared memory), bucket_any runs a thread per (bucket, column group), so
// a small D with many buckets (the reference's scale shapes: 640 buckets)
// still fills the card.
//
// Lane axis (the fleet's form: bucketgram_pallas under jax.vmap, one call
// per bucket-round): a (B, n, D) stack with each lane's own plan;
// blockIdx.y carries the lane, and every kernel below offsets its pointers
// by it, so a single stack is lane 0 of a one-lane launch.  The non-finite
// spread reads and writes lane b only, so a NaN in one lane never reaches
// another.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;                // largest block
constexpr int NB = 8;                       // register-Gram bucket limit
constexpr int NPAIR = NB * (NB + 1) / 2;    // upper-triangle Gram entries
constexpr int MEANS_NB = 16;                // register path without the Gram

constexpr int REG_MAX_N = 4096;             // register path's largest n
constexpr int G = 8;                        // plan positions in flight

// V elements of T (V * sizeof(T) bytes, aligned to it) as raw words.
template <typename T, int V>
struct Raw {
  static constexpr int WORDS = (V * (int)sizeof(T) + 3) / 4;
  unsigned w[WORDS];
};

template <typename T, int V>
__device__ __forceinline__ void load_raw(const T* p, Raw<T, V>& r) {
  constexpr int BYTES = V * (int)sizeof(T);
  if constexpr (BYTES == 16) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = t.x; r.w[1] = t.y; r.w[2] = t.z; r.w[3] = t.w;
  } else if constexpr (BYTES == 8) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = t.x; r.w[1] = t.y;
  } else if constexpr (BYTES == 4) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// The V elements as fp32 (a bf16 is the high half of the fp32 of the
// same value: exact).
template <typename T, int V>
__device__ __forceinline__ void widen(const Raw<T, V>& r, float (&f)[V]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = __uint_as_float(r.w[k]);
  } else if constexpr (V == 1) {
    f[0] = __uint_as_float(r.w[0] << 16);
  } else {
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      f[2 * k] = __uint_as_float(r.w[k] << 16);
      f[2 * k + 1] = __uint_as_float(r.w[k] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// V fp32 values to p as T (round to nearest even for bf16), by one store
// of V * sizeof(T) bytes, or two of 16 for 8 fp32 values.
template <typename T, int V>
__device__ __forceinline__ void store_vals(T* p, const float (&v)[V]) {
  if constexpr (sizeof(T) == 4) {
    float* q = reinterpret_cast<float*>(p);
    if constexpr (V >= 4) {
#pragma unroll
      for (int k = 0; k < V; k += 4)
        *reinterpret_cast<float4*>(q + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(q) = make_float2(v[0], v[1]);
    } else {
      q[0] = v[0];
    }
  } else {
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(p) =
          make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                     pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(p) =
          make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
    } else if constexpr (V == 2) {
      *reinterpret_cast<unsigned*>(p) = pack_bf16x2(v[0], v[1]);
    } else {
      *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16(v[0]);
    }
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Which bucket holds a column's non-finite values: -1 none, b one bucket,
// -2 several (as each value of bucket b would note it).
__device__ __forceinline__ int note(int bad, int b) {
  return (bad == -1 || bad == b) ? b : -2;
}

__device__ __forceinline__ int clamp_row(long long v, int n) {
  return (int)(v < 0 ? 0 : v >= n ? n - 1 : v);
}

// The plan of this block's lane in shared memory: so[p] the row at
// position p, sw[p] its weight, sb[p] its bucket.  From the permutation
// (s > 0: bucket k holds the workers at permutation positions [k s, k s
// + s), in worker order, weight 1 / their count; a worker's slot is its
// rank in the bucket, ties by position, and a value outside [0, n) is
// clamped to a row, so every slot is written once and names a row even
// for a malformed permutation) or from the wrapper's order / start /
// weight (s == 0).
__device__ __forceinline__ void stage_plan(const long long* __restrict__ perm,
                                           int s, const int* __restrict__ order,
                                           const int* __restrict__ start,
                                           const float* __restrict__ weight,
                                           int n, int nb, int* so, float* sw,
                                           int* sb) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (s > 0) {
    int* sp = sb;                        // the permutation, for the ranks
    for (int j = tid; j < n; j += nt) {
      sp[j] = clamp_row(perm[j], n);
    }
    __syncthreads();
    for (int j = tid; j < n; j += nt) {
      const int lo = j / s * s, hi = min(lo + s, n), v = sp[j];
      int rank = 0;
      for (int q = lo; q < hi; ++q) {
        const int u = sp[q];
        rank += (u < v || (u == v && q < j)) ? 1 : 0;
      }
      so[lo + rank] = v;
    }
    __syncthreads();
    for (int p = tid; p < n; p += nt) {
      const int lo = p / s * s;
      sb[p] = p / s;
      sw[p] = 1.0f / (float)(min(lo + s, n) - lo);
    }
  } else {
    for (int p = tid; p < n; p += nt) {
      so[p] = order[p];
      sw[p] = weight[p];
    }
    for (int b = tid; b < nb; b += nt)
      for (int p = start[b], e = start[b + 1]; p < e; ++p) sb[p] = b;
  }
  __syncthreads();
}

// The register path: one thread a unit of V columns, the lane's plan in
// shared memory (stage_plan).  GRAM (n_b <= 8): every bucket's means in
// registers, the NaN spread, the means stored and the Gram's NPAIR sums
// folded into the thread's shared-memory slots at the column's end (kept
// out of registers: with them the bf16 instances held one block an SM).
// Else (n_b <= MEANS_NB): each bucket's mean stored as it finishes (also
// as fp32 into yf when given), NaN written over afterwards where the
// spread asks for it.  Dynamic shared memory: 12 n bytes, and with GRAM
// 4 NPAIR blockDim.x more.
template <typename T, int V, bool GRAM>
__global__ void __launch_bounds__(THREADS)
bucket_reg(const T* __restrict__ x, int n, long long d,
           const long long* __restrict__ perm, int s,
           const int* __restrict__ order, const int* __restrict__ start,
           const float* __restrict__ weight, int nb, T* __restrict__ y,
           float* __restrict__ yf, float* __restrict__ partial) {
  constexpr int NA = GRAM ? NB : 1;
  extern __shared__ __align__(16) int shm[];
  const long long lane = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  x += lane * n * d;
  if (perm) perm += lane * n;
  if (order) {
    order += lane * n;
    weight += lane * n;
    start += lane * (nb + 1);
  }
  y += lane * nb * d;
  if (yf) yf += lane * nb * d;
  if constexpr (GRAM) partial += lane * gridDim.x * NPAIR;
  int* so = shm;
  float* sw = reinterpret_cast<float*>(shm + n);
  int* sb = shm + 2 * n;
  float* sg = reinterpret_cast<float*>(shm + 3 * n);  // [NPAIR][nt], GRAM
  if constexpr (GRAM)
    for (int e = 0; e < NPAIR; ++e) sg[e * nt + tid] = 0.f;
  stage_plan(perm, s, order, start, weight, n, nb, so, sw, sb);

  const long long units = d / V;
  const long long stride = (long long)gridDim.x * nt;
  for (long long u = (long long)blockIdx.x * nt + tid; u < units;
       u += stride) {
    const long long col = u * V;
    float acc[NA][V];
    float cur[V];
    bool nf[V];
    int bad[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      cur[k] = 0.f;
      nf[k] = false;
      bad[k] = -1;
#pragma unroll
      for (int a = 0; a < NA; ++a) acc[a][k] = 0.f;
    }
    int b = 0;                          // the bucket of the running sums
    // Bucket b is complete: note its non-finite values, keep or store its
    // means, restart the sums.
    auto finish = [&]() {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (nf[k]) bad[k] = note(bad[k], b);
      if constexpr (GRAM) {
#pragma unroll
        for (int a = 0; a < NA; ++a)
          if (a == b)
#pragma unroll
            for (int k = 0; k < V; ++k) acc[a][k] = cur[k];
      } else {
        store_vals<T, V>(y + (long long)b * d + col, cur);
        if (yf) store_vals<float, V>(yf + (long long)b * d + col, cur);
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        cur[k] = 0.f;
        nf[k] = false;
      }
    };
    for (int p0 = 0; p0 < n; p0 += G) {
      Raw<T, V> r[G];
#pragma unroll
      for (int q = 0; q < G; ++q)
        if (p0 + q < n)
          load_raw<T, V>(x + (long long)so[p0 + q] * d + col, r[q]);
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const int p = p0 + q;
        if (p < n) {
          const int bp = sb[p];
          while (b < bp) {               // empty buckets finish as zeros
            finish();
            ++b;
          }
          const float w = sw[p];
          float v[V];
          widen<T, V>(r[q], v);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            nf[k] = nf[k] || !isfinite(v[k]);
            cur[k] = fmaf(w, v[k], cur[k]);
          }
        }
      }
    }
    for (; b < nb; ++b) finish();        // the last bucket and empty ones

    const float qnan = __int_as_float(0x7fffffff);
    if constexpr (GRAM) {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (bad[k] != -1)
#pragma unroll
          for (int a = 0; a < NB; ++a)
            if (a < nb && bad[k] != a) acc[a][k] = qnan;
#pragma unroll
      for (int a = 0; a < NB; ++a)
        if (a < nb) store_vals<T, V>(y + (long long)a * d + col, acc[a]);
      int e = 0;
#pragma unroll
      for (int a = 0; a < NB; ++a)
#pragma unroll
        for (int c = a; c < NB; ++c, ++e) {
          float t = sg[e * nt + tid];
#pragma unroll
          for (int k = 0; k < V; ++k) t = fmaf(acc[a][k], acc[c][k], t);
          sg[e * nt + tid] = t;
        }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (bad[k] == -1) continue;
        for (int a = 0; a < nb; ++a) {
          if (a == bad[k]) continue;
          store1(y + (long long)a * d + col + k, qnan);
          if (yf) yf[(long long)a * d + col + k] = qnan;
        }
      }
    }
  }

  if constexpr (GRAM) {
    // Fixed-order block reduction of the NPAIR sums, every sum's shuffle
    // level issued together.
    __shared__ float red[THREADS / 32][NPAIR];
    const int lid = tid & 31, warp = tid >> 5;
    float v[NPAIR];
#pragma unroll
    for (int e = 0; e < NPAIR; ++e) v[e] = sg[e * nt + tid];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int e = 0; e < NPAIR; ++e)
        v[e] += __shfl_down_sync(0xffffffffu, v[e], off);
    if (lid == 0)
#pragma unroll
      for (int e = 0; e < NPAIR; ++e) red[warp][e] = v[e];
    __syncthreads();
    for (int e = tid; e < NPAIR; e += nt) {
      float t = 0.f;
      for (int w = 0; w < (nt >> 5); ++w) t += red[w][e];
      partial[(long long)blockIdx.x * NPAIR + e] = t;
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
      if (!isfinite(v[k])) bad[k] = note(bad[k], b);
      acc[k] = fmaf(w, v[k], acc[k]);
    }
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_cols(T* p, const float v[W]) {
  if constexpr (W == 4) {
    const float (&q)[4] = *reinterpret_cast<const float (*)[4]>(v);
    store_vals<T, 4>(p, q);
  } else {
    store1(p, v[0]);
  }
}

// Any n_b: one thread per (bucket, column group), so a small D with many
// buckets still fills the card.  Means are written as they finish (also as
// fp32 into yf when given); each thread that meets a non-finite value
// notes its bucket in bad[col] (-1 none, b one bucket, -2 several, by
// atomics), and bucket_nan_spread then writes NaN to the other buckets of
// those columns.
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

}  // namespace

// What a K6 / K7 launch at one shape passes besides its pointers and
// stream; the wrapper fills one per shape once (kernels/bucketgram/ops.py::
// Plan) and passes its address.  d: columns; dtype: REPRO_F32 /
// REPRO_BF16; nb: buckets; s: the bucket size when the register path
// builds the plan from permutations, 0 when the wrapper wrote it; reg: 1
// for the
// register path (n <= REG_MAX_N and nb <= NB with the Gram, <= MEANS_NB
// without), 0 for bucket_any; gram: 1 for the register Gram (reg, nb <=
// NB); vec: columns
// a thread of the register path loads at once (8 for bf16 only, 4, 2, 1;
// dividing d, x, y and yf aligned to it); threads (32..256, a multiple of
// 32) and blocks: the register path's block size and column blocks per
// lane (bucket_any: 256 threads, `blocks` at most).
struct ReproBucketPlan {
  long long d;
  int dtype, lanes, n, nb, s, reg, gram, vec, threads, blocks;
};

namespace {

// Scratch words of a plan (int32 / fp32 words): the plan arrays order
// (lanes*n), start (lanes*(nb+1)) and weight (lanes*n), unless the
// register path stages the plan from the permutation; then the
// Gram partials (lanes*blocks*NPAIR) with the register Gram, or
// bucket_any's bad flags (lanes*d).
struct Layout {
  long long start, weight, tail, words;
};

inline Layout layout_of(const ReproBucketPlan& p) {
  Layout l;
  const bool arrays = p.s == 0;
  l.start = arrays ? (long long)p.lanes * p.n : 0;
  l.weight = arrays ? l.start + (long long)p.lanes * (p.nb + 1) : 0;
  l.tail = arrays ? l.weight + (long long)p.lanes * p.n : 0;
  l.words = l.tail + (p.gram ? (long long)p.lanes * p.blocks * NPAIR
                             : !p.reg ? (long long)p.lanes * p.d : 0);
  return l;
}

// Dynamic shared memory of a register-path launch, allowed above the
// default 48 KB once per instance (`allowed`: that instance's limit).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <typename T, int V>
int launch_reg(const ReproBucketPlan& p, const T* x, const long long* perm,
               const int* order, const int* start, const float* weight, T* y,
               float* yf, float* partial, float* g, cudaStream_t s) {
  const dim3 grid(p.blocks, p.lanes);
  const size_t plan_bytes = 12 * (size_t)p.n;
  static size_t allowed_gram = 48 << 10, allowed_means = 48 << 10;
  cudaError_t err;
  if (p.gram) {
    auto kernel = bucket_reg<T, V, true>;
    const size_t smem = plan_bytes + 4 * (size_t)NPAIR * p.threads;
    if ((err = allow_smem(kernel, smem, allowed_gram)) != cudaSuccess)
      return err;
    kernel<<<grid, p.threads, smem, s>>>(x, p.n, p.d, perm, p.s, order,
                                         start, weight, p.nb, y, nullptr,
                                         partial);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bucketgram_reduce<<<p.lanes, 64, 0, s>>>(partial, p.blocks, p.nb, g);
  } else {
    auto kernel = bucket_reg<T, V, false>;
    if ((err = allow_smem(kernel, plan_bytes, allowed_means)) != cudaSuccess)
      return err;
    kernel<<<grid, p.threads, plan_bytes, s>>>(x, p.n, p.d, perm, p.s, order,
                                               start, weight, p.nb, y, yf,
                                               nullptr);
  }
  return cudaGetLastError();
}

template <typename T>
int launch(const ReproBucketPlan& p, const void* xv, const long long* perm,
           int* scratch, void* yv, float* yf, float* g, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const Layout l = layout_of(p);
  const bool arrays = p.s == 0;
  const int* order = arrays ? scratch : nullptr;
  const int* start = arrays ? scratch + l.start : nullptr;
  const float* weight =
      arrays ? reinterpret_cast<const float*>(scratch + l.weight) : nullptr;
  if (p.reg) {
    float* partial = p.gram ? reinterpret_cast<float*>(scratch + l.tail)
                            : nullptr;
    const int v = p.vec;
    const size_t vb = (size_t)v * sizeof(T);
    if ((v != 1 && v != 2 && v != 4 && !(v == 8 && sizeof(T) == 2)) ||
        p.d % v != 0 || reinterpret_cast<uintptr_t>(xv) % vb != 0 ||
        reinterpret_cast<uintptr_t>(yv) % vb != 0 ||
        (yf && reinterpret_cast<uintptr_t>(yf) % (v >= 4 ? 16 : v * 4) != 0) ||
        p.threads < 32 || p.threads > THREADS || p.threads % 32)
      return cudaErrorInvalidValue;
    switch (v) {
      case 8:
        if constexpr (sizeof(T) == 2)
          return launch_reg<T, 8>(p, x, perm, order, start, weight, y, yf,
                                  partial, g, s);
        break;
      case 4: return launch_reg<T, 4>(p, x, perm, order, start, weight, y, yf, partial, g, s);
      case 2: return launch_reg<T, 2>(p, x, perm, order, start, weight, y, yf, partial, g, s);
      case 1: return launch_reg<T, 1>(p, x, perm, order, start, weight, y, yf, partial, g, s);
    }
    return cudaErrorInvalidValue;
  }
  int* bad = scratch + l.tail;
  const bool vec = vec4_ok<T>(xv, p.d) && vec4_ok<T>(yv, p.d) &&
                   (!yf || vec4_ok<float>(yf, p.d));
  const dim3 grid(p.blocks, p.lanes);
  cudaError_t err =
      cudaMemsetAsync(bad, 0xFF, sizeof(int) * p.d * p.lanes, s);  // -1
  if (err != cudaSuccess) return err;
  if (vec)
    bucket_any<T, true><<<grid, THREADS, 0, s>>>(x, p.n, p.d, order, start,
                                                 weight, p.nb, y, yf, bad);
  else
    bucket_any<T, false><<<grid, THREADS, 0, s>>>(x, p.n, p.d, order, start,
                                                  weight, p.nb, y, yf, bad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long spread = (p.d + THREADS - 1) / THREADS;
  bucket_nan_spread<<<dim3((unsigned)(spread < p.blocks ? spread : p.blocks),
                           p.lanes),
                      THREADS, 0, s>>>(bad, p.d, p.nb, y, sizeof(T) == 2, yf);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_bucketgram_reg_nb() { return NB; }
extern "C" int repro_bucketgram_means_nb() { return MEANS_NB; }
extern "C" int repro_bucketgram_reg_max_n() { return REG_MAX_N; }

// int32 words of scratch a launch with this plan takes.
extern "C" long long repro_bucketgram_scratch(const ReproBucketPlan* plan) {
  return layout_of(*plan).words;
}

// x: (lanes, n, d) stacks (a single stack is one lane); perm: (lanes, n)
// int64 permutations when plan->s > 0 (the register path only: it stages
// each lane's plan from them), else NULL and the wrapper wrote the plan
// (order, start, weight) at the head of scratch; scratch:
// repro_bucketgram_scratch(plan) int32 words (NULL when 0); y: (lanes,
// nb, d) means in x's dtype; yf: optional fp32 copy of the means (not
// with the register Gram); g: (lanes, nb, nb) fp32 Grams with
// plan->gram, else NULL.
extern "C" int repro_bucketgram(const void* x, const long long* perm,
                                int* scratch, void* y, float* yf, float* g,
                                const ReproBucketPlan* plan, void* stream) {
  const ReproBucketPlan p = *plan;
  if (p.lanes < 1 || p.lanes > 65535 || p.n < 1 || p.d < 1 || p.nb < 1 ||
      p.blocks < 1 || (p.gram && (!p.reg || p.nb > NB || yf || !g)) ||
      (!p.gram && g) || (p.reg && (p.nb > MEANS_NB || p.n > REG_MAX_N)) ||
      (p.s > 0) != (perm != nullptr) ||
      (p.s > 0 && (!p.reg || p.nb != (p.n + p.s - 1) / p.s)) ||
      (layout_of(p).words > 0 && !scratch))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.dtype == REPRO_F32)
    return launch<float>(p, x, perm, scratch, y, yf, g, s);
  if (p.dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(p, x, perm, scratch, y, yf, g, s);
  return cudaErrorInvalidValue;
}
