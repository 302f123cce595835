// K2 and K4 for 64 < n <= 1024 workers · the NNM mix as a register-tiled
// fp32 tile product, then a rank selection in place of a sort.
//
// Replaces, for 64 < n <= MAX_N (1024), the TPU kernels
// repro/kernels/mixtrim/kernel.py::mixtrim_pallas (body _make_kernel: the
// mix as one dot_general on the MXU, then a bitonic sort of each column)
// and ::mixtrim_dyn_pallas (body _make_dyn_kernel, f per lane on the
// device).  mixtrim_big (csrc/mixtrim.cuh) keeps 1024 < n <= 16384.
// Semantics are those of mixtrim_ref / mixtrim_dyn_ref
// (kernels/mixtrim/ops.py): NaN sorts last; K2's trim is the mean of the
// sorted slice [f, n - f) (the plain mean at f = 0); K4's is the
// reference's rank mask, so a non-finite value in a trimmed rank makes the
// column NaN (inf * 0), f >= n / 2 keeps nothing (0, or NaN) and f <= 0
// keeps every rank over max(n - 2f, 1); "med" is the median.
//
// What bounds it on this card.  With the mix, the product Y = M X: 2 n^2 D
// fp32 FLOP (n = 640, D = 2^20: 8.6e11, 12.8 ms at 67 TFLOP/s), against
// 0.8 ms for reading X once at 3.35 TB/s.  Without the mix, the bytes.
// On an H100 80GB HBM3 at 700 W, mixtrim_big reached 11 % of the first
// bound and 3 % of the second at n = 640, D = 2^20 (PERF.md): one
// shared-memory load per FMA of the mix, M read from L2 once per four
// columns, and a 1024-high shared-memory bitonic sort of every column (55
// stages, each ending in a block barrier) where a trim needs two ranks.
//
// What the design does about it.
//   - The mix.  A block owns TC columns and all n rows of Y (rows padded
//     to ROWS = TR * R with zero rows of M).  Its 512 threads are TR
//     thread-rows by TCG = 512 / TR thread-columns; thread (tr, tc) holds
//     rows R tr .. R tr + R - 1 and columns 4 tc + 4 TCG b + j (b < 2,
//     j < 4): an R x 8 micro-tile of fp32 accumulators in registers
//     (10 x 8 at n = 640, TC = 64).  Per step of the contraction it reads
//     its R values of M (two 16-byte and one 8-byte shared loads at
//     R = 10) and two 16-byte words of X for 8 R FMAs: a word loaded
//     feeds 8 FMAs (mixtrim_big: one).
//   - M and X stream through a ring of STAGES k-tiles of depth KT.  Before
//     the kernel, pack_m writes M^T into a scratch buffer in the ring's
//     layout: k-major, a thread's R rows 16-byte aligned, and with R = 8
//     four pad words every 32 rows, so the rows the threads of a warp read
//     at one k lie in distinct banks.  Each k-tile of M is then one
//     contiguous block, staged by one bulk copy (cp.async.bulk, the copy
//     engine) that completes on the stage's mbarrier.  X goes through
//     registers (widened to fp32 on the way, any alignment), loaded before
//     the block computes on the current stage and stored after it.  M is
//     read from L2 once per TC columns.  (Per-thread 4- and 8-byte
//     cp.async copies of M ran markedly slower: the small copies, not the
//     bytes from L2, set the pace.)
//   - fp32 FMAs, no TF32: each output is one FMA chain over every j in
//     ascending order, zeros of M included, so 0 * inf gives NaN where the
//     plain fp32 product does.
//   - Y never reaches device memory: after the contraction the micro-tiles
//     become the NaN-last uint32 keys of mixtrim.cuh (key_of) in shared
//     memory, over the ring's space, column-major at an odd pitch.
//   - A rank selection instead of a sort (select2): one warp per column
//     finds the keys at two ranks (trim: f and n - f - 1; median:
//     (n - 1) / 2 and n / 2) by a most-significant-digit radix select,
//     8-bit digits, a 256-bin histogram per rank in the warp's own shared
//     memory, stopping once each rank's digit prefix is held by one key
//     (wider digits with 16-bit counters, fewer passes, ran slower).  The
//     trim then sums, in one more pass, the values strictly between the
//     two keys plus each end key times its copies inside [f, n - f): the
//     multiset of the sorted slice, summed in another order.  K4 counts
//     the non-finite keys of the column and of the kept ranks; where they
//     differ a trimmed rank held +-inf or NaN, and the column is NaN.
//   - Without the mix (select_nomix) a block of 256 threads stages TCN
//     columns of X as keys (four columns a load where D and the pointer
//     allow) and runs the same selection; two or three blocks a SM
//     overlap one's loads with another's selection.
// The grid is persistent: one wave of resident blocks walks the column
// tiles of each lane (blockIdx.y = lane for K4).
#pragma once

#include "mixtrim.cuh"

namespace mixtrim_select {

using mixtrim_detail::Args;
using mixtrim_detail::key_of;
using mixtrim_detail::val_of;

constexpr int KT = 16;                   // contraction depth of a ring stage
constexpr int STAGES = 3;
constexpr int HIST = 512;                // histogram words a warp: 2 x 256
constexpr int NM_THREADS = 256;          // no-mix kernel
constexpr int NM_WARPS = NM_THREADS / 32;
constexpr int NM_KEY_WORDS = 16640;      // keys a no-mix tile: 65 KB
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned NEG_INF_KEY = 0x007FFFFFu;   // key_of(-inf)
constexpr unsigned POS_INF_KEY = 0xFF800000u;   // key_of(+inf); NaN above

// Tile geometry of the mix kernel: NT threads, TR thread-rows of R rows
// each, CW columns a thread.
template <int NT, int TR, int R, int CW>
struct Cfg {
  static constexpr int THREADS = NT, R_ = R, CW_ = CW;
  static constexpr int WARPS = NT / 32;
  static constexpr int TCG = NT / TR;
  static constexpr int TC = CW * TCG;                // columns a tile
  static constexpr int ROWS = TR * R;                // >= n
  // Word of row r in a k-row of the M tile: a thread's R rows start on a
  // 16-byte boundary (R = 10 takes 12 words), and with R = 8 four pad
  // words every 32 rows put the rows of the eight threads of a warp on
  // distinct banks (R = 10: 12 tr mod 32 differ for the four of a warp).
  static constexpr int RP = (R + 3) & ~3;
  __host__ __device__ static constexpr int pos(int r) {
    return (r / R) * RP + r % R + (R % 8 == 0 ? 4 * (r >> 5) : 0);
  }
  static constexpr int MP = (pos(ROWS - 1) + 4) & ~3;   // k-row pitch
  static constexpr int M_WORDS = MP * KT;
  static constexpr int X_WORDS = KT * TC;
  static constexpr int STAGE = M_WORDS + X_WORDS;
  static constexpr int XE = X_WORDS / NT;            // X elements a thread stages
  static_assert(TR % 8 == 0 && R % 2 == 0 && CW % 4 == 0 && XE >= 1,
                "tile geometry");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}
// One arrival that also expects `bytes` of bulk copies on the barrier.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}
// A bulk copy global -> shared of `bytes` (a multiple of 16, both ends
// 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}
// Orders this thread's generic-proxy shared accesses before later bulk
// copies (the async proxy) into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ bool nonfinite(unsigned k) {
  return k <= NEG_INF_KEY || k >= POS_INF_KEY;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}
__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(FULL, v);
}

// The bins of two 256-bin histograms h0, h1 (h1 may be h0) that hold
// ranks k0 and k1 (warp-uniform, each below its histogram's total):
// digit, keys in lower bins and the bin's count, packed as dig | before
// << 8 | cnt << 20.  Lane l reads bins 8l .. 8l + 7 of each; both counts
// ride one inclusive scan in the two halves of a word (n <= 1024 < 2^16).
__device__ __forceinline__ void find_bins(const unsigned* h0,
                                          const unsigned* h1, int k0, int k1,
                                          int lane, unsigned& o0,
                                          unsigned& o1) {
  const uint4 a0 = reinterpret_cast<const uint4*>(h0)[2 * lane];
  const uint4 b0 = reinterpret_cast<const uint4*>(h0)[2 * lane + 1];
  const uint4 a1 = reinterpret_cast<const uint4*>(h1)[2 * lane];
  const uint4 b1 = reinterpret_cast<const uint4*>(h1)[2 * lane + 1];
  const unsigned c[8] = {a0.x | a1.x << 16, a0.y | a1.y << 16,
                         a0.z | a1.z << 16, a0.w | a1.w << 16,
                         b0.x | b1.x << 16, b0.y | b1.y << 16,
                         b0.z | b1.z << 16, b0.w | b1.w << 16};
  unsigned tot = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) tot += c[j];
  unsigned incl = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  const unsigned excl = incl - tot;
  unsigned r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int sh = 16 * h, k = h ? k1 : k0;
    const int lo = (int)((excl >> sh) & 0xFFFFu);
    const int hi = (int)((incl >> sh) & 0xFFFFu);
    const bool mine = lo <= k && k < hi;
    const int src = __ffs(__ballot_sync(FULL, mine)) - 1;
    unsigned pk = 0;
    if (mine) {
      int run = lo;
      bool done = false;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cj = (int)((c[j] >> sh) & 0xFFFFu);
        if (!done && k < run + cj) {
          pk = (unsigned)(8 * lane + j) | (unsigned)run << 8 | (unsigned)cj << 20;
          done = true;
        }
        run += cj;
      }
    }
    r[h] = __shfl_sync(FULL, pk, src);
  }
  o0 = r[0];
  o1 = r[1];
}

// A two-rank radix select's state: each rank's key prefix (the bits in
// msk), its rank among the keys that share that prefix, and their count.
struct Sel {
  unsigned p0, p1, msk;
  int k0, k1, c0, c1;
};

// Ranks r0 <= r1 of the n keys col[0, n) in shared memory, by one warp:
// a most-significant-digit radix select, 8 bits a pass, both ranks in the
// same passes (one histogram while their prefixes agree), stopping once
// each rank's prefix is held by one key (c0 = c1 = 1, k0 = k1 = 0).
// hist: this warp's HIST words, zero on entry and on return.
__device__ __forceinline__ Sel select2(const unsigned* col, int n, int r0,
                                       int r1, unsigned* hist, int lane) {
  Sel s{0u, 0u, 0u, r0, r1, n, n};
  uint4* h4 = reinterpret_cast<uint4*>(hist);
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll 1
  for (int shift = 24; shift >= 0 && (s.c0 > 1 || s.c1 > 1); shift -= 8) {
    const bool same = s.p0 == s.p1;
    for (int i = lane; i < n; i += 32) {
      const unsigned key = col[i];
      const unsigned dig = (key >> shift) & 0xFFu;
      const unsigned top = key & s.msk;
      if (top == s.p0) atomicAdd(hist + dig, 1u);
      if (!same && top == s.p1) atomicAdd(hist + 256 + dig, 1u);
    }
    __syncwarp();
    unsigned q0, q1;
    find_bins(hist, same ? hist : hist + 256, s.k0, s.k1, lane, q0, q1);
    __syncwarp();
    h4[2 * lane] = zero;
    h4[2 * lane + 1] = zero;
    if (!same) {
      h4[64 + 2 * lane] = zero;
      h4[64 + 2 * lane + 1] = zero;
    }
    __syncwarp();
    s.p0 |= (q0 & 0xFFu) << shift;
    s.p1 |= (q1 & 0xFFu) << shift;
    s.k0 -= (int)((q0 >> 8) & 0xFFFu);
    s.k1 -= (int)((q1 >> 8) & 0xFFFu);
    s.c0 = (int)(q0 >> 20);
    s.c1 = (int)(q1 >> 20);
    s.msk |= 0xFFu << shift;
  }
  return s;
}

// One output of a column of n keys, by one warp (f: this lane's f; dyn:
// K4's rank-mask semantics, else K2's slice).
__device__ __forceinline__ float column_result(const unsigned* col, int n,
                                               int f, int med, bool dyn,
                                               unsigned* hist, int lane) {
  if (med) {
    const Sel s = select2(col, n, (n - 1) / 2, n / 2, hist, lane);
    unsigned lo = 0, hi = 0;             // the keys holding the prefixes
    for (int i = lane; i < n; i += 32) {
      const unsigned key = col[i], mk = key & s.msk;
      if (mk == s.p0) lo = key;
      if (mk == s.p1) hi = key;
    }
    lo = __reduce_max_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    return (n & 1) ? val_of(hi) : 0.5f * (val_of(lo) + val_of(hi));
  }
  if (f <= 0 || 2 * f >= n) {
    // Every rank kept (the sum over max(n - 2f, 1)), or, for K4 with
    // f >= n / 2, none: 0, or NaN where a value is not finite.
    const bool none = f > 0;
    float s = 0.f;
    int bad = 0;
    for (int i = lane; i < n; i += 32) {
      const unsigned key = col[i];
      s += val_of(key);
      bad += nonfinite(key);
    }
    if (none) return warp_sum(bad) ? __int_as_float(0x7fffffff) : 0.f;
    return warp_sum(s) / (float)max(n - 2 * f, 1);
  }
  // The sorted slice [f, n - f): the keys strictly between the keys lo and
  // hi at ranks f and n - f - 1, plus c0 - k0 copies of lo and k1 + 1 of
  // hi.  A key's prefix orders it against lo and hi even where the select
  // stopped early (each prefix then held by one key), and the same pass
  // reads lo and hi.
  const Sel sl = select2(col, n, f, n - f - 1, hist, lane);
  float s = 0.f;
  int in = 0, all = 0;
  unsigned lo = 0, hi = 0;
  for (int i = lane; i < n; i += 32) {
    const unsigned key = col[i], mk = key & sl.msk;
    const bool nf = nonfinite(key);
    all += nf;
    if (mk > sl.p0 && mk < sl.p1) {
      s += val_of(key);
      in += nf;
    }
    if (mk == sl.p0) lo = key;
    if (mk == sl.p1) hi = key;
  }
  s = warp_sum(s);
  lo = __reduce_max_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  const int kept = n - 2 * f;
  if (lo == hi) {
    s = (float)kept * val_of(lo);
    in = nonfinite(lo) ? kept : 0;
  } else {
    const int clo = sl.c0 - sl.k0, chi = sl.k1 + 1;
    s += (float)clo * val_of(lo) + (float)chi * val_of(hi);
    in = warp_sum(in) + (nonfinite(lo) ? clo : 0) + (nonfinite(hi) ? chi : 0);
  }
  if (dyn && warp_sum(all) > in) return __int_as_float(0x7fffffff);
  return s / (float)kept;
}

// mt[b] = M_b^T in the layout of the ring's M tiles: row k of M^T at
// k * mp, M's row r at pos(r) = (r / R) rp + r % R + 4 skew (r >> 5), so
// that each k-tile is one contiguous block of KT * mp words (zero rows
// and pads, from a memset, beyond n).  32 x 32 tiles through shared
// memory (grid: ceil(n / 32)^2 x lanes, 32 x 8 threads).
static __global__ void __launch_bounds__(256)
pack_m(const float* __restrict__ m, float* __restrict__ mt, int n, int r_,
       int rp, int skew, int mp, long long lane_words) {
  __shared__ float tile[32][33];
  m += (long long)blockIdx.z * n * n;
  mt += (long long)blockIdx.z * lane_words;
  const int tx = threadIdx.x, ty = threadIdx.y;
  int c = blockIdx.x * 32 + tx, r = blockIdx.y * 32 + ty;
#pragma unroll
  for (int j = 0; j < 32; j += 8)
    if (c < n && r + j < n) tile[ty + j][tx] = m[(long long)(r + j) * n + c];
  __syncthreads();
  r = blockIdx.y * 32 + tx;                         // M's row, now along x
  c = blockIdx.x * 32 + ty;                         // M's column = k
  const int p = (r / r_) * rp + r % r_ + 4 * skew * (r >> 5);
#pragma unroll
  for (int j = 0; j < 32; j += 8)
    if (r < n && c + j < n) mt[(long long)(c + j) * mp + p] = tile[tx][ty + j];
}

// X's k-tile (rows k0 .. k0 + KT, columns c0 .. c0 + TC) into registers.
template <class C, typename T>
__device__ __forceinline__ void load_x(float (&xr)[C::XE], const T* x, int n,
                                       long long d, int k0, long long c0,
                                       int t) {
#pragma unroll
  for (int q = 0; q < C::XE; ++q) {
    const int e = t + q * C::THREADS;
    const int k = e / C::TC, c = e % C::TC;
    const bool ok = k0 + k < n && c0 + c < d;
    xr[q] = ok ? to_f32(x[(long long)(k0 + k) * d + c0 + c]) : 0.f;
  }
}

template <class C>
__device__ __forceinline__ void store_x(float* xs, const float (&xr)[C::XE],
                                        int t) {
#pragma unroll
  for (int q = 0; q < C::XE; ++q) xs[t + q * C::THREADS] = xr[q];
}

// Grid: (column blocks, lanes).  fdev NULL: K2 (f static, one lane);
// else K4 (blockIdx.y = lane, f = fdev[lane], M per lane).  mt: M^T as
// pack_m lays it out; bar: word offset of the ring's mbarriers.
template <typename T, class C>
__global__ void __launch_bounds__(C::THREADS, 1)
mix_select(const T* __restrict__ x, const float* __restrict__ mt, int n,
           long long d, int f, const int* __restrict__ fdev, int med,
           int bar, float* __restrict__ out) {
  constexpr int R = C::R_, CW = C::CW_;
  constexpr unsigned M_BYTES = sizeof(float) * C::M_WORDS;
  const int ktiles = (n + KT - 1) / KT;
  const bool dyn = fdev != nullptr;
  if (dyn) {
    x += (long long)blockIdx.y * n * d;
    mt += (long long)blockIdx.y * ktiles * C::M_WORDS;
    out += (long long)blockIdx.y * d;
    f = fdev[blockIdx.y];
  }
  extern __shared__ __align__(16) float ring[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tc = t % C::TCG, tr = t / C::TCG;
  const int kp = n | 1;                                // odd key pitch
  unsigned* keys = reinterpret_cast<unsigned*>(ring);  // over the ring
  unsigned* hist = keys + C::TC * kp + warp * HIST;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(ring + bar);
  const long long tiles = (d + C::TC - 1) / C::TC;
  if (t == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // One thread issues each k-tile of M as one bulk copy into its stage.
  auto issue = [&](int kt, unsigned slot) {
    if (t == 0) {
      fence_proxy_async();
      mbar_expect(full + slot, M_BYTES);
      bulk_copy(ring + slot * C::STAGE, mt + (long long)kt * C::M_WORDS,
                M_BYTES, full + slot);
    }
  };
  unsigned g = 0;                        // k-tiles this block has consumed

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long c0 = tile * C::TC;
    float acc[R][CW];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[a][j] = 0.f;
    float xr[C::XE];
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < ktiles) {
        const unsigned slot = (g + s) % STAGES;
        issue(s, slot);
        load_x<C>(xr, x, n, d, s * KT, c0, t);
        store_x<C>(ring + slot * C::STAGE + C::M_WORDS, xr, t);
      }
    }
#pragma unroll 1
    for (int kt = 0; kt < ktiles; ++kt, ++g) {
      const unsigned slot = g % STAGES;
      mbar_wait(full + slot, (g / STAGES) & 1);   // M of kt landed
      __syncthreads();                   // X of kt too; stage kt - 1 is free
      const int pf = kt + STAGES - 1;
      const unsigned pslot = (g + STAGES - 1) % STAGES;
      float* pst = ring + pslot * C::STAGE;
      if (pf < ktiles) {
        issue(pf, pslot);
        load_x<C>(xr, x, n, d, pf * KT, c0, t);
      }
      const float* ms = ring + slot * C::STAGE + C::pos(R * tr);
      const float* xs = ring + slot * C::STAGE + C::M_WORDS + 4 * tc;
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        float mv[R];
#pragma unroll
        for (int a = 0; a + 4 <= R; a += 4) {
          const float4 q = *reinterpret_cast<const float4*>(ms + k * C::MP + a);
          mv[a] = q.x;
          mv[a + 1] = q.y;
          mv[a + 2] = q.z;
          mv[a + 3] = q.w;
        }
        if constexpr (R % 4 != 0) {
          const float2 q =
              *reinterpret_cast<const float2*>(ms + k * C::MP + R - 2);
          mv[R - 2] = q.x;
          mv[R - 1] = q.y;
        }
        float xv[CW];
#pragma unroll
        for (int b = 0; b < CW / 4; ++b) {
          const float4 q = *reinterpret_cast<const float4*>(
              xs + k * C::TC + 4 * C::TCG * b);
          xv[4 * b] = q.x;
          xv[4 * b + 1] = q.y;
          xv[4 * b + 2] = q.z;
          xv[4 * b + 3] = q.w;
        }
#pragma unroll
        for (int a = 0; a < R; ++a) {
#pragma unroll
          for (int j = 0; j < CW; ++j) acc[a][j] = fmaf(mv[a], xv[j], acc[a][j]);
        }
      }
      if (pf < ktiles) store_x<C>(pst + C::M_WORDS, xr, t);
    }
    __syncthreads();                     // the ring is free: keys go there
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int row = R * tr + a;
      if (row < n) {
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          const int col = 4 * C::TCG * (j >> 2) + 4 * tc + (j & 3);
          keys[col * kp + row] = key_of(acc[a][j]);
        }
      }
    }
    reinterpret_cast<uint4*>(hist)[lane] = make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(hist)[32 + lane] = make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(hist)[64 + lane] = make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(hist)[96 + lane] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    const int w = (int)min((long long)C::TC, d - c0);
    for (int c = warp; c < w; c += C::WARPS) {
      const float r = column_result(keys + c * kp, n, f, med, dyn, hist, lane);
      if (lane == 0) out[c0 + c] = r;
    }
    fence_proxy_async();                 // keys before the next bulk copies
    __syncthreads();                     // the next tile's ring is over keys
  }
}

// Without the mix: a tile of TCN = 2^tcn_log2 columns of X as keys, read
// four columns a load (16-byte fp32 / 8-byte bf16) when vec.
template <typename T>
__global__ void __launch_bounds__(NM_THREADS, 3)
select_nomix(const T* __restrict__ x, int n, long long d, int tcn_log2,
             bool vec, int f, const int* __restrict__ fdev, int med,
             float* __restrict__ out) {
  const bool dyn = fdev != nullptr;
  if (dyn) {
    x += (long long)blockIdx.y * n * d;
    out += (long long)blockIdx.y * d;
    f = fdev[blockIdx.y];
  }
  extern __shared__ __align__(16) unsigned nm_keys[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int kp = n | 1, tcn = 1 << tcn_log2;
  unsigned* hist = nm_keys + tcn * kp + warp * HIST;
#pragma unroll
  for (int q = 0; q < HIST / 128; ++q)
    reinterpret_cast<uint4*>(hist)[q * 32 + lane] = make_uint4(0, 0, 0, 0);
  const long long tiles = (d + tcn - 1) / tcn;
  constexpr int BATCH = 8;               // loads in flight a thread
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long c0 = tile * tcn;
    if (vec && c0 + tcn <= d) {
      const int l4 = tcn_log2 - 2, total = n << l4;
      for (int e0 = t; e0 < total; e0 += BATCH * NM_THREADS) {
        float v[BATCH][4];
#pragma unroll
        for (int q = 0; q < BATCH; ++q) {
          const int e = e0 + q * NM_THREADS;
          if (e < total)
            load4(x + (long long)(e >> l4) * d + c0 + 4 * (e & ((1 << l4) - 1)),
                  v[q]);
        }
#pragma unroll
        for (int q = 0; q < BATCH; ++q) {
          const int e = e0 + q * NM_THREADS;
          if (e < total) {
            unsigned* k = nm_keys + 4 * (e & ((1 << l4) - 1)) * kp + (e >> l4);
#pragma unroll
            for (int j = 0; j < 4; ++j) k[j * kp] = key_of(v[q][j]);
          }
        }
      }
    } else {
      const int total = n << tcn_log2;
      for (int e0 = t; e0 < total; e0 += BATCH * NM_THREADS) {
        float v[BATCH];
#pragma unroll
        for (int q = 0; q < BATCH; ++q) {
          const int e = e0 + q * NM_THREADS;
          const int i = e >> tcn_log2, c = e & (tcn - 1);
          v[q] = (e < total && c0 + c < d)
                     ? to_f32(x[(long long)i * d + c0 + c]) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < BATCH; ++q) {
          const int e = e0 + q * NM_THREADS;
          if (e < total)
            nm_keys[(e & (tcn - 1)) * kp + (e >> tcn_log2)] = key_of(v[q]);
        }
      }
    }
    __syncthreads();
    const int w = (int)min((long long)tcn, d - c0);
    for (int c = warp; c < w; c += NM_WARPS) {
      const float r = column_result(nm_keys + c * kp, n, f, med, dyn, hist, lane);
      if (lane == 0) out[c0 + c] = r;
    }
    __syncthreads();
  }
}

// Column blocks a lane: one wave of resident blocks, at most `blocks` and
// the tile count.
template <typename K>
inline cudaError_t wave(K kern, int threads, size_t smem, const Args& j,
                        long long tiles, int& grid) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads,
                                                        smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  long long g = (long long)occ * sms / j.lanes;
  if (g > j.blocks) g = j.blocks;
  if (g > tiles) g = tiles;
  grid = (int)(g < 1 ? 1 : g);
  return cudaSuccess;
}

// Words a lane of M^T takes in pack_m's layout for the tile C.
template <class C>
inline long long packed_words(int n) {
  return (long long)((n + KT - 1) / KT) * C::M_WORDS;
}

template <typename T, class C>
int launch_mix(const Args& j) {
  const size_t keys =
      sizeof(unsigned) * ((size_t)C::TC * (j.n | 1) + (size_t)C::WARPS * HIST);
  const size_t ring = sizeof(float) * (size_t)STAGES * C::STAGE;
  const size_t body = ((keys > ring ? keys : ring) + 15) & ~(size_t)15;
  const size_t smem = body + sizeof(unsigned long long) * STAGES;
  auto kern = mix_select<T, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = wave(kern, C::THREADS, smem, j, (j.d + C::TC - 1) / C::TC, grid);
  if (err != cudaSuccess) return err;
  const long long words = packed_words<C>(j.n);
  err = cudaMemsetAsync(j.mt, 0, sizeof(float) * words * j.lanes, j.s);
  if (err != cudaSuccess) return err;
  const int nt = (j.n + 31) / 32;
  pack_m<<<dim3(nt, nt, j.lanes), dim3(32, 8), 0, j.s>>>(
      j.m, j.mt, j.n, C::R_, C::RP, C::R_ % 8 == 0, C::MP, words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kern<<<dim3(grid, j.lanes), C::THREADS, smem, j.s>>>(
      static_cast<const T*>(j.x), j.mt, j.n, j.d, j.f, j.fdev, j.med,
      (int)(body / sizeof(float)), j.out);
  return cudaGetLastError();
}

// Columns a no-mix tile (log2): the most that keep the keys within
// NM_KEY_WORDS, 8 to 64.
inline int nomix_tcn_log2(int n) {
  int l = 6;
  while (l > 3 && (1 << l) * (n | 1) > NM_KEY_WORDS) --l;
  return l;
}

template <typename T>
int launch_nomix(const Args& j) {
  const int l = nomix_tcn_log2(j.n);
  const size_t smem = sizeof(unsigned) *
      ((size_t)(j.n | 1) * (1 << l) + (size_t)NM_WARPS * HIST);
  auto kern = select_nomix<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = wave(kern, NM_THREADS, smem, j, (j.d + (1 << l) - 1) >> l, grid);
  if (err != cudaSuccess) return err;
  select_nomix<T><<<dim3(grid, j.lanes), NM_THREADS, smem, j.s>>>(
      static_cast<const T*>(j.x), j.n, j.d, l, vec4_ok<T>(j.x, j.d), j.f,
      j.fdev, j.med, j.out);
  return cudaGetLastError();
}

// The mix kernel's tile for n: rows padded to 256, 640 or 1024 (R = 8,
// 10, 8 rows a thread; 128, 64, 32 columns a tile), the three geometries
// timed against the previous design (PERF.md); fn gets a value of the
// tile's Cfg type.
template <typename Fn>
inline auto by_tile(int n, Fn&& fn) {
  if (n <= 256) return fn(Cfg<512, 32, 8, 8>{});
  if (n <= 640) return fn(Cfg<512, 64, 10, 8>{});
  return fn(Cfg<512, 128, 8, 8>{});
}

template <typename T>
int launch_mix_n(const Args& j) {
  return by_tile(j.n, [&](auto c) { return launch_mix<T, decltype(c)>(j); });
}

}  // namespace mixtrim_select
