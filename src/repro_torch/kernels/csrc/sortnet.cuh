// Batcher's odd-even merge sorting network, sized to the real n at
// compile time (K4, csrc/mixtrim_dyn.cuh).
//
// The network for P = next power of two >= N has every comparator in the
// same direction (min to the lower index).  Keys at positions >= N that
// hold the largest value therefore never move: a comparator (i, j), i < j,
// with j >= N leaves both ends as they are.  Dropping every comparator
// that touches a position >= N leaves a network that sorts N keys
// (n = 17: 85 comparators, where the 32-high bitonic network has 240).
// A bitonic network cannot be cut this way: half its comparators point
// the other way.
//
// The comparator list is a constexpr table; sort_net applies it through a
// fold over an index sequence, so every register index is a compile-time
// constant (no local-memory array).
#pragma once

#include <utility>

namespace sortnet {

__host__ __device__ constexpr int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <int COUNT>
struct Pairs {
  int lo[COUNT > 0 ? COUNT : 1] = {};
  int hi[COUNT > 0 ? COUNT : 1] = {};
};

// Walk the P-high network and call emit(i, j) for each comparator kept
// for N keys; returns their count.
template <typename Emit>
__host__ __device__ constexpr int walk(int n, Emit emit) {
  const int P = next_pow2(n);
  int count = 0;
  for (int p = 1; p < P; p += p)
    for (int k = p; k > 0; k /= 2)
      for (int j = k % p; j + k < P; j += k + k)
        for (int i = 0; i < k; ++i)
          if ((i + j) / (p + p) == (i + j + k) / (p + p) && i + j + k < n) {
            emit(i + j, i + j + k, count);
            ++count;
          }
  return count;
}

struct NoEmit {
  __host__ __device__ constexpr void operator()(int, int, int) const {}
};

template <int COUNT>
struct Fill {
  Pairs<COUNT>* out;
  __host__ __device__ constexpr void operator()(int a, int b, int c) const {
    out->lo[c] = a;
    out->hi[c] = b;
  }
};

template <int N>
__host__ __device__ constexpr int count_of() {
  return walk(N, NoEmit{});
}

template <int N>
__host__ __device__ constexpr Pairs<count_of<N>()> make_pairs() {
  Pairs<count_of<N>()> p{};
  walk(N, Fill<count_of<N>()>{&p});
  return p;
}

template <int N>
struct Net {
  static constexpr int COUNT = count_of<N>();
  static constexpr Pairs<COUNT> pairs = make_pairs<N>();
};

// One comparator on C columns at once: keys[LO][k] <= keys[HI][k] after.
template <int LO, int HI, int N, int C>
__host__ __device__ __forceinline__ void cmpx(float (&v)[N][C]) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const float a = v[LO][k], b = v[HI][k];
    v[LO][k] = fminf(a, b);
    v[HI][k] = fmaxf(a, b);
  }
}

template <int N, int C, int... I>
__host__ __device__ __forceinline__ void apply(float (&v)[N][C],
                                               std::integer_sequence<int, I...>) {
  (cmpx<Net<N>::pairs.lo[I], Net<N>::pairs.hi[I], N, C>(v), ...);
}

// Sort each of the C columns of v (N values, no NaN) in ascending order.
template <int N, int C>
__host__ __device__ __forceinline__ void sort_net(float (&v)[N][C]) {
  apply<N, C>(v, std::make_integer_sequence<int, Net<N>::COUNT>{});
}

}  // namespace sortnet
