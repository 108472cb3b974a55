// Compile-time shape of one IPM configuration: bounded indices and the
// structural-nonzero patterns of the stage Jacobians A and B.
//
// A configuration header (config_*.cuh) defines a struct with NX, NU, the
// index lists IDXBX / IDXBU and the patterns A / B.  The kernels unroll every
// small-matrix loop over these constants, so a product with a structural zero
// is dropped at compile time.  The Python side parses the same header
// (ops/_build.py::header_config) to pick the specialisation for a model and
// to test the table against the detected pattern.
#pragma once

template <int... I>
struct IndexList {
  static constexpr int size = sizeof...(I);
  static_assert(size > 0, "an empty bound group has no kernel specialisation");
  __host__ __device__ static constexpr int at(int k) {
    constexpr int t[] = {I...};
    return t[k];
  }
};

// Row-major R x C table of 0/1 entries.
template <int R, int C, int... Bits>
struct Pattern {
  static_assert(sizeof...(Bits) == R * C, "a pattern lists R*C entries");
  __host__ __device__ static constexpr bool nz(int i, int j) {
    constexpr int t[] = {Bits...};
    return t[i * C + j] != 0;
  }
  __host__ __device__ static constexpr int count() {
    int n = 0;
    for (int k = 0; k < R * C; ++k) n += nz(k / C, k % C) ? 1 : 0;
    return n;
  }
};

// Every entry structurally nonzero (arbitrary QP data).
template <int R, int C>
struct DensePattern {
  __host__ __device__ static constexpr bool nz(int, int) { return true; }
  __host__ __device__ static constexpr int count() { return R * C; }
};
