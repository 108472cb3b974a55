// Dense 7x2 QP with the diff model's bounded indices: every A/B entry is
// structural.  The kernels' tests run it on random QPs.
#pragma once
#include "pattern.cuh"

struct Dense72Config {
  static constexpr int NX = 7;
  static constexpr int NU = 2;
  using IDXBX = IndexList<5, 6>;
  using IDXBU = IndexList<0, 1>;
  using A = DensePattern<7, 7>;
  using B = DensePattern<7, 2>;
};
