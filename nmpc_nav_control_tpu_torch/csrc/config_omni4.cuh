// 4-wheel omnidirectional model (models/omni4.py): x = (x, y, theta, v1..v4,
// v1_ref..v4_ref), u = (dv1_ref..dv4_ref); bounds on the four wheel
// references and on all four inputs.  The patterns are the RK4 stage
// Jacobians' structural nonzeros as ocp/sparsity.py::detect_jacobian_sparsity
// finds them (41 of 121 in A, 20 of 44 in B); tests/test_torch_leaf.py holds
// them equal.
#pragma once
#include "pattern.cuh"

struct Omni4Config {
  static constexpr int NX = 11;
  static constexpr int NU = 4;
  using IDXBX = IndexList<7, 8, 9, 10>;
  using IDXBU = IndexList<0, 1, 2, 3>;
  using A = Pattern<11, 11,
                    1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                    0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                    0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0,
                    0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0,
                    0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0,
                    0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1,
                    0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0,
                    0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0,
                    0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0,
                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1>;
  using B = Pattern<11, 4,
                    1, 1, 1, 1,
                    1, 1, 1, 1,
                    1, 1, 1, 1,
                    1, 0, 0, 0,
                    0, 1, 0, 0,
                    0, 0, 1, 0,
                    0, 0, 0, 1,
                    1, 0, 0, 0,
                    0, 1, 0, 0,
                    0, 0, 1, 0,
                    0, 0, 0, 1>;
};
