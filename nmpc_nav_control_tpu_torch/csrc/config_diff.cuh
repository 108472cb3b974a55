// Differential-drive model (models/diff.py): x = (x, y, theta, vl, vr,
// vl_ref, vr_ref), u = (dvl_ref, dvr_ref); bounds on (vl_ref, vr_ref) and on
// both inputs.  The patterns are the RK4 stage Jacobians' structural
// nonzeros as ocp/sparsity.py::detect_jacobian_sparsity finds them
// (23 of 49 in A, 10 of 14 in B); tests/test_torch_ipm_kernels.py holds
// them equal.
#pragma once
#include "pattern.cuh"

struct DiffConfig {
  static constexpr int NX = 7;
  static constexpr int NU = 2;
  using IDXBX = IndexList<5, 6>;
  using IDXBU = IndexList<0, 1>;
  using A = Pattern<7, 7,
                    1, 0, 1, 1, 1, 1, 1,
                    0, 1, 1, 1, 1, 1, 1,
                    0, 0, 1, 1, 1, 1, 1,
                    0, 0, 0, 1, 0, 1, 0,
                    0, 0, 0, 0, 1, 0, 1,
                    0, 0, 0, 0, 0, 1, 0,
                    0, 0, 0, 0, 0, 0, 1>;
  using B = Pattern<7, 2,
                    1, 1,
                    1, 1,
                    1, 1,
                    1, 0,
                    0, 1,
                    1, 0,
                    0, 1>;
};
