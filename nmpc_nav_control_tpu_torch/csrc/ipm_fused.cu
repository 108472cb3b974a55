// The five sweeps of the batched Mehrotra box-IPM, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of nmpc_nav_control_tpu/ops/pallas_ipm.py:
//   ipm_bwd_fused_*   <- ipm_bwd_fused  (_bwd_fused_kernel)
//   ipm_fwd_affine_*  <- ipm_fwd_affine (_fwd_kernel, mode "affine")
//   ipm_bwd_corr_*    <- ipm_bwd_corr   (_bwd_corr_kernel)
//   ipm_fwd_corr_*    <- ipm_fwd_corr   (_fwd_kernel, mode "corr")
//   ipm_kkt_fused_*   <- ipm_kkt_fused  (_kkt_kernel)
// The plain torch version of each is in ops/ipm_fused.py; the arithmetic and
// its order follow the TPU kernels term by term.
//
// Design.  On the TPU a lane of an (8, 128) tile is one scenario and the
// sequential grid axis walks the stages, with the carries in VMEM scratch.
// Here one thread is one scenario: the stage loop runs inside the thread,
// every carry (the lower triangle of the cost-to-go P, p, dx, the step-ratio
// minimum, the sums, the finiteness flag) stays in registers, and the
// per-stage operands are read in the batch-minor layout [rows, E, B] at
// ((k*E)+e)*B + b, so a warp's 32 loads of one entry form one coalesced
// 128-byte transaction.  A ragged last block is masked (b >= B returns).
// The model's dimensions, bounded indices and A/B structural nonzeros are
// template parameters (config_*.cuh): every small-matrix loop unrolls and
// the products with a structural zero vanish at compile time, as the Python
// unrolling of _dot does in the TPU kernels.  The per-lane results that the
// TPU kernels rewrote on every grid step (musum, alpha, c12, finite, kkt,
// ddx_N) are written once, after the loop.
//
// Bound.  Each stage reads 60-110 floats per lane and does a few hundred
// flops on them, and the stages of one lane run in sequence, so a sweep is
// bound by memory latency times N per lane, not by bandwidth or flops: at
// B=2048 and 128 threads per block only 16 of the 132 SMs hold work, with 4
// warps each.  The design keeps each stage's loads independent of the
// previous stage's arithmetic, so the compiler can hoist them together and
// pay one latency per stage rather than one per entry.  Filling the card
// (smaller blocks, several lanes' stages in flight) is left for later work.
//
// Arithmetic is IEEE f32: the library is built without --use_fast_math.  The
// finiteness flag must see NaN and Inf, lambda/s runs up to the 1e10 cap at
// the 1e-9 slack floor, and the Cholesky needs correctly rounded sqrt and
// division.  min/max propagate NaN like jnp.minimum/jnp.maximum.
#include <cuda_runtime.h>

#include <cstddef>

#include "config_dense72.cuh"
#include "config_diff.cuh"

namespace {

constexpr float kBig = 3.4e38f;  // fraction-to-boundary sentinel (_BIG)
constexpr int kThreads = 128;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float finite1(float v) { return isfinite(v) ? 1.f : 0.f; }

// Fraction-to-boundary ratio for v + alpha dv >= 0.
__device__ __forceinline__ float ratio(float v, float dv) {
  return dv < 0.f ? -v / dv : kBig;
}

// Lane b of entry e at row k of a [rows, E, B] tensor.  Inputs are
// read-only for the kernel's lifetime, so the load goes through the
// non-coherent path and the compiler may move it ahead of earlier stores.
__device__ __forceinline__ float ld(const float* p, int k, int e, int E, int B, int b) {
  return __ldg(p + (static_cast<size_t>(k) * E + e) * B + b);
}

__device__ __forceinline__ void st(float* p, int k, int e, int E, int B, int b, float v) {
  p[(static_cast<size_t>(k) * E + e) * B + b] = v;
}

// Index of (i, j) in a lower triangle stored row-major.
__host__ __device__ constexpr int tri(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

template <class C>
struct Shape {
  static constexpr int NX = C::NX, NU = C::NU;
  static constexpr int NBX = C::IDXBX::size, NBU = C::IDXBU::size;
  static constexpr int NNZA = C::A::count(), NNZB = C::B::count();
  static constexpr int NTRX = NX * (NX + 1) / 2, NTRU = NU * (NU + 1) / 2;
};

// Row k of a packed [N, nnz, B] tensor -> dense R x Cc (zeros off pattern).
template <class P, int R, int Cc>
__device__ __forceinline__ void load_packed(float (&M)[R][Cc], const float* p, int k,
                                            int nnz, int B, int b) {
  int e = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < Cc; ++j) {
      if (P::nz(i, j)) {
        M[i][j] = ld(p, k, e, nnz, B, b);
        ++e;
      } else {
        M[i][j] = 0.f;
      }
    }
  }
}

template <int E>
__device__ __forceinline__ void load_vec(float (&v)[E], const float* p, int k, int B, int b) {
#pragma unroll
  for (int i = 0; i < E; ++i) v[i] = ld(p, k, i, E, B, b);
}

// sum_m M[i][m] v[m] over the structural nonzeros of row i.
template <class P, int R, int Cc>
__device__ __forceinline__ float row_dot(const float (&M)[R][Cc], int i, const float (&v)[Cc]) {
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < Cc; ++m)
    if (P::nz(i, m)) s += M[i][m] * v[m];
  return s;
}

// sum_m M[m][j] v[m] over the structural nonzeros of column j.
template <class P, int R, int Cc>
__device__ __forceinline__ float col_dot(const float (&M)[R][Cc], int j, const float (&v)[R]) {
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < R; ++m)
    if (P::nz(m, j)) s += M[m][j] * v[m];
  return s;
}

// x <- (L L')^{-1} x, L lower row-major.
template <int NU>
__device__ __forceinline__ void chol_solve(const float (&L)[NU * (NU + 1) / 2], float (&x)[NU]) {
  float y[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    float s = x[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[tri(i, k)] * y[k];
    y[i] = s / L[tri(i, i)];
  }
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < NU; ++k) s -= L[tri(k, i)] * x[k];
    x[i] = s / L[tri(i, i)];
  }
}

// Stationarity gradients at the consumption rows:
// gx_{k+1} = Qd dx + qx + sel'(le_xu - le_xl), gu_k = Rd du + qu + sel'(le_uu - le_ul).
template <class C>
__device__ __forceinline__ void grad_terms(const float (&Qdn)[C::NX], const float (&qxn)[C::NX],
                                           const float (&dxn)[C::NX], const float (&Rd)[C::NU],
                                           const float (&qu)[C::NU], const float (&du)[C::NU],
                                           const float (&lex)[2][C::IDXBX::size],
                                           const float (&leu)[2][C::IDXBU::size],
                                           float (&gx)[C::NX], float (&gu)[C::NU]) {
#pragma unroll
  for (int i = 0; i < C::NX; ++i) gx[i] = Qdn[i] * dxn[i] + qxn[i];
#pragma unroll
  for (int j = 0; j < C::IDXBX::size; ++j) gx[C::IDXBX::at(j)] += lex[1][j] - lex[0][j];
#pragma unroll
  for (int i = 0; i < C::NU; ++i) gu[i] = Rd[i] * du[i] + qu[i];
#pragma unroll
  for (int j = 0; j < C::IDXBU::size; ++j) gu[C::IDXBU::at(j)] += leu[1][j] - leu[0][j];
}

// One stage of the backward vector recursion with the diagonal-free carry:
// tmp = p + gx + Pc, qu_bar = gu + B' tmp, kff = -(L L')^{-1} qu_bar,
// p <- A' tmp + K' qu_bar.
template <class C>
__device__ __forceinline__ void vector_bwd(const float (&A)[C::NX][C::NX],
                                           const float (&Bm)[C::NX][C::NU],
                                           const float (&K)[C::NU][C::NX],
                                           const float (&L)[C::NU * (C::NU + 1) / 2],
                                           const float (&Pc)[C::NX], const float (&gx)[C::NX],
                                           const float (&gu)[C::NU], float (&p)[C::NX],
                                           float (&kff)[C::NU]) {
  constexpr int NX = C::NX, NU = C::NU;
  float tmp[NX], qub[NU], sol[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) tmp[i] = p[i] + gx[i] + Pc[i];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    qub[i] = gu[i] + col_dot<typename C::B>(Bm, i, tmp);
    sol[i] = qub[i];
  }
  chol_solve<NU>(L, sol);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    float kt = 0.f;
#pragma unroll
    for (int m = 0; m < NU; ++m) kt += K[m][i] * qub[m];
    p[i] = col_dot<typename C::A>(A, i, tmp) + kt;
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) kff[i] = -sol[i];
}

// Bound groups are ordered (x lower, x upper, u lower, u upper) throughout.
// Pointers travel by value: taking the address of a kernel parameter would
// copy the argument struct to the stack and put a local load in front of
// every global one.
struct In4 {
  const float* g[4];
};
struct Out4 {
  float* g[4];
};

template <class C>
struct Groups {
  float x[2][C::IDXBX::size];
  float u[2][C::IDXBU::size];

  __device__ __forceinline__ void load(In4 p, int k, int B, int b) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      load_vec(x[g], p.g[g], k, B, b);
      load_vec(u[g], p.g[2 + g], k, B, b);
    }
  }
};

// --------------------------------------------------------------------------
// Kernel 1: fused backward sweep (factor + residuals + affine recursion + mu)
// --------------------------------------------------------------------------

struct BwdFusedArgs {
  const float *A, *Bm, *Qd, *Rd, *qx, *qu, *c, *dx, *du;
  In4 s, l, bnd;
  float *K, *L, *Pc, *rdyn, *kff;
  Out4 rp;
  float* musum;
};

template <class C>
__global__ void __launch_bounds__(kThreads)
    bwd_fused_kernel(BwdFusedArgs a, int N, int B, float reg, float d_cap) {
  using S = Shape<C>;
  using PA = typename C::A;
  using PB = typename C::B;
  constexpr int NX = S::NX, NU = S::NU, NBX = S::NBX, NBU = S::NBU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float P[S::NTRX];  // lower triangle of P_core (no stage diagonal)
  float p[NX];
#pragma unroll
  for (int t = 0; t < S::NTRX; ++t) P[t] = 0.f;
#pragma unroll
  for (int i = 0; i < NX; ++i) p[i] = 0.f;
  float mu = 0.f;

#pragma unroll 1
  for (int k = N - 1; k >= 0; --k) {
    float A[NX][NX], Bm[NX][NU];
    load_packed<PA>(A, a.A, k, S::NNZA, B, b);
    load_packed<PB>(Bm, a.Bm, k, S::NNZB, B, b);
    float dx[NX], dxn[NX], du[NU], Qdn[NX], qxn[NX], Rd[NU], qu[NU], c0[NX];
    load_vec(dx, a.dx, k, B, b);
    load_vec(dxn, a.dx, k + 1, B, b);
    load_vec(du, a.du, k, B, b);
    load_vec(Qdn, a.Qd, k + 1, B, b);
    load_vec(qxn, a.qx, k + 1, B, b);
    load_vec(Rd, a.Rd, k, B, b);
    load_vec(qu, a.qu, k, B, b);
    load_vec(c0, a.c, k, B, b);
    Groups<C> s, l, bd;
    s.load(a.s, k, B, b);
    l.load(a.l, k, B, b);
    bd.load(a.bnd, k, B, b);

    // Gaps and primal residuals rp = gap - s (x bounds of row k: stage k+1).
    float rpx[2][NBX], rpu[2][NBU];
#pragma unroll
    for (int j = 0; j < NBX; ++j) {
      const float z = dxn[C::IDXBX::at(j)];
      rpx[0][j] = z - bd.x[0][j] - s.x[0][j];
      rpx[1][j] = bd.x[1][j] - z - s.x[1][j];
      st(a.rp.g[0], k, j, NBX, B, b, rpx[0][j]);
      st(a.rp.g[1], k, j, NBX, B, b, rpx[1][j]);
    }
#pragma unroll
    for (int j = 0; j < NBU; ++j) {
      const float z = du[C::IDXBU::at(j)];
      rpu[0][j] = z - bd.u[0][j] - s.u[0][j];
      rpu[1][j] = bd.u[1][j] - z - s.u[1][j];
      st(a.rp.g[2], k, j, NBU, B, b, rpu[0][j]);
      st(a.rp.g[3], k, j, NBU, B, b, rpu[1][j]);
    }

    // Complementarity sum.
#pragma unroll
    for (int j = 0; j < NBX; ++j) mu = mu + s.x[0][j] * l.x[0][j] + s.x[1][j] * l.x[1][j];
#pragma unroll
    for (int j = 0; j < NBU; ++j) mu = mu + s.u[0][j] * l.u[0][j] + s.u[1][j] * l.u[1][j];

    // Barrier diagonals on the consumed rows: state cost of stage k+1,
    // input cost of stage k.
    float qbar[NX], rbar[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) qbar[i] = Qdn[i];
#pragma unroll
    for (int j = 0; j < NBX; ++j)
      qbar[C::IDXBX::at(j)] += min_nan(l.x[0][j] / s.x[0][j] + l.x[1][j] / s.x[1][j], d_cap);
#pragma unroll
    for (int i = 0; i < NU; ++i) rbar[i] = Rd[i] + reg;
#pragma unroll
    for (int j = 0; j < NBU; ++j)
      rbar[C::IDXBU::at(j)] += min_nan(l.u[0][j] / s.u[0][j] + l.u[1][j] / s.u[1][j], d_cap);

    // Full cost-to-go at consumption: P_{k+1} = P_core + diag(qbar).
    float Pm[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) Pm[i][j] = (i == j) ? P[tri(i, j)] + qbar[i] : P[tri(i, j)];

    // Dynamics residual r_dyn = c - dx_{k+1} + A dx + B du, and Pc = P r_dyn.
    float r[NX], Pc[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float t = c0[i] - dxn[i];
      t += row_dot<PA>(A, i, dx);
      t += row_dot<PB>(Bm, i, du);
      r[i] = t;
      st(a.rdyn, k, i, NX, B, b, t);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float t = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m) t += Pm[i][m] * r[m];
      Pc[i] = t;
      st(a.Pc, k, i, NX, B, b, t);
    }

    // Riccati factorization, column by column of PA: Qux = B'PA, A'PA.
    float Qux[NU][NX], apa[S::NTRX];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float PAj[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float t = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m)
          if (PA::nz(m, j)) t += Pm[i][m] * A[m][j];
        PAj[i] = t;
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) Qux[i][j] = col_dot<PB>(Bm, i, PAj);
#pragma unroll
      for (int i = j; i < NX; ++i) apa[tri(i, j)] = col_dot<PA>(A, i, PAj);
    }
    float Quu[S::NTRU];
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      float PBj[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float t = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m)
          if (PB::nz(m, j)) t += Pm[i][m] * Bm[m][j];
        PBj[i] = t;
      }
#pragma unroll
      for (int i = j; i < NU; ++i) {
        float t = col_dot<PB>(Bm, i, PBj);
        if (i == j) t += rbar[i];
        Quu[tri(i, j)] = t;
      }
    }
    float L[S::NTRU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float t = Quu[tri(i, j)];
#pragma unroll
        for (int m = 0; m < j; ++m) t -= L[tri(i, m)] * L[tri(j, m)];
        L[tri(i, j)] = (i == j) ? sqrtf(t) : t / L[tri(j, j)];
      }
    }
    float K[NU][NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float x[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) x[i] = Qux[i][j];
      chol_solve<NU>(L, x);
#pragma unroll
      for (int i = 0; i < NU; ++i) K[i][j] = -x[i];
    }
    // P_core_k = A'PA + Qux'K, lower triangle only (symmetric by construction).
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float t = 0.f;
#pragma unroll
        for (int m = 0; m < NU; ++m) t += Qux[m][i] * K[m][j];
        P[tri(i, j)] = apa[tri(i, j)] + t;
      }
    }
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) st(a.K, k, i * NX + j, NU * NX, B, b, K[i][j]);
#pragma unroll
    for (int t = 0; t < S::NTRU; ++t) st(a.L, k, t, S::NTRU, B, b, L[t]);

    // Affine vector recursion (sigma = 0, no corrector): le = -(lam/s) rp.
    float lex[2][NBX], leu[2][NBU];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int j = 0; j < NBX; ++j) lex[g][j] = -(l.x[g][j] / s.x[g][j]) * rpx[g][j];
#pragma unroll
      for (int j = 0; j < NBU; ++j) leu[g][j] = -(l.u[g][j] / s.u[g][j]) * rpu[g][j];
    }
    float gx[NX], gu[NU], kff[NU];
    grad_terms<C>(Qdn, qxn, dxn, Rd, qu, du, lex, leu, gx, gu);
    vector_bwd<C>(A, Bm, K, L, Pc, gx, gu, p, kff);
#pragma unroll
    for (int i = 0; i < NU; ++i) st(a.kff, k, i, NU, B, b, kff[i]);
  }
  a.musum[b] = mu;
}

// --------------------------------------------------------------------------
// Kernels 2 and 4: forward sweeps (rollout + deltas + step length)
// --------------------------------------------------------------------------

struct FwdArgs {
  const float *A, *Bm, *K, *kff, *rdyn, *r_init;
  In4 s, l, rp;
  In4 corr;                       // corrector only
  const float* sigma_mu;          // corrector only
  Out4 prod;                      // affine only
  float* c12;                     // affine only
  float *ddx, *ddu, *ddx_N;       // corrector only
  Out4 ds, dl;                    // corrector only
  float *finite, *alpha;
};

struct FwdCarry {
  float m, c1, c2, fin;
};

// Slack and multiplier deltas of one bound entry, the ratio update, and the
// mode's accumulations; sign is +1 for a lower bound, -1 for an upper one.
template <bool CORR>
__device__ __forceinline__ void fwd_delta(float s, float lam, float rp, float co, float sm,
                                          float dz, float sign, FwdCarry& cr, float& ds,
                                          float& dl) {
  float le;
  if constexpr (CORR) {
    le = (sm - co) / s - (lam / s) * rp;
  } else {
    le = -(lam / s) * rp;
  }
  ds = rp + sign * dz;
  dl = -sign * (lam / s) * dz + le - lam;
  cr.m = min_nan(cr.m, ratio(s, ds));
  cr.m = min_nan(cr.m, ratio(lam, dl));
  if constexpr (CORR) {
    cr.fin *= finite1(ds) * finite1(dl);
  } else {
    cr.c1 = cr.c1 + s * dl + lam * ds;
    cr.c2 = cr.c2 + ds * dl;
  }
}

template <class C, bool CORR>
__global__ void __launch_bounds__(kThreads) fwd_kernel(FwdArgs a, int N, int B, float tau) {
  using S = Shape<C>;
  using PA = typename C::A;
  using PB = typename C::B;
  constexpr int NX = S::NX, NU = S::NU, NBX = S::NBX, NBU = S::NBU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float dx[NX];
  load_vec(dx, a.r_init, 0, B, b);  // r_init = dx0 - dx[0]
  FwdCarry cr{kBig, 0.f, 0.f, 1.f};
  float sm = 0.f;
  if constexpr (CORR) sm = __ldg(a.sigma_mu + b);

#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    // All of the stage's operands first.
    float A[NX][NX], Bm[NX][NU], K[NU][NX], kff[NU], c[NX];
    load_packed<PA>(A, a.A, k, S::NNZA, B, b);
    load_packed<PB>(Bm, a.Bm, k, S::NNZB, B, b);
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) K[i][j] = ld(a.K, k, i * NX + j, NU * NX, B, b);
    load_vec(kff, a.kff, k, B, b);
    load_vec(c, a.rdyn, k, B, b);
    Groups<C> s, l, rp, co;
    s.load(a.s, k, B, b);
    l.load(a.l, k, B, b);
    rp.load(a.rp, k, B, b);
    if constexpr (CORR) co.load(a.corr, k, B, b);

    // Rollout: du = K dx + kff, dx' = A dx + B du + r_dyn.
    float du[NU], dxn[NX];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float t = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m) t += K[i][m] * dx[m];
      du[i] = kff[i] + t;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float t = c[i];
      t += row_dot<PA>(A, i, dx);
      t += row_dot<PB>(Bm, i, du);
      dxn[i] = t;
    }
    if constexpr (CORR) {
#pragma unroll
      for (int i = 0; i < NU; ++i) cr.fin *= finite1(du[i]);
#pragma unroll
      for (int i = 0; i < NX; ++i) cr.fin *= finite1(dxn[i]);
    }

    // Deltas per bound entry, in the TPU kernel's group order.
    float dsx[2][NBX], dlx[2][NBX], dsu[2][NBU], dlu[2][NBU];
#pragma unroll
    for (int j = 0; j < NBX; ++j) {
      const float dz = dxn[C::IDXBX::at(j)];
#pragma unroll
      for (int g = 0; g < 2; ++g)
        fwd_delta<CORR>(s.x[g][j], l.x[g][j], rp.x[g][j], CORR ? co.x[g][j] : 0.f, sm, dz,
                        g == 0 ? 1.f : -1.f, cr, dsx[g][j], dlx[g][j]);
    }
#pragma unroll
    for (int j = 0; j < NBU; ++j) {
      const float dz = du[C::IDXBU::at(j)];
#pragma unroll
      for (int g = 0; g < 2; ++g)
        fwd_delta<CORR>(s.u[g][j], l.u[g][j], rp.u[g][j], CORR ? co.u[g][j] : 0.f, sm, dz,
                        g == 0 ? 1.f : -1.f, cr, dsu[g][j], dlu[g][j]);
    }

    // Stores last.
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int j = 0; j < NBX; ++j) {
        if constexpr (CORR) {
          st(a.ds.g[g], k, j, NBX, B, b, dsx[g][j]);
          st(a.dl.g[g], k, j, NBX, B, b, dlx[g][j]);
        } else {
          st(a.prod.g[g], k, j, NBX, B, b, dsx[g][j] * dlx[g][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NBU; ++j) {
        if constexpr (CORR) {
          st(a.ds.g[2 + g], k, j, NBU, B, b, dsu[g][j]);
          st(a.dl.g[2 + g], k, j, NBU, B, b, dlu[g][j]);
        } else {
          st(a.prod.g[2 + g], k, j, NBU, B, b, dsu[g][j] * dlu[g][j]);
        }
      }
    }
    if constexpr (CORR) {
#pragma unroll
      for (int i = 0; i < NX; ++i) st(a.ddx, k, i, NX, B, b, dx[i]);
#pragma unroll
      for (int i = 0; i < NU; ++i) st(a.ddu, k, i, NU, B, b, du[i]);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[i] = dxn[i];
  }
  a.alpha[b] = min_nan(1.f, tau * cr.m);
  if constexpr (CORR) {
#pragma unroll
    for (int i = 0; i < NX; ++i) st(a.ddx_N, 0, i, NX, B, b, dx[i]);
    a.finite[b] = cr.fin;
  } else {
    a.c12[b] = cr.c1;
    a.c12[B + b] = cr.c2;
  }
}

// --------------------------------------------------------------------------
// Kernel 3: corrector backward sweep (vector recursion, gradients in-kernel)
// --------------------------------------------------------------------------

struct BwdCorrArgs {
  const float *A, *Bm, *K, *L, *Pc, *Qd, *qx, *dx, *Rd, *qu, *du;
  In4 s, l, rp, corr;
  const float* sigma_mu;
  float* kff;
};

template <class C>
__global__ void __launch_bounds__(kThreads) bwd_corr_kernel(BwdCorrArgs a, int N, int B) {
  using S = Shape<C>;
  constexpr int NX = S::NX, NU = S::NU, NBX = S::NBX, NBU = S::NBU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float p[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) p[i] = 0.f;
  const float sm = __ldg(a.sigma_mu + b);

#pragma unroll 1
  for (int k = N - 1; k >= 0; --k) {
    float A[NX][NX], Bm[NX][NU], K[NU][NX], L[S::NTRU], Pc[NX];
    load_packed<typename C::A>(A, a.A, k, S::NNZA, B, b);
    load_packed<typename C::B>(Bm, a.Bm, k, S::NNZB, B, b);
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) K[i][j] = ld(a.K, k, i * NX + j, NU * NX, B, b);
    load_vec(L, a.L, k, B, b);
    load_vec(Pc, a.Pc, k, B, b);
    float Qdn[NX], qxn[NX], dxn[NX], Rd[NU], qu[NU], du[NU];
    load_vec(Qdn, a.Qd, k + 1, B, b);
    load_vec(qxn, a.qx, k + 1, B, b);
    load_vec(dxn, a.dx, k + 1, B, b);
    load_vec(Rd, a.Rd, k, B, b);
    load_vec(qu, a.qu, k, B, b);
    load_vec(du, a.du, k, B, b);
    Groups<C> s, l, rp, co;
    s.load(a.s, k, B, b);
    l.load(a.l, k, B, b);
    rp.load(a.rp, k, B, b);
    co.load(a.corr, k, B, b);

    // Effective multiplier gradients (sigma mu - corr)/s - (lam/s) rp.
    float lex[2][NBX], leu[2][NBU];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int j = 0; j < NBX; ++j)
        lex[g][j] = (sm - co.x[g][j]) / s.x[g][j] - (l.x[g][j] / s.x[g][j]) * rp.x[g][j];
#pragma unroll
      for (int j = 0; j < NBU; ++j)
        leu[g][j] = (sm - co.u[g][j]) / s.u[g][j] - (l.u[g][j] / s.u[g][j]) * rp.u[g][j];
    }
    float gx[NX], gu[NU], kff[NU];
    grad_terms<C>(Qdn, qxn, dxn, Rd, qu, du, lex, leu, gx, gu);
    vector_bwd<C>(A, Bm, K, L, Pc, gx, gu, p, kff);
#pragma unroll
    for (int i = 0; i < NU; ++i) st(a.kff, k, i, NU, B, b, kff[i]);
  }
}

// --------------------------------------------------------------------------
// Kernel 5: post-solve KKT stationarity + complementarity
// --------------------------------------------------------------------------

struct KKTArgs {
  const float *A, *Bm, *Qd, *qx, *dx, *Rd, *qu, *du;
  In4 l, s;
  float *kkt, *musum;
};

// Costate recursion nu_{k+1} = gx_{k+1} + c, c <- A_k' nu_{k+1};
// ru_k = gu_k + B_k' nu_{k+1}; kkt = max_k |ru_k|.
template <class C>
__global__ void __launch_bounds__(kThreads) kkt_kernel(KKTArgs a, int N, int B) {
  using S = Shape<C>;
  constexpr int NX = S::NX, NU = S::NU, NBX = S::NBX, NBU = S::NBU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float c[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) c[i] = 0.f;
  float m = 0.f, mu = 0.f;

#pragma unroll 1
  for (int k = N - 1; k >= 0; --k) {
    float A[NX][NX], Bm[NX][NU];
    load_packed<typename C::A>(A, a.A, k, S::NNZA, B, b);
    load_packed<typename C::B>(Bm, a.Bm, k, S::NNZB, B, b);
    float Qdn[NX], qxn[NX], dxn[NX], Rd[NU], qu[NU], du[NU];
    load_vec(Qdn, a.Qd, k + 1, B, b);
    load_vec(qxn, a.qx, k + 1, B, b);
    load_vec(dxn, a.dx, k + 1, B, b);
    load_vec(Rd, a.Rd, k, B, b);
    load_vec(qu, a.qu, k, B, b);
    load_vec(du, a.du, k, B, b);
    Groups<C> l, s;
    l.load(a.l, k, B, b);
    s.load(a.s, k, B, b);

    float gx[NX], gu[NU], nu_v[NX];
    grad_terms<C>(Qdn, qxn, dxn, Rd, qu, du, l.x, l.u, gx, gu);
#pragma unroll
    for (int i = 0; i < NX; ++i) nu_v[i] = gx[i] + c[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) m = max_nan(m, fabsf(gu[i] + col_dot<typename C::B>(Bm, i, nu_v)));
#pragma unroll
    for (int j = 0; j < NBX; ++j) mu = mu + (s.x[0][j] * l.x[0][j] + s.x[1][j] * l.x[1][j]);
#pragma unroll
    for (int j = 0; j < NBU; ++j) mu = mu + (s.u[0][j] * l.u[0][j] + s.u[1][j] * l.u[1][j]);
#pragma unroll
    for (int i = 0; i < NX; ++i) c[i] = col_dot<typename C::A>(A, i, nu_v);
  }
  a.kkt[b] = m;
  a.musum[b] = mu;
}

// --------------------------------------------------------------------------
// Launchers: pointers arrive as an array, inputs then outputs, in the order
// of the argument structs above (ops/ipm_fused.py builds it).
// --------------------------------------------------------------------------

struct PtrReader {
  void* const* p;
  int i = 0;
  const float* in() { return static_cast<const float*>(p[i++]); }
  float* out() { return static_cast<float*>(p[i++]); }
  void in(In4& g) {
    for (auto& p : g.g) p = in();
  }
  void out(Out4& g) {
    for (auto& p : g.g) p = out();
  }
};

inline dim3 grid_of(int B) { return dim3((B + kThreads - 1) / kThreads); }

inline int bad_args(int n, int want, int N, int B) {
  return (n != want || N <= 0 || B <= 0) ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

template <class C>
int launch_bwd_fused(void* const* ptrs, int n, int N, int B, float reg, float d_cap,
                     cudaStream_t stream) {
  if (int e = bad_args(n, 31, N, B)) return e;
  PtrReader r{ptrs};
  BwdFusedArgs a;
  a.A = r.in(); a.Bm = r.in(); a.Qd = r.in(); a.Rd = r.in(); a.qx = r.in();
  a.qu = r.in(); a.c = r.in(); a.dx = r.in(); a.du = r.in();
  r.in(a.s); r.in(a.l); r.in(a.bnd);
  a.K = r.out(); a.L = r.out(); a.Pc = r.out(); a.rdyn = r.out(); a.kff = r.out();
  r.out(a.rp); a.musum = r.out();
  bwd_fused_kernel<C><<<grid_of(B), kThreads, 0, stream>>>(a, N, B, reg, d_cap);
  return static_cast<int>(cudaGetLastError());
}

template <class C, bool CORR>
int launch_fwd(void* const* ptrs, int n, int N, int B, float tau, cudaStream_t stream) {
  if (int e = bad_args(n, CORR ? 36 : 24, N, B)) return e;
  PtrReader r{ptrs};
  FwdArgs a{};
  a.A = r.in(); a.Bm = r.in(); a.K = r.in(); a.kff = r.in(); a.rdyn = r.in();
  a.r_init = r.in();
  r.in(a.s); r.in(a.l); r.in(a.rp);
  if (CORR) {
    r.in(a.corr); a.sigma_mu = r.in();
    a.ddx = r.out(); a.ddu = r.out(); a.ddx_N = r.out();
    r.out(a.ds); r.out(a.dl);
    a.alpha = r.out(); a.finite = r.out();
  } else {
    r.out(a.prod);
    a.alpha = r.out(); a.c12 = r.out();
  }
  fwd_kernel<C, CORR><<<grid_of(B), kThreads, 0, stream>>>(a, N, B, tau);
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int launch_bwd_corr(void* const* ptrs, int n, int N, int B, cudaStream_t stream) {
  if (int e = bad_args(n, 29, N, B)) return e;
  PtrReader r{ptrs};
  BwdCorrArgs a;
  a.A = r.in(); a.Bm = r.in(); a.K = r.in(); a.L = r.in(); a.Pc = r.in();
  a.Qd = r.in(); a.qx = r.in(); a.dx = r.in(); a.Rd = r.in(); a.qu = r.in();
  a.du = r.in();
  r.in(a.s); r.in(a.l); r.in(a.rp); r.in(a.corr); a.sigma_mu = r.in();
  a.kff = r.out();
  bwd_corr_kernel<C><<<grid_of(B), kThreads, 0, stream>>>(a, N, B);
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int launch_kkt(void* const* ptrs, int n, int N, int B, cudaStream_t stream) {
  if (int e = bad_args(n, 18, N, B)) return e;
  PtrReader r{ptrs};
  KKTArgs a;
  a.A = r.in(); a.Bm = r.in(); a.Qd = r.in(); a.qx = r.in(); a.dx = r.in();
  a.Rd = r.in(); a.qu = r.in(); a.du = r.in();
  r.in(a.l); r.in(a.s);
  a.kkt = r.out(); a.musum = r.out();
  kkt_kernel<C><<<grid_of(B), kThreads, 0, stream>>>(a, N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define IPM_EXPORT(name, Config)                                                             \
  extern "C" int ipm_bwd_fused_##name(void* const* p, int n, int N, int B, float f0,        \
                                      float f1, void* s) {                                   \
    return launch_bwd_fused<Config>(p, n, N, B, f0, f1, static_cast<cudaStream_t>(s));      \
  }                                                                                          \
  extern "C" int ipm_fwd_affine_##name(void* const* p, int n, int N, int B, float f0,       \
                                       float, void* s) {                                     \
    return launch_fwd<Config, false>(p, n, N, B, f0, static_cast<cudaStream_t>(s));         \
  }                                                                                          \
  extern "C" int ipm_fwd_corr_##name(void* const* p, int n, int N, int B, float f0, float,  \
                                     void* s) {                                              \
    return launch_fwd<Config, true>(p, n, N, B, f0, static_cast<cudaStream_t>(s));          \
  }                                                                                          \
  extern "C" int ipm_bwd_corr_##name(void* const* p, int n, int N, int B, float, float,     \
                                     void* s) {                                              \
    return launch_bwd_corr<Config>(p, n, N, B, static_cast<cudaStream_t>(s));               \
  }                                                                                          \
  extern "C" int ipm_kkt_fused_##name(void* const* p, int n, int N, int B, float, float,    \
                                      void* s) {                                             \
    return launch_kkt<Config>(p, n, N, B, static_cast<cudaStream_t>(s));                    \
  }

IPM_EXPORT(diff, DiffConfig)
IPM_EXPORT(dense72, Dense72Config)
