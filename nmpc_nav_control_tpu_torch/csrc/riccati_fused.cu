// Batched Riccati factorisation and the two halves of the Riccati solve,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of nmpc_nav_control_tpu/ops/pallas_riccati.py:
//   riccati_factor_*     <- riccati_factor_batched (_factor_kernel)
//   riccati_solve_bwd_*  <- riccati_solve_batched, backward (_solve_bwd_kernel)
//   riccati_solve_fwd_*  <- riccati_solve_batched, forward (_solve_fwd_kernel)
// The plain torch version of each is in ops/riccati_fused.py; the recursion
// is that of qp/riccati.py, term by term.
//
// Design.  One thread is one scenario lane; the stage loop runs inside the
// thread.  Operands are dense (no sparsity pattern) and batch-minor, entry e
// of row k of lane b at ((k*E)+e)*B + b, so a warp's loads of one entry are
// one coalesced 128-byte transaction.  The factor's cost-to-go carry P is the
// full symmetric matrix stored as its lower triangle: Ps[k] = P_k is written
// for every row 0..N, and each P_k is symmetrised as (M + M')/2 like
// qp/riccati.py.  Each stage starts by copying all of its operands into the
// thread's own slots of shared memory with cp.async (stride kThreads, so the
// 32 lanes of a warp hit 32 banks): every copy of the stage is in flight at
// once, no register holds it, and the stage pays one memory latency.  At
// nx = 11 the factor would otherwise hold A (121 floats), P (66) and the new
// P (66) at once, past the 255 registers of a thread; here A, B and the P
// carry stay in shared memory and P A is formed one column at a time, as in
// ops/pallas_ipm.py.  The solve kernels keep their carry (p, dx) in registers.
//
// Bound.  Each stage reads and writes a few hundred floats per lane and does
// a few thousand flops on them, and the stages of a lane run in sequence, so
// the kernels are bound by memory latency times N per lane, not by bandwidth
// or flops.  Blocks are one warp (kThreads = 32), so B = 2048 lanes spread
// over 64 SMs.  Filling the card, and overlapping a stage's copies with the
// previous stage's arithmetic, is later work.
//
// Arithmetic is IEEE f32 (no --use_fast_math): a non-positive pivot gives NaN
// through sqrtf and poisons the lane, which the IPM's per-lane rejection of
// non-finite steps relies on.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 32;

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

// One thread's slots in shared memory: entry e at p[e * kThreads].
struct Slots {
  float* p;
  __device__ __forceinline__ float& operator[](int e) const { return p[e * kThreads]; }
};

// The thread's slots for an array that starts OFF floats into the block's
// shared memory.
template <int OFF>
__device__ __forceinline__ Slots slots(float* smem) {
  return Slots{smem + OFF * kThreads + threadIdx.x};
}

// Asynchronous 4-byte copy global -> shared (sm_80 and later): it holds no
// register, and the thread's copies are complete after cp_async_wait().
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy row k (E entries) of a batch-minor [rows, E, B] tensor into slots.
template <int E>
__device__ __forceinline__ void stage_row(Slots dst, const float* src, int k, int B, int b) {
#pragma unroll
  for (int e = 0; e < E; ++e) cp_async(&dst[e], src + (static_cast<size_t>(k) * E + e) * B + b);
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

// --------------------------------------------------------------------------
// Factor: A, B, Qd, Rd -> Ps (every row 0..N), Ks, Ls (packed lower)
// --------------------------------------------------------------------------

struct FactorArgs {
  const float *A, *Bm, *Qd, *Rd;
  float *Ps, *Ks, *Ls;
};

template <int NX, int NU>
struct FactorSlots {  // offsets, in floats per thread, of the factor's arrays
  static constexpr int NTRX = NX * (NX + 1) / 2;
  static constexpr int A = 0, B = A + NX * NX, P = B + NX * NU, QD = P + NTRX, RD = QD + NX;
  static constexpr int SIZE = RD + NU;
};

template <int NX, int NU>
__global__ void __launch_bounds__(kThreads)
    factor_kernel(FactorArgs a, int N, int B, float reg) {
  using S = FactorSlots<NX, NU>;
  constexpr int NTRX = S::NTRX, NTRU = NU * (NU + 1) / 2;
  extern __shared__ float smem[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Slots sA = slots<S::A>(smem), sB = slots<S::B>(smem), sP = slots<S::P>(smem);
  const Slots sQ = slots<S::QD>(smem), sR = slots<S::RD>(smem);

  // P_N = diag(Qd_N).
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    const float q = ld(a.Qd, N, i, NX, B, b);
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      st(a.Ps, N, i * NX + j, NX * NX, B, b, (i == j) ? q : 0.f);
      if (j <= i) sP[tri(i, j)] = (i == j) ? q : 0.f;
    }
  }

#pragma unroll 1
  for (int k = N - 1; k >= 0; --k) {
    stage_row<NX * NX>(sA, a.A, k, B, b);
    stage_row<NX * NU>(sB, a.Bm, k, B, b);
    stage_row<NX>(sQ, a.Qd, k, B, b);
    stage_row<NU>(sR, a.Rd, k, B, b);
    cp_async_wait();

    // Column j of PA = P_{k+1} A gives column j of Qux = B'PA and column j
    // of A'PA; acc gathers (A'PA + (A'PA)')/2, lower triangle.
    float acc[NTRX], Qux[NU][NX];
#pragma unroll
    for (int e = 0; e < NTRX; ++e) acc[e] = 0.f;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float PAj[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m) s += sP[tri(i, m)] * sA[m * NX + j];
        PAj[i] = s;
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m) s += sB[m * NU + u] * PAj[m];
        Qux[u][j] = s;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m) s += sA[m * NX + i] * PAj[m];
        acc[tri(i, j)] += (i == j) ? s : 0.5f * s;
      }
    }

    // Quu = B'PB + diag(Rd + reg), lower triangle, one column of PB at a time.
    float Quu[NTRU];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float PBu[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m) s += sP[tri(i, m)] * sB[m * NU + u];
        PBu[i] = s;
      }
#pragma unroll
      for (int v = u; v < NU; ++v) {
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m) s += sB[m * NU + v] * PBu[m];
        Quu[tri(v, u)] = (v == u) ? s + (sR[u] + reg) : s;
      }
    }

    // L = chol(Quu); K = -Quu^{-1} Qux, column by column.
    float L[NTRU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float s = Quu[tri(i, j)];
#pragma unroll
        for (int m = 0; m < j; ++m) s -= L[tri(i, m)] * L[tri(j, m)];
        L[tri(i, j)] = (i == j) ? sqrtf(s) : s / L[tri(j, j)];
      }
    }
    float K[NU][NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float x[NU];
#pragma unroll
      for (int u = 0; u < NU; ++u) x[u] = Qux[u][j];
      chol_solve<NU>(L, x);
#pragma unroll
      for (int u = 0; u < NU; ++u) K[u][j] = -x[u];
    }

    // P_k = (M + M')/2 + diag(Qd_k), M = A'PA + Qux'K.
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float s = 0.f;
#pragma unroll
        for (int u = 0; u < NU; ++u) s += Qux[u][i] * K[u][j];
        acc[tri(i, j)] += (i == j) ? s : 0.5f * s;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) acc[tri(i, i)] += sQ[i];

#pragma unroll
    for (int e = 0; e < NTRX; ++e) sP[e] = acc[e];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) st(a.Ps, k, i * NX + j, NX * NX, B, b, acc[tri(i, j)]);
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int j = 0; j < NX; ++j) st(a.Ks, k, u * NX + j, NU * NX, B, b, K[u][j]);
#pragma unroll
    for (int e = 0; e < NTRU; ++e) st(a.Ls, k, e, NTRU, B, b, L[e]);
  }
}

// --------------------------------------------------------------------------
// Solve, backward half: factors + gradients -> kff
//   tmp = p + P_{k+1} c_k, qu_bar = qu_k + B'tmp, kff = -(L L')^{-1} qu_bar,
//   p <- qx_k + A'tmp + K'qu_bar, from p = qx_N.
// --------------------------------------------------------------------------

struct SolveBwdArgs {
  const float *A, *Bm, *Ks, *Ls, *Ps, *qx, *qu, *c;
  float* kff;
};

template <int NX, int NU>
struct SolveBwdSlots {
  static constexpr int NTRX = NX * (NX + 1) / 2, NTRU = NU * (NU + 1) / 2;
  static constexpr int A = 0, B = A + NX * NX, K = B + NX * NU, P = K + NU * NX, L = P + NTRX,
                       C = L + NTRU, QX = C + NX, QU = QX + NX;
  static constexpr int SIZE = QU + NU;
};

template <int NX, int NU>
__global__ void __launch_bounds__(kThreads) solve_bwd_kernel(SolveBwdArgs a, int N, int B) {
  using S = SolveBwdSlots<NX, NU>;
  constexpr int NTRU = S::NTRU;
  extern __shared__ float smem[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Slots sA = slots<S::A>(smem), sB = slots<S::B>(smem), sK = slots<S::K>(smem);
  const Slots sP = slots<S::P>(smem), sL = slots<S::L>(smem), sc = slots<S::C>(smem);
  const Slots sqx = slots<S::QX>(smem), squ = slots<S::QU>(smem);

  float p[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) p[i] = ld(a.qx, N, i, NX, B, b);

#pragma unroll 1
  for (int k = N - 1; k >= 0; --k) {
    stage_row<NX * NX>(sA, a.A, k, B, b);
    stage_row<NX * NU>(sB, a.Bm, k, B, b);
    stage_row<NU * NX>(sK, a.Ks, k, B, b);
    stage_row<NTRU>(sL, a.Ls, k, B, b);
    stage_row<NX>(sc, a.c, k, B, b);
    stage_row<NX>(sqx, a.qx, k, B, b);
    stage_row<NU>(squ, a.qu, k, B, b);
    // P_{k+1} is symmetric: only its lower triangle is copied.
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j)
        cp_async(&sP[tri(i, j)],
                 a.Ps + (static_cast<size_t>(k + 1) * NX * NX + i * NX + j) * B + b);
    cp_async_wait();

    float tmp[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m) s += sP[tri(i, m)] * sc[m];
      tmp[i] = p[i] + s;
    }
    float L[NTRU], qub[NU], sol[NU];
#pragma unroll
    for (int e = 0; e < NTRU; ++e) L[e] = sL[e];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m) s += sB[m * NU + u] * tmp[m];
      qub[u] = squ[u] + s;
      sol[u] = qub[u];
    }
    chol_solve<NU>(L, sol);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float s = 0.f, r = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m) s += sA[m * NX + i] * tmp[m];
#pragma unroll
      for (int u = 0; u < NU; ++u) r += sK[u * NX + i] * qub[u];
      p[i] = (sqx[i] + s) + r;
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) st(a.kff, k, u, NU, B, b, -sol[u]);
  }
}

// --------------------------------------------------------------------------
// Solve, forward half: du = K dx + kff, dx' = A dx + B du + c, from dx0;
// writes dx_0..dx_N and du_0..du_{N-1}.
// --------------------------------------------------------------------------

struct SolveFwdArgs {
  const float *A, *Bm, *Ks, *kff, *c, *dx0;
  float *dxs, *dus;
};

template <int NX, int NU>
struct SolveFwdSlots {
  static constexpr int A = 0, B = A + NX * NX, K = B + NX * NU, KFF = K + NU * NX, C = KFF + NU;
  static constexpr int SIZE = C + NX;
};

template <int NX, int NU>
__global__ void __launch_bounds__(kThreads) solve_fwd_kernel(SolveFwdArgs a, int N, int B) {
  using S = SolveFwdSlots<NX, NU>;
  extern __shared__ float smem[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Slots sA = slots<S::A>(smem), sB = slots<S::B>(smem), sK = slots<S::K>(smem);
  const Slots skff = slots<S::KFF>(smem), sc = slots<S::C>(smem);

  float dx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) dx[i] = ld(a.dx0, 0, i, NX, B, b);

#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    stage_row<NX * NX>(sA, a.A, k, B, b);
    stage_row<NX * NU>(sB, a.Bm, k, B, b);
    stage_row<NU * NX>(sK, a.Ks, k, B, b);
    stage_row<NU>(skff, a.kff, k, B, b);
    stage_row<NX>(sc, a.c, k, B, b);
    cp_async_wait();

    float du[NU], dxn[NX];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m) s += sK[u * NX + m] * dx[m];
      du[u] = s + skff[u];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float s = 0.f, r = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m) s += sA[i * NX + m] * dx[m];
#pragma unroll
      for (int u = 0; u < NU; ++u) r += sB[i * NU + u] * du[u];
      dxn[i] = (s + r) + sc[i];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) st(a.dxs, k, i, NX, B, b, dx[i]);
#pragma unroll
    for (int u = 0; u < NU; ++u) st(a.dus, k, u, NU, B, b, du[u]);
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[i] = dxn[i];
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) st(a.dxs, N, i, NX, B, b, dx[i]);
}

// --------------------------------------------------------------------------
// Launchers: pointers arrive as an array, inputs then outputs, in the order
// of the argument structs above (ops/riccati_fused.py builds it).
// --------------------------------------------------------------------------

inline dim3 grid_of(int B) { return dim3((B + kThreads - 1) / kThreads); }

// Dynamic shared memory of a block: every thread's slots.
template <class S>
constexpr size_t smem_of() {
  constexpr size_t bytes = sizeof(float) * S::SIZE * kThreads;
  static_assert(bytes <= 48 * 1024, "a block past 48 KB of shared memory needs the opt-in");
  return bytes;
}

inline int bad_args(int n, int want, int N, int B) {
  return (n != want || N <= 0 || B <= 0) ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

template <int NX, int NU>
int launch_factor(void* const* p, int n, int N, int B, float reg, cudaStream_t stream) {
  if (int e = bad_args(n, 7, N, B)) return e;
  FactorArgs a{static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
               static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
               static_cast<float*>(p[4]), static_cast<float*>(p[5]),
               static_cast<float*>(p[6])};
  factor_kernel<NX, NU><<<grid_of(B), kThreads, smem_of<FactorSlots<NX, NU>>(), stream>>>(
      a, N, B, reg);
  return static_cast<int>(cudaGetLastError());
}

template <int NX, int NU>
int launch_solve_bwd(void* const* p, int n, int N, int B, cudaStream_t stream) {
  if (int e = bad_args(n, 9, N, B)) return e;
  SolveBwdArgs a{static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
                 static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
                 static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
                 static_cast<const float*>(p[6]), static_cast<const float*>(p[7]),
                 static_cast<float*>(p[8])};
  solve_bwd_kernel<NX, NU><<<grid_of(B), kThreads, smem_of<SolveBwdSlots<NX, NU>>(), stream>>>(
      a, N, B);
  return static_cast<int>(cudaGetLastError());
}

template <int NX, int NU>
int launch_solve_fwd(void* const* p, int n, int N, int B, cudaStream_t stream) {
  if (int e = bad_args(n, 8, N, B)) return e;
  SolveFwdArgs a{static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
                 static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
                 static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
                 static_cast<float*>(p[6]), static_cast<float*>(p[7])};
  solve_fwd_kernel<NX, NU><<<grid_of(B), kThreads, smem_of<SolveFwdSlots<NX, NU>>(), stream>>>(
      a, N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define RICCATI_EXPORT(nx, nu)                                                               \
  extern "C" int riccati_factor_##nx##x##nu(void* const* p, int n, int N, int B, float f0,  \
                                            float, void* s) {                                \
    return launch_factor<nx, nu>(p, n, N, B, f0, static_cast<cudaStream_t>(s));             \
  }                                                                                          \
  extern "C" int riccati_solve_bwd_##nx##x##nu(void* const* p, int n, int N, int B, float,  \
                                               float, void* s) {                             \
    return launch_solve_bwd<nx, nu>(p, n, N, B, static_cast<cudaStream_t>(s));              \
  }                                                                                          \
  extern "C" int riccati_solve_fwd_##nx##x##nu(void* const* p, int n, int N, int B, float,  \
                                               float, void* s) {                             \
    return launch_solve_fwd<nx, nu>(p, n, N, B, static_cast<cudaStream_t>(s));              \
  }

RICCATI_EXPORT(7, 2)
RICCATI_EXPORT(11, 4)
