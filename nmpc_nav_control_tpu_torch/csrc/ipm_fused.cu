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
// Per-stage operands are batch-minor [rows, E, B], entry e of row k of lane b
// at ((k*E)+e)*B + b.  The model's dimensions, bounded indices and A/B
// structural nonzeros are template parameters (config_*.cuh); a product with
// a structural zero is left out of its sum (at compile time where the index
// is static, by a per-thread bit mask where it is a thread's column), as the
// Python unrolling of _dot does in the TPU kernels, so a NaN or Inf times a
// structural zero never enters a result.  Per-lane results (musum, alpha,
// c12, finite, kkt, ddx_N) are written once, after the stage loop.
//
// Bound.  Each stage reads 60-180 floats per lane and does a few hundred to
// a few thousand flops on them, and a lane's stages run in sequence, so each
// sweep is bound by its serial chain per lane and by memory latency, far
// from the card's bandwidth or flop rate.  Every sweep splits a lane's
// stages so that only the carry is sequential:
//
//   fwd_kernel (ipm_fwd_affine, ipm_fwd_corr): a block owns kSweepLanes lanes
//   and walks the horizon in chunks of S stages.  Warp 0 rolls the chunk out
//   (one thread per lane, du = K dx + kff, dx' = A dx + B du + r_dyn) from
//   operands that the other warps copied into a shared-memory ring with
//   cp.async two chunks ahead; only the carry dx is sequential.  Meanwhile
//   the other warps, one thread per (stage, lane) of the previous chunk, do
//   the bound-entry work, which depends on nothing but that stage's dx_{k+1}
//   and du_k: deltas, ratios, products, finiteness.  Their partials are
//   reduced per lane at the end.
//
//   bwd_fused_kernel: a block owns 8 lanes and walks the horizon backward in
//   chunks of S stages.  Producer warps, one or two threads per (stage,
//   lane), prepare the next chunk in shared memory: the work no carry feeds
//   (gaps and rp, sum s*lam, barrier diagonals, gradients, r_dyn) and A, B
//   laid out dense.  Meanwhile each lane's team of 16 threads, two teams to
//   a warp, runs the Riccati chain: thread j owns column j of [A | B], so of
//   P A, Qux, A'PA, K and the new P carry, and row j of P r_dyn; the nu x nu
//   Cholesky runs in every thread.  A stage is two halves, each ending in a
//   __syncwarp; the affine vector recursion runs one stage late, inside the
//   next stage's first half.  Results leave through a shared-memory tile that
//   the producers write out a row of 8 lanes at a time.
//
//   bwd_corr_kernel (ipm_bwd_corr), kkt_kernel (ipm_kkt_fused): one
//   skeleton (vec_sweep), fwd_kernel's split run backward.  A block owns
//   kSweepLanes lanes and walks the horizon from its end in chunks of S
//   stages.  Warp 0 runs the short chain, one thread per lane, from a
//   shared-memory ring: p <- A'(p + w) + K'qu_bar with qu_bar = gu + B'(p +
//   w) for bwd_corr; nu = gx + c, c <- A'nu and beside it max |gu + B'nu|
//   for kkt.  Meanwhile the other warps, one thread per (stage, lane), copy
//   the next chunk's A and B (and K) with cp.async and compute its
//   carry-free vectors from its bound entries (w = gx + Pc and gu; gx, gu
//   and sum s*lam, reduced per lane at the end); bwd_corr's fan-out also
//   finishes the last chunk from the qu_bar the chain left in the ring,
//   kff = -(L L')^{-1} qu_bar.
//
// Arithmetic is IEEE f32: the library is built without --use_fast_math.  The
// finiteness flag must see NaN and Inf, lambda/s runs up to the 1e10 cap at
// the 1e-9 slack floor, and the Cholesky needs correctly rounded sqrt and
// division.  min/max propagate NaN like jnp.minimum/jnp.maximum.
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>
#include <utility>

#include "config_dense72.cuh"
#include "config_diff.cuh"
#include "config_omni4.cuh"
#include "sweep.cuh"

namespace {

constexpr float kBig = 3.4e38f;  // fraction-to-boundary sentinel (_BIG)

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

// Bit m set where the R x Cc pattern P has a structural nonzero at (m, j),
// for a column j known only at run time (a thread's column).  Each column's
// mask is a template constant, chosen by a chain of selects: a pattern's
// table read at a run-time index would be copied to local memory.
template <class P, int R, int J>
__host__ __device__ constexpr unsigned col_bits() {
  unsigned bits = 0;
  for (int m = 0; m < R; ++m)
    if (P::nz(m, J)) bits |= 1u << m;
  return bits;
}

template <class P, int R, int... J>
__device__ __forceinline__ unsigned col_mask_of(int j, std::integer_sequence<int, J...>) {
  unsigned bits = 0;
  ((bits = j == J ? std::integral_constant<unsigned, col_bits<P, R, J>()>::value : bits), ...);
  return bits;
}

template <class P, int R, int Cc>
__device__ __forceinline__ unsigned col_mask(int j) {
  return col_mask_of<P, R>(j, std::make_integer_sequence<int, Cc>{});
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

// Shared-memory plan of bwd_fused_kernel.  A block owns LANES lanes and
// walks the horizon backward in chunks of SC stages.  Its first TEAM threads
// are the lanes' teams of T threads (two teams to a warp); the last FAN
// threads, SPLIT per (stage, lane) of a chunk, prepare the next chunk and
// write out the last one.  Per lane and stage the ring holds SLOT floats (A
// and B dense, entries off the pattern never written and never read; the
// barrier-modified diagonals, the gradients and r_dyn); the teams' results
// go to an output tile [SC][NOUT][LANES]; each team keeps W floats of its
// own (the carry P, dense and symmetric, and its exchange slots).  SLOT and
// W are 16 (mod 32) floats, so the two teams of a warp, each reading one
// address, hit distinct banks.
constexpr int kBwdRingBytes = 64 * 1024;

template <class C>
struct BwdPlan {
  static constexpr int NX = C::NX, NU = C::NU, NTRU = NU * (NU + 1) / 2;
  static constexpr int T = 16, LANES = 8, TEAM = T * LANES;
  static_assert(NX + NU <= T, "a team needs a thread per column of [A | B]");
  static_assert(NTRU <= T, "a team stores L with a thread per entry");
  static constexpr int PX = (NX + 3) / 4 * 4;  // row pitch of P and Qux (float4 rows)
  // Stage slot, per lane.
  static constexpr int OA = 0, OB = NX * NX, OQB = OB + NX * NU, ORB = OQB + NX,
                       OGX = ORB + NU, OGU = OGX + NX, ORD = OGU + NU, SLOT = pad16(ORD + NX);
  // Team slots, per lane.
  static constexpr int TP = 0, TQUX = NX * PX, TQUU = TQUX + NU * PX,
                       TTMP = TQUU + (NU * NU + 3) / 4 * 4, W = pad16(TTMP + 2 * PX);
  // Output entries of a stage: K (row-major), L, Pc, kff.
  static constexpr int EK = 0, EL = NU * NX, EP = EL + NTRU, EF = EP + NX, NOUT = EF + NU;
  static constexpr int S_FIT = kBwdRingBytes / (2 * LANES * SLOT * 4);
  static constexpr int SC = S_FIT < 8 ? S_FIT : 8;
  static_assert(SC >= 1, "ring too small for one stage");
  // Measured on the H100 at N=40, B=2048: where nx > 8 one producer thread
  // per (stage, lane) item falls behind the teams, so two share it; where
  // nx <= 8 the deferred vector recursion keeps its stage's B, gu and A
  // column in registers (KEEP), which nx > 8 has no registers for.
  static constexpr int SPLIT = NX > 8 ? 2 : 1;
  static constexpr bool KEEP = NX <= 8;
  static constexpr int ITEMS = SC * LANES, FAN = SPLIT * ITEMS, THREADS = TEAM + FAN;
  static constexpr int RING = SC * LANES * SLOT, OUT = SC * NOUT * LANES, TEAMS = LANES * W;
  static constexpr int SMEM = (2 * RING + 2 * OUT + TEAMS) * 4;
  static_assert(2 * RING >= FAN && THREADS % 32 == 0, "whole warps; the reduction reuses the ring");
};

template <class C>
__global__ void __launch_bounds__(BwdPlan<C>::THREADS, 2)
    bwd_fused_kernel(BwdFusedArgs a, int N, int B, float reg, float d_cap) {
  using S = Shape<C>;
  using Pl = BwdPlan<C>;
  using PA = typename C::A;
  using PB = typename C::B;
  constexpr int NX = S::NX, NU = S::NU, NBX = S::NBX, NBU = S::NBU, NTRU = S::NTRU;
  constexpr int LANES = Pl::LANES, SC = Pl::SC, PX = Pl::PX;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                     // 2 x [SC][LANES][SLOT]
  float* outb = ring + 2 * Pl::RING;      // 2 x [SC][NOUT][LANES]
  float* teams = outb + 2 * Pl::OUT;      // [LANES][W]
  const int tid = threadIdx.x, b0 = blockIdx.x * LANES;
  const int nch = (N + SC - 1) / SC;
  const bool chain = tid < Pl::TEAM;
  // Chunk q holds stages [lo(q), hi(q)), at position p = hi(q) - 1 - k.
  auto lo = [&](int q) { return max(0, N - (q + 1) * SC); };
  auto hi = [&](int q) { return N - q * SC; };

  // ---- Producers: SPLIT groups of SC * LANES threads; thread g of a group
  // takes position g / LANES and lane g % LANES of each chunk.
  const int f = tid - Pl::TEAM, part = f / Pl::ITEMS, g = f % Pl::ITEMS;
  const int fp = g / LANES, fl = g % LANES, fb = b0 + fl;
  float mu = 0.f;

  // Stage k of lane fb into its ring slot R, in two parts (one per group
  // where SPLIT = 2).  A lane past B gets a benign stage: identity
  // diagonals, zero A, B and vectors.
  // Part 0: A and B, and r_dyn (also to global memory).
  auto prepare_ab = [&, a](int k, float* R) {
    const int b = fb;
    if (b >= B) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        R[Pl::ORD + i] = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m)
          if (PA::nz(i, m)) R[Pl::OA + i * NX + m] = 0.f;
#pragma unroll
        for (int m = 0; m < NU; ++m)
          if (PB::nz(i, m)) R[Pl::OB + i * NU + m] = 0.f;
      }
      return;
    }
    float A[NX][NX], Bm[NX][NU], dx0[NX], dx1[NX], du[NU], cc[NX];
    load_packed<PA>(A, a.A, k, S::NNZA, B, b);
    load_packed<PB>(Bm, a.Bm, k, S::NNZB, B, b);
    load_vec(dx0, a.dx, k, B, b);
    load_vec(dx1, a.dx, k + 1, B, b);
    load_vec(du, a.du, k, B, b);
    load_vec(cc, a.c, k, B, b);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const float r = cc[i] - dx1[i] + row_dot<PA>(A, i, dx0) + row_dot<PB>(Bm, i, du);
      R[Pl::ORD + i] = r;
      st(a.rdyn, k, i, NX, B, b, r);
#pragma unroll
      for (int m = 0; m < NX; ++m)
        if (PA::nz(i, m)) R[Pl::OA + i * NX + m] = A[i][m];
#pragma unroll
      for (int m = 0; m < NU; ++m)
        if (PB::nz(i, m)) R[Pl::OB + i * NU + m] = Bm[i][m];
    }
  };

  // Part 1: the primal residuals (to global memory), the barrier-modified
  // diagonals, the gradients, and this thread's share of sum s*lam.
  auto prepare_bounds = [&, a](int k, float* R) {
    const int b = fb;
    if (b >= B) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        R[Pl::OQB + i] = 1.f;
        R[Pl::OGX + i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        R[Pl::ORB + i] = 1.f;
        R[Pl::OGU + i] = 0.f;
      }
      return;
    }
    float Qd1[NX], qx1[NX], Rd[NU], qu[NU], dx1[NX], du[NU];
    load_vec(dx1, a.dx, k + 1, B, b);
    load_vec(du, a.du, k, B, b);
    load_vec(Qd1, a.Qd, k + 1, B, b);
    load_vec(qx1, a.qx, k + 1, B, b);
    load_vec(Rd, a.Rd, k, B, b);
    load_vec(qu, a.qu, k, B, b);
    Groups<C> s, l, bd;
    s.load(a.s, k, B, b);
    l.load(a.l, k, B, b);
    bd.load(a.bnd, k, B, b);
    // One bound pair on z: gap residuals (written out), s*lam, the barrier
    // diagonal term and le_upper - le_lower, le = -(lam/s) rp.
    auto pair = [&](float z, float lb, float ub, float sl, float su, float ll, float lu,
                    float* rpl_out, float* rpu_out, float& diag, float& g) {
      const float rpl = z - lb - sl, rpu = ub - z - su;
      *rpl_out = rpl;
      *rpu_out = rpu;
      mu = mu + sl * ll + su * lu;
      const float rl = ll / sl, ru = lu / su;
      diag += min_nan(rl + ru, d_cap);
      g += -ru * rpu - -rl * rpl;
    };
    float qb[NX], gx[NX], rb[NU], gu[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      qb[i] = Qd1[i];
      gx[i] = Qd1[i] * dx1[i] + qx1[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      rb[i] = Rd[i] + reg;
      gu[i] = Rd[i] * du[i] + qu[i];
    }
    const size_t kb = static_cast<size_t>(k);
#pragma unroll
    for (int jb = 0; jb < NBX; ++jb) {
      const int i = C::IDXBX::at(jb);
      const size_t o = (kb * NBX + jb) * B + b;
      pair(dx1[i], bd.x[0][jb], bd.x[1][jb], s.x[0][jb], s.x[1][jb], l.x[0][jb], l.x[1][jb],
           a.rp.g[0] + o, a.rp.g[1] + o, qb[i], gx[i]);
    }
#pragma unroll
    for (int jb = 0; jb < NBU; ++jb) {
      const int i = C::IDXBU::at(jb);
      const size_t o = (kb * NBU + jb) * B + b;
      pair(du[i], bd.u[0][jb], bd.u[1][jb], s.u[0][jb], s.u[1][jb], l.u[0][jb], l.u[1][jb],
           a.rp.g[2] + o, a.rp.g[3] + o, rb[i], gu[i]);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      R[Pl::OQB + i] = qb[i];
      R[Pl::OGX + i] = gx[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      R[Pl::ORB + i] = rb[i];
      R[Pl::OGU + i] = gu[i];
    }
  };

  // Chunk q into ring slot q & 1: stage hi(q) - 1 - fp of lane fb.
  auto prepare = [&](int q) {
    const int k = hi(q) - 1 - fp;
    if (k < lo(q)) return;
    float* R = ring + (q & 1) * Pl::RING + (fp * LANES + fl) * Pl::SLOT;
    if (Pl::SPLIT == 1 || part == 0) prepare_ab(k, R);
    if (Pl::SPLIT == 1 || part == 1) prepare_bounds(k, R);
  };

  // Chunk q's output tile to K, L, Pc and kff, by threads t of nt, a row of
  // LANES lanes at a time (one 32-byte sector).
  auto flush = [&, a](int q, int t, int nt) {
    const float* O = outb + (q & 1) * Pl::OUT;
    const int k0 = lo(q), k1 = hi(q);
    auto out = [&](float* dst, int off, int E) {
#pragma unroll 1
      for (int i = t; i < SC * E * LANES; i += nt) {
        const int l = i % LANES, r = i / LANES, p = r / E, e = r % E, k = k1 - 1 - p;
        if (k >= k0 && b0 + l < B)
          st(dst, k, e, E, B, b0 + l, O[(p * Pl::NOUT + off + e) * LANES + l]);
      }
    };
    out(a.K, Pl::EK, NU * NX);
    out(a.L, Pl::EL, NTRU);
    out(a.Pc, Pl::EP, NX);
    out(a.kff, Pl::EF, NU);
  };

  // ---- Teams: thread j of the team of lane tl.
  const int tl = tid / Pl::T, j = tid % Pl::T;
  const int jx = j < NX ? j : NX - 1, ju = j < NX ? 0 : j < NX + NU ? j - NX : NU - 1;
  float* tm = teams + tl * Pl::W;
  float* P = tm + Pl::TP;  // P_core (no stage diagonal), dense and symmetric
  // Column j of M = [A | B] in a stage slot: entry m at R[mbase + m * mstride],
  // structural nonzeros in mcol (none for a thread past the last column).
  const unsigned mcol = j < NX ? col_mask<PA, NX, NX>(j)
                                : j < NX + NU ? col_mask<PB, NX, NU>(j - NX) : 0u;
  const int mbase = j < NX ? Pl::OA + j : j < NX + NU ? Pl::OB + (j - NX) : Pl::OA;
  const int mstride = j < NX ? NX : j < NX + NU ? NU : 0;
  float pv = 0.f;  // p_j, the affine vector carry

  // The affine vector recursion of a stage runs one stage late, inside the
  // next stage's first half, whose arithmetic does not depend on it: tmp =
  // p + gx + Pc, qu_bar = gu + B' tmp, kff = -(L L')^{-1} qu_bar, p_j <-
  // (A' tmp)_j + (K' qu_bar)_j.  What it needs of its stage is kept here;
  // tmp alternates between two slots.
  float Lv[NTRU] = {}, inv[NU] = {}, kc[NU] = {}, mv[NX] = {}, bv[NX][NU] = {}, guv[NU] = {};
  float sol[NU] = {};  // -kff of the stage owed
  float* Ov = nullptr;
  const float* Rv = nullptr;
  // Rp: the stage's slot; Tp: its tmp slot.  Not pending, both are slots
  // no other thread writes meanwhile, and p is left as it is.
  auto vector = [&](bool pending, const float* Rp, const float* Tp) {
    float tmp[PX], qub[NU];
    load_row<PX>(tmp, Tp);
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float t = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m)
        if (PB::nz(m, u)) t += (Pl::KEEP ? bv[m][u] : Rp[Pl::OB + m * NU + u]) * tmp[m];
      qub[u] = (Pl::KEEP ? guv[u] : Rp[Pl::OGU + u]) + t;
      sol[u] = qub[u];
    }
    chol_solve_inv<NU>(Lv, inv, sol);
    float at = 0.f, kt = 0.f;
#pragma unroll
    for (int m = 0; m < NX; ++m)
      if ((mcol >> m) & 1u) at += (Pl::KEEP ? mv[m] : Rp[mbase + m * mstride]) * tmp[m];
#pragma unroll
    for (int u = 0; u < NU; ++u) kt += kc[u] * qub[u];
    pv = pending ? at + kt : pv;
  };
  auto store_kff = [&](bool pending) {
#pragma unroll
    for (int u = 0; u < NU; ++u)
      if (pending && u == j) Ov[(Pl::EF + u) * LANES] = -sol[u];
  };

  // One stage: R its slot, O its output column (entry e at O[e * LANES]),
  // T its tmp slot; pending: the stage after it (in the sweep's order, the
  // one before) still owes its vector recursion.  Each half loads what it
  // reads from shared memory first, so the loads issue together, and ends
  // in stores only, which need no branch.
  auto stage = [&](const float* R, float* O, float* T, const float* Tp, bool pending) {
    // P_{k+1} = P_core + diag(qbar) times column j of M: v = P M e_j, then
    // w = B'v and apa = A'v.  For j < NX these are Qux e_j and A'PA e_j; for
    // j = NX + u, w is column u of Quu less rbar.  Row j < NX also gives
    // Pc_j = (P r_dyn)_j.
    float mc[NX], rd[NX], prow[PX], v[NX], w[NU], apa[NX];
#pragma unroll
    for (int m = 0; m < NX; ++m) {
      mc[m] = R[mbase + m * mstride];
      rd[m] = R[Pl::ORD + m];
    }
    load_row<PX>(prow, P + jx * PX);
    const float qbj = R[Pl::OQB + jx], gxj = R[Pl::OGX + jx], rbu = R[Pl::ORB + ju];
    vector(pending, pending ? Rv : R, Tp);
    float pc = 0.f;
#pragma unroll
    for (int m = 0; m < NX; ++m) pc = fmaf(m == jx ? prow[m] + qbj : prow[m], rd[m], pc);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float row[PX];
      load_row<PX>(row, P + i * PX);
      row[i] += R[Pl::OQB + i];
      float t = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m)
        if ((mcol >> m) & 1u) t = fmaf(row[m], mc[m], t);
      v[i] = t;
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float t = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m)
        if (PB::nz(m, u)) t = fmaf(R[Pl::OB + m * NU + u], v[m], t);
      w[u] = t;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float t = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m)
        if (PA::nz(m, i)) t = fmaf(R[Pl::OA + m * NX + i], v[m], t);
      apa[i] = t;
    }
    if (j < NX) {
#pragma unroll
      for (int u = 0; u < NU; ++u) tm[Pl::TQUX + u * PX + j] = w[u];
      T[j] = pv + gxj + pc;
      O[(Pl::EP + j) * LANES] = pc;
    }
#pragma unroll
    for (int i = 0; i < NU; ++i)
      if (j >= NX && j < NX + NU && i >= ju)
        tm[Pl::TQUU + i * NU + ju] = i == ju ? w[i] + rbu : w[i];
    store_kff(pending);
    __syncwarp();

    float q[NU][NU];
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int jj = 0; jj <= i; ++jj) q[i][jj] = tm[Pl::TQUU + i * NU + jj];
    Rv = R;
    Ov = O;
    if constexpr (Pl::KEEP) {
#pragma unroll
      for (int m = 0; m < NX; ++m) {
        mv[m] = mc[m];
#pragma unroll
        for (int u = 0; u < NU; ++u)
          if (PB::nz(m, u)) bv[m][u] = R[Pl::OB + m * NU + u];
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) guv[u] = R[Pl::OGU + u];
    }

    // Cholesky of Quu, in every thread, and the reciprocal pivots.
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int jj = 0; jj <= i; ++jj) {
        float t = q[i][jj];
#pragma unroll
        for (int m = 0; m < jj; ++m) t -= Lv[tri(i, m)] * Lv[tri(jj, m)];
        Lv[tri(i, jj)] = (i == jj) ? sqrtf(t) : t / Lv[tri(jj, jj)];
      }
      inv[i] = 1.f / Lv[tri(i, i)];
    }

    // Column j of K, and of the new carry P_core = A'PA + Qux'K (lower
    // triangle, mirrored).  The stores come last, after every load.
#pragma unroll
    for (int u = 0; u < NU; ++u) kc[u] = w[u];
    chol_solve_inv<NU>(Lv, inv, kc);
#pragma unroll
    for (int u = 0; u < NU; ++u) kc[u] = -kc[u];
    float pn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float t = 0.f;
#pragma unroll
      for (int u = 0; u < NU; ++u) t += tm[Pl::TQUX + u * PX + i] * kc[u];
      pn[i] = apa[i] + t;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i)
      if (j < NX && i >= j) {
        P[i * PX + j] = pn[i];
        P[j * PX + i] = pn[i];
      }
#pragma unroll
    for (int t = 0; t < NTRU; ++t)
      if (t == j) O[(Pl::EL + t) * LANES] = Lv[t];
#pragma unroll
    for (int u = 0; u < NU; ++u)
      if (j < NX) O[(Pl::EK + u * NX + j) * LANES] = kc[u];
    __syncwarp();
  };

  if (chain) {
    for (int t = j; t < NX * PX; t += Pl::T) P[t] = 0.f;
  } else {
    prepare(0);
  }
  __syncthreads();
  // The teams run chunk q while the producers prepare chunk q + 1 and write
  // out chunk q - 1.
#pragma unroll 1
  for (int q = 0; q < nch; ++q) {
    if (chain) {
      const float* R = ring + (q & 1) * Pl::RING + tl * Pl::SLOT;
      float* O = outb + (q & 1) * Pl::OUT + tl;
      const int sc = hi(q) - lo(q);
#pragma unroll 1
      for (int p = 0; p < sc; ++p)
        stage(R + p * LANES * Pl::SLOT, O + p * Pl::NOUT * LANES, tm + Pl::TTMP + (p & 1) * PX,
              tm + Pl::TTMP + ((p + 1) & 1) * PX, p > 0);
      // The chunk's last stage, before its outputs are written out.
      vector(true, Rv, tm + Pl::TTMP + ((sc + 1) & 1) * PX);
      store_kff(true);
    } else {
      if (q + 1 < nch) prepare(q + 1);
      if (q >= 1) flush(q - 1, f, Pl::FAN);
    }
    __syncthreads();
  }
  // The last chunk's outputs, by every thread, and sum s*lam over each
  // lane's producers.
  flush(nch - 1, tid, Pl::THREADS);
  float* red = ring;
  if (!chain) red[f] = mu;
  __syncthreads();
  if (!chain && part == Pl::SPLIT - 1 && fp == 0 && fb < B) {
    float m = red[f];
#pragma unroll
    for (int r = 1; r < SC; ++r) m = m + red[f + r * LANES];
    a.musum[fb] = m;
  }
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

// Shared-memory plan of fwd_kernel: TL lanes per block, chunks of S stages.
// The ring holds two chunks of the rollout operands (A, B packed, K, kff,
// r_dyn) as [S][E][TL]; the rollout writes dx (S + 1 rows, the first being
// the chunk's start) and du (S rows) of a chunk into one of two slots.

template <class C>
struct FwdPlan {
  static constexpr int NX = C::NX, NU = C::NU, TL = kSweepLanes;
  static constexpr int OA = 0, OB = C::A::count(), OK = OB + C::B::count(), OKFF = OK + NU * NX,
                       ORD = OKFF + NU, E = ORD + NX;
  static constexpr int S_FIT = kSweepRingBytes / (2 * E * TL * 4);
  static constexpr int S = S_FIT < 8 ? S_FIT : 8;
  static_assert(S >= 1 && TL % 4 == 0, "ring too small for one stage");
  static constexpr int NF = S * TL, THREADS = 32 + NF;  // warp 0 rolls out, NF fan out
  static constexpr int RING = S * E * TL, DX = (S + 1) * NX * TL, DU = S * NU * TL;
  static constexpr int SMEM = (2 * RING + 2 * (DX + DU)) * 4;
  static_assert(2 * RING >= 4 * NF, "the final reduction reuses the ring");
};

// Row-major packed pattern P read from shared memory: entry e at p[e * TL].
template <class P, int R, int Cc, int TL>
__device__ __forceinline__ void load_packed_smem(float (&M)[R][Cc], const float* p) {
  int e = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < Cc; ++j) {
      if (P::nz(i, j)) {
        M[i][j] = p[e * TL];
        ++e;
      } else {
        M[i][j] = 0.f;
      }
    }
  }
}

template <class C, bool CORR>
__global__ void __launch_bounds__(FwdPlan<C>::THREADS) fwd_kernel(FwdArgs a, int N, int B, float tau) {
  using S = Shape<C>;
  using F = FwdPlan<C>;
  using PA = typename C::A;
  using PB = typename C::B;
  constexpr int NX = S::NX, NU = S::NU, NBX = S::NBX, NBU = S::NBU, TL = F::TL, SC = F::S;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                   // 2 x [SC][E][TL]
  float* dxb = smem + 2 * F::RING;      // 2 x [SC + 1][NX][TL]
  float* dub = dxb + 2 * F::DX;         // 2 x [SC][NU][TL]
  const int tid = threadIdx.x, b0 = blockIdx.x * TL;
  const int nch = (N + SC - 1) / SC;
  const bool roller = tid < 32;
  const int f = tid - 32, fl = roller ? tid : f % TL, fs = roller ? 0 : f / TL;
  const int b = b0 + fl;
  const bool live = b < B && (!roller || tid < TL);

  // The roller's carry, and the fan-out threads' partials for their lane.
  float dx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) dx[i] = live && roller ? ld(a.r_init, 0, i, NX, B, b) : 0.f;
  FwdCarry cr{kBig, 0.f, 0.f, 1.f};
  float sm = 0.f;
  if constexpr (CORR) sm = live && !roller ? __ldg(a.sigma_mu + b) : 0.f;

  // Fan-out threads copy chunk c's rollout operands into ring slot c & 1.
  auto copy_chunk = [&, a](int c) {
    float* r = ring + (c & 1) * F::RING;
    const int k0 = c * SC, sc = min(SC, N - k0);
    copy_chunk_rows<F, S::NNZA>(r, F::OA, a.A, k0, sc, b0, B, f, F::NF);
    copy_chunk_rows<F, S::NNZB>(r, F::OB, a.Bm, k0, sc, b0, B, f, F::NF);
    copy_chunk_rows<F, NU * NX>(r, F::OK, a.K, k0, sc, b0, B, f, F::NF);
    copy_chunk_rows<F, NU>(r, F::OKFF, a.kff, k0, sc, b0, B, f, F::NF);
    copy_chunk_rows<F, NX>(r, F::ORD, a.rdyn, k0, sc, b0, B, f, F::NF);
    cp_async_commit();
  };

  // Warp 0, one thread per lane: roll chunk c out into dx/du slot c & 1.
  auto rollout = [&](int c) {
    const float* r = ring + (c & 1) * F::RING + fl;
    float* X = dxb + (c & 1) * F::DX + fl;
    float* U = dub + (c & 1) * F::DU + fl;
    const int sc = min(SC, N - c * SC);
#pragma unroll
    for (int i = 0; i < NX; ++i) X[i * TL] = dx[i];
#pragma unroll 1
    for (int s = 0; s < sc; ++s) {
      const float* rs = r + s * F::E * TL;
      float A[NX][NX], Bm[NX][NU], K[NU][NX], kff[NU], c0[NX];
      load_packed_smem<PA, NX, NX, TL>(A, rs + F::OA * TL);
      load_packed_smem<PB, NX, NU, TL>(Bm, rs + F::OB * TL);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        kff[i] = rs[(F::OKFF + i) * TL];
#pragma unroll
        for (int j = 0; j < NX; ++j) K[i][j] = rs[(F::OK + i * NX + j) * TL];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) c0[i] = rs[(F::ORD + i) * TL];
      float du[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float t = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m) t += K[i][m] * dx[m];
        du[i] = kff[i] + t;
        U[(s * NU + i) * TL] = du[i];
      }
      float dxn[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float t = c0[i];
        t += row_dot<PA>(A, i, dx);
        t += row_dot<PB>(Bm, i, du);
        dxn[i] = t;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        dx[i] = dxn[i];
        X[((s + 1) * NX + i) * TL] = dxn[i];
      }
    }
  };

  // Fan-out thread (fs, fl): stage k0 + fs of chunk c, every bound entry.
  auto fanout = [&, a](int c) {
    const int k = c * SC + fs;
    if (!live || k >= N) return;
    const float* X = dxb + (c & 1) * F::DX + fl;
    const float* U = dub + (c & 1) * F::DU + fl;
    Groups<C> s, l, rp, co;
    s.load(a.s, k, B, b);
    l.load(a.l, k, B, b);
    rp.load(a.rp, k, B, b);
    if constexpr (CORR) {
      co.load(a.corr, k, B, b);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const float xn = X[((fs + 1) * NX + i) * TL];
        st(a.ddx, k, i, NX, B, b, X[(fs * NX + i) * TL]);
        cr.fin *= finite1(xn);
        if (k == N - 1) st(a.ddx_N, 0, i, NX, B, b, xn);
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        const float u = U[(fs * NU + i) * TL];
        st(a.ddu, k, i, NU, B, b, u);
        cr.fin *= finite1(u);
      }
    }
#pragma unroll
    for (int j = 0; j < NBX; ++j) {
      const float dz = X[((fs + 1) * NX + C::IDXBX::at(j)) * TL];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        float ds, dl;
        fwd_delta<CORR>(s.x[g][j], l.x[g][j], rp.x[g][j], CORR ? co.x[g][j] : 0.f, sm, dz,
                        g == 0 ? 1.f : -1.f, cr, ds, dl);
        if constexpr (CORR) {
          st(a.ds.g[g], k, j, NBX, B, b, ds);
          st(a.dl.g[g], k, j, NBX, B, b, dl);
        } else {
          st(a.prod.g[g], k, j, NBX, B, b, ds * dl);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NBU; ++j) {
      const float dz = U[(fs * NU + C::IDXBU::at(j)) * TL];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        float ds, dl;
        fwd_delta<CORR>(s.u[g][j], l.u[g][j], rp.u[g][j], CORR ? co.u[g][j] : 0.f, sm, dz,
                        g == 0 ? 1.f : -1.f, cr, ds, dl);
        if constexpr (CORR) {
          st(a.ds.g[2 + g], k, j, NBU, B, b, ds);
          st(a.dl.g[2 + g], k, j, NBU, B, b, dl);
        } else {
          st(a.prod.g[2 + g], k, j, NBU, B, b, ds * dl);
        }
      }
    }
  };

  // Chunk c + 1 rolls out while chunk c fans out and chunk c + 2 is copied.
  if (!roller) {
    copy_chunk(0);
    if (nch > 1) copy_chunk(1);
    cp_async_wait<0>();
  }
  __syncthreads();
  if (roller && tid < TL) rollout(0);
  __syncthreads();
#pragma unroll 1
  for (int c = 0; c < nch; ++c) {
    if (roller) {
      if (tid < TL && c + 1 < nch) rollout(c + 1);
    } else {
      if (c + 2 < nch) copy_chunk(c + 2);
      fanout(c);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  // Per-lane reduction of the SC fan-out threads' partials, rows in order.
  float* red = smem;  // [4][NF], over the ring (no copy in flight)
  if (!roller) {
    red[f] = cr.m;
    red[F::NF + f] = cr.c1;
    red[2 * F::NF + f] = cr.c2;
    red[3 * F::NF + f] = cr.fin;
  }
  __syncthreads();
  if (!roller && fs == 0 && live) {
    float m = red[fl], c1 = red[F::NF + fl], c2 = red[2 * F::NF + fl], fin = red[3 * F::NF + fl];
#pragma unroll
    for (int r = 1; r < SC; ++r) {
      const int i = r * TL + fl;
      m = min_nan(m, red[i]);
      c1 = c1 + red[F::NF + i];
      c2 = c2 + red[2 * F::NF + i];
      fin *= red[3 * F::NF + i];
    }
    a.alpha[b] = min_nan(1.f, tau * m);
    if constexpr (CORR) {
      a.finite[b] = fin;
    } else {
      a.c12[b] = c1;
      a.c12[B + b] = c2;
    }
  }
}

// --------------------------------------------------------------------------
// Kernels 3 and 5: backward vector sweeps (corrector recursion, KKT)
// --------------------------------------------------------------------------

// Shared-memory plan of bwd_corr_kernel (KKT false) and kkt_kernel (KKT
// true): TL lanes per block, the horizon walked backward in chunks of S
// stages.  Warp 0 runs the chain, one thread per lane; the NF = S * TL
// fan-out threads, one per (stage, lane) of a chunk, prepare the next chunk
// (and for bwd_corr finish the last one).  The ring holds two chunks as
// [S][E][TL], stage s of a chunk being its s-th row in memory order:
//   bwd_corr: A, B packed and K (copied by cp.async), w = gx + Pc and gu
//             (fan-out), qu_bar (chain);
//   kkt:      A, B packed (cp.async), gx and gu (fan-out).
template <class C, bool KKT>
struct VecPlan {
  static constexpr int NX = C::NX, NU = C::NU, TL = kSweepLanes;
  static constexpr int NNZA = C::A::count(), NNZB = C::B::count();
  static constexpr int OA = 0, OB = NNZA, OK = OB + NNZB, OW = OK + (KKT ? 0 : NU * NX),
                       OGU = OW + NX, OV = OGU + NU, E = OV + (KKT ? 0 : NU);
  static constexpr int S_FIT = kSweepRingBytes / (2 * E * TL * 4);
  static constexpr int S = S_FIT < 8 ? S_FIT : 8;
  static_assert(S >= 1 && TL % 4 == 0 && TL <= 32, "ring too small for one stage");
  static constexpr int NF = S * TL, THREADS = 32 + NF;
  static constexpr int RING = S * E * TL, SMEM = 2 * RING * 4;
  static_assert(RING >= NF, "the final reduction reuses the ring");
};

struct BwdCorrArgs {
  const float *A, *Bm, *K, *L, *Pc, *Qd, *qx, *dx, *Rd, *qu, *du;
  In4 s, l, rp, corr;
  const float* sigma_mu;
  float* kff;
};

// Corrector vector recursion: tmp = p + w, w = gx + Pc, qu_bar = gu + B'
// tmp, p <- A' tmp + K' qu_bar (the chain); the effective multiplier
// gradients (sigma mu - corr)/s - (lam/s) rp, gx, gu and w before it, and
// kff = -(L L')^{-1} qu_bar after it (fan-out).
template <class C>
__global__ void __launch_bounds__(VecPlan<C, false>::THREADS)
    bwd_corr_kernel(BwdCorrArgs a, int N, int B) {
  using S = Shape<C>;
  using F = VecPlan<C, false>;
  using PA = typename C::A;
  using PB = typename C::B;
  constexpr int NX = S::NX, NU = S::NU, NBX = S::NBX, NBU = S::NBU, NTRU = S::NTRU, TL = F::TL;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, b0 = blockIdx.x * TL;
  const int f = tid - 32, b = b0 + f % TL;
  const bool live = tid >= 32 && b < B;
  const float sm = live ? __ldg(a.sigma_mu + b) : 0.f;

  auto copy = [&, a](float* r, int k0, int sc) {
    copy_chunk_rows<F, S::NNZA>(r, F::OA, a.A, k0, sc, b0, B, f, F::NF);
    copy_chunk_rows<F, S::NNZB>(r, F::OB, a.Bm, k0, sc, b0, B, f, F::NF);
    copy_chunk_rows<F, NU * NX>(r, F::OK, a.K, k0, sc, b0, B, f, F::NF);
    cp_async_commit();
  };
  auto prepare = [&, a](float* R, int k) {
    if (!live) return;
    float Pc[NX], Qdn[NX], qxn[NX], dxn[NX], Rd[NU], qu[NU], du[NU];
    load_vec(Pc, a.Pc, k, B, b);
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
    float gx[NX], gu[NU];
    grad_terms<C>(Qdn, qxn, dxn, Rd, qu, du, lex, leu, gx, gu);
#pragma unroll
    for (int i = 0; i < NX; ++i) R[(F::OW + i) * TL] = gx[i] + Pc[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) R[(F::OGU + i) * TL] = gu[i];
  };
  // A lane past B solves with L = I on qu_bar = 0.
  auto finish = [&, a](float* R, int k) {
    float L[NTRU], x[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j)
        L[tri(i, j)] = live ? ld(a.L, k, tri(i, j), NTRU, B, b) : (i == j ? 1.f : 0.f);
      x[i] = R[(F::OV + i) * TL];
    }
    chol_solve<NU>(L, x);
    if (live) {
#pragma unroll
      for (int i = 0; i < NU; ++i) st(a.kff, k, i, NU, B, b, -x[i]);
    }
  };
  float p[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) p[i] = 0.f;
  // Every load of the stage first, its one store last.
  auto step = [&](float* R) {
    float A[NX][NX], Bm[NX][NU], K[NU][NX], tmp[NX], gu[NU], qub[NU];
    load_packed_smem<PA, NX, NX, TL>(A, R + F::OA * TL);
    load_packed_smem<PB, NX, NU, TL>(Bm, R + F::OB * TL);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      gu[i] = R[(F::OGU + i) * TL];
#pragma unroll
      for (int j = 0; j < NX; ++j) K[i][j] = R[(F::OK + i * NX + j) * TL];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) tmp[i] = p[i] + R[(F::OW + i) * TL];
#pragma unroll
    for (int i = 0; i < NU; ++i) qub[i] = gu[i] + col_dot<PB>(Bm, i, tmp);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float kt = 0.f;
#pragma unroll
      for (int m = 0; m < NU; ++m) kt += K[m][i] * qub[m];
      p[i] = col_dot<PA>(A, i, tmp) + kt;
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) R[(F::OV + i) * TL] = qub[i];
  };
  vec_sweep<F>(smem, N, copy, prepare, finish, step);
}

struct KKTArgs {
  const float *A, *Bm, *Qd, *qx, *dx, *Rd, *qu, *du;
  In4 l, s;
  float *kkt, *musum;
};

// Costate recursion nu_{k+1} = gx_{k+1} + c, c <- A_k' nu_{k+1}, and beside
// it ru_k = gu_k + B_k' nu_{k+1} with max |ru| (from 0, NaN propagating like
// jnp.maximum), stage by stage in the order of the TPU kernel (the chain);
// gx, gu and each (stage, lane)'s share of sum s*lam before it (fan-out),
// the shares reduced per lane at the end.
template <class C>
__global__ void __launch_bounds__(VecPlan<C, true>::THREADS)
    kkt_kernel(KKTArgs a, int N, int B) {
  using S = Shape<C>;
  using F = VecPlan<C, true>;
  using PA = typename C::A;
  using PB = typename C::B;
  constexpr int NX = S::NX, NU = S::NU, NBX = S::NBX, NBU = S::NBU, TL = F::TL;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, b0 = blockIdx.x * TL;
  const int f = tid - 32, b = b0 + (tid < 32 ? tid : f % TL);
  const bool live = b < B && (tid >= 32 || tid < TL);
  float m = 0.f, mu = 0.f;

  auto copy = [&, a](float* r, int k0, int sc) {
    copy_chunk_rows<F, S::NNZA>(r, F::OA, a.A, k0, sc, b0, B, f, F::NF);
    copy_chunk_rows<F, S::NNZB>(r, F::OB, a.Bm, k0, sc, b0, B, f, F::NF);
    cp_async_commit();
  };
  auto prepare = [&, a](float* R, int k) {
    if (!live) return;
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
    float gx[NX], gu[NU];
    grad_terms<C>(Qdn, qxn, dxn, Rd, qu, du, l.x, l.u, gx, gu);
#pragma unroll
    for (int j = 0; j < NBX; ++j) mu = mu + (s.x[0][j] * l.x[0][j] + s.x[1][j] * l.x[1][j]);
#pragma unroll
    for (int j = 0; j < NBU; ++j) mu = mu + (s.u[0][j] * l.u[0][j] + s.u[1][j] * l.u[1][j]);
#pragma unroll
    for (int i = 0; i < NX; ++i) R[(F::OW + i) * TL] = gx[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) R[(F::OGU + i) * TL] = gu[i];
  };
  float c[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) c[i] = 0.f;
  auto step = [&](float* R) {
    float A[NX][NX], Bm[NX][NU], nu_v[NX], gu[NU];
    load_packed_smem<PA, NX, NX, TL>(A, R + F::OA * TL);
    load_packed_smem<PB, NX, NU, TL>(Bm, R + F::OB * TL);
#pragma unroll
    for (int i = 0; i < NU; ++i) gu[i] = R[(F::OGU + i) * TL];
#pragma unroll
    for (int i = 0; i < NX; ++i) nu_v[i] = R[(F::OW + i) * TL] + c[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) m = max_nan(m, fabsf(gu[i] + col_dot<PB>(Bm, i, nu_v)));
#pragma unroll
    for (int i = 0; i < NX; ++i) c[i] = col_dot<PA>(A, i, nu_v);
  };
  vec_sweep<F>(smem, N, copy, prepare, [](float*, int) {}, step);

  // Sum s*lam over each lane's S fan-out rows, in row order, over the ring.
  __syncthreads();
  if (tid >= 32) smem[f] = mu;
  __syncthreads();
  if (tid < TL && live) {
    mu = smem[tid];
#pragma unroll 1
    for (int r = 1; r < F::S; ++r) mu = mu + smem[r * TL + tid];
    a.kkt[b] = m;
    a.musum[b] = mu;
  }
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
  using Pl = BwdPlan<C>;
  static const int attr = smem_attr(bwd_fused_kernel<C>, Pl::SMEM);
  if (attr != 0) return attr;
  bwd_fused_kernel<C><<<(B + Pl::LANES - 1) / Pl::LANES, Pl::THREADS, Pl::SMEM, stream>>>(
      a, N, B, reg, d_cap);
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
  using F = FwdPlan<C>;
  static const int attr = smem_attr(fwd_kernel<C, CORR>, F::SMEM);
  if (attr != 0) return attr;
  fwd_kernel<C, CORR><<<(B + F::TL - 1) / F::TL, F::THREADS, F::SMEM, stream>>>(a, N, B, tau);
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
  using F = VecPlan<C, false>;
  static const int attr = smem_attr(bwd_corr_kernel<C>, F::SMEM);
  if (attr != 0) return attr;
  bwd_corr_kernel<C><<<(B + F::TL - 1) / F::TL, F::THREADS, F::SMEM, stream>>>(a, N, B);
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
  using F = VecPlan<C, true>;
  static const int attr = smem_attr(kkt_kernel<C>, F::SMEM);
  if (attr != 0) return attr;
  kkt_kernel<C><<<(B + F::TL - 1) / F::TL, F::THREADS, F::SMEM, stream>>>(a, N, B);
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
IPM_EXPORT(omni4, Omni4Config)
