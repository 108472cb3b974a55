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
// from the card's bandwidth or flop rate.  Each sweep has two launch plans,
// picked by plan_of from N and B alone: the batched plans below, for many
// lanes, and the one-lane plans (a block a lane, its chain spread over a
// warp; the section before the launchers), for the few lanes of a robot's
// node.  In the batched plans every sweep splits a lane's stages so that
// only the carry is sequential:
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

#include <algorithm>
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

// Each kernel is a template on its launch plan (an int, so a kernel's name in
// a trace says which plan ran): kBatched, the chunked plans above, or
// kOneLane, the one-lane plans of the section before the launchers.
constexpr int kBatched = 0, kOneLane = 1;

template <class C>
struct BwdLane;
template <class C, bool CORR>
struct FwdLane;
template <class C, bool KKT>
struct VecLane;

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
__device__ __forceinline__ void bwd_fused_lane(BwdFusedArgs a, int N, int B, float reg,
                                               float d_cap);

template <class C, int PLAN>
__global__ void __launch_bounds__(PLAN == kOneLane ? BwdLane<C>::THREADS : BwdPlan<C>::THREADS,
                                  PLAN == kOneLane ? 1 : 2)
    bwd_fused_kernel(BwdFusedArgs a, int N, int B, float reg, float d_cap) {
  if constexpr (PLAN == kOneLane) return bwd_fused_lane<C>(a, N, B, reg, d_cap);
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
__device__ __forceinline__ void fwd_lane(FwdArgs a, int N, int B, float tau);

template <class C, int PLAN, bool CORR>
__global__ void __launch_bounds__(PLAN == kOneLane ? FwdLane<C, CORR>::THREADS
                                                   : FwdPlan<C>::THREADS)
    fwd_kernel(FwdArgs a, int N, int B, float tau) {
  if constexpr (PLAN == kOneLane) return fwd_lane<C, CORR>(a, N, B, tau);
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
__device__ __forceinline__ void bwd_corr_lane(BwdCorrArgs a, int N, int B);

template <class C, int PLAN>
__global__ void __launch_bounds__(PLAN == kOneLane ? VecLane<C, false>::THREADS
                                                   : VecPlan<C, false>::THREADS)
    bwd_corr_kernel(BwdCorrArgs a, int N, int B) {
  if constexpr (PLAN == kOneLane) return bwd_corr_lane<C>(a, N, B);
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
__device__ __forceinline__ void kkt_lane(KKTArgs a, int N, int B);

template <class C, int PLAN>
__global__ void __launch_bounds__(PLAN == kOneLane ? VecLane<C, true>::THREADS
                                                   : VecPlan<C, true>::THREADS)
    kkt_kernel(KKTArgs a, int N, int B) {
  if constexpr (PLAN == kOneLane) return kkt_lane<C>(a, N, B);
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
// The one-lane plans (kOneLane)
// --------------------------------------------------------------------------
//
// At a small batch the batched plans leave most of the card idle and run
// each lane's chain on one thread (or one team), chunk by chunk, so a sweep
// takes its chain's latency times N plus a block barrier a chunk.  The
// one-lane plans give each lane a block of its own:
//
//   1. The lane's whole horizon of the chain's operands goes into shared
//      memory in one burst of cp.async copies (16 bytes where B = 1 and the
//      rows are aligned), and the carry-free work of every stage (gaps,
//      barrier diagonals, gradients, r_dyn) runs at once, one thread a stage.
//   2. The chain is spread over threads, one per output entry: a warp, lane i
//      owning entry i of the vector carry, exchanged by shuffles (fwd: du_i
//      then dx'_i; bwd_corr: p_i; kkt: nu_i), each stage's operands read
//      one stage ahead and no branch in the stage (lanes past the carry's
//      length repeat the last lane's work, a term off the pattern is dropped
//      by a select); for bwd_fused one thread per entry of (P + Q)[A | B],
//      then of Qux and A'PA while one warp forms Quu and factors it, then of
//      the new P, under a named barrier of the chain's warps, and its affine
//      vector recursion one stage behind in a warp that phase 2 leaves idle.
//   3. The work that follows the chain (the forward sweeps' bound entries,
//      bwd_corr's kff) runs over all stages at once; the per-lane reductions
//      run across the block.
//
// Every entry is summed over the same terms in the same order as in the
// batched plans, with the same helpers, and the per-lane sums (musum, c12)
// are folded in the batched plans' chunk order, so the two plans give a
// lane the same outputs to the bit.  plan_of picks the plan from N and B
// alone.

// The most dynamic shared memory a block may take on Hopper (227 KB).
constexpr int kLaneSmemBytes = 232448;
// The one-lane plans serve B up to this many lanes (a block a lane): on the
// H100 at N=80 they beat the batched plans at every B up to 132 and lose
// for omni4 from 200, where two blocks share an SM.
constexpr int kOneLaneMaxB = 132;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// The largest horizon whose layout L(N) fits kLaneSmemBytes.
template <class L>
constexpr int lane_fit() {
  int n = 0;
  while (L::floats(n + 1) * 4 <= kLaneSmemBytes) ++n;
  return n;
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Lane b of n consecutive entries of a [rows, E, B] tensor (n = rows * E from
// its first row) into dst[0, n), 16-byte aligned: 16-byte copies where B = 1
// and src is aligned, else one entry a copy at stride B.
__device__ __forceinline__ void copy_lane(float* dst, const float* src, int n, int B, int b,
                                          int t, int nt) {
  if (B == 1 && reinterpret_cast<size_t>(src) % 16 == 0) {
    const int n4 = n / 4;
#pragma unroll 1
    for (int i = t; i < n4; i += nt) cp_async16(dst + 4 * i, src + 4 * i);
#pragma unroll 1
    for (int i = 4 * n4 + t; i < n; i += nt) cp_async4(dst + i, src + i);
  } else {
#pragma unroll 1
    for (int i = t; i < n; i += nt) cp_async4(dst + i, src + static_cast<size_t>(i) * B + b);
  }
}

// Index of entry (i, j) among the structural nonzeros of the R x Cc pattern
// P, row-major (its place in a packed row); -1 off the pattern.
template <class P, int R, int Cc>
__host__ __device__ constexpr int packed_at(int i, int j) {
  int e = 0;
  for (int k = 0; k < i * Cc + j; ++k) e += P::nz(k / Cc, k % Cc) ? 1 : 0;
  return P::nz(i, j) ? e : -1;
}

// off[m] = packed index of (i, m) (ROW) or (m, i), for a row or column i
// known only at run time (a lane's): each line's indices are template
// constants, chosen by a chain of selects, like col_mask.
template <class P, int R, int Cc, bool ROW, int I, int... M>
__device__ __forceinline__ void put_line(int (&off)[ROW ? Cc : R], std::integer_sequence<int, M...>) {
  ((off[M] = std::integral_constant<int, ROW ? packed_at<P, R, Cc>(I, M)
                                             : packed_at<P, R, Cc>(M, I)>::value),
   ...);
}

template <class P, int R, int Cc, bool ROW, int... I>
__device__ __forceinline__ void line_offsets_of(int i, int (&off)[ROW ? Cc : R],
                                                std::integer_sequence<int, I...>) {
#pragma unroll
  for (int m = 0; m < (ROW ? Cc : R); ++m) off[m] = -1;
  ((i == I ? put_line<P, R, Cc, ROW, I>(off, std::make_integer_sequence<int, ROW ? Cc : R>{})
           : void()),
   ...);
}

template <class P, int R, int Cc, bool ROW>
__device__ __forceinline__ void line_offsets(int i, int (&off)[ROW ? Cc : R]) {
  line_offsets_of<P, R, Cc, ROW>(i, off, std::make_integer_sequence<int, ROW ? R : Cc>{});
}

// yes where bit (0 or 1) is 1, else no, bit for bit: a select in integer
// logic, which holds no predicate register (a masked dot keeps a mask a term,
// more than the seven predicates a thread has).
__device__ __forceinline__ float keep(unsigned bit, float yes, float no) {
  const int m = -static_cast<int>(bit);
  return __int_as_float((__float_as_int(yes) & m) | (__float_as_int(no) & ~m));
}

// The entries of that line of a packed stage p, each read at an address
// that is always valid (an entry off the pattern reads entry 0).
template <int E>
__device__ __forceinline__ void load_line(float (&a)[E], const float* p, const int (&off)[E]) {
#pragma unroll
  for (int m = 0; m < E; ++m) a[m] = p[off[m] < 0 ? 0 : off[m]];
}

// row_dot / col_dot of a line so loaded: the same terms in the same order;
// a term off the pattern is dropped by a select, not a branch.
template <int E>
__device__ __forceinline__ float line_dot(const float (&a)[E], const int (&off)[E],
                                          const float (&v)[E]) {
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < E; ++m) s = keep(static_cast<unsigned>(~off[m]) >> 31, s + a[m] * v[m], s);
  return s;
}

// Entry i of v, for an i known only at run time, by a chain of selects.
template <int E>
__device__ __forceinline__ float pick(const float (&v)[E], int i) {
  float r = v[0];
#pragma unroll
  for (int m = 1; m < E; ++m) r = i == m ? v[m] : r;
  return r;
}

// Every lane of the warp gets the E values that lanes 0 .. E-1 hold.
template <int E>
__device__ __forceinline__ void gather(float (&v)[E], float mine) {
#pragma unroll
  for (int m = 0; m < E; ++m) v[m] = __shfl_sync(0xffffffffu, mine, m);
}

// (i, j), j <= i, of the e-th entry of a lower triangle stored row-major.
__device__ __forceinline__ void tri_at(int e, int& i, int& j) {
  i = 0;
  while ((i + 1) * (i + 2) / 2 <= e) ++i;
  j = e - i * (i + 1) / 2;
}

// ---- bwd_fused, one lane ---------------------------------------------------

// A block of THREADS: CT chain threads and the warp that folds sum s*lam.
// The chain runs a stage in three phases, each closed by a named barrier of
// the chain's warps: (1) a thread per entry of (P + Q)[A | B] and of Pc; (2)
// a thread per entry of Qux and of A'(P + Q)A, while warp WQ forms Quu and
// factors it (the Cholesky, the longest step, so overlapping the rest of
// phase 2) and warp WV runs the affine vector recursion of the stage before
// (its K, L and Pc are complete by then); (3) a thread per entry of the new
// carry P, with column j of K where i = j.  Shared memory: the chain's
// matrices (fixed), then a slot per stage: A and B dense (entries off the
// pattern never written and never read), the barrier-modified diagonals,
// the gradients and r_dyn (as BwdPlan's slot), then the stage's K
// (row-major), L and Pc.
template <class C>
struct BwdLane {
  static constexpr int NX = C::NX, NU = C::NU, NTRU = NU * (NU + 1) / 2, NC = NX + NU;
  static constexpr int PX = (NX + 3) / 4 * 4;
  static constexpr int P1 = NX * NC + NX, P2 = NU * NX + NX * (NX + 1) / 2;
  static constexpr int CT = ((P1 > P2 + 64 ? P1 : P2 + 64) + 31) / 32 * 32, THREADS = CT + 32;
  static constexpr int WQ = CT / 32 - 2, WV = CT / 32 - 1;
  static_assert(P2 <= WQ * 32 && NTRU <= 32 && NX <= 32, "phases 2 and 3 need a thread an entry");
  static constexpr int OA = 0, OB = NX * NX, OQB = OB + NX * NU, ORB = OQB + NX, OGX = ORB + NU,
                       OGU = OGX + NX, ORD = OGU + NU, OK = ORD + NX, OL = OK + NU * NX,
                       OP = OL + NTRU, SLOT = round4(OP + NX);
  // Fixed part: P, (P + Q)[A | B], Qux, the stage's reciprocal pivots, A'(P + Q)A.
  static constexpr int FP = 0, FPA = FP + round4(NX * PX), FQX = FPA + round4(NX * NC),
                       FINV = FQX + round4(NU * NX), FAPA = FINV + round4(NU),
                       FIXED = FAPA + round4(NX * NX);
  __host__ __device__ static constexpr int floats(int N) { return FIXED + N * SLOT; }
};

// Stage k of lane b: A and B dense and r_dyn (also to global memory), as
// bwd_fused_kernel's prepare_ab.
template <class C>
__device__ __forceinline__ void lane_prepare_ab(const BwdFusedArgs& a, int k, int B, int b,
                                                float* R) {
  using S = Shape<C>;
  using L = BwdLane<C>;
  using PA = typename C::A;
  using PB = typename C::B;
  constexpr int NX = S::NX, NU = S::NU;
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
    R[L::ORD + i] = r;
    st(a.rdyn, k, i, NX, B, b, r);
#pragma unroll
    for (int m = 0; m < NX; ++m)
      if (PA::nz(i, m)) R[L::OA + i * NX + m] = A[i][m];
#pragma unroll
    for (int m = 0; m < NU; ++m)
      if (PB::nz(i, m)) R[L::OB + i * NU + m] = Bm[i][m];
  }
}

// Stage k of lane b: the primal residuals (to global memory), the barrier-
// modified diagonals and the gradients, as bwd_fused_kernel's
// prepare_bounds; sum s*lam is folded apart (bwd_fused_lane).
template <class C>
__device__ __forceinline__ void lane_prepare_bounds(const BwdFusedArgs& a, int k, int B, int b,
                                                    float reg, float d_cap, float* R) {
  using S = Shape<C>;
  using L = BwdLane<C>;
  constexpr int NX = S::NX, NU = S::NU, NBX = S::NBX, NBU = S::NBU;
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
  auto pair = [&](float z, float lb, float ub, float sl, float su, float ll, float lu,
                  float* rpl_out, float* rpu_out, float& diag, float& g) {
    const float rpl = z - lb - sl, rpu = ub - z - su;
    *rpl_out = rpl;
    *rpu_out = rpu;
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
    R[L::OQB + i] = qb[i];
    R[L::OGX + i] = gx[i];
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    R[L::ORB + i] = rb[i];
    R[L::OGU + i] = gu[i];
  }
}

// The Cholesky factor of Quu (lower triangle q) and its reciprocal pivots,
// entry by entry as in bwd_fused_kernel, spread over a warp column by
// column: every lane takes the square root of the pivot; in one division,
// lane i > j divides out entry (i, j) and lane j the reciprocal pivot (a
// correctly rounded 1 / L_jj, the same bits as bwd_fused_kernel's 1.f /
// L_jj); shuffles hand the column to every lane, so every lane ends with all
// of L and inv.  The IEEE steps in sequence fall from NU(NU + 3)/2 to 2 NU.
template <int NU>
__device__ __forceinline__ void chol_factor_warp(const float (&q)[NU][NU],
                                                 float (&Lv)[NU * (NU + 1) / 2], float (&inv)[NU],
                                                 int lane) {
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    float t = q[j][j];
#pragma unroll
    for (int m = 0; m < j; ++m) t -= Lv[tri(j, m)] * Lv[tri(j, m)];
    Lv[tri(j, j)] = sqrtf(t);
    float num = 1.f;
#pragma unroll
    for (int i = j + 1; i < NU; ++i) {
      float u = q[i][j];
#pragma unroll
      for (int m = 0; m < j; ++m) u -= Lv[tri(i, m)] * Lv[tri(j, m)];
      num = lane == i ? u : num;
    }
    const float r = num / Lv[tri(j, j)];
#pragma unroll
    for (int i = j + 1; i < NU; ++i) Lv[tri(i, j)] = __shfl_sync(0xffffffffu, r, i);
    inv[j] = __shfl_sync(0xffffffffu, r, j);
  }
}

template <class C>
__device__ __forceinline__ void bwd_fused_lane(BwdFusedArgs a, int N, int B, float reg,
                                               float d_cap) {
  using S = Shape<C>;
  using L = BwdLane<C>;
  using PA = typename C::A;
  using PB = typename C::B;
  constexpr int NX = S::NX, NU = S::NU, NBX = S::NBX, NBU = S::NBU, NTRU = S::NTRU;
  constexpr int NC = L::NC, PX = L::PX, CT = L::CT;
  extern __shared__ __align__(16) float smem[];
  float* P = smem + L::FP;       // P_core (no stage diagonal), dense and symmetric
  float* PAm = smem + L::FPA;    // (P_core + diag qbar)[A | B], [NX][NC]
  float* QX = smem + L::FQX;     // Qux [NU][NX]
  float* INV = smem + L::FINV;   // 1 / L_ii of the stage
  float* APA = smem + L::FAPA;   // A'(P_core + diag qbar)A, lower triangle of [NX][NX]
  float* slots = smem + L::FIXED;
  const int tid = threadIdx.x, b = blockIdx.x;

#pragma unroll 1
  for (int i = tid; i < NX * PX; i += L::THREADS) P[i] = 0.f;
#pragma unroll 1
  for (int it = tid; it < 2 * N; it += L::THREADS) {
    const int k = it < N ? it : it - N;
    if (it < N) {
      lane_prepare_ab<C>(a, k, B, b, slots + k * L::SLOT);
    } else {
      lane_prepare_bounds<C>(a, k, B, b, reg, d_cap, slots + k * L::SLOT);
    }
  }
  __syncthreads();

  if (tid < CT) {
    // ---- The Riccati chain, stage by stage from the last.  Phase 1: entry
    // (i1, j1) of (P + Q)[A | B], or Pc_jc.
    const int t = tid, w = t / 32, lane = t % 32;
    const int i1 = t / NC, j1 = t % NC, jc = t - NX * NC;
    const bool pa = t < NX * NC, pc = !pa && jc < NX;
    const unsigned mcol = !pa ? 0u : j1 < NX ? col_mask<PA, NX, NX>(j1) : col_mask<PB, NX, NU>(j1 - NX);
    const int mbase = j1 < NX ? L::OA + j1 : L::OB + (j1 - NX), mstride = j1 < NX ? NX : NU;
    // Phase 2: column c2 of A or B (its mask m2, entry m at base2 + m *
    // stride2) against column s2 of (P + Q)[A | B], to d2; in warp WQ, lane
    // e < NTRU forms entry (iq, jq) of Quu (column iq of B against column
    // NX + jq), adding rbar on the diagonal.
    int d2 = -1, s2 = 0, base2 = 0, stride2 = NU;
    unsigned m2 = 0u;
    if (t < NU * NX) {            // Qux[u][j] = (B' (P + Q) A)_{u j}
      const int u = t / NX, j = t % NX;
      d2 = L::FQX + t, s2 = j, base2 = L::OB + u, m2 = col_mask<PB, NX, NU>(u);
    } else if (t < L::P2) {       // A'(P + Q)A, lower
      int i, j;
      tri_at(t - NU * NX, i, j);
      d2 = L::FAPA + i * NX + j, s2 = j, base2 = L::OA + i, stride2 = NX;
      m2 = col_mask<PA, NX, NX>(i);
    }
    int iq = 0, jq = 0;
    tri_at(w == L::WQ && lane < NTRU ? lane : 0, iq, jq);
    const unsigned mq = col_mask<PB, NX, NU>(iq);
    // Phase 3: entry (i3, j3), j3 <= i3, of the new carry, and column j3 of K
    // where i3 = j3.
    const bool p3 = t < NX * (NX + 1) / 2;
    int i3 = 0, j3 = 0;
    tri_at(p3 ? t : 0, i3, j3);
    // Warp WV: the affine vector recursion of stage kv, lane j owning p_j:
    // tmp = p + gx + Pc, qu_bar = gu + B' tmp, kff = -(L L')^{-1} qu_bar, p <-
    // A' tmp + K' qu_bar.  Lanes past NX repeat lane NX - 1's work; nothing
    // reads theirs.
    const int jx = min(lane, NX - 1);
    const unsigned amask = col_mask<PA, NX, NX>(jx);
    float p = 0.f;
    auto vector = [&](int kv) {
      const float* R = slots + kv * L::SLOT;
      float tmp[NX], qub[NU];
      gather<NX>(tmp, p + R[L::OGX + jx] + R[L::OP + jx]);
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m)
          if (PB::nz(m, u)) s += R[L::OB + m * NU + u] * tmp[m];
        qub[u] = R[L::OGU + u] + s;
      }
      float at = 0.f, kt = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m) {
        at = keep((amask >> m) & 1u, at + R[L::OA + m * NX + jx] * tmp[m], at);
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) kt += R[L::OK + u * NX + jx] * qub[u];
      p = at + kt;
      // kff, the same in every lane; lane u stores entry u.
      float Lv[NTRU], inv[NU], sol[NU];
#pragma unroll
      for (int e = 0; e < NTRU; ++e) Lv[e] = R[L::OL + e];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        inv[i] = 1.f / Lv[tri(i, i)];
        sol[i] = qub[i];
      }
      chol_solve_inv<NU>(Lv, inv, sol);
      if (lane < NU) st(a.kff, kv, lane, NU, B, b, -pick<NU>(sol, lane));
    };

#pragma unroll 1
    for (int k = N - 1; k >= 0; --k) {
      float* R = slots + k * L::SLOT;
      if (pa) {
        const float qb = R[L::OQB + i1];
        float t1 = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m) {
          const float pm = m == i1 ? P[i1 * PX + m] + qb : P[i1 * PX + m];
          t1 = keep((mcol >> m) & 1u, fmaf(pm, R[mbase + m * mstride], t1), t1);
        }
        PAm[i1 * NC + j1] = t1;
      } else if (pc) {
        float v = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m)
          v = fmaf(m == jc ? P[jc * PX + m] + R[L::OQB + jc] : P[jc * PX + m], R[L::ORD + m], v);
        R[L::OP + jc] = v;
        st(a.Pc, k, jc, NX, B, b, v);
      }
      bar_sync(1, CT);
      if (d2 >= 0) {
        float t2 = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m) {
          t2 = keep((m2 >> m) & 1u, fmaf(R[base2 + m * stride2], PAm[m * NC + s2], t2), t2);
        }
        smem[d2] = t2;
      } else if (w == L::WQ) {
        float qe = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m) {
          qe = keep((mq >> m) & 1u, fmaf(R[L::OB + iq + m * NU], PAm[m * NC + NX + jq], qe), qe);
        }
        qe = iq == jq ? qe + R[L::ORB + jq] : qe;
        float q[NU][NU], Lv[NTRU], inv[NU];
#pragma unroll
        for (int i = 0; i < NU; ++i)
#pragma unroll
          for (int jj = 0; jj <= i; ++jj) q[i][jj] = __shfl_sync(0xffffffffu, qe, tri(i, jj));
        chol_factor_warp<NU>(q, Lv, inv, lane);
        if (lane < NTRU) {
          const float l = pick<NTRU>(Lv, lane);
          R[L::OL + lane] = l;
          st(a.L, k, lane, NTRU, B, b, l);
        }
        if (lane < NU) INV[lane] = pick<NU>(inv, lane);
      } else if (w == L::WV && k < N - 1) {
        vector(k + 1);
      }
      bar_sync(1, CT);
      if (p3) {
        float Lv[NTRU], inv[NU], kc[NU];
#pragma unroll
        for (int e = 0; e < NTRU; ++e) Lv[e] = R[L::OL + e];
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          inv[u] = INV[u];
          kc[u] = QX[u * NX + j3];
        }
        chol_solve_inv<NU>(Lv, inv, kc);
#pragma unroll
        for (int u = 0; u < NU; ++u) kc[u] = -kc[u];
        float t3 = 0.f;
#pragma unroll
        for (int u = 0; u < NU; ++u) t3 += QX[u * NX + i3] * kc[u];
        const float pn = APA[i3 * NX + j3] + t3;
        P[i3 * PX + j3] = pn;
        P[j3 * PX + i3] = pn;
        if (i3 == j3) {
#pragma unroll
          for (int u = 0; u < NU; ++u) {
            R[L::OK + u * NX + j3] = kc[u];
            st(a.K, k, u * NX + j3, NU * NX, B, b, kc[u]);
          }
        }
      }
      bar_sync(1, CT);
    }
    if (w == L::WV) vector(0);
  } else {
    // ---- Sum s*lam, folded as bwd_fused_kernel's producers fold it: lane
    // fp takes position fp of each chunk of BwdPlan's SC stages, from the
    // horizon's end; then the lanes' sums in order.
    constexpr int SC = BwdPlan<C>::SC;
    static_assert(SC <= 32, "a lane a chunk position");
    const int fp = tid - CT;
    float mu = 0.f;
    if (fp < SC) {
      const int nch = (N + SC - 1) / SC;
#pragma unroll 1
      for (int q = 0; q < nch; ++q) {
        const int k = N - q * SC - 1 - fp;
        if (k < max(0, N - (q + 1) * SC)) continue;
        Groups<C> s, l;
        s.load(a.s, k, B, b);
        l.load(a.l, k, B, b);
#pragma unroll
        for (int jb = 0; jb < NBX; ++jb)
          mu = mu + s.x[0][jb] * l.x[0][jb] + s.x[1][jb] * l.x[1][jb];
#pragma unroll
        for (int jb = 0; jb < NBU; ++jb)
          mu = mu + s.u[0][jb] * l.u[0][jb] + s.u[1][jb] * l.u[1][jb];
      }
    }
    float m = __shfl_sync(0xffffffffu, mu, 0);
#pragma unroll
    for (int r = 1; r < SC; ++r) m = m + __shfl_sync(0xffffffffu, mu, r);
    if (fp == 0) a.musum[b] = m;
  }
}

// ---- Forward sweeps, one lane ----------------------------------------------

// Shared memory of fwd_lane, in floats, each region 16-byte aligned: the
// rollout's operands (A, B packed, K, kff, r_dyn), the four bound groups of
// s, lambda, rp (and corr), the rollout's dx (N + 1 rows, the first r_init)
// and du, and for the affine sweep each bound entry's ds and dl.
template <class C, bool CORR>
struct FwdLane {
  static constexpr int NX = C::NX, NU = C::NU, NBX = C::IDXBX::size, NBU = C::IDXBU::size;
  static constexpr int G = 2 * (NBX + NBU);  // bound entries of a stage
  static constexpr int THREADS = 256, WARPS = THREADS / 32;
  struct Layout {
    int A, Bm, K, kff, rd, grp[4][4], X, U, DS, DL, RED, total;
    __host__ __device__ constexpr Layout(int N)
        : A(0), Bm(0), K(0), kff(0), rd(0), grp{}, X(0), U(0), DS(0), DL(0), RED(0), total(0) {
      int o = 0;
      auto take = [&o](int n) {
        const int r = o;
        o += round4(n);
        return r;
      };
      A = take(N * C::A::count());
      Bm = take(N * C::B::count());
      K = take(N * NU * NX);
      kff = take(N * NU);
      rd = take(N * NX);
      for (int v = 0; v < (CORR ? 4 : 3); ++v)  // s, lambda, rp, corr
        for (int g = 0; g < 4; ++g) grp[v][g] = take(N * (g < 2 ? NBX : NBU));
      X = take((N + 1) * NX);
      U = take(N * NU);
      DS = take(CORR ? 0 : N * G);
      DL = take(CORR ? 0 : N * G);
      RED = take(2 * WARPS);
      total = o;
    }
  };
  __host__ __device__ static constexpr int floats(int N) { return Layout(N).total; }
};

template <class C, bool CORR>
__device__ __forceinline__ void fwd_lane(FwdArgs a, int N, int B, float tau) {
  using S = Shape<C>;
  using F = FwdLane<C, CORR>;
  using PA = typename C::A;
  using PB = typename C::B;
  constexpr int NX = S::NX, NU = S::NU, NBX = S::NBX, NBU = S::NBU, G = F::G, T = F::THREADS;
  extern __shared__ __align__(16) float smem[];
  const typename F::Layout Y(N);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, b = blockIdx.x;
  float* X = smem + Y.X;
  float* U = smem + Y.U;
  auto grp = [&](int v, int g) { return smem + Y.grp[v][g]; };

  // The rollout's operands first, in a group of their own, so that the
  // rollout starts while the bound entries' operands arrive.
  copy_lane(smem + Y.A, a.A, N * S::NNZA, B, b, tid, T);
  copy_lane(smem + Y.Bm, a.Bm, N * S::NNZB, B, b, tid, T);
  copy_lane(smem + Y.K, a.K, N * NU * NX, B, b, tid, T);
  copy_lane(smem + Y.kff, a.kff, N * NU, B, b, tid, T);
  copy_lane(smem + Y.rd, a.rdyn, N * NX, B, b, tid, T);
  copy_lane(X, a.r_init, NX, B, b, tid, T);
  cp_async_commit();
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int n = N * (g < 2 ? NBX : NBU);
    copy_lane(grp(0, g), a.s.g[g], n, B, b, tid, T);
    copy_lane(grp(1, g), a.l.g[g], n, B, b, tid, T);
    copy_lane(grp(2, g), a.rp.g[g], n, B, b, tid, T);
    if constexpr (CORR) copy_lane(grp(3, g), a.corr.g[g], n, B, b, tid, T);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  if (warp == 0) {
    // ---- The rollout: lane i owns du_i = kff_i + K_i dx, then dx'_i = r_dyn_i
    // + A_i dx + B_i du, as fwd_kernel's rollout.  Lanes past NU (NX) repeat
    // lane NU - 1's (NX - 1's) work; nothing reads theirs.  A stage's
    // operands are read one stage ahead.
    const int ru = min(lane, NU - 1), rx = min(lane, NX - 1);
    int offA[NX], offB[NU];
    line_offsets<PA, NX, NX, true>(rx, offA);
    line_offsets<PB, NX, NU, true>(rx, offB);
    struct Ops {
      float K[NX], kff, rd, a[NX], b[NU];
    };
    auto load = [&](int k) {
      Ops o;
#pragma unroll
      for (int m = 0; m < NX; ++m) o.K[m] = smem[Y.K + (k * NU + ru) * NX + m];
      o.kff = smem[Y.kff + k * NU + ru];
      o.rd = smem[Y.rd + k * NX + rx];
      load_line(o.a, smem + Y.A + k * S::NNZA, offA);
      load_line(o.b, smem + Y.Bm + k * S::NNZB, offB);
      return o;
    };
    float dxi = X[rx];
    Ops cur = load(0);
#pragma unroll 2
    for (int k = 0; k < N; ++k) {
      const Ops nxt = load(min(k + 1, N - 1));
      float dx[NX], du[NU];
      gather<NX>(dx, dxi);
      float t = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m) t += cur.K[m] * dx[m];
      const float dui = cur.kff + t;
      gather<NU>(du, dui);
      t = cur.rd;
      t += line_dot<NX>(cur.a, offA, dx);
      t += line_dot<NU>(cur.b, offB, du);
      dxi = t;
      if (lane < NU) U[k * NU + lane] = dui;
      if (lane < NX) X[(k + 1) * NX + lane] = t;
      cur = nxt;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- Every stage's bound entries at once: item (k, part), part 0 the x
  // bounds at dx_{k+1}, part 1 the u bounds at du_k, as fwd_kernel's fanout.
  float sm = 0.f;
  if constexpr (CORR) sm = __ldg(a.sigma_mu + b);
  float mpart = kBig, fin = 1.f;
#pragma unroll 1
  for (int it = tid; it < 2 * N; it += T) {
    const int k = it < N ? it : it - N;
    auto entry = [&](int v, int g, int nb, int j) { return grp(v, g)[k * nb + j]; };
    auto item = [&](int g, int nb, int j, int q, float dz) {
      float ds, dl;
      FwdCarry cr{kBig, 0.f, 0.f, 1.f};
      fwd_delta<CORR>(entry(0, g, nb, j), entry(1, g, nb, j), entry(2, g, nb, j),
                      CORR ? entry(3, g, nb, j) : 0.f, sm, dz, (g & 1) == 0 ? 1.f : -1.f, cr,
                      ds, dl);
      mpart = min_nan(mpart, cr.m);
      if constexpr (CORR) {
        fin *= cr.fin;
        st(a.ds.g[g], k, j, nb, B, b, ds);
        st(a.dl.g[g], k, j, nb, B, b, dl);
      } else {
        st(a.prod.g[g], k, j, nb, B, b, ds * dl);
        smem[Y.DS + k * G + q] = ds;
        smem[Y.DL + k * G + q] = dl;
      }
    };
    if (it < N) {
      if constexpr (CORR) {
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          const float xn = X[(k + 1) * NX + i];
          st(a.ddx, k, i, NX, B, b, X[k * NX + i]);
          fin *= finite1(xn);
          if (k == N - 1) st(a.ddx_N, 0, i, NX, B, b, xn);
        }
      }
#pragma unroll
      for (int j = 0; j < NBX; ++j)
#pragma unroll
        for (int g = 0; g < 2; ++g)
          item(g, NBX, j, 2 * j + g, X[(k + 1) * NX + C::IDXBX::at(j)]);
    } else {
      if constexpr (CORR) {
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          const float u = U[k * NU + i];
          st(a.ddu, k, i, NU, B, b, u);
          fin *= finite1(u);
        }
      }
#pragma unroll
      for (int j = 0; j < NBU; ++j)
#pragma unroll
        for (int g = 0; g < 2; ++g)
          item(2 + g, NBU, j, 2 * NBX + 2 * j + g, U[k * NU + C::IDXBU::at(j)]);
    }
  }
  // The step's least ratio and the finiteness flag over the block.
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    mpart = min_nan(mpart, __shfl_xor_sync(0xffffffffu, mpart, o));
    fin *= __shfl_xor_sync(0xffffffffu, fin, o);
  }
  if (lane == 0) {
    smem[Y.RED + warp] = mpart;
    smem[Y.RED + F::WARPS + warp] = fin;
  }
  __syncthreads();
  if (warp != 0) return;
  float m = smem[Y.RED];
  fin = smem[Y.RED + F::WARPS];
#pragma unroll
  for (int w = 1; w < F::WARPS; ++w) {
    m = min_nan(m, smem[Y.RED + w]);
    fin *= smem[Y.RED + F::WARPS + w];
  }
  if constexpr (CORR) {
    if (lane == 0) {
      a.alpha[b] = min_nan(1.f, tau * m);
      a.finite[b] = fin;
    }
  } else {
    // c1 and c2 folded as fwd_kernel's fan-out threads fold them: lane fs
    // takes stage fs of each chunk of FwdPlan's S stages, then the lanes'
    // sums in order.
    constexpr int SC = FwdPlan<C>::S;
    static_assert(SC <= 32, "a lane a chunk position");
    float c1 = 0.f, c2 = 0.f;
    if (lane < SC) {
#pragma unroll 1
      for (int k = lane; k < N; k += SC) {
        auto fold = [&](int g, int nb, int j, int q) {
          const float s = grp(0, g)[k * nb + j], lam = grp(1, g)[k * nb + j];
          const float ds = smem[Y.DS + k * G + q], dl = smem[Y.DL + k * G + q];
          // fwd_delta's sums, but ds * dl rounded before the add: in
          // fwd_kernel that product is also stored (prod), and a product with
          // a use other than an add is not fused into it.
          c1 = c1 + s * dl + lam * ds;
          c2 = c2 + __fmul_rn(ds, dl);
        };
#pragma unroll
        for (int j = 0; j < NBX; ++j)
#pragma unroll
          for (int g = 0; g < 2; ++g) fold(g, NBX, j, 2 * j + g);
#pragma unroll
        for (int j = 0; j < NBU; ++j)
#pragma unroll
          for (int g = 0; g < 2; ++g) fold(2 + g, NBU, j, 2 * NBX + 2 * j + g);
      }
    }
    float s1 = __shfl_sync(0xffffffffu, c1, 0), s2 = __shfl_sync(0xffffffffu, c2, 0);
#pragma unroll
    for (int r = 1; r < SC; ++r) {
      s1 = s1 + __shfl_sync(0xffffffffu, c1, r);
      s2 = s2 + __shfl_sync(0xffffffffu, c2, r);
    }
    if (lane == 0) {
      a.alpha[b] = min_nan(1.f, tau * m);
      a.c12[b] = s1;
      a.c12[B + b] = s2;
    }
  }
}

// ---- Backward vector sweeps, one lane --------------------------------------

// Shared memory of bwd_corr_lane (KKT false) and kkt_lane (KKT true): the
// chain's operands (A, B packed; K for bwd_corr), what the prepare pass
// leaves a stage (w = gx + Pc or gx, and gu), and bwd_corr's qu_bar or kkt's
// s*lam terms.
template <class C, bool KKT>
struct VecLane {
  static constexpr int NX = C::NX, NU = C::NU, NB = C::IDXBX::size + C::IDXBU::size;
  static constexpr int THREADS = 256;
  struct Layout {
    int A, Bm, K, W, GU, V, total;
    __host__ __device__ constexpr Layout(int N) : A(0), Bm(0), K(0), W(0), GU(0), V(0), total(0) {
      int o = 0;
      auto take = [&o](int n) {
        const int r = o;
        o += round4(n);
        return r;
      };
      A = take(N * C::A::count());
      Bm = take(N * C::B::count());
      K = take(KKT ? 0 : N * NU * NX);
      W = take(N * NX);
      GU = take(N * NU);
      V = take(N * (KKT ? NB : NU));
      total = o;
    }
  };
  __host__ __device__ static constexpr int floats(int N) { return Layout(N).total; }
};

template <class C>
__device__ __forceinline__ void bwd_corr_lane(BwdCorrArgs a, int N, int B) {
  using S = Shape<C>;
  using F = VecLane<C, false>;
  using PA = typename C::A;
  using PB = typename C::B;
  constexpr int NX = S::NX, NU = S::NU, NBX = S::NBX, NBU = S::NBU, NTRU = S::NTRU, T = F::THREADS;
  extern __shared__ __align__(16) float smem[];
  const typename F::Layout Y(N);
  const int tid = threadIdx.x, b = blockIdx.x;
  const float sm = __ldg(a.sigma_mu + b);

  copy_lane(smem + Y.A, a.A, N * S::NNZA, B, b, tid, T);
  copy_lane(smem + Y.Bm, a.Bm, N * S::NNZB, B, b, tid, T);
  copy_lane(smem + Y.K, a.K, N * NU * NX, B, b, tid, T);
  cp_async_commit();
  // Every stage's w = gx + Pc and gu, as bwd_corr_kernel's prepare.
#pragma unroll 1
  for (int k = tid; k < N; k += T) {
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
    for (int i = 0; i < NX; ++i) smem[Y.W + k * NX + i] = gx[i] + Pc[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) smem[Y.GU + k * NU + i] = gu[i];
  }
  cp_async_wait<0>();
  __syncthreads();

  if (tid < 32) {
    // ---- The chain, lane i owning p_i: tmp = p + w, qu_bar = gu + B' tmp,
    // p <- A' tmp + K' qu_bar, as bwd_corr_kernel's step.  Lanes past NX
    // repeat lane NX - 1's work; nothing reads theirs.  A stage's operands
    // are read one stage ahead.
    const int i = tid, ix = min(i, NX - 1);
    int offA[NX];
    line_offsets<PA, NX, NX, false>(ix, offA);
    struct Ops {
      float Bm[NX][NU], a[NX], kc[NU], gu[NU], w;
    };
    auto load = [&](int k) {
      Ops o;
      load_packed_smem<PB, NX, NU, 1>(o.Bm, smem + Y.Bm + k * S::NNZB);
      load_line(o.a, smem + Y.A + k * S::NNZA, offA);
#pragma unroll
      for (int m = 0; m < NU; ++m) {
        o.kc[m] = smem[Y.K + (k * NU + m) * NX + ix];
        o.gu[m] = smem[Y.GU + k * NU + m];
      }
      o.w = smem[Y.W + k * NX + ix];
      return o;
    };
    float p = 0.f;
    Ops cur = load(N - 1);
#pragma unroll 2
    for (int k = N - 1; k >= 0; --k) {
      const Ops nxt = load(max(k - 1, 0));
      float tmp[NX], qub[NU];
      gather<NX>(tmp, p + cur.w);
#pragma unroll
      for (int u = 0; u < NU; ++u) qub[u] = cur.gu[u] + col_dot<PB>(cur.Bm, u, tmp);
      float kt = 0.f;
#pragma unroll
      for (int m = 0; m < NU; ++m) kt += cur.kc[m] * qub[m];
      p = line_dot<NX>(cur.a, offA, tmp) + kt;
      if (i < NU) smem[Y.V + k * NU + i] = pick<NU>(qub, i);
      cur = nxt;
    }
  }
  __syncthreads();
  // ---- Every stage's kff = -(L L')^{-1} qu_bar, as bwd_corr_kernel's finish.
#pragma unroll 1
  for (int k = tid; k < N; k += T) {
    float L[NTRU], x[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) L[tri(i, j)] = ld(a.L, k, tri(i, j), NTRU, B, b);
      x[i] = smem[Y.V + k * NU + i];
    }
    chol_solve<NU>(L, x);
#pragma unroll
    for (int i = 0; i < NU; ++i) st(a.kff, k, i, NU, B, b, -x[i]);
  }
}

template <class C>
__device__ __forceinline__ void kkt_lane(KKTArgs a, int N, int B) {
  using S = Shape<C>;
  using F = VecLane<C, true>;
  using PA = typename C::A;
  using PB = typename C::B;
  constexpr int NX = S::NX, NU = S::NU, NBX = S::NBX, NBU = S::NBU, NB = F::NB, T = F::THREADS;
  extern __shared__ __align__(16) float smem[];
  const typename F::Layout Y(N);
  const int tid = threadIdx.x, b = blockIdx.x;

  copy_lane(smem + Y.A, a.A, N * S::NNZA, B, b, tid, T);
  copy_lane(smem + Y.Bm, a.Bm, N * S::NNZB, B, b, tid, T);
  cp_async_commit();
  // Every stage's gx and gu, and its s*lam term of each bound entry, as
  // kkt_kernel's prepare.
#pragma unroll 1
  for (int k = tid; k < N; k += T) {
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
    for (int j = 0; j < NBX; ++j)
      smem[Y.V + k * NB + j] = s.x[0][j] * l.x[0][j] + s.x[1][j] * l.x[1][j];
#pragma unroll
    for (int j = 0; j < NBU; ++j)
      smem[Y.V + k * NB + NBX + j] = s.u[0][j] * l.u[0][j] + s.u[1][j] * l.u[1][j];
#pragma unroll
    for (int i = 0; i < NX; ++i) smem[Y.W + k * NX + i] = gx[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) smem[Y.GU + k * NU + i] = gu[i];
  }
  cp_async_wait<0>();
  __syncthreads();

  if (tid < 32) {
    // ---- The chain, lane i owning c_i: nu = gx + c, max |gu + B' nu|, c <-
    // A' nu, as kkt_kernel's step.
    // Lanes past NX repeat lane NX - 1's work; nothing reads theirs.  A
    // stage's operands are read one stage ahead.
    const int i = tid, ix = min(i, NX - 1);
    int offA[NX];
    line_offsets<PA, NX, NX, false>(ix, offA);
    struct Ops {
      float Bm[NX][NU], a[NX], gu[NU], w;
    };
    auto load = [&](int k) {
      Ops o;
      load_packed_smem<PB, NX, NU, 1>(o.Bm, smem + Y.Bm + k * S::NNZB);
      load_line(o.a, smem + Y.A + k * S::NNZA, offA);
#pragma unroll
      for (int u = 0; u < NU; ++u) o.gu[u] = smem[Y.GU + k * NU + u];
      o.w = smem[Y.W + k * NX + ix];
      return o;
    };
    float c = 0.f, m = 0.f;
    Ops cur = load(N - 1);
#pragma unroll 2
    for (int k = N - 1; k >= 0; --k) {
      const Ops nxt = load(max(k - 1, 0));
      float nu_v[NX];
      gather<NX>(nu_v, cur.w + c);
#pragma unroll
      for (int u = 0; u < NU; ++u)
        m = max_nan(m, fabsf(cur.gu[u] + col_dot<PB>(cur.Bm, u, nu_v)));
      c = line_dot<NX>(cur.a, offA, nu_v);
      cur = nxt;
    }
    if (i == 0) a.kkt[b] = m;
  } else if (tid < 64) {
    // ---- Sum s*lam, folded as kkt_kernel's fan-out threads fold it: lane fs
    // takes row fs of each chunk of VecPlan's S stages, from the horizon's
    // end; then the lanes' sums in order.
    constexpr int SC = VecPlan<C, true>::S;
    static_assert(SC <= 32, "a lane a chunk position");
    const int fs = tid - 32, nch = (N + SC - 1) / SC;
    float mu = 0.f;
    if (fs < SC) {
#pragma unroll 1
      for (int q = 0; q < nch; ++q) {
        const int lo = max(0, N - (q + 1) * SC), hi = N - q * SC;
        if (fs >= hi - lo) continue;
#pragma unroll
        for (int j = 0; j < NB; ++j) mu = mu + smem[Y.V + (lo + fs) * NB + j];
      }
    }
    float s = __shfl_sync(0xffffffffu, mu, 0);
#pragma unroll
    for (int r = 1; r < SC; ++r) s = s + __shfl_sync(0xffffffffu, mu, r);
    if (fs == 0) a.musum[b] = s;
  }
}

// The plan a sweep of configuration C takes at horizon N over B lanes: one
// lane a block while B is small and every one-lane layout fits the horizon.
template <class C>
struct LaneFit {
  static constexpr int N_FIT =
      std::min({lane_fit<BwdLane<C>>(), lane_fit<FwdLane<C, false>>(),
                lane_fit<FwdLane<C, true>>(), lane_fit<VecLane<C, false>>(),
                lane_fit<VecLane<C, true>>()});
};

template <class C>
int plan_of(int N, int B) {
  return B <= kOneLaneMaxB && N <= LaneFit<C>::N_FIT ? kOneLane : kBatched;
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
  if (plan_of<C>(N, B) == kOneLane) {
    using L = BwdLane<C>;
    static const int attr = smem_attr(bwd_fused_kernel<C, kOneLane>, kLaneSmemBytes);
    if (attr != 0) return attr;
    bwd_fused_kernel<C, kOneLane><<<B, L::THREADS, L::floats(N) * 4, stream>>>(a, N, B, reg,
                                                                                d_cap);
    return static_cast<int>(cudaGetLastError());
  }
  using Pl = BwdPlan<C>;
  static const int attr = smem_attr(bwd_fused_kernel<C, kBatched>, Pl::SMEM);
  if (attr != 0) return attr;
  bwd_fused_kernel<C, kBatched><<<(B + Pl::LANES - 1) / Pl::LANES, Pl::THREADS, Pl::SMEM, stream>>>(
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
  if (plan_of<C>(N, B) == kOneLane) {
    using L = FwdLane<C, CORR>;
    static const int attr = smem_attr(fwd_kernel<C, kOneLane, CORR>, kLaneSmemBytes);
    if (attr != 0) return attr;
    fwd_kernel<C, kOneLane, CORR><<<B, L::THREADS, L::floats(N) * 4, stream>>>(a, N, B, tau);
    return static_cast<int>(cudaGetLastError());
  }
  using F = FwdPlan<C>;
  static const int attr = smem_attr(fwd_kernel<C, kBatched, CORR>, F::SMEM);
  if (attr != 0) return attr;
  fwd_kernel<C, kBatched, CORR><<<(B + F::TL - 1) / F::TL, F::THREADS, F::SMEM, stream>>>(a, N, B,
                                                                                          tau);
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
  if (plan_of<C>(N, B) == kOneLane) {
    using L = VecLane<C, false>;
    static const int attr = smem_attr(bwd_corr_kernel<C, kOneLane>, kLaneSmemBytes);
    if (attr != 0) return attr;
    bwd_corr_kernel<C, kOneLane><<<B, L::THREADS, L::floats(N) * 4, stream>>>(a, N, B);
    return static_cast<int>(cudaGetLastError());
  }
  using F = VecPlan<C, false>;
  static const int attr = smem_attr(bwd_corr_kernel<C, kBatched>, F::SMEM);
  if (attr != 0) return attr;
  bwd_corr_kernel<C, kBatched><<<(B + F::TL - 1) / F::TL, F::THREADS, F::SMEM, stream>>>(a, N, B);
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
  if (plan_of<C>(N, B) == kOneLane) {
    using L = VecLane<C, true>;
    static const int attr = smem_attr(kkt_kernel<C, kOneLane>, kLaneSmemBytes);
    if (attr != 0) return attr;
    kkt_kernel<C, kOneLane><<<B, L::THREADS, L::floats(N) * 4, stream>>>(a, N, B);
    return static_cast<int>(cudaGetLastError());
  }
  using F = VecPlan<C, true>;
  static const int attr = smem_attr(kkt_kernel<C, kBatched>, F::SMEM);
  if (attr != 0) return attr;
  kkt_kernel<C, kBatched><<<(B + F::TL - 1) / F::TL, F::THREADS, F::SMEM, stream>>>(a, N, B);
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
  }                                                                                          \
  extern "C" int ipm_plan_##name(int N, int B) { return plan_of<Config>(N, B); }

IPM_EXPORT(diff, DiffConfig)
IPM_EXPORT(dense72, Dense72Config)
IPM_EXPORT(omni4, Omni4Config)
