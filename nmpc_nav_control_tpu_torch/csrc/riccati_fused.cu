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
// Layout.  Operands are dense (no sparsity pattern) and batch-minor, entry e
// of row k of lane b at ((k*E)+e)*B + b.  Ps[k] = P_k is written, full and
// symmetric, for every row 0..N; Ls are packed lower triangles.
//
// Design.  On the TPU a lane of an (8, 128) tile is one scenario and the
// sequential grid axis walks the stages.  Here each kernel splits a lane's
// stage so that only its carry is sequential:
//
//   factor_kernel: the team design of ipm_fused.cu's bwd_fused_kernel.  A
//   block owns 8 lanes and walks the horizon backward in chunks of SC
//   stages.  Each lane has a team of 16 threads, two teams to a warp:
//   thread j owns column j of M = [A | B], so of v = P_{k+1} M e_j, of Qux
//   (w = B'v) or of Quu (for j >= nx), of A'PA (A'v), of K and of the new P.
//   The nu x nu Cholesky of Quu, with reciprocal pivots, runs in every
//   thread.  A stage is three parts, each ending in a __syncwarp: v, w and
//   A'v, with Qux and Quu to the team's shared slots; L, K and M = A'PA +
//   Qux'K, with M to the slots; P_k = (M + M')/2 + diag(Qd_k) from the own
//   column and row of M, to the carry (its lower triangle).  Every
//   product is computed (A and B are dense), so a NaN or Inf reaches what it
//   reaches in the plain version.  Meanwhile producer warps copy the next
//   chunk's A, B, Qd and Rd into a two-slot ring with cp.async and write the
//   last chunk's Ps, Ks and Ls out of a shared tile, a row of lanes at a time.
//
//   solve_bwd_kernel: the vec_sweep skeleton of bwd_corr_kernel (sweep.cuh).
//   A block owns 16 lanes and walks the horizon from its end in chunks of S
//   stages.  Warp 0 runs the carry only, one thread per lane, from a
//   shared-memory ring: tmp = p + w, qu_bar = qu + B'tmp, p <- (qx + A'tmp)
//   + K'qu_bar.  The fan-out threads, one per (stage, lane), copy the next
//   chunk's A, B, K, qx and qu with cp.async, compute its carry-free w =
//   P_{k+1} c_k from the lower triangle of P (and load its L), and finish
//   the last chunk with kff = -(L L')^{-1} qu_bar from the qu_bar the chain
//   left in the ring; so neither P nor L enters the chain.
//
//   solve_fwd_kernel: the shape of ipm_fused.cu's fwd_kernel without the
//   bound-entry work.  A block owns 32 lanes at (7, 2) and 16 at (11, 4)
//   and walks the horizon forward in chunks of S stages.  Warp 0 rolls a
//   chunk out, one thread per lane, from a two-slot shared-memory ring
//   (du = K dx + kff, then A dx + B du, then + c, the plain version's
//   order) into a shared output tile; the fan-out threads copy the chunk
//   after next into the ring with unrolled cp.async rows (copy_rows) and
//   store the last chunk's dx and du from the tile, one thread per (stage,
//   lane), so neither a load nor a store sits on the chain.
//
// Bound.  By the card's peaks each kernel is bound by the bytes it must move
// (every input read once, every output written once), far below its flops.
// What sets the time is elsewhere.  The factor's stage is a dependent chain
// of three parts, and every team thread reads all of P and A from shared
// memory each stage (broadcast reads; 66 + 121 floats at nx = 11), so shared
// memory's bandwidth and the chain bound it; P is kept as its lower triangle
// for that.  solve_bwd's and solve_fwd's chains are short: their fan-out
// sets the pace, moving a chunk's bytes at a time, and the first chunk
// overlaps nothing.
//
// Arithmetic is IEEE f32 (no --use_fast_math): a non-positive pivot gives NaN
// through sqrtf and poisons the lane, which the IPM's per-lane rejection of
// non-finite steps relies on.  Lanes at or past B join every barrier and
// store nothing.
#include <cuda_runtime.h>

#include <cstddef>

#include "sweep.cuh"

namespace {

// Entries e = pe, pe + EG, ... < E of one row of a batch-minor tensor (src:
// its entry 0 of one lane) into shared memory, entry e at (e / WIDTH) * PITCH
// + e % WIDTH of dst.  Unrolled, the copies issue back to back.
template <int E, int WIDTH, int PITCH, int EG>
__device__ __forceinline__ void copy_row(float* dst, const float* src, int B, int pe) {
#pragma unroll
  for (int t = 0; t < (E + EG - 1) / EG; ++t) {
    const int e = t * EG + pe;
    if (e < E) cp_async4(dst + (e / WIDTH) * PITCH + e % WIDTH, src + static_cast<size_t>(e) * B);
  }
}

// The reverse: entries e = pe, pe + EG, ... < E of src (shared memory) to
// one row of a batch-minor tensor (dst: its entry 0 of one lane).
template <int E, int EG>
__device__ __forceinline__ void store_row(float* dst, const float* src, int B, int pe) {
#pragma unroll
  for (int t = 0; t < (E + EG - 1) / EG; ++t) {
    const int e = t * EG + pe;
    if (e < E) dst[static_cast<size_t>(e) * B] = src[e];
  }
}

// --------------------------------------------------------------------------
// Factor: A, B, Qd, Rd -> Ps (every row 0..N), Ks, Ls (packed lower)
// --------------------------------------------------------------------------

struct FactorArgs {
  const float *A, *Bm, *Qd, *Rd;
  float *Ps, *Ks, *Ls;
};

// Shared memory of one factor block: the two-slot ring, the two-slot output
// tile and the teams' slots.
constexpr int kFactorBytes = 110 * 1024;

// Shared-memory plan of factor_kernel.  A block owns LANES lanes; its first
// TEAM threads are the lanes' teams of T threads, the last FAN threads the
// producers.  Per lane and stage the ring holds SLOT floats: A with rows of
// pitch PX (float4 rows), B (row-major), Qd, Rd.  The output tile holds OUTP
// floats per lane and stage: P_k (row-major), K (row-major), L.  Each team
// keeps W floats: the carry P (its lower triangle: shared memory's
// bandwidth, which a team's broadcast reads of P and A use up, bounds the
// stage), M, Qux and Quu.
// SLOT, OUTP and W are 16 (mod 32) floats, so the two teams of a warp hit
// distinct banks.  SC stages a chunk, as many as kFactorBytes holds, at
// most 8: two blocks an SM.
template <int NX, int NU>
struct FactorPlan {
  static constexpr int NTRU = NU * (NU + 1) / 2;
  static constexpr int T = 16, LANES = 8, TEAM = T * LANES, FAN = 64, THREADS = TEAM + FAN;
  static constexpr int EG = FAN / LANES;  // producers per lane
  static_assert(NX + NU <= T, "a team needs a thread per column of [A | B]");
  static_assert(NTRU <= T, "a team stores L with a thread per entry");
  static constexpr int PX = (NX + 3) / 4 * 4;
  // Ring slot, per lane and stage.
  static constexpr int OA = 0, OB = NX * PX, OQ = OB + NX * NU, OR = OQ + NX,
                       SLOT = pad16(OR + NU);
  // Output tile, per lane and stage.
  static constexpr int EP = 0, EK = NX * NX, EL = EK + NU * NX, OUTP = pad16(EL + NTRU);
  // Team slots, per lane.
  static constexpr int TP = 0, TM = (NX * (NX + 1) / 2 + 3) / 4 * 4, TQUX = TM + NX * PX,
                       TQUU = TQUX + NU * PX,
                       W = pad16(TQUU + NU * NU);
  static constexpr int TEAMS = LANES * W, PER_STAGE = 2 * LANES * (SLOT + OUTP);
  static constexpr int S_FIT = (kFactorBytes / 4 - TEAMS) / PER_STAGE;
  static constexpr int SC = S_FIT < 8 ? S_FIT : 8;
  static_assert(SC >= 1, "shared memory too small for one stage");
  static constexpr int RING = SC * LANES * SLOT, OUT = SC * LANES * OUTP;
  static constexpr int SMEM = (2 * RING + 2 * OUT + TEAMS) * 4;
};

template <int NX, int NU>
__global__ void __launch_bounds__(FactorPlan<NX, NU>::THREADS, 2)
    factor_kernel(FactorArgs a, int N, int B, float reg) {
  using Pl = FactorPlan<NX, NU>;
  constexpr int NTRU = Pl::NTRU, LANES = Pl::LANES, SC = Pl::SC, PX = Pl::PX;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                    // 2 x [SC][LANES][SLOT]
  float* outb = ring + 2 * Pl::RING;     // 2 x [SC][LANES][OUTP]
  float* teams = outb + 2 * Pl::OUT;     // [LANES][W]
  const int tid = threadIdx.x, b0 = blockIdx.x * LANES;
  const int nch = (N + SC - 1) / SC;
  const bool team = tid < Pl::TEAM;
  // Chunk q holds stages [lo(q), hi(q)), stage k at position hi(q) - 1 - k.
  auto lo = [&](int q) { return max(0, N - (q + 1) * SC); };
  auto hi = [&](int q) { return N - q * SC; };

  // ---- Producers: thread f of FAN takes lane pl and entries pe, pe + EG,
  // ... of every row, so that a warp's copies and stores of one entry cover
  // LANES lanes (one 32-byte sector).
  const int f = tid - Pl::TEAM, pl = f % LANES, pe = f / LANES;
  constexpr int EG = Pl::EG;

  // Chunk q's A, B, Qd and Rd into ring slot q & 1.
  auto copy_chunk = [&, a](int q) {
    float* R0 = ring + (q & 1) * Pl::RING;
    const int k1 = hi(q), sc = k1 - lo(q), b = b0 + pl;
    if (b < B) {
#pragma unroll 1
      for (int p = 0; p < sc; ++p) {
        const size_t k = k1 - 1 - p;
        float* R = R0 + (p * LANES + pl) * Pl::SLOT;
        copy_row<NX * NX, NX, PX, EG>(R + Pl::OA, a.A + k * NX * NX * B + b, B, pe);
        copy_row<NX * NU, NU, NU, EG>(R + Pl::OB, a.Bm + k * NX * NU * B + b, B, pe);
        copy_row<NX, NX, 0, EG>(R + Pl::OQ, a.Qd + k * NX * B + b, B, pe);
        copy_row<NU, NU, 0, EG>(R + Pl::OR, a.Rd + k * NU * B + b, B, pe);
      }
    }
    cp_async_commit();
  };
  // Chunk q's output tile to Ps, Ks and Ls.
  auto flush = [&, a](int q) {
    const float* O0 = outb + (q & 1) * Pl::OUT;
    const int k1 = hi(q), sc = k1 - lo(q), b = b0 + pl;
    if (b >= B) return;
#pragma unroll 1
    for (int p = 0; p < sc; ++p) {
      const size_t k = k1 - 1 - p;
      const float* O = O0 + (p * LANES + pl) * Pl::OUTP;
      store_row<NX * NX, EG>(a.Ps + k * NX * NX * B + b, O + Pl::EP, B, pe);
      store_row<NU * NX, EG>(a.Ks + k * NU * NX * B + b, O + Pl::EK, B, pe);
      store_row<NTRU, EG>(a.Ls + k * NTRU * B + b, O + Pl::EL, B, pe);
    }
  };

  // ---- Teams: thread j of the team of lane tl.
  const int tl = tid / Pl::T, j = tid % Pl::T;
  float* tm = teams + tl * Pl::W;
  float* P = tm + Pl::TP;
  // Column j of M = [A | B] in a ring slot: entry m at R[mbase + m * mstride]
  // (column 0 of A for a thread past the last column, which stores nothing).
  const int mbase = j < NX ? Pl::OA + j : j < NX + NU ? Pl::OB + (j - NX) : Pl::OA;
  const int mstride = j < NX ? PX : j < NX + NU ? NU : PX;
  const int ju = j - NX;  // column of B (j >= NX)

  // One stage: R its ring slot, O its output slot.
  auto stage = [&](const float* R, float* O) {
    // Part 1: v = P_{k+1} M e_j, w = B'v (column j of Qux for j < nx,
    // column ju of B'PB for j >= nx) and, for j < nx, apa = A'v (column j
    // of A'PA).
    float mc[NX], v[NX], w[NU], apa[NX];
#pragma unroll
    for (int m = 0; m < NX; ++m) mc[m] = R[mbase + m * mstride];
    // Each entry of P's lower triangle is read once and used twice.
#pragma unroll
    for (int i = 0; i < NX; ++i) v[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int m = 0; m <= i; ++m) {
        const float p = P[tri(i, m)];
        v[i] = fmaf(p, mc[m], v[i]);
        if (m < i) v[m] = fmaf(p, mc[i], v[m]);
      }
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) w[u] = 0.f;
#pragma unroll
    for (int m = 0; m < NX; ++m)
#pragma unroll
      for (int u = 0; u < NU; ++u) w[u] = fmaf(R[Pl::OB + m * NU + u], v[m], w[u]);
#pragma unroll
    for (int i = 0; i < NX; ++i) apa[i] = 0.f;
    if (j < NX) {
#pragma unroll
      for (int m = 0; m < NX; ++m) {
        float arow[PX];
        load_row<PX>(arow, R + Pl::OA + m * PX);
#pragma unroll
        for (int i = 0; i < NX; ++i) apa[i] = fmaf(arow[i], v[m], apa[i]);
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) tm[Pl::TQUX + u * PX + j] = w[u];
    } else if (ju < NU) {
      const float rd = R[Pl::OR + ju] + reg;
#pragma unroll
      for (int u = 0; u < NU; ++u)
        if (u >= ju) tm[Pl::TQUU + u * NU + ju] = u == ju ? w[u] + rd : w[u];
    }
    __syncwarp();

    // Part 2: L = chol(Quu) in every thread, with the reciprocal pivots, so
    // that the chain holds one square root and one reciprocal a column;
    // column j of K = -Quu^{-1} Qux and of M = A'PA + Qux'K.
    float L[NTRU], inv[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int jj = 0; jj <= i; ++jj) {
        float s = tm[Pl::TQUU + i * NU + jj];
#pragma unroll
        for (int m = 0; m < jj; ++m) s -= L[tri(i, m)] * L[tri(jj, m)];
        L[tri(i, jj)] = (i == jj) ? sqrtf(s) : s * inv[jj];
      }
      inv[i] = __frcp_rn(L[tri(i, i)]);
    }
    float kc[NU], qk[NX];
#pragma unroll
    for (int u = 0; u < NU; ++u) kc[u] = w[u];
    chol_solve_inv<NU>(L, inv, kc);
#pragma unroll
    for (int u = 0; u < NU; ++u) kc[u] = -kc[u];
#pragma unroll
    for (int i = 0; i < NX; ++i) qk[i] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float qrow[PX];
      load_row<PX>(qrow, tm + Pl::TQUX + u * PX);
#pragma unroll
      for (int i = 0; i < NX; ++i) qk[i] = fmaf(qrow[i], kc[u], qk[i]);
    }
    float mj[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) mj[i] = apa[i] + qk[i];
    if (j < NX) {
#pragma unroll
      for (int i = 0; i < NX; ++i) tm[Pl::TM + i * PX + j] = mj[i];
#pragma unroll
      for (int u = 0; u < NU; ++u) O[Pl::EK + u * NX + j] = kc[u];
    }
#pragma unroll
    for (int t = 0; t < NTRU; ++t)
      if (t == j) O[Pl::EL + t] = L[t];
    __syncwarp();

    // Part 3: column j of P_k = (M + M')/2 + diag(Qd_k), row j of M being
    // the other threads' columns; to the carry and the output tile.
    if (j < NX) {
      float mrow[PX];
      load_row<PX>(mrow, tm + Pl::TM + j * PX);
      const float qd = R[Pl::OQ + j];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const float pk = i == j ? mj[i] + qd : 0.5f * (mj[i] + mrow[i]);
        if (i >= j) P[tri(i, j)] = pk;
        O[Pl::EP + i * NX + j] = pk;
      }
    }
    __syncwarp();
  };

  // A lane past B keeps this ring: zeros but Rd = 1, so its Quu is I.
  for (int i = tid; i < 2 * Pl::RING; i += Pl::THREADS) {
    const int e = i % Pl::SLOT;
    ring[i] = e >= Pl::OR && e < Pl::OR + NU ? 1.f : 0.f;
  }
  __syncthreads();
  if (team) {
    // P_N = diag(Qd_N), to the carry and to Ps row N.
    const int b = b0 + tl;
    if (j < NX) {
      const float q = b < B ? ld(a.Qd, N, j, NX, B, b) : 0.f;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        if (i >= j) P[tri(i, j)] = i == j ? q : 0.f;
        if (b < B) st(a.Ps, N, i * NX + j, NX * NX, B, b, i == j ? q : 0.f);
      }
    }
  } else {
    copy_chunk(0);
    cp_async_wait<0>();
  }
  __syncthreads();
  // The teams run chunk q while the producers copy chunk q + 1 in and write
  // chunk q - 1 out.
#pragma unroll 1
  for (int q = 0; q < nch; ++q) {
    if (team) {
      const int sc = hi(q) - lo(q);
      const float* R = ring + (q & 1) * Pl::RING + tl * Pl::SLOT;
      float* O = outb + (q & 1) * Pl::OUT + tl * Pl::OUTP;
#pragma unroll 1
      for (int p = 0; p < sc; ++p) stage(R + p * LANES * Pl::SLOT, O + p * LANES * Pl::OUTP);
    } else {
      if (q + 1 < nch) copy_chunk(q + 1);
      if (q >= 1) flush(q - 1);
      cp_async_wait<0>();
    }
    __syncthreads();
  }
  if (!team) flush(nch - 1);
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

// Shared-memory plan of solve_bwd_kernel, vec_sweep's ring as [S][E][TL]:
// A, B, K, qx and qu (copied by cp.async), w = P_{k+1} c_k and L (fan-out,
// so that the finish two chunks later reads L from the ring), qu_bar
// (chain).
template <int NX, int NU>
struct SolveBwdPlan {
  static constexpr int TL = kSweepLanes, NTRU = NU * (NU + 1) / 2;
  static constexpr int OA = 0, OB = NX * NX, OK = OB + NX * NU, OQX = OK + NU * NX,
                       OQU = OQX + NX, OW = OQU + NU, OL = OW + NX, OV = OL + NTRU, E = OV + NU;
  static constexpr int S_FIT = kSweepRingBytes / (2 * E * TL * 4);
  static constexpr int S = S_FIT < 8 ? S_FIT : 8;
  static_assert(S >= 1 && TL % 4 == 0 && TL <= 32, "ring too small for one stage");
  static constexpr int NF = S * TL, THREADS = 32 + NF;
  static constexpr int RING = S * E * TL, SMEM = 2 * RING * 4;
};

// Rows k0 .. k0 + sc - 1 (entries [0, E)) of a [rows, E, B] tensor into
// vec_sweep's ring slot r at entry OFF, [s][OFF + e][TL], by fan-out thread f
// of NF.  Each thread keeps one group of 4 lanes (16-byte copies, where the
// tensor starts 16-byte aligned and B % 4 == 0) or one lane (4-byte copies)
// and takes every EG-th entry, unrolled, so its copies issue back to back; a
// thread whose lanes lie past B has none.
template <class F, int E, int OFF>
__device__ __forceinline__ void copy_rows(float* r, const float* src, int k0, int sc, int b0,
                                          int B, int f) {
  constexpr int TL = F::TL;
  if (B % 4 == 0 && reinterpret_cast<size_t>(src) % 16 == 0) {
    constexpr int EG = F::NF / (TL / 4);
    const int q = f % (TL / 4), eg = f / (TL / 4), b = b0 + 4 * q;
    if (b >= B) return;
#pragma unroll 1
    for (int s = 0; s < sc; ++s) {
      const float* g = src + static_cast<size_t>(k0 + s) * E * B + b;
      float* d = r + (s * F::E + OFF) * TL + 4 * q;
#pragma unroll
      for (int t = 0; t < (E + EG - 1) / EG; ++t) {
        const int e = t * EG + eg;
        if (e < E) cp_async16(d + e * TL, g + static_cast<size_t>(e) * B);
      }
    }
  } else {
    constexpr int EG = F::NF / TL;
    const int l = f % TL, eg = f / TL, b = b0 + l;
    if (b >= B) return;
#pragma unroll 1
    for (int s = 0; s < sc; ++s) {
      const float* g = src + static_cast<size_t>(k0 + s) * E * B + b;
      float* d = r + (s * F::E + OFF) * TL + l;
#pragma unroll
      for (int t = 0; t < (E + EG - 1) / EG; ++t) {
        const int e = t * EG + eg;
        if (e < E) cp_async4(d + e * TL, g + static_cast<size_t>(e) * B);
      }
    }
  }
}

template <int NX, int NU>
__global__ void __launch_bounds__(SolveBwdPlan<NX, NU>::THREADS)
    solve_bwd_kernel(SolveBwdArgs a, int N, int B) {
  using F = SolveBwdPlan<NX, NU>;
  constexpr int NTRU = F::NTRU, TL = F::TL;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, b0 = blockIdx.x * TL;
  const int f = tid - 32, b = b0 + (tid < 32 ? tid : f % TL);
  const bool live = b < B && (tid >= 32 || tid < TL);

  auto copy = [&, a](float* r, int k0, int sc) {
    copy_rows<F, NX * NX, F::OA>(r, a.A, k0, sc, b0, B, f);
    copy_rows<F, NX * NU, F::OB>(r, a.Bm, k0, sc, b0, B, f);
    copy_rows<F, NU * NX, F::OK>(r, a.Ks, k0, sc, b0, B, f);
    copy_rows<F, NX, F::OQX>(r, a.qx, k0, sc, b0, B, f);
    copy_rows<F, NU, F::OQU>(r, a.qu, k0, sc, b0, B, f);
    cp_async_commit();
  };
  // w = P_{k+1} c_k from the lower triangle of P_{k+1}, and L_k, every load
  // first so that they are in flight together.
  auto prepare = [&, a](float* R, int k) {
    if (!live) return;
    float c[NX], P[NX * (NX + 1) / 2], L[NTRU];
#pragma unroll
    for (int i = 0; i < NX; ++i) c[i] = ld(a.c, k, i, NX, B, b);
#pragma unroll
    for (int t = 0; t < NTRU; ++t) L[t] = ld(a.Ls, k, t, NTRU, B, b);
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int m = 0; m <= i; ++m) P[tri(i, m)] = ld(a.Ps, k + 1, i * NX + m, NX * NX, B, b);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m) s += P[tri(i, m)] * c[m];
      R[(F::OW + i) * TL] = s;
    }
#pragma unroll
    for (int t = 0; t < NTRU; ++t) R[(F::OL + t) * TL] = L[t];
  };
  // A lane past B solves with L = I on qu_bar = 0.
  auto finish = [&, a](float* R, int k) {
    float L[NTRU], x[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j)
        L[tri(i, j)] = live ? R[(F::OL + tri(i, j)) * TL] : (i == j ? 1.f : 0.f);
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
  for (int i = 0; i < NX; ++i) p[i] = live && tid < 32 ? ld(a.qx, N, i, NX, B, b) : 0.f;
  auto step = [&](float* R) {
    float tmp[NX], qub[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) tmp[i] = p[i] + R[(F::OW + i) * TL];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m) s += R[(F::OB + m * NU + u) * TL] * tmp[m];
      qub[u] = R[(F::OQU + u) * TL] + s;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float s = 0.f, r = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m) s += R[(F::OA + m * NX + i) * TL] * tmp[m];
#pragma unroll
      for (int u = 0; u < NU; ++u) r += R[(F::OK + u * NX + i) * TL] * qub[u];
      p[i] = (R[(F::OQX + i) * TL] + s) + r;
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) R[(F::OV + u) * TL] = qub[u];
  };
  vec_sweep<F>(smem, N, copy, prepare, finish, step);
}

// --------------------------------------------------------------------------
// Solve, forward half: du = K dx + kff, dx' = A dx + B du + c, from dx0;
// writes dx_0..dx_N and du_0..du_{N-1}.
// --------------------------------------------------------------------------

struct SolveFwdArgs {
  const float *A, *Bm, *Ks, *kff, *c, *dx0;
  float *dxs, *dus;
};

// Shared-memory plan of solve_fwd_kernel: TL lanes a block, chunks of S
// stages.  The ring holds two chunks of A, B, K, kff and c as [S][E][TL]
// (copied by cp.async); the rollout writes dx (S + 1 rows, the first being
// the chunk's start) and du (S rows) of a chunk into one of two output
// slots, from which the fan-out threads store them.  A block takes 32
// lanes, so that each row it copies is one 128-byte line, where the ring
// still holds 6 stages of them ((7, 2)), else kSweepLanes ((11, 4)): on the
// card the wider block ran (7, 2) at B=2048 10% faster, and (11, 4), at 2
// stages a chunk, slower.
template <int NX, int NU>
struct SolveFwdPlan {
  static constexpr int OA = 0, OB = NX * NX, OK = OB + NX * NU, OKFF = OK + NU * NX,
                       OC = OKFF + NU, E = OC + NX;
  static constexpr int TL = kSweepRingBytes / (2 * E * 32 * 4) >= 6 ? 32 : kSweepLanes;
  static constexpr int S_FIT = kSweepRingBytes / (2 * E * TL * 4);
  static constexpr int S = S_FIT < 8 ? S_FIT : 8;
  static_assert(S >= 1 && TL % 4 == 0 && TL <= 32, "ring too small for one stage");
  static constexpr int NF = S * TL, THREADS = 32 + NF;  // warp 0 rolls out, NF fan out
  static constexpr int RING = S * E * TL, DX = (S + 1) * NX * TL, DU = S * NU * TL;
  static constexpr int SMEM = (2 * RING + 2 * (DX + DU)) * 4;
};

template <int NX, int NU>
__global__ void __launch_bounds__(SolveFwdPlan<NX, NU>::THREADS, 1)
    solve_fwd_kernel(SolveFwdArgs a, int N, int B) {
  using F = SolveFwdPlan<NX, NU>;
  constexpr int TL = F::TL, SC = F::S;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                // 2 x [SC][E][TL]
  float* dxb = smem + 2 * F::RING;   // 2 x [SC + 1][NX][TL]
  float* dub = dxb + 2 * F::DX;      // 2 x [SC][NU][TL]
  const int tid = threadIdx.x, b0 = blockIdx.x * TL, nch = (N + SC - 1) / SC;
  const bool roller = tid < 32;
  const int f = tid - 32, fl = roller ? tid : f % TL, fs = roller ? 0 : f / TL;
  const int b = b0 + fl;
  const bool live = b < B && (!roller || tid < TL);

  // The roller's carry.
  float dx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) dx[i] = live && roller ? ld(a.dx0, 0, i, NX, B, b) : 0.f;

  // Fan-out threads copy chunk q's operands into ring slot q & 1.
  auto copy_chunk = [&, a](int q) {
    float* r = ring + (q & 1) * F::RING;
    const int k0 = q * SC, sc = min(SC, N - k0);
    copy_rows<F, NX * NX, F::OA>(r, a.A, k0, sc, b0, B, f);
    copy_rows<F, NX * NU, F::OB>(r, a.Bm, k0, sc, b0, B, f);
    copy_rows<F, NU * NX, F::OK>(r, a.Ks, k0, sc, b0, B, f);
    copy_rows<F, NU, F::OKFF>(r, a.kff, k0, sc, b0, B, f);
    copy_rows<F, NX, F::OC>(r, a.c, k0, sc, b0, B, f);
    cp_async_commit();
  };

  // Warp 0, one thread per lane: roll chunk q out into output slot q & 1,
  // in the plain version's term order (du first, then A dx + B du, then c).
  // A stage stores only at its end, so none of its ring loads waits behind
  // a store it might alias: they issue together.
  auto rollout = [&](int q) {
    const float* r = ring + (q & 1) * F::RING + tid;
    float* X = dxb + (q & 1) * F::DX + tid;
    float* U = dub + (q & 1) * F::DU + tid;
    const int sc = min(SC, N - q * SC);
#pragma unroll
    for (int i = 0; i < NX; ++i) X[i * TL] = dx[i];
#pragma unroll 1
    for (int s = 0; s < sc; ++s) {
      const float* R = r + s * F::E * TL;
      float du[NU], dxn[NX];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        float t = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m) t += R[(F::OK + u * NX + m) * TL] * dx[m];
        du[u] = t + R[(F::OKFF + u) * TL];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float t = 0.f, v = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m) t += R[(F::OA + i * NX + m) * TL] * dx[m];
#pragma unroll
        for (int u = 0; u < NU; ++u) v += R[(F::OB + i * NU + u) * TL] * du[u];
        dxn[i] = (t + v) + R[(F::OC + i) * TL];
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) U[(s * NU + u) * TL] = du[u];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        dx[i] = dxn[i];
        X[((s + 1) * NX + i) * TL] = dxn[i];
      }
    }
  };

  // Fan-out thread (fs, fl): store stage q SC + fs of chunk q (and dx_N
  // after the last stage) from output slot q & 1.
  auto store = [&, a](int q) {
    const int k = q * SC + fs;
    if (!live || k >= N) return;
    const float* X = dxb + (q & 1) * F::DX + fl;
    const float* U = dub + (q & 1) * F::DU + fl;
#pragma unroll
    for (int i = 0; i < NX; ++i) st(a.dxs, k, i, NX, B, b, X[(fs * NX + i) * TL]);
#pragma unroll
    for (int u = 0; u < NU; ++u) st(a.dus, k, u, NU, B, b, U[(fs * NU + u) * TL]);
    if (k == N - 1) {
#pragma unroll
      for (int i = 0; i < NX; ++i) st(a.dxs, N, i, NX, B, b, X[((fs + 1) * NX + i) * TL]);
    }
  };

  // Chunk q rolls out while chunk q - 1 is stored and chunk q + 1 arrives;
  // chunk q + 2 is copied into q's ring slot once q has rolled out.  Lanes
  // at or past B roll out on whatever their ring entries hold and store
  // nothing.
  if (!roller) {
    copy_chunk(0);
    if (nch > 1) {
      copy_chunk(1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int q = 0; q < nch; ++q) {
    if (roller) {
      if (tid < TL) rollout(q);
    } else {
      if (q >= 1) store(q - 1);
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!roller && q + 2 < nch) copy_chunk(q + 2);
  }
  if (!roller) store(nch - 1);
}

// --------------------------------------------------------------------------
// Launchers: pointers arrive as an array, inputs then outputs, in the order
// of the argument structs above (ops/riccati_fused.py builds it).
// --------------------------------------------------------------------------

template <int NX, int NU>
int launch_factor(void* const* p, int n, int N, int B, float reg, cudaStream_t stream) {
  if (int e = bad_args(n, 7, N, B)) return e;
  FactorArgs a{static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
               static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
               static_cast<float*>(p[4]), static_cast<float*>(p[5]),
               static_cast<float*>(p[6])};
  using Pl = FactorPlan<NX, NU>;
  static const int attr = smem_attr(factor_kernel<NX, NU>, Pl::SMEM);
  if (attr != 0) return attr;
  factor_kernel<NX, NU><<<(B + Pl::LANES - 1) / Pl::LANES, Pl::THREADS, Pl::SMEM, stream>>>(
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
  using F = SolveBwdPlan<NX, NU>;
  static const int attr = smem_attr(solve_bwd_kernel<NX, NU>, F::SMEM);
  if (attr != 0) return attr;
  solve_bwd_kernel<NX, NU><<<(B + F::TL - 1) / F::TL, F::THREADS, F::SMEM, stream>>>(a, N, B);
  return static_cast<int>(cudaGetLastError());
}

template <int NX, int NU>
int launch_solve_fwd(void* const* p, int n, int N, int B, cudaStream_t stream) {
  if (int e = bad_args(n, 8, N, B)) return e;
  SolveFwdArgs a{static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
                 static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
                 static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
                 static_cast<float*>(p[6]), static_cast<float*>(p[7])};
  using F = SolveFwdPlan<NX, NU>;
  static const int attr = smem_attr(solve_fwd_kernel<NX, NU>, F::SMEM);
  if (attr != 0) return attr;
  solve_fwd_kernel<NX, NU><<<(B + F::TL - 1) / F::TL, F::THREADS, F::SMEM, stream>>>(a, N, B);
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
