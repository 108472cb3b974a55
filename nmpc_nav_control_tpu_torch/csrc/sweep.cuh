// Device helpers that the kernels of ipm_fused.cu and riccati_fused.cu share:
// batch-minor loads and stores, asynchronous copies, the small Cholesky
// solve, and the chunked backward vector sweep (vec_sweep) with its copy
// loop.  Per-stage operands are batch-minor [rows, E, B], entry e of row k
// of lane b at ((k*E)+e)*B + b.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// The chunked sweeps (fwd_kernel, vec_sweep): lanes per block, and the
// shared memory their two-chunk ring may take.
constexpr int kSweepLanes = 16;
constexpr int kSweepRingBytes = 160 * 1024;

// Lane b of entry e at row k of a [rows, E, B] tensor.  Inputs are
// read-only for the kernel's lifetime, so the load goes through the
// non-coherent path and the compiler may move it ahead of earlier stores.
__device__ __forceinline__ float ld(const float* p, int k, int e, int E, int B, int b) {
  return __ldg(p + (static_cast<size_t>(k) * E + e) * B + b);
}

__device__ __forceinline__ void st(float* p, int k, int e, int E, int B, int b, float v) {
  p[(static_cast<size_t>(k) * E + e) * B + b] = v;
}

// n rounded up to 16 (mod 32) floats: two slots of that pitch, each read at
// one address by a team, hit distinct banks.
__host__ __device__ constexpr int pad16(int n) { return n + ((16 - n % 32) % 32 + 32) % 32; }

// Row of PX floats (PX % 4 == 0) from 16-byte aligned shared memory.
template <int PX>
__device__ __forceinline__ void load_row(float (&row)[PX], const float* p) {
#pragma unroll
  for (int m = 0; m < PX; m += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + m);
    row[m] = q.x, row[m + 1] = q.y, row[m + 2] = q.z, row[m + 3] = q.w;
  }
}

// Asynchronous copies global -> shared (sm_80 and later): they hold no
// register; a thread's copies of one commit group are complete, for that
// thread, after cp_async_wait<n> leaves at most n newer groups pending.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// 16 bytes: src and dst 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Index of (i, j) in a lower triangle stored row-major.
__host__ __device__ constexpr int tri(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
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

// x <- (L L')^{-1} x with inv[i] = 1 / L_ii: the two substitutions multiply
// by the reciprocal pivots, computed once per stage.
template <int NU>
__device__ __forceinline__ void chol_solve_inv(const float (&L)[NU * (NU + 1) / 2],
                                               const float (&inv)[NU], float (&x)[NU]) {
  float y[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    float s = x[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[tri(i, k)] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < NU; ++k) s -= L[tri(k, i)] * x[k];
    x[i] = s * inv[i];
  }
}

// Copy rows k0 .. k0 + sc - 1 (entries [0, E)) of a [rows, E, B] tensor into
// the ring slot at entry off: [s][off + e][l] for lanes b0 + l.  16-byte
// copies where the tensor starts 16-byte aligned and B % 4 == 0 (then every
// row start is), else 4.
template <class F, int E>
__device__ __forceinline__ void copy_chunk_rows(float* ring, int off, const float* src, int k0,
                                                int sc, int b0, int B, int t, int nt) {
  constexpr int TL = F::TL;
  if (B % 4 == 0 && reinterpret_cast<size_t>(src) % 16 == 0) {
    constexpr int Q = TL / 4;
#pragma unroll 1
    for (int i = t; i < sc * E * Q; i += nt) {
      const int q = i % Q, r = i / Q, e = r % E, s = r / E, bb = b0 + 4 * q;
      if (bb < B)
        cp_async16(ring + (s * F::E + off + e) * TL + 4 * q,
                   src + (static_cast<size_t>(k0 + s) * E + e) * B + bb);
    }
  } else {
#pragma unroll 1
    for (int i = t; i < sc * E * TL; i += nt) {
      const int l = i % TL, r = i / TL, e = r % E, s = r / E, bb = b0 + l;
      if (bb < B)
        cp_async4(ring + (s * F::E + off + e) * TL + l,
                  src + (static_cast<size_t>(k0 + s) * E + e) * B + bb);
    }
  }
}

// The skeleton of the backward vector sweeps: bwd_corr_kernel and kkt_kernel
// (ipm_fused.cu), solve_bwd_kernel (riccati_fused.cu).  Chunk q holds stages
// [lo(q), hi(q)), hi(q) = N - q S; the chain walks it from its last stage
// down, carrying its vector in registers, while the fan-out threads copy and
// prepare chunk q + 1 into the other ring slot and finish chunk q - 1 from
// it (the copies write no entry that finish reads, which are the chain's
// result and what the same thread's prepare wrote, and prepare comes after
// finish, so the two share the slot).  Lanes at or past B take part in
// every step on the ring's initial zeros and store nothing.
//   copy(r, k0, sc):      issue the chunk's cp.async copies into slot r;
//   prepare(R, k):        fan-out, stage k's carry-free entries into R;
//   finish(R, k):         fan-out, stage k's work on the chain's result
//                         (kkt has none: its chain takes max |ru| itself);
//   step(R):              chain, one stage from its slot entry R.
template <class F, class Copy, class Prepare, class Finish, class Step>
__device__ __forceinline__ void vec_sweep(float* smem, int N, Copy copy, Prepare prepare,
                                          Finish finish, Step step) {
  constexpr int TL = F::TL, SC = F::S;
  const int tid = threadIdx.x, nch = (N + SC - 1) / SC;
  const bool chain = tid < 32;
  const int f = tid - 32, fl = f % TL, fs = f / TL;
  auto lo = [&](int q) { return max(0, N - (q + 1) * SC); };
  auto hi = [&](int q) { return N - q * SC; };
  auto slot = [&](int q) { return smem + (q & 1) * F::RING; };
  auto item = [&](int q) { return slot(q) + fs * F::E * TL + fl; };

  for (int i = tid; i < 2 * F::RING; i += F::THREADS) smem[i] = 0.f;
  __syncthreads();
  if (!chain) {
    copy(slot(0), lo(0), hi(0) - lo(0));
    if (fs < hi(0) - lo(0)) prepare(item(0), lo(0) + fs);
    cp_async_wait<0>();
  }
  __syncthreads();
#pragma unroll 1
  for (int q = 0; q < nch; ++q) {
    if (chain) {
      if (tid < TL) {
        float* r = slot(q) + tid;
#pragma unroll 1
        for (int s = hi(q) - lo(q) - 1; s >= 0; --s) step(r + s * F::E * TL);
      }
    } else {
      if (q + 1 < nch) copy(slot(q + 1), lo(q + 1), hi(q + 1) - lo(q + 1));
      if (q >= 1 && fs < hi(q - 1) - lo(q - 1)) finish(item(q - 1), lo(q - 1) + fs);
      if (q + 1 < nch && fs < hi(q + 1) - lo(q + 1)) prepare(item(q + 1), lo(q + 1) + fs);
      cp_async_wait<0>();
    }
    __syncthreads();
  }
  if (!chain && fs < hi(nch - 1) - lo(nch - 1)) finish(item(nch - 1), lo(nch - 1) + fs);
}

// Allow a kernel the dynamic shared memory it launches with (above 48 KB this
// is required); the launcher returns a failure like a launch error.
template <class Kernel>
int smem_attr(Kernel* kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

inline int bad_args(int n, int want, int N, int B) {
  return (n != want || N <= 0 || B <= 0) ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

}  // namespace
