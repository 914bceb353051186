// Batched real symmetric Jacobi transfer amplitude for NVIDIA Hopper
// (sm_90a), in two hand-written routes: a group of lanes per matrix for the
// batches the optimizer zoo launches, one thread per matrix for batches
// that fill the card.
//
// Replaces the TPU kernel code_robchar_tpu/ops/pallas_jacobi.py
// make_sym_amp_kernel (bodies sym_sweeps_on_scratch, _sym_apply and
// transfer_amp_from_scratch; wrappers transfer_amp_sym_pallas,
// fidelity_sym_pallas): for every element b of the batch,
//
//     amp[b] = <out| exp(-i t[b] A_b) |in> = sum_k V[out,k] V[in,k]
//              e^{-i t[b] lam_k} = phr + i phi
//
// where A_b (real symmetric, n x n) = V diag(lam) V^T is diagonalised by
// `sweeps` round-robin Jacobi sweeps with the symmetric update
// (jacobi_common.cuh SymState) carrying only the in and out rows of V.  The
// arithmetic per pivot is that of the Pallas body and of the plain torch
// version (code_robchar_tpu_torch/ops/realform.py transfer_amp_sym_lanes,
// order="roundrobin").  This is the optimizer zoo's objective: every
// Nelder-Mead round, the L-BFGS re-evaluation and the noisy and
// fixed-ensemble objectives go through it, and PPO's true fidelities.
//
// What bounds it on the H100 is never HBM (an element reads n(n+1)/2
// floats and writes two) but which of two things the batch leaves short.
// A Nelder-Mead round is 9216 matrices: one thread each is 72 blocks of
// 128 on 72 of 132 SMs with one warp per scheduler, so nothing hides the
// dependent chain of sweeps * n(n-1)/2 pivots (each an IEEE division, two
// sqrtf and two more divisions before its first multiply) and the launch
// takes as long as one thread does.  A batch of 131072 fills every
// scheduler and is bound by the instructions issued.
//
// Small batches, sym_jacobi_amp_group: a group of lanes per matrix
// (jacobi_common.cuh group_sweeps; 4 lanes, 2 at n = 3, 4).  The lanes
// compute a stage's angles side by side, by the written-out fast paths of
// division and sqrtf, and exchange them with shuffles; every lane applies
// the stage's rotations to its own copy of the packed A; lane 0 carries
// the in row of V and lane 1 the out row.  The chain is sweeps * (M - 1)
// stages; 32-thread blocks put 9216 matrices on every SM at about nine
// warps each.  The n phase factors are dealt over the lanes (lane k takes
// the eigenvalues k, k + L, ...) and phr, phi are summed across the group
// in lane order.  Every lane loads every entry of its matrix itself: the
// lanes of a group read one address, which the load unit serves as one
// request, so a warp's load of one entry still touches one sector of 8
// neighbouring matrices and nothing has to be exchanged.
//
// Large batches, sym_jacobi_amp: one thread per matrix, the working set
// n(n+1)/2 + 2n floats (42 at n = 7, 75 at n = 10) in registers.  Summed
// over its group a matrix costs the group route about twice the
// instructions (A is updated once per lane), so a full card is faster this
// way.
// ops/cuda_jacobi.py picks the route from (n, B).
//
// Layout: the JAX lanes layout, a (n*n, B) with the batch fastest (only the
// lower triangle and the diagonal are read), t (B,), amp (2, B): row 0 phr,
// row 1 phi.  Masked tail, any B.  Precision: the one-thread kernel takes
// its angles by IEEE division and sqrtf, the lane-group kernel by
// sym_angles_fast (jacobi_common.cuh: the same fast paths written out, held
// bit-equal to `/` and sqrtf on the card, exact fallback outside their
// ranges); sinf/cosf with full range reduction; build without
// --use_fast_math.

#include <cuda_runtime.h>

#include <cstdint>

#include "jacobi_common.cuh"

namespace {

using jacobi::kGroupThreads;
using jacobi::kThreads;

template <int N>
__global__ void __launch_bounds__(kThreads)
sym_jacobi_amp_kernel(const float* __restrict__ a,
                      const float* __restrict__ t, float* __restrict__ amp,
                      int in_spin, int out_spin, int sweeps, float eps,
                      int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;

  jacobi::SymState<N, 2> st;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    st.d[i] = a[static_cast<int64_t>(i * N + i) * B + b];
#pragma unroll
    for (int j = 0; j < i; ++j) {
      st.l[jacobi::tri(i, j)] = a[static_cast<int64_t>(i * N + j) * B + b];
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    st.v[0][k] = (k == in_spin) ? 1.0f : 0.0f;
    st.v[1][k] = (k == out_spin) ? 1.0f : 0.0f;
  }

  // @phase(st) load
  jacobi::jacobi_sweeps<N>(st, sweeps, eps);

  const float tb = t[b];
  float phr = 0.0f;
  float phi = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float w = st.v[0][k] * st.v[1][k];
    const float ang = st.d[k] * tb;
    phr = phr + w * cosf(ang);
    phi = phi - w * sinf(ang);
  }
  // @phase(st) amplitude epilogue
  amp[b] = phr;
  amp[B + b] = phi;
  // @phase(st) store
}

// A group of L lanes per matrix.  Lane 0 carries V[in, :], lane 1
// V[out, :]; the other lanes carry a copy of lane 1's row that nothing
// reads.
template <int N>
__global__ void __launch_bounds__(kGroupThreads)
sym_jacobi_amp_group_kernel(const float* __restrict__ a,
                            const float* __restrict__ t,
                            float* __restrict__ amp, int in_spin,
                            int out_spin, int sweeps, float eps, int64_t B) {
  constexpr int L = jacobi::group_lanes<N>();
  using Lanes = jacobi::GroupLanes<N, L>;
  constexpr int kMine = (N + L - 1) / L;   // phase factors of one lane
  const Lanes lanes(B);
  const int64_t b = lanes.b;

  jacobi::SymState<N, 1> st;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    st.d[i] = a[static_cast<int64_t>(i * N + i) * B + b];
#pragma unroll
    for (int j = 0; j < i; ++j) {
      st.l[jacobi::tri(i, j)] = a[static_cast<int64_t>(i * N + j) * B + b];
    }
  }
  const int spin = lanes.k == 0 ? in_spin : out_spin;
#pragma unroll
  for (int k = 0; k < N; ++k) st.v[0][k] = (k == spin) ? 1.0f : 0.0f;
  const float tb = t[b];
  // @phase(st) load

  jacobi::group_sweeps<N, L>(st, sweeps, eps, lanes);

  // w[k] = V[in,k] V[out,k] in every lane; then lane k's own eigenvalues
  // k, k + L, ... picked by selects (zero weight past the end)
  float w[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    w[k] = jacobi::group_get(st.v[0][k], lanes.base, 0) *
           jacobi::group_get(st.v[0][k], lanes.base, 1);
  }
  float phr = 0.0f;
  float phi = 0.0f;
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    float wk = 0.0f;
    float lam = 0.0f;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (i * L + j < N && lanes.k == j) {
        wk = w[i * L + j < N ? i * L + j : 0];
        lam = st.d[i * L + j < N ? i * L + j : 0];
      }
    }
    const float ang = lam * tb;
    phr = phr + wk * cosf(ang);
    phi = phi - wk * sinf(ang);
  }
  phr = jacobi::group_sum<L>(phr, lanes.base);
  phi = jacobi::group_sum<L>(phi, lanes.base);
  // @phase(st) amplitude epilogue
  if (lanes.owns && lanes.k == 0) {
    amp[b] = phr;
    amp[B + b] = phi;
  }
  // @phase(st) store
}

template <int N>
cudaError_t launch_group(const float* a, const float* t, float* amp,
                         int in_spin, int out_spin, int sweeps, float eps,
                         int64_t B, cudaStream_t stream) {
  using Lanes = jacobi::GroupLanes<N, jacobi::group_lanes<N>()>;
  sym_jacobi_amp_group_kernel<N><<<Lanes::blocks(B), kGroupThreads, 0,
                                   stream>>>(
      a, t, amp, in_spin, out_spin, sweeps, eps, B);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch(const float* a, const float* t, float* amp, int in_spin,
                   int out_spin, int sweeps, float eps, int64_t B,
                   cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  sym_jacobi_amp_kernel<N><<<blocks, kThreads, 0, stream>>>(
      a, t, amp, in_spin, out_spin, sweeps, eps, B);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes.  a: (n*n, B) float32, t: (B,), amp: (2, B)
// output, all on `device`; launches on `stream` and does not synchronise.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for n
// outside 2..10).
extern "C" int sym_jacobi_amp(const float* a, const float* t, float* amp,
                              int n, int in_spin, int out_spin, int sweeps,
                              float eps, long long B, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 2: return launch<2>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    case 3: return launch<3>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    case 4: return launch<4>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    case 5: return launch<5>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    case 6: return launch<6>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    case 7: return launch<7>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    case 8: return launch<8>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    case 9: return launch<9>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    case 10: return launch<10>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The lane-group route: the same arguments, layouts and return value, for
// n in 3..10.  n = 2 has one pivot a stage, so its group would be one lane:
// that size keeps the one-thread kernel above (cudaErrorInvalidValue here).
extern "C" int sym_jacobi_amp_group(const float* a, const float* t,
                                    float* amp, int n, int in_spin,
                                    int out_spin, int sweeps, float eps,
                                    long long B, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 3: return launch_group<3>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    case 4: return launch_group<4>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    case 5: return launch_group<5>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    case 6: return launch_group<6>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    case 7: return launch_group<7>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    case 8: return launch_group<8>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    case 9: return launch_group<9>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    case 10: return launch_group<10>(a, t, amp, in_spin, out_spin, sweeps, eps, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
