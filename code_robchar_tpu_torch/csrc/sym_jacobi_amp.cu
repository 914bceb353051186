// Batched real symmetric Jacobi transfer amplitude, one thread per matrix,
// for NVIDIA Hopper (sm_90a).
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
// fixed-ensemble objectives go through it.
//
// What bounds it on the H100: per-thread ALU work and registers, not HBM.
// Each element reads n(n+1)/2 floats and writes two, then runs
// ~sweeps * n(n-1)/2 dependent pivots of ~6n flops plus two sqrts and two
// divisions each.  The working set — the lower triangle and diagonal of A
// plus two rows of V, n(n+1)/2 + 2n floats (42 at n = 7, 75 at n = 10) —
// stays in registers, with compile-time indices from the template N and the
// compile-time schedule.  Many independent threads per SM hide the latency
// of the dependent chain.
//
// Layout: the JAX lanes layout, a (n*n, B) with the batch fastest (only the
// lower triangle and the diagonal are read), t (B,), amp (2, B): row 0 phr,
// row 1 phi.  128 threads per block, ceil(B/128) blocks, masked tail.
// Precision: IEEE sqrtf and division, sinf/cosf with full range reduction;
// build without --use_fast_math.

#include <cuda_runtime.h>

#include <cstdint>

#include "jacobi_common.cuh"

namespace {

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
  amp[b] = phr;
  amp[B + b] = phi;
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
