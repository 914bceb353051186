// Batched exact infidelity and gradient of the real symmetric transfer
// objective, one thread per controller, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel code_robchar_tpu/ops/pallas_jacobi.py
// make_sym_grad_kernel (wrapper infidelity_and_gradient_sym_pallas): for
// every controller x_b = (biases x[0..n-1], time x[n]) of the batch, with
// A = h0 + diag(x[:n]) = V diag(lam) V^T and T = |x[n]|,
//
//     phi      = sum_k V[out,k] V[in,k] e^{-i T lam_k}
//     err[b]   = 1 - |phi|^2
//     grad[b,l] = -2 Re(dphi_l conj(phi)),  l < n   (Daleckii-Krein)
//     grad[b,n] = -2 Im((H U)[out,in] conj(phi))
//
// with dphi_l = sum_{j,k} V[out,j] V[l,j] Gamma_jk V[l,k] V[in,k] and the
// split Daleckii-Krein matrix in its cancellation-free sinc form
// Gamma_jk = -i T e^{-i T (lam_j + lam_k)/2} sinc(T (lam_j - lam_k)/2)
// (code_robchar_tpu/ops/realform.py _gamma_parts; series below |x| < 1e-3),
// accurate at every eigenvalue gap including the ring's exact degeneracies.
// The plain torch version is
// code_robchar_tpu_torch/ops/realform.py infidelity_and_gradient_sym_lanes
// (order="roundrobin").  This is the L-BFGS line search's objective: every
// trial of every noiseless restart goes through it.
//
// What bounds it on the H100: per-thread ALU work and registers.  The
// matrix is built in registers from h0 and x (the JAX wrapper builds the
// (n, n, B) batch in XLA first; this computes the same thing without it),
// and Jacobi carries all of V plus its in and out rows once more:
// n(n+1)/2 + n^2 + 2n floats (91 at n = 7, 175 at n = 10).  The Pallas kernel caches all n^2 Gamma entries (2n^2 live
// values) before the contraction; that would spill here, so the
// contraction loops over the pairs j <= k instead, computes each Gamma
// once (it is symmetric: sinc is even), and accumulates
//     dphi_l += V[l,j] V[l,k] (V[out,j] V[in,k] + V[out,k] V[in,j]) Gamma_jk
// (one term for j == k) into 2n accumulators.  The contraction stays in
// full float32.
//
// Layout: h0 (n, n) row-major, xs (B, n+1) row-major, err (B,), grad
// (B, n+1) row-major — the layouts of the wrapper's inputs and outputs, so
// nothing is transposed around the launch.  128 threads per block,
// ceil(B/128) blocks, masked tail.  Precision: IEEE sqrtf and division,
// sinf/cosf with full range reduction (T lam reaches a few hundred
// radians); build without --use_fast_math.

#include <cuda_runtime.h>

#include <cstdint>

#include "jacobi_common.cuh"

namespace {

using jacobi::kThreads;

template <int N>
__global__ void __launch_bounds__(kThreads)
sym_jacobi_grad_kernel(const float* __restrict__ h0,
                       const float* __restrict__ xs,
                       float* __restrict__ err, float* __restrict__ grad,
                       int in_spin, int out_spin, int sweeps, float eps,
                       int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  const float* x = xs + b * (N + 1);

  // carried rows 0..N-1 are V itself; rows N and N+1 are V's rows in and
  // out, carried a second time: selecting them from the first N rows with
  // the runtime spins would index registers at run time, which moves the
  // whole state to local memory
  jacobi::SymState<N, N + 2> st;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    st.d[i] = h0[i * N + i] + x[i];
#pragma unroll
    for (int j = 0; j < i; ++j) st.l[jacobi::tri(i, j)] = h0[i * N + j];
#pragma unroll
    for (int k = 0; k < N; ++k) st.v[i][k] = (i == k) ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    st.v[N][k] = (k == in_spin) ? 1.0f : 0.0f;
    st.v[N + 1][k] = (k == out_spin) ? 1.0f : 0.0f;
  }
  const float tb = fabsf(x[N]);

  jacobi::jacobi_sweeps<N>(st, sweeps, eps);

  float(&vin)[N] = st.v[N];            // V[in, :]
  float(&vout)[N] = st.v[N + 1];       // V[out, :]

  float phr = 0.0f, phi = 0.0f, hur = 0.0f, hui = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float w = vout[k] * vin[k];
    const float ang = st.d[k] * tb;
    const float fr = cosf(ang);
    const float fi = -sinf(ang);
    phr = phr + w * fr;
    phi = phi + w * fi;
    hur = hur + st.d[k] * w * fr;
    hui = hui + st.d[k] * w * fi;
  }
  err[b] = 1.0f - (phr * phr + phi * phi);

  float dphr[N], dphi[N];
#pragma unroll
  for (int l = 0; l < N; ++l) {
    dphr[l] = 0.0f;
    dphi[l] = 0.0f;
  }
  // pairs j <= k; both loops keep a constant trip count, so that they
  // unroll fully and every register index is a compile-time constant
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k < j) continue;
      const float xh = 0.5f * (st.d[j] - st.d[k]) * tb;
      const bool small = fabsf(xh) < 1e-3f;
      const float xsafe = small ? 1.0f : xh;
      const float sc = small ? 1.0f - xh * xh * (1.0f / 6.0f)
                             : sinf(xsafe) / xsafe;
      const float mang = 0.5f * (st.d[j] + st.d[k]) * tb;
      const float gr = -tb * sc * sinf(mang);
      const float gi = -tb * sc * cosf(mang);
      const float coef = (j == k) ? vout[j] * vin[j]
                                  : vout[j] * vin[k] + vout[k] * vin[j];
      const float cr = coef * gr;
      const float ci = coef * gi;
#pragma unroll
      for (int l = 0; l < N; ++l) {
        const float p = st.v[l][j] * st.v[l][k];
        dphr[l] = dphr[l] + p * cr;
        dphi[l] = dphi[l] + p * ci;
      }
    }
  }

  float* g = grad + b * (N + 1);
#pragma unroll
  for (int l = 0; l < N; ++l) g[l] = -2.0f * (dphr[l] * phr + dphi[l] * phi);
  g[N] = -2.0f * (hui * phr - hur * phi);
}

template <int N>
cudaError_t launch(const float* h0, const float* xs, float* err, float* grad,
                   int in_spin, int out_spin, int sweeps, float eps,
                   int64_t B, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  sym_jacobi_grad_kernel<N><<<blocks, kThreads, 0, stream>>>(
      h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes.  h0: (n, n) float32, xs: (B, n+1), err: (B,)
// and grad: (B, n+1) outputs, all on `device`; launches on `stream` and does
// not synchronise.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for n outside 2..10).
extern "C" int sym_jacobi_grad(const float* h0, const float* xs, float* err,
                               float* grad, int n, int in_spin, int out_spin,
                               int sweeps, float eps, long long B, int device,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 2: return launch<2>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    case 3: return launch<3>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    case 4: return launch<4>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    case 5: return launch<5>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    case 6: return launch<6>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    case 7: return launch<7>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    case 8: return launch<8>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    case 9: return launch<9>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    case 10: return launch<10>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
