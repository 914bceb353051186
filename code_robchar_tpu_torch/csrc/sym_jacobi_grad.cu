// Batched exact infidelity and gradient of the real symmetric transfer
// objective for NVIDIA Hopper (sm_90a), in two hand-written routes: a group
// of lanes per controller for the batches the optimizer zoo launches, one
// thread per controller for batches that fill the card.
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
// The matrix is built in registers from h0 and x (the JAX wrapper builds
// the (n, n, B) batch in XLA first), so HBM sees n + 1 floats in and n + 2
// out per controller and never bounds the kernel.  Gamma is symmetric
// (sinc is even), so the contraction runs over the n(n+1)/2 pairs j <= k,
//     dphi_l += V[l,j] V[l,k] (V[out,j] V[in,k] + V[out,k] V[in,j]) Gamma_jk
// (one term for j == k), each Gamma computed once from three range-reduced
// sinf/cosf, in full float32.
//
// What bounds it on the H100 depends on the batch.  The L-BFGS lanes give
// B = 1024: one thread each is 8 blocks of 128 on 8 of 132 SMs, one warp
// per scheduler, and the launch lasts as long as one thread's chain of
// sweeps * n(n-1)/2 pivots (each an IEEE division, two sqrtf, two more
// divisions, then the rotation of A and of n + 2 rows of V) followed by 28
// Gammas and their sums at n = 7.  A batch of 131072 fills the card and is
// bound by the instructions issued.
//
// Small batches, sym_jacobi_grad_group: a group of lanes per controller
// (jacobi_common.cuh group_sweeps; 4 lanes, 2 at n = 3, 4 and 3 at
// n = 5, 6: 8 controllers a warp at n = 7, 32-thread blocks, 1024
// controllers on 128 SMs).  The lanes compute a stage's angles side by
// side, by the written-out fast paths of division and sqrtf; every lane
// applies the stage's rotations to its own copy of the packed A; the n
// rows of V are dealt over the lanes (lane k carries rows k, k + L, ...:
// two rows at n = 7, where the one-thread kernel rotates nine).  V's in
// and out rows are not carried a second time: the group reads them by
// shuffle from the lane that holds them.  The pairs j <= k are dealt over
// the lanes too (lane k takes the pairs k, k + L, ... of the row-major
// list: 7 of 28 at n = 7), each lane computes coef_jk Gamma_jk of its
// pairs, the group gathers all of them by shuffle from compile-time lanes
// and registers, and each lane sums dphi_l of its own rows in the list's
// order, the order of the one-thread kernel.  The n phase factors of phi
// and (H U)[out,in] are dealt likewise and summed across the group in lane
// order.  Lane k stores grad[b, l] of its rows; lane 0 stores err and
// grad[b, n].  Every lane loads x_b and h0 itself (one address per group;
// the load unit serves it once).
//
// Large batches, sym_jacobi_grad: one thread per controller.  Jacobi
// carries all of V plus its in and out rows once more, n(n+1)/2 + n^2 + 2n
// floats (91 at n = 7, 175 at n = 10), the contraction loops over the pairs
// with 2n accumulators.  Summed over its group a controller costs the
// group route about twice the instructions of the sweeps, so a full card
// is faster this way.  ops/cuda_jacobi.py picks the route from (n, B).
//
// Layout: h0 (n, n) row-major, xs (B, n+1) row-major, err (B,), grad
// (B, n+1) row-major — the layouts of the wrapper's inputs and outputs, so
// nothing is transposed around the launch.  Masked tail, any B.
// Precision: the one-thread kernel takes its angles by IEEE division and
// sqrtf, the lane-group kernel by sym_angles_fast (jacobi_common.cuh: the
// same fast paths written out, held bit-equal to `/` and sqrtf on the card,
// exact fallback outside their ranges); sinf/cosf with full range reduction
// (T lam reaches a few hundred radians); build without --use_fast_math.

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "jacobi_common.cuh"

namespace {

using jacobi::kGroupThreads;
using jacobi::kThreads;

// coef * Gamma_jk = coef * (gr + i gi) for the eigenvalues lj, lk and the
// time tb: the split Daleckii-Krein entry in its sinc form
__device__ __forceinline__ void gamma_term(float lj, float lk, float tb,
                                           float coef, float& cr, float& ci) {
  const float xh = 0.5f * (lj - lk) * tb;
  const bool small = fabsf(xh) < 1e-3f;
  const float xsafe = small ? 1.0f : xh;
  const float sc = small ? 1.0f - xh * xh * (1.0f / 6.0f)
                         : sinf(xsafe) / xsafe;
  const float mang = 0.5f * (lj + lk) * tb;
  const float gr = -tb * sc * sinf(mang);
  const float gi = -tb * sc * cosf(mang);
  cr = coef * gr;
  ci = coef * gi;
}

// the pair (j, k), j <= k, at place q of the row-major list of pairs
template <int N>
struct Pairs {
  static constexpr int kCount = N * (N + 1) / 2;
  __host__ __device__ static constexpr int first(int q) {
    int j = 0;
    while (q >= N - j) {
      q -= N - j;
      ++j;
    }
    return j;
  }
  __host__ __device__ static constexpr int second(int q) {
    int j = 0;
    while (q >= N - j) {
      q -= N - j;
      ++j;
    }
    return j + q;
  }
};

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
  // @phase(st) load

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
  // @phase(st) amplitude epilogue

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
      const float coef = (j == k) ? vout[j] * vin[j]
                                  : vout[j] * vin[k] + vout[k] * vin[j];
      float cr, ci;
      gamma_term(st.d[j], st.d[k], tb, coef, cr, ci);
#pragma unroll
      for (int l = 0; l < N; ++l) {
        const float p = st.v[l][j] * st.v[l][k];
        dphr[l] = dphr[l] + p * cr;
        dphi[l] = dphi[l] + p * ci;
      }
    }
  }

  // @phase(st) DK contraction
  float* g = grad + b * (N + 1);
#pragma unroll
  for (int l = 0; l < N; ++l) g[l] = -2.0f * (dphr[l] * phr + dphi[l] * phi);
  g[N] = -2.0f * (hui * phr - hur * phi);
  // @phase(st) store
}

// The pairs are dealt over a group's lanes: pair q belongs to lane q % L,
// which keeps it in its register q / L.
template <int N, int L>
struct Deal {
  static constexpr int kMine = (Pairs<N>::kCount + L - 1) / L;
};

// lane `k` takes the pair Q if it is its own: the eigenvalues and
// coef = V[out,j] V[in,k] + V[out,k] V[in,j] (one term for j == k)
template <int N, int L, int Q>
__device__ __forceinline__ void take_pair(int k, const float (&d)[N],
                                          const float (&vin)[N],
                                          const float (&vout)[N], float& lj,
                                          float& lk, float& coef) {
  if constexpr (Q < Pairs<N>::kCount) {
    constexpr int pj = Pairs<N>::first(Q);
    constexpr int pk = Pairs<N>::second(Q);
    if (k == Q % L) {
      lj = d[pj];
      lk = d[pk];
      coef = (pj == pk) ? vout[pj] * vin[pj]
                        : vout[pj] * vin[pk] + vout[pk] * vin[pj];
    }
  }
}

// coef * Gamma of the lane's I-th pair (zero past the end of the list)
template <int N, int L, int I, int... J>
__device__ __forceinline__ void gamma_item(
    int k, const float (&d)[N], const float (&vin)[N], const float (&vout)[N],
    float tb, float (&cr)[Deal<N, L>::kMine], float (&ci)[Deal<N, L>::kMine],
    std::integer_sequence<int, J...>) {
  float lj = 0.0f, lk = 0.0f, coef = 0.0f;
  (take_pair<N, L, I * L + J>(k, d, vin, vout, lj, lk, coef), ...);
  gamma_term(lj, lk, tb, coef, cr[I], ci[I]);
}

template <int N, int L, int... I>
__device__ __forceinline__ void gamma_items(
    int k, const float (&d)[N], const float (&vin)[N], const float (&vout)[N],
    float tb, float (&cr)[Deal<N, L>::kMine], float (&ci)[Deal<N, L>::kMine],
    std::integer_sequence<int, I...>) {
  (gamma_item<N, L, I>(k, d, vin, vout, tb, cr, ci,
                       std::make_integer_sequence<int, L>{}), ...);
}

// coef * Gamma of the pair Q, read from the lane and the register that
// computed it, added into this lane's rows of dphi
template <int N, int L, int R, int Q>
__device__ __forceinline__ void contract_pair(
    const float (&v)[R][N], const float (&cr)[Deal<N, L>::kMine],
    const float (&ci)[Deal<N, L>::kMine], int base, float (&dphr)[R],
    float (&dphi)[R]) {
  constexpr int pj = Pairs<N>::first(Q);
  constexpr int pk = Pairs<N>::second(Q);
  const float gr = jacobi::group_get(cr[Q / L], base, Q % L);
  const float gi = jacobi::group_get(ci[Q / L], base, Q % L);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float p = v[r][pj] * v[r][pk];
    dphr[r] = dphr[r] + p * gr;
    dphi[r] = dphi[r] + p * gi;
  }
}

// every pair, in the list's order
template <int N, int L, int R, int... Q>
__device__ __forceinline__ void contract_pairs(
    const float (&v)[R][N], const float (&cr)[Deal<N, L>::kMine],
    const float (&ci)[Deal<N, L>::kMine], int base, float (&dphr)[R],
    float (&dphi)[R], std::integer_sequence<int, Q...>) {
  (contract_pair<N, L, R, Q>(v, cr, ci, base, dphr, dphi), ...);
}

// A group of L lanes per controller.  Lane k carries the rows
// k, k + L, ... of V (R = ceil(n / L) of them; a row past the end is zero
// and is never stored).
template <int N>
__global__ void __launch_bounds__(kGroupThreads)
sym_jacobi_grad_group_kernel(const float* __restrict__ h0,
                             const float* __restrict__ xs,
                             float* __restrict__ err, float* __restrict__ grad,
                             int in_spin, int out_spin, int sweeps, float eps,
                             int64_t B) {
  constexpr int L = jacobi::group_lanes<N>();
  using Lanes = jacobi::GroupLanes<N, L>;
  using P = Pairs<N>;
  constexpr int R = (N + L - 1) / L;              // rows of V of one lane
  constexpr int kMine = Deal<N, L>::kMine;        // pairs of one lane
  const Lanes lanes(B);
  const int64_t b = lanes.b;
  const float* x = xs + b * (N + 1);

  jacobi::SymState<N, R> st;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    st.d[i] = h0[i * N + i] + x[i];
#pragma unroll
    for (int j = 0; j < i; ++j) st.l[jacobi::tri(i, j)] = h0[i * N + j];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      st.v[r][k] = (lanes.k + r * L == k) ? 1.0f : 0.0f;
    }
  }
  const float tb = fabsf(x[N]);
  // @phase(st) load

  jacobi::group_sweeps<N, L>(st, sweeps, eps, lanes);

  // V[in, :] and V[out, :] in every lane: the lane spin % L holds the row
  // in its register row spin / L.  Every register row is read from that
  // lane and the one wanted is picked afterwards: a select between
  // shuffled values stays a select, one between the rows of st.v would be
  // compiled into an indexed load and send the state to local memory.
  float vin[N], vout[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    vin[k] = jacobi::group_get(st.v[0][k], lanes.base, in_spin % L);
    vout[k] = jacobi::group_get(st.v[0][k], lanes.base, out_spin % L);
#pragma unroll
    for (int r = 1; r < R; ++r) {
      const float from_in =
          jacobi::group_get(st.v[r][k], lanes.base, in_spin % L);
      const float from_out =
          jacobi::group_get(st.v[r][k], lanes.base, out_spin % L);
      vin[k] = (in_spin / L == r) ? from_in : vin[k];
      vout[k] = (out_spin / L == r) ? from_out : vout[k];
    }
  }

  // the phase factors k, k + L, ... of lane k (zero weight past the end)
  float phr = 0.0f, phi = 0.0f, hur = 0.0f, hui = 0.0f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float w = 0.0f;
    float lam = 0.0f;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (i * L + j < N && lanes.k == j) {
        w = vout[i * L + j < N ? i * L + j : 0] *
            vin[i * L + j < N ? i * L + j : 0];
        lam = st.d[i * L + j < N ? i * L + j : 0];
      }
    }
    const float ang = lam * tb;
    const float fr = cosf(ang);
    const float fi = -sinf(ang);
    phr = phr + w * fr;
    phi = phi + w * fi;
    hur = hur + lam * w * fr;
    hui = hui + lam * w * fi;
  }
  phr = jacobi::group_sum<L>(phr, lanes.base);
  phi = jacobi::group_sum<L>(phi, lanes.base);
  hur = jacobi::group_sum<L>(hur, lanes.base);
  hui = jacobi::group_sum<L>(hui, lanes.base);
  // @phase(st) amplitude epilogue

  // coef * Gamma of this lane's pairs k, k + L, ...
  float cr[kMine], ci[kMine];
  gamma_items<N, L>(lanes.k, st.d, vin, vout, tb, cr, ci,
                    std::make_integer_sequence<int, kMine>{});

  float dphr[R], dphi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dphr[r] = 0.0f;
    dphi[r] = 0.0f;
  }
  contract_pairs<N, L, R>(st.v, cr, ci, lanes.base, dphr, dphi,
                          std::make_integer_sequence<int, P::kCount>{});
  // @phase(st) DK contraction

  if (lanes.owns) {
    float* g = grad + b * (N + 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int l = lanes.k + r * L;
      if (l < N) g[l] = -2.0f * (dphr[r] * phr + dphi[r] * phi);
    }
    if (lanes.k == 0) {
      g[N] = -2.0f * (hui * phr - hur * phi);
      err[b] = 1.0f - (phr * phr + phi * phi);
    }
  }
  // @phase(st) store
}

template <int N>
cudaError_t launch_group(const float* h0, const float* xs, float* err,
                         float* grad, int in_spin, int out_spin, int sweeps,
                         float eps, int64_t B, cudaStream_t stream) {
  using Lanes = jacobi::GroupLanes<N, jacobi::group_lanes<N>()>;
  sym_jacobi_grad_group_kernel<N><<<Lanes::blocks(B), kGroupThreads, 0,
                                    stream>>>(
      h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B);
  return cudaGetLastError();
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

// The lane-group route: the same arguments, layouts and return value, for
// n in 3..10.  n = 2 has one pivot a stage, so its group would be one lane:
// that size keeps the one-thread kernel above (cudaErrorInvalidValue here).
extern "C" int sym_jacobi_grad_group(const float* h0, const float* xs,
                                     float* err, float* grad, int n,
                                     int in_spin, int out_spin, int sweeps,
                                     float eps, long long B, int device,
                                     void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 3: return launch_group<3>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    case 4: return launch_group<4>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    case 5: return launch_group<5>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    case 6: return launch_group<6>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    case 7: return launch_group<7>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    case 8: return launch_group<8>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    case 9: return launch_group<9>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    case 10: return launch_group<10>(h0, xs, err, grad, in_spin, out_spin, sweeps, eps, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
