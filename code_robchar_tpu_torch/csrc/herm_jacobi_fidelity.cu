// Batched split-complex Hermitian Jacobi transfer fidelity, one thread per
// Hamiltonian, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel code_robchar_tpu/ops/pallas_jacobi.py
// make_fidelity_kernel (body _rotation_body, wrapper fidelity_herm_pallas):
// for every element b of the batch,
//
//     fid[b] = |sum_k V[out,k] exp(-i t[b] lam_k) conj(V[in,k])|^2
//
// where A = ar + i ai (Hermitian, n x n) = V diag(lam) V^H is diagonalised by
// `sweeps` round-robin Jacobi sweeps with the symmetric update (only the
// column pair rotates, rows p and q are conjugate mirrors, the 2x2 pivot
// block is closed-form) and only the in and out rows of V are carried.
// The arithmetic per pivot is that of the Pallas body and of the plain torch
// version (code_robchar_tpu_torch/ops/realform.py, order="roundrobin").
//
// What bounds it on the H100: per-thread ALU work and registers, not HBM.
// Each element reads n^2 floats and writes one, then runs ~sweeps * n(n-1)/2
// dependent pivots of ~20n flops plus a sqrt and divisions each.  The design
// keeps the whole working set in registers: the lower triangle of A (real
// and imaginary parts) plus its real diagonal, and the two carried rows of V
// — n^2 + 4n floats (77 at n = 7, 140 at n = 10), half of what the full
// split matrix would take, since the upper triangle is the conjugate mirror.
// Registers can only be addressed with compile-time indices, so the matrix
// size is a template parameter (n = 2..10) and the circle-method schedule is
// expanded at compile time into one straight-line sweep body; the sweep
// count stays a runtime loop.  Many independent threads per SM hide the
// dependent-chain latency that the TPU kernel hid with round-robin stages.
//
// Layout: the JAX lanes layout, (n*n, B) with the batch fastest, so thread b
// reads ar[r*B + b] — coalesced across a warp.  128 threads per block,
// ceil(B/128) blocks, masked tail.  Precision: IEEE sqrtf and division,
// sinf/cosf with full range reduction (lam*t reaches several hundred
// radians); build without --use_fast_math.

#include <cuda_runtime.h>

#include <cstdint>

#include "jacobi_common.cuh"

namespace {

using jacobi::kThreads;
using jacobi::tri;

template <int N>
struct Herm {
  float d[N];                  // real diagonal
  float lr[N * (N - 1) / 2];   // Re A[i][j], i > j
  float li[N * (N - 1) / 2];   // Im A[i][j], i > j
  float vr[2][N];              // rows in, out of V (real)
  float vi[2][N];              // rows in, out of V (imaginary)

  template <int P, int Q>
  __device__ __forceinline__ void rotate(float eps);
};

// A[i][j], i != j, from the lower triangle (upper = conjugate mirror)
template <int N>
__device__ __forceinline__ void get(const Herm<N>& h, int i, int j,
                                    float& re, float& im) {
  if (i > j) {
    re = h.lr[tri(i, j)];
    im = h.li[tri(i, j)];
  } else {
    re = h.lr[tri(j, i)];
    im = -h.li[tri(j, i)];
  }
}

// A[i][j] = re + i im and, implicitly, A[j][i] = re - i im
template <int N>
__device__ __forceinline__ void set(Herm<N>& h, int i, int j, float re,
                                    float im) {
  if (i > j) {
    h.lr[tri(i, j)] = re;
    h.li[tri(i, j)] = im;
  } else {
    h.lr[tri(j, i)] = re;
    h.li[tri(j, i)] = -im;
  }
}

template <int N>
template <int P, int Q>
__device__ __forceinline__ void Herm<N>::rotate(float eps) {
  Herm<N>& h = *this;
  static_assert(0 <= P && P < Q && Q < N, "pivot out of range");
  const float app = h.d[P];
  const float aqq = h.d[Q];
  float xr, xi;
  get<N>(h, P, Q, xr, xi);
  const float r = sqrtf(xr * xr + xi * xi);
  const bool active = r > eps * (fabsf(app) + fabsf(aqq) + r);
  const float safe = active ? r : 1.0f;
  const float pr = active ? xr / safe : 1.0f;
  const float pi = active ? xi / safe : 0.0f;
  const float tau = (aqq - app) / (2.0f * safe);
  // sign(tau) / (|tau| + sqrt(1 + tau^2)), and t = 1 where tau == 0 (both
  // signed zeros), as jnp.sign(0) = 0 followed by where(tau == 0, 1, t)
  const float t = (tau == 0.0f)
      ? 1.0f
      : copysignf(1.0f, tau) / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  float c = 1.0f / sqrtf(1.0f + t * t);
  float s = t * c;
  c = active ? c : 1.0f;
  s = active ? s : 0.0f;
  const float t_eff = active ? t : 0.0f;

  // columns p, q at rows i not in {p, q}; rows p, q follow by symmetry
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i == P || i == Q) continue;
    float cpr, cpi, cqr, cqi;
    get<N>(h, i, P, cpr, cpi);
    get<N>(h, i, Q, cqr, cqi);
    float tr = pr * cqr + pi * cqi;    // conj(phase) * A[i][q]
    float ti = pr * cqi - pi * cqr;
    const float npr = c * cpr - s * tr;
    const float npi = c * cpi - s * ti;
    tr = pr * cpr - pi * cpi;          // phase * A[i][p]
    ti = pr * cpi + pi * cpr;
    const float nqr = s * tr + c * cqr;
    const float nqi = s * ti + c * cqi;
    set<N>(h, i, P, npr, npi);
    set<N>(h, i, Q, nqr, nqi);
  }

  // closed-form pivot block; inactive lanes keep A[p][q] unchanged and the
  // imaginary diagonal is never stored (it stays exactly zero)
  h.d[P] = app - t_eff * r;
  h.d[Q] = aqq + t_eff * r;
  set<N>(h, P, Q, active ? 0.0f : xr, active ? 0.0f : xi);

  // carried eigenvector rows: V <- V J
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const float wpr = h.vr[row][P];
    const float wpi = h.vi[row][P];
    const float wqr = h.vr[row][Q];
    const float wqi = h.vi[row][Q];
    float tr = pr * wqr + pi * wqi;
    float ti = pr * wqi - pi * wqr;
    h.vr[row][P] = c * wpr - s * tr;
    h.vi[row][P] = c * wpi - s * ti;
    tr = pr * wpr - pi * wpi;
    ti = pr * wpi + pi * wpr;
    h.vr[row][Q] = s * tr + c * wqr;
    h.vi[row][Q] = s * ti + c * wqi;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
herm_jacobi_fidelity_kernel(const float* __restrict__ ar,
                            const float* __restrict__ ai,
                            const float* __restrict__ t,
                            float* __restrict__ fid, int in_spin,
                            int out_spin, int sweeps, float eps, int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;

  Herm<N> h;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    h.d[i] = ar[static_cast<int64_t>(i * N + i) * B + b];
#pragma unroll
    for (int j = 0; j < i; ++j) {
      h.lr[tri(i, j)] = ar[static_cast<int64_t>(i * N + j) * B + b];
      h.li[tri(i, j)] = ai[static_cast<int64_t>(i * N + j) * B + b];
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    h.vr[0][k] = (k == in_spin) ? 1.0f : 0.0f;
    h.vr[1][k] = (k == out_spin) ? 1.0f : 0.0f;
    h.vi[0][k] = 0.0f;
    h.vi[1][k] = 0.0f;
  }

  jacobi::jacobi_sweeps<N>(h, sweeps, eps);

  // phi = sum_k V[out,k] e^{-i t lam_k} conj(V[in,k])
  const float tb = t[b];
  float phr = 0.0f;
  float phi = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float bir = h.vr[0][k];
    const float bii = h.vi[0][k];
    const float aor = h.vr[1][k];
    const float aoi = h.vi[1][k];
    const float gr = aor * bir + aoi * bii;
    const float gi = aoi * bir - aor * bii;
    const float ang = h.d[k] * tb;
    const float fr = cosf(ang);
    const float fi = -sinf(ang);
    phr = phr + gr * fr - gi * fi;
    phi = phi + gr * fi + gi * fr;
  }
  fid[b] = phr * phr + phi * phi;
}

template <int N>
cudaError_t launch(const float* ar, const float* ai, const float* t,
                   float* fid, int in_spin, int out_spin, int sweeps,
                   float eps, int64_t B, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  herm_jacobi_fidelity_kernel<N><<<blocks, kThreads, 0, stream>>>(
      ar, ai, t, fid, in_spin, out_spin, sweeps, eps, B);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes.  ar, ai: (n*n, B) float32, t: (B,), fid: (B,)
// output, all on `device`; launches on `stream` and does not synchronise.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for n
// outside 2..10).
extern "C" int herm_jacobi_fidelity(const float* ar, const float* ai,
                                    const float* t, float* fid, int n,
                                    int in_spin, int out_spin, int sweeps,
                                    float eps, long long B, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 2: return launch<2>(ar, ai, t, fid, in_spin, out_spin, sweeps, eps, B, s);
    case 3: return launch<3>(ar, ai, t, fid, in_spin, out_spin, sweeps, eps, B, s);
    case 4: return launch<4>(ar, ai, t, fid, in_spin, out_spin, sweeps, eps, B, s);
    case 5: return launch<5>(ar, ai, t, fid, in_spin, out_spin, sweeps, eps, B, s);
    case 6: return launch<6>(ar, ai, t, fid, in_spin, out_spin, sweeps, eps, B, s);
    case 7: return launch<7>(ar, ai, t, fid, in_spin, out_spin, sweeps, eps, B, s);
    case 8: return launch<8>(ar, ai, t, fid, in_spin, out_spin, sweeps, eps, B, s);
    case 9: return launch<9>(ar, ai, t, fid, in_spin, out_spin, sweeps, eps, B, s);
    case 10: return launch<10>(ar, ai, t, fid, in_spin, out_spin, sweeps, eps, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
