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
// count stays a runtime loop.
//
// The dependent chain of a thread is the angle chain of every pivot: r =
// sqrt(xr^2 + xi^2), the phase and tau by divisions, t by a square root and
// a division, c by one more of each.  IEEE sqrtf and `/` each end in a
// range check and a branch, so one pivot's chain is a row of basic blocks
// that nothing overlaps (78% of a thread's clocks at n = 7, 929 a pivot,
// measured on the H100 before this design).  The sweep is therefore
// jacobi::hoisted_sweeps: a stage's angles are taken from the state at the
// start of the stage, as the Pallas body and the plain version take them
// (exact: a stage's pivots are disjoint), each by
// jacobi::herm_angles_fast, the same arithmetic with the fast paths of
// division and sqrtf written out and one range check for the chain, and
// placed in the basic block of the previous pivot's rotation, which it
// overlaps; a pivot with an operand out of the checked ranges takes
// jacobi::herm_angles, the IEEE arithmetic.  The outputs are those of the
// per-pivot IEEE chain, bit for bit.  Computing all of a stage's chains
// before its rotations instead kept three sets of angles live: 168
// registers, 3 blocks an SM and no faster than the IEEE chain; this way
// n = 7 takes 128 registers, no spill, 4 blocks of 128 threads an SM.
//
// Layout: the JAX lanes layout, (n*n, B) with the batch fastest, so thread b
// reads ar[r*B + b] — coalesced across a warp.  128 threads per block,
// ceil(B/128) blocks, masked tail.  Precision: the results of IEEE sqrtf
// and division, sincosf with full range reduction (lam*t reaches several
// hundred radians); build without --use_fast_math.

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

  using Angles = jacobi::HermAngles;

  // the angles of the pivot (P, Q), P < Q, from A[P][Q] = conj(A[Q][P])
  template <int P, int Q>
  __device__ __forceinline__ Angles angles_fast(float eps, bool& ok) const {
    return jacobi::herm_angles_fast(d[P], d[Q], lr[tri(Q, P)],
                                    -li[tri(Q, P)], eps, ok);
  }
  template <int P, int Q>
  __device__ __forceinline__ Angles angles_exact(float eps) const {
    return jacobi::herm_angles(d[P], d[Q], lr[tri(Q, P)], -li[tri(Q, P)],
                               eps);
  }
  template <int P, int Q>
  __device__ __forceinline__ void apply(const Angles& g);
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

// the rotation g at the pivot (P, Q): A <- J^H A J, V <- V J
template <int N>
template <int P, int Q>
__device__ __forceinline__ void Herm<N>::apply(const Angles& g) {
  Herm<N>& h = *this;
  static_assert(0 <= P && P < Q && Q < N, "pivot out of range");
  const float app = h.d[P];
  const float aqq = h.d[Q];
  float xr, xi;
  get<N>(h, P, Q, xr, xi);
  const float pr = g.pr, pi = g.pi, c = g.c, s = g.s();

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
  h.d[P] = app - g.t_eff * g.r;
  h.d[Q] = aqq + g.t_eff * g.r;
  set<N>(h, P, Q, g.active ? 0.0f : xr, g.active ? 0.0f : xi);
  // @phase A update

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
  // @phase V update
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

  Herm<N> st;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    st.d[i] = ar[static_cast<int64_t>(i * N + i) * B + b];
#pragma unroll
    for (int j = 0; j < i; ++j) {
      st.lr[tri(i, j)] = ar[static_cast<int64_t>(i * N + j) * B + b];
      st.li[tri(i, j)] = ai[static_cast<int64_t>(i * N + j) * B + b];
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    st.vr[0][k] = (k == in_spin) ? 1.0f : 0.0f;
    st.vr[1][k] = (k == out_spin) ? 1.0f : 0.0f;
    st.vi[0][k] = 0.0f;
    st.vi[1][k] = 0.0f;
  }

  // @phase(st) load
  jacobi::hoisted_sweeps<N>(st, sweeps, eps);

  // phi = sum_k V[out,k] e^{-i t lam_k} conj(V[in,k])
  const float tb = t[b];
  float phr = 0.0f;
  float phi = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float bir = st.vr[0][k];
    const float bii = st.vi[0][k];
    const float aor = st.vr[1][k];
    const float aoi = st.vi[1][k];
    const float gr = aor * bir + aoi * bii;
    const float gi = aoi * bir - aor * bii;
    const float ang = st.d[k] * tb;
    float sn, fr;
    sincosf(ang, &sn, &fr);           // both with full range reduction
    const float fi = -sn;
    phr = phr + gr * fr - gi * fi;
    phi = phi + gr * fi + gi * fr;
  }
  // @phase(st) amplitude epilogue
  fid[b] = phr * phr + phi * phi;
  // @phase(st) store
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
