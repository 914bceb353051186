// The written-out fast paths of jacobi_common.cuh (div_fast, sqrt_fast,
// sym_angles_fast, herm_angles_fast) side by side with `/`, sqrtf,
// sym_angles and herm_angles on the same operands, so that a test on the
// card can hold them equal bit for bit (tests/test_torch_cuda.py,
// chip_smoke.py phases 2 and 4).  No path of the package calls it.

#include <cuda_runtime.h>

#include <cstdint>

#include "jacobi_common.cuh"

namespace {

__global__ void angles_probe_kernel(const float* __restrict__ x,
                                    float* __restrict__ exact,
                                    float* __restrict__ fast, float eps,
                                    int64_t B) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * jacobi::kThreads + threadIdx.x;
  if (b >= B) return;
  const float app = x[b], aqq = x[B + b], apq = x[2 * B + b];

  const jacobi::SymAngles e = jacobi::sym_angles(app, aqq, apq, eps);
  bool ok;
  const jacobi::SymAngles f = jacobi::sym_angles_fast(app, aqq, apq, eps, ok);
  const float q = jacobi::div_fast(app, aqq);
  // the ranges sym_angles_fast checks for its divisions and square roots
  const bool div_ok = jacobi::exp_in(aqq, -40, 40) &
                      ((app == 0.0f) | jacobi::exp_in(app, -40, 40)) &
                      ((q == 0.0f) | jacobi::exp_in(q, -30, 30));
  const float r = fabsf(apq);
  const bool sqrt_ok = jacobi::exp_in(r, 0, 61);

  exact[b] = e.c;
  exact[B + b] = e.s;
  exact[2 * B + b] = e.t_eff;
  exact[3 * B + b] = e.active ? 1.0f : 0.0f;
  exact[4 * B + b] = app / aqq;
  exact[5 * B + b] = sqrtf(r);
  fast[b] = f.c;
  fast[B + b] = f.s;
  fast[2 * B + b] = f.t_eff;
  fast[3 * B + b] = f.active ? 1.0f : 0.0f;
  fast[4 * B + b] = q;
  fast[5 * B + b] = jacobi::sqrt_fast(r);
  fast[6 * B + b] = (ok ? 1.0f : 0.0f) + (div_ok ? 2.0f : 0.0f) +
                    (sqrt_ok ? 4.0f : 0.0f);
}

__global__ void herm_angles_probe_kernel(const float* __restrict__ x,
                                         float* __restrict__ exact,
                                         float* __restrict__ fast, float eps,
                                         int64_t B) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * jacobi::kThreads + threadIdx.x;
  if (b >= B) return;
  const float app = x[b], aqq = x[B + b], xr = x[2 * B + b],
              xi = x[3 * B + b];
  const jacobi::HermAngles e = jacobi::herm_angles(app, aqq, xr, xi, eps);
  bool ok;
  const jacobi::HermAngles f =
      jacobi::herm_angles_fast(app, aqq, xr, xi, eps, ok);
  const jacobi::HermAngles* g[2] = {&e, &f};
  float* out[2] = {exact, fast};
  for (int i = 0; i < 2; ++i) {
    out[i][b] = g[i]->pr;
    out[i][B + b] = g[i]->pi;
    out[i][2 * B + b] = g[i]->c;
    out[i][3 * B + b] = g[i]->s();
    out[i][4 * B + b] = g[i]->t_eff;
    out[i][5 * B + b] = g[i]->r;
    out[i][6 * B + b] = g[i]->active ? 1.0f : 0.0f;
  }
  fast[7 * B + b] = ok ? 1.0f : 0.0f;
}

}  // namespace

// C entry with the argument list of the Jacobi kernels.  x: (4, B) float32,
// rows app, aqq, xr, xi of a Hermitian pivot.  exact: (7, B), rows pr, pi,
// c, s, t_eff, r, active of herm_angles; fast: (8, B), the same seven from
// herm_angles_fast, then 1 where it reports its operands in range.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int herm_angles_probe(const float* x, float* exact, float* fast,
                                 int, int, int, int, float eps, long long B,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks =
      static_cast<unsigned>((B + jacobi::kThreads - 1) / jacobi::kThreads);
  herm_angles_probe_kernel<<<blocks, jacobi::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, exact, fast, eps, B);
  return static_cast<int>(cudaGetLastError());
}

// C entry with the argument list of the Jacobi kernels.  x: (3, B) float32,
// rows app, aqq, apq.  exact: (6, B), rows c, s, t_eff, active of
// sym_angles, app / aqq, sqrtf(|apq|).  fast: (7, B), the same six from
// sym_angles_fast, div_fast and sqrt_fast, then a row of flags: 1 where
// sym_angles_fast reports its operands in range, 2 where the operands of
// the division are inside the ranges it checks, 4 where |apq| is in
// [1, 2^61].  Launches on `stream`; returns cudaGetLastError().
extern "C" int angles_probe(const float* x, float* exact, float* fast, int,
                            int, int, int, float eps, long long B, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks =
      static_cast<unsigned>((B + jacobi::kThreads - 1) / jacobi::kThreads);
  angles_probe_kernel<<<blocks, jacobi::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, exact, fast,
                                                             eps, B);
  return static_cast<int>(cudaGetLastError());
}
