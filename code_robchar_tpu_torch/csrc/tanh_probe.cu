// The tanh micro-benchmark's kernel of artifacts/perf/tanh_microbench.py:26-31
// (make_kernel, its pl.pallas_call at :31), written for Hopper: K times
//     acc <- op(acc) * 0.999
// on every element of a float32 array, for three ops:
//   0  x * 1.0001                  (a multiply: the unit the others are read in)
//   1  tanhf(x)                    (CUDA's tanhf, not the approximate tanh.approx)
//   2  the rational P13/Q6 tanh of tanh_microbench.py:52-66: x clamped to
//      +-7.99881172180175781, Horner in x^2 with the reference's coefficients
//      in the reference's order, one division.
// Every multiply and add is rounded on its own (__fmul_rn, __fadd_rn, never
// an FMA) and the division is IEEE (__fdiv_rn), as the JAX bodies read and as
// the plain versions in ops/probes.py compute them with separate torch
// operations: ops 0 and 2 are bit-equal to them.  The constants are the
// float32 roundings of the reference's Python floats, written in hex.
//
// What bounds it: operations.  Op 2 takes 24 float32 operations a step (clamp
// 2, x^2 1, numerator 13, denominator 6, division 1, the 0.999 scale 1), so
// 65,536 elements x 8192 steps are 1.29e10 operations, 0.19 ms at 67 TFLOP/s.
// One thread per element; the K loop is one dependent chain a thread, so the
// marginal cost per step is the chain's latency spread over the warps an SM
// holds (code_robchar_tpu_torch/perf/probes.py measures it).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int kOp>
__device__ __forceinline__ float probe_op(float x) {
  if (kOp == 0) return __fmul_rn(x, 0x1.00068ep+0f);            // 1.0001
  if (kOp == 1) return tanhf(x);
  const float bound = 0x1.ffec88p+2f;                            // 7.99881172
  x = fminf(fmaxf(x, -bound), bound);
  const float x2 = __fmul_rn(x, x);
  float a = __fadd_rn(__fmul_rn(x2, -0x1.3e4b8p-52f),            // -2.76e-16
                      0x1.c266fcp-43f);                          // 2.00e-13
  a = __fadd_rn(__fmul_rn(x2, a), -0x1.7a6ffep-34f);             // -8.60e-11
  a = __fadd_rn(__fmul_rn(x2, a), 0x1.b80082p-25f);              // 5.12e-08
  a = __fadd_rn(__fmul_rn(x2, a), 0x1.f28694p-17f);              // 1.49e-05
  a = __fadd_rn(__fmul_rn(x2, a), 0x1.4e1bdap-11f);              // 6.37e-04
  a = __fadd_rn(__fmul_rn(x2, a), 0x1.40b3b8p-8f);               // 4.89e-03
  const float p = __fmul_rn(x, a);
  float b = __fadd_rn(__fmul_rn(x2, 0x1.41a7bp-20f),             // 1.20e-06
                      0x1.f12bacp-14f);                          // 1.19e-04
  b = __fadd_rn(__fmul_rn(x2, b), 0x1.29540ap-9f);               // 2.27e-03
  const float q = __fadd_rn(__fmul_rn(x2, b), 0x1.40b3bap-8f);   // 4.89e-03
  return __fdiv_rn(p, q);
}

template <int kOp>
__global__ void __launch_bounds__(kThreads)
tanh_probe_kernel(const float* __restrict__ x, float* __restrict__ out, int k,
                  long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float acc = x[i];
  for (int step = 0; step < k; ++step) {
    acc = __fmul_rn(probe_op<kOp>(acc), 0x1.ff7ceep-1f);        // 0.999
  }
  out[i] = acc;
}

}  // namespace

// x, out (n,) float32; op in {0, 1, 2} as above.  Launches on `stream`;
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// another op).
extern "C" int tanh_probe(const float* x, float* out, int op, int k,
                          long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: tanh_probe_kernel<0><<<blocks, kThreads, 0, s>>>(x, out, k, n); break;
    case 1: tanh_probe_kernel<1><<<blocks, kThreads, 0, s>>>(x, out, k, n); break;
    case 2: tanh_probe_kernel<2><<<blocks, kThreads, 0, s>>>(x, out, k, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
