// The synthetic ALU probe of artifacts/perf/roofline.py:256-276 (make_probe,
// its pl.pallas_call at :272), written for Hopper.  Over every lane of a
// (rows, B) float32 block, `streams` independent chains
//     x_s <- x_s * m + c,   K / streams steps each,
// with x_s = row s, m = row `streams`, c = row `streams + 1`; the output
// lane is the chains summed in order.  Each step is a multiply and then an
// add, each rounded (__fmul_rn, __fadd_rn, never contracted into an FMA), as
// the TPU kernel's body `x * m + c` reads and as the plain version in
// ops/probes.py computes it with two torch operations: the kernel is bit-equal
// to it.
//
// What bounds it: operations, 2 * B * K float32 operations a launch (4.29e9
// at B = 2^19, K = 4096); the bytes, (streams + 3) * 4 * B, take microseconds.
// One thread per lane, the chains in registers: `streams` is a template
// parameter (1, 4, 8), K a run-time argument, so nothing is folded away.
// With one stream a thread's steps form one dependent chain, and a warp
// scheduler keeps issuing only with as many warps as the pipeline's latency
// in cycles; more streams give each thread independent steps.  The marginal
// cost per step (the slope over K) is what the probe measures
// (code_robchar_tpu_torch/perf/probes.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int kStreams>
__global__ void __launch_bounds__(kThreads)
alu_probe_kernel(const float* __restrict__ x, float* __restrict__ out, int k,
                 long long b) {
  const long long lane =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= b) return;
  float xs[kStreams];
#pragma unroll
  for (int s = 0; s < kStreams; ++s) xs[s] = x[s * b + lane];
  const float m = x[kStreams * b + lane];
  const float c = x[(kStreams + 1) * b + lane];
  const int steps = k / kStreams;
#pragma unroll 4
  for (int i = 0; i < steps; ++i) {
#pragma unroll
    for (int s = 0; s < kStreams; ++s) {
      xs[s] = __fadd_rn(__fmul_rn(xs[s], m), c);
    }
  }
  float acc = xs[0];
#pragma unroll
  for (int s = 1; s < kStreams; ++s) acc = __fadd_rn(acc, xs[s]);
  out[lane] = acc;
}

}  // namespace

// x (rows, b) row-major float32 with rows >= streams + 2, out (b,); streams
// in {1, 4, 8}.  Launches on `stream`; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for another stream count).
extern "C" int alu_probe(const float* x, float* out, int streams, int k,
                         long long b, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((b + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (streams) {
    case 1: alu_probe_kernel<1><<<blocks, kThreads, 0, s>>>(x, out, k, b); break;
    case 4: alu_probe_kernel<4><<<blocks, kThreads, 0, s>>>(x, out, k, b); break;
    case 8: alu_probe_kernel<8><<<blocks, kThreads, 0, s>>>(x, out, k, b); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
