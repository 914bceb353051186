// PPO value regression — `iters` full-batch Adam steps of the tanh critic,
// forward, hand-written backward and Adam fused — one block per agent, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel code_robchar_tpu/ops/pallas_critic.py _build
// (called through critic_train): per agent, with X = [obs, 1] (T, d+1) and
// the biases folded into the weights as their last row,
//
//   h1 = tanh(X W1), h2 = tanh([h1 1] W2), v = [h2 1] w3
//   dv = (2/T)(v - ret); g3 = [h2 1]^T dv
//   dz2 = dv w3[:h]^T * (1 - h2^2); g2 = [h1 1]^T dz2
//   dz1 = (dz2 W2[:h]^T) * (1 - h1^2); g1 = X^T dz1
//   Adam at t = count + i + 1 with bias corrections 1 - exp(t log beta)
//
// repeated `iters` times, with the arithmetic of the plain torch version
// (code_robchar_tpu_torch/ops/critic.py critic_train_plain).
//
// What bounds it on the H100.  Operations: per iteration and agent ~32.3k
// multiply-adds per batch row (the two h x h products forward and back
// dominate) plus ~0.8k flops of tanh and elementwise work, so ~33 MFLOP
// at T = 500, h = 100; at A = 1024 and 200 iterations 6.7 TFLOP, 0.10 s at
// the float32 peak.  Bytes (parameters and both moments in and out, the
// batch once, ~0.3 GB) take 0.09 ms.
//
// What the design does about it.
// - One block per agent keeps the parameters and their gradient in shared
//   memory for all iterations (~90 KB at h = 100; two blocks per SM), as
//   the TPU kernel keeps one agent's state in VMEM; the Adam moments stay
//   in global memory (L2-resident: each is read and written once per
//   iteration, ~90 KB per agent).
// - The batch is walked in tiles of kRows = 16 rows: each tile's forward
//   and backward add into the gradient, so the (T, h) activations are
//   never resident, and a padded last tile contributes exactly zero
//   (X rows and dv set to 0).
// - The products are float32 FMAs outside the tensor cores (TF32 or bf16,
//   the TPU's fast_dot, are a later choice with their accuracy measured),
//   register-tiled: a warp takes kRT rows of the output, a lane kCT
//   columns 32 apart, so per k each lane loads kRT broadcast and kCT
//   consecutive values for kRT * kCT FMAs.  W2 and its gradient use an odd
//   leading dimension so that the transposed read of the backward pass
//   (W2[j][k] over consecutive j) hits distinct banks.
//
// Layout: packed per agent (A, P), P = (d+1) h + (h+1) h + (h+1): W1, W2,
// w3 row-major; the moments alike; count (A,) int32; obs (A, T, d);
// rets (A, T).  Precision: IEEE division and sqrtf, tanhf, expf; build
// without --use_fast_math.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRows = 16;       // batch rows per tile (ops/critic.py ROWS)
constexpr int kRT = 2;          // output rows per warp in a product
constexpr int kCT = 4;          // output columns per lane, 32 apart

struct Hyper {
  int d1, h, T, iters;
  float lr, b1, omb1, b2, omb2, lb1, lb2, eps, two_over_t;
};

// C(m, n) = sum_k A(m, k) B(k, n) for m < M, n < Ncol, handed to
// epi(m, n, value); A(m, k) = A[m * sam + k * sak], B(k, n) =
// B[k * sbk + n * sbn].  Out-of-range rows and columns read row / column 0
// and are not stored, so the inner loop has no branch.
template <class Epi>
__device__ __forceinline__ void product(int M, int Ncol, int K,
                                        const float* A, int sam, int sak,
                                        const float* B, int sbk, int sbn,
                                        Epi epi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int m0 = warp * kRT; m0 < M; m0 += nwarps * kRT) {
    for (int n0 = 0; n0 < Ncol; n0 += 32 * kCT) {
      const float* ap[kRT];
      const float* bp[kCT];
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        ap[r] = A + (m0 + r < M ? m0 + r : 0) * sam;
      }
#pragma unroll
      for (int c = 0; c < kCT; ++c) {
        const int n = n0 + lane + 32 * c;
        bp[c] = B + (n < Ncol ? n : 0) * sbn;
      }
      float acc[kRT][kCT];
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
#pragma unroll
        for (int c = 0; c < kCT; ++c) acc[r][c] = 0.0f;
      }
      for (int k = 0; k < K; ++k) {
        float av[kRT];
        float bv[kCT];
#pragma unroll
        for (int r = 0; r < kRT; ++r) av[r] = ap[r][k * sak];
#pragma unroll
        for (int c = 0; c < kCT; ++c) bv[c] = bp[c][k * sbk];
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
#pragma unroll
          for (int c = 0; c < kCT; ++c) {
            acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
#pragma unroll
        for (int c = 0; c < kCT; ++c) {
          const int n = n0 + lane + 32 * c;
          if (m0 + r < M && n < Ncol) epi(m0 + r, n, acc[r][c]);
        }
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// shared-memory offset of packed parameter i (W2 rows are ld2 apart)
__device__ __forceinline__ int param_offset(int i, int d1, int h, int ld2) {
  const int n1 = d1 * h;
  const int n2 = (h + 1) * h;
  if (i < n1) return i;
  if (i < n1 + n2) {
    const int j = i - n1;
    return n1 + (j / h) * ld2 + j % h;
  }
  return n1 + (h + 1) * ld2 + (i - n1 - n2);
}

__global__ void __launch_bounds__(kThreads)
critic_train_kernel(const float* __restrict__ theta_in,
                    const float* __restrict__ mu_in,
                    const float* __restrict__ nu_in,
                    const int* __restrict__ count_in,
                    const float* __restrict__ obs,
                    const float* __restrict__ rets,
                    float* __restrict__ theta_out, float* __restrict__ mu_out,
                    float* __restrict__ nu_out, int* __restrict__ count_out,
                    Hyper hp) {
  const int agent = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int d1 = hp.d1;
  const int d = d1 - 1;
  const int h = hp.h;
  const int T = hp.T;
  const int ld2 = h + 1 - (h & 1);   // odd: conflict-free transposed reads
  const int ldh = h + 1;             // hidden tiles carry the ones column
  const int P = d1 * h + (h + 1) * h + (h + 1);
  const int ps = d1 * h + (h + 1) * ld2 + (h + 1);   // parameters in smem

  extern __shared__ float smem[];
  float* W1 = smem;                  // d1 x h
  float* W2 = W1 + d1 * h;           // (h + 1) x ld2
  float* w3 = W2 + (h + 1) * ld2;    // h + 1
  float* G = smem + ps;              // the gradient, same layout
  float* G1 = G;
  float* G2 = G1 + d1 * h;
  float* g3 = G2 + (h + 1) * ld2;
  float* X = G + ps;                 // kRows x d1
  float* H1 = X + kRows * d1;        // kRows x ldh
  float* H2 = H1 + kRows * ldh;      // kRows x ldh
  float* V = H2 + kRows * ldh;       // kRows: v, then dv
  float* R = V + kRows;              // kRows returns

  const int64_t pbase = static_cast<int64_t>(agent) * P;
  const int64_t rbase = static_cast<int64_t>(agent) * T;
  for (int i = tid; i < P; i += nthr) {
    const int o = param_offset(i, d1, h, ld2);
    smem[o] = theta_in[pbase + i];
    G[o] = 0.0f;
  }
  for (int r = tid; r < kRows; r += nthr) {
    H1[r * ldh + h] = 1.0f;
    H2[r * ldh + h] = 1.0f;
  }
  const int c0 = count_in[agent];
  if (hp.iters == 0) {
    for (int i = tid; i < P; i += nthr) {
      mu_out[pbase + i] = mu_in[pbase + i];
      nu_out[pbase + i] = nu_in[pbase + i];
    }
  }
  __syncthreads();

  for (int it = 0; it < hp.iters; ++it) {
    for (int r0 = 0; r0 < T; r0 += kRows) {
      for (int i = tid; i < kRows * d1; i += nthr) {
        const int r = i / d1;
        const int k = i - r * d1;
        float x = 0.0f;
        if (r0 + r < T) {
          x = k < d ? obs[(rbase + r0 + r) * d + k] : 1.0f;
        }
        X[i] = x;
      }
      for (int r = tid; r < kRows; r += nthr) {
        R[r] = r0 + r < T ? rets[rbase + r0 + r] : 0.0f;
      }
      __syncthreads();
      // forward: h1 = tanh(X W1), h2 = tanh([h1 1] W2)
      product(kRows, h, d1, X, d1, 1, W1, h, 1,
              [&](int r, int j, float z) { H1[r * ldh + j] = tanhf(z); });
      __syncthreads();
      product(kRows, h, h + 1, H1, ldh, 1, W2, ld2, 1,
              [&](int r, int j, float z) { H2[r * ldh + j] = tanhf(z); });
      __syncthreads();
      // v = [h2 1] w3, one warp per row; dv = (2/T)(v - ret), 0 on padding
      for (int r = warp; r < kRows; r += nwarps) {
        float s = 0.0f;
        for (int k = lane; k < h + 1; k += 32) {
          s = fmaf(H2[r * ldh + k], w3[k], s);
        }
        s = warp_sum(s);
        if (lane == 0) V[r] = r0 + r < T ? hp.two_over_t * (s - R[r]) : 0.0f;
      }
      __syncthreads();
      // g3 += [h2 1]^T dv
      for (int k = tid; k < h + 1; k += nthr) {
        float s = 0.0f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) s = fmaf(H2[r * ldh + k], V[r], s);
        g3[k] += s;
      }
      __syncthreads();
      // dz2 = dv w3^T (1 - h2^2), in place of h2
      for (int i = tid; i < kRows * h; i += nthr) {
        const int r = i / h;
        const int j = i - r * h;
        const float y = H2[r * ldh + j];
        H2[r * ldh + j] = V[r] * w3[j] * (1.0f - y * y);
      }
      __syncthreads();
      // g2 += [h1 1]^T dz2
      product(h + 1, h, kRows, H1, 1, ldh, H2, ldh, 1,
              [&](int k, int j, float z) { G2[k * ld2 + j] += z; });
      __syncthreads();
      // dz1 = (dz2 W2[:h]^T)(1 - h1^2), in place of h1
      product(kRows, h, h, H2, ldh, 1, W2, 1, ld2,
              [&](int r, int j, float z) {
                const float y = H1[r * ldh + j];
                H1[r * ldh + j] = z * (1.0f - y * y);
              });
      __syncthreads();
      // g1 += X^T dz1
      product(d1, h, kRows, X, 1, d1, H1, ldh, 1,
              [&](int k, int j, float z) { G1[k * h + j] += z; });
      __syncthreads();
    }

    // Adam at t = count + it + 1; moments from the inputs on the first
    // iteration, from the outputs after it (each thread keeps its indices)
    const float t = static_cast<float>(c0 + it + 1);
    const float bc1 = 1.0f - expf(t * hp.lb1);
    const float bc2 = 1.0f - expf(t * hp.lb2);
    const float* msrc = it == 0 ? mu_in : mu_out;
    const float* vsrc = it == 0 ? nu_in : nu_out;
    for (int i = tid; i < P; i += nthr) {
      const int o = param_offset(i, d1, h, ld2);
      const float g = G[o];
      const float m = hp.b1 * msrc[pbase + i] + hp.omb1 * g;
      const float v = hp.b2 * vsrc[pbase + i] + hp.omb2 * g * g;
      mu_out[pbase + i] = m;
      nu_out[pbase + i] = v;
      smem[o] = smem[o] - hp.lr * ((m / bc1) / (sqrtf(v / bc2) + hp.eps));
      G[o] = 0.0f;
    }
    __syncthreads();
  }

  for (int i = tid; i < P; i += nthr) {
    theta_out[pbase + i] = smem[param_offset(i, d1, h, ld2)];
  }
  if (tid == 0) count_out[agent] = c0 + hp.iters;
}

}  // namespace

// C entry, bound with ctypes.  theta, mu, nu: (A, P) float32; count (A,)
// int32; obs (A, T, d1 - 1); rets (A, T); the outputs alike, all on
// `device`.  The scalars are float32 as the plain version rounds them:
// lr, beta1, 1 - beta1, beta2, 1 - beta2, log beta1, log beta2, eps, 2 / T.
// Launches on `stream` and does not synchronise.  Returns
// cudaGetLastError() after the launch, or the error of
// cudaFuncSetAttribute when the parameters do not fit in a block's shared
// memory.
extern "C" int critic_train(const float* theta, const float* mu,
                            const float* nu, const int* count,
                            const float* obs, const float* rets,
                            float* theta_out, float* mu_out, float* nu_out,
                            int* count_out, int d1, int h, int T, int iters,
                            float lr, float b1, float omb1, float b2,
                            float omb2, float lb1, float lb2, float eps,
                            float two_over_t, int A, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (A <= 0) return static_cast<int>(cudaSuccess);
  if (h < 1 || d1 < 1 || T < 1 || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ld2 = h + 1 - (h & 1);
  const size_t ps = static_cast<size_t>(d1) * h
      + static_cast<size_t>(h + 1) * ld2 + (h + 1);
  const size_t tile = static_cast<size_t>(kRows) * (d1 + 2 * (h + 1) + 2);
  const size_t smem = sizeof(float) * (2 * ps + tile);
  err = cudaFuncSetAttribute(critic_train_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Hyper hp{d1, h, T, iters, lr, b1, omb1, b2, omb2, lb1, lb2, eps,
                 two_over_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  critic_train_kernel<<<A, kThreads, smem, s>>>(theta, mu, nu, count, obs,
                                                rets, theta_out, mu_out,
                                                nu_out, count_out, hp);
  return static_cast<int>(cudaGetLastError());
}
