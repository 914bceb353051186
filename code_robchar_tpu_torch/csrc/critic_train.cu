// PPO value regression — `iters` full-batch Adam steps of the tanh critic,
// forward, hand-written backward and Adam fused — one block per agent, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel code_robchar_tpu/ops/pallas_critic.py _build
// (called through critic_train) with fast_dot=False: per agent, with
// X = [obs, 1] (T, d+1) and the biases folded into the weights as their
// last row,
//
//   h1 = tanh(X W1), h2 = tanh([h1 1] W2), v = [h2 1] w3
//   dv = (2/T)(v - ret); g3 = [h2 1]^T dv
//   dz2 = dv w3[:h]^T * (1 - h2^2); g2 = [h1 1]^T dz2
//   dz1 = (dz2 W2[:h]^T) * (1 - h1^2); g1 = X^T dz1
//   Adam at t = count + i + 1 with bias corrections 1 - exp(t log beta)
//
// repeated `iters` times, with the arithmetic of the plain torch version
// (code_robchar_tpu_torch/ops/critic.py critic_train_plain, fast_dot=False):
// every product in full float32 on the FP32 pipe (FFMA; no tensor cores,
// no TF32).  csrc/critic_train_bf16.cu is the same regression with bf16
// operands (fast_dot=True).
//
// What bounds it on the H100.  Operations: per iteration and agent ~32.3k
// multiply-adds per batch row (three h x h products: h2's forward, dz1's
// backward and g2; 98% of the count) plus ~0.9k flops of tanh and
// elementwise work, so ~33 MFLOP at T = 500, h = 100; at A = 1024 and 200
// iterations 6.7 TFLOP, 100.6 ms at the float32 peak (67 TFLOP/s).  Bytes
// (parameters and both moments in and out, the batch once, ~0.3 GB) take
// 0.09 ms.  So it is a chain of small batched GEMMs on the FP32 pipe, and
// what paces such a chain is the shared memory that feeds it: an SM
// delivers 32 lane-floats a cycle from shared memory (a 128-bit load takes
// four wavefronts however many lanes share its address) against 128 FFMAs,
// so each float a thread loads must feed four FFMAs for the FP32 pipe to
// set the pace.
//
// What the design does about it.
// - One block of 8 warps per agent and per SM (__launch_bounds__(256, 1);
//   240 registers, no spill): the parameters, their gradient, the agent's
//   whole batch (read once, not once an iteration) and one row tile of
//   activations in shared memory (209,696 B at h = 100, T = 500), the Adam
//   moments in global memory (L2), read and written once an iteration.
// - Row tiles of up to kMaxRows = 100 batch rows (T = 500 is 5 tiles, none
//   padded; a ragged last tile has zero X rows and dv, so it adds exactly
//   zero), 7 block barriers a tile.
// - Register tiles.  h1, h2, dz1 = f(X W1), f(h1a W2), f(dz2 W2^T): a
//   thread owns kPR x kPC = 10 rows x 4 columns of the output and walks K
//   in chunks of 4: one 128-bit shared load of each of its 10 rows and
//   four of the weights feed 160 FFMAs, 2.9 FFMAs a loaded float (a
//   larger patch leaves threads idle at 100 rows x 100 columns).  At
//   h = 100 and 100 rows that is 250 patches for 256 threads; the hidden
//   axis is padded to a multiple of 4 only (100 stays 100), with zero
//   columns and rows where a chunk of K overruns, so the padding adds
//   exactly zero.  Columns of dz1's patch lie 25 apart, so that the lanes
//   of a warp read W2 rows an odd number of 16-byte units apart (the W
//   rows hold an odd number of float4s where the shared memory allows):
//   no bank conflict, and no transposed copy of W2 for the backward
//   product.
// - g2 = h1a^T dz2 contracts over the tile's rows: a thread owns 4 x 10
//   of g2 (250 patches at h = 100), one 128-bit and five 64-bit loads
//   per row for 40 FFMAs, and keeps it in registers across all the row
//   tiles of an iteration; it is written out once, for Adam.  g1 = X^T
//   dz1 likewise (3 x 4 a thread, 75 patches at d + 1 = 9).  Where a
//   width has more patches than threads (h > 100, or ceil((d+1)/3)
//   ceil(h/4) > 256), the same code adds each tile's sums into the
//   gradient in shared memory instead.
// - The elementwise work is fused: tanh in the epilogues of the forward
//   products (with the partial sums of v over each patch's columns),
//   (1 - h1^2) in dz1's; dz2, g2's ones row and g3 in one pass by columns.
//   Where a loop reads and writes the same array (dz1's epilogue, the dz2
//   pass, Adam), a batch of its loads is issued before any of its stores:
//   the compiler cannot tell the addresses apart and would otherwise wait
//   for each store.
// - Adam walks the parameters in rows of h with a carry (no index
//   division) and takes its divisions and square root by their exact fast
//   paths (critic_adam.cuh, shared with the bf16 kernel).
// - Lines `// @phase <name>` mark where a phase starts;
//   tools/profile_critic.py --f32 builds a copy with a clock64() reading
//   at each.
//
// Layout: packed per agent (A, P), P = (d+1) h + (h+1) h + (h+1): W1, W2,
// w3 row-major; the moments alike; count (A,) int32; obs (A, T, d);
// rets (A, T).  Precision: IEEE division and sqrtf, tanhf, expf; build
// without --use_fast_math.

#include <cuda_runtime.h>

#include <cstdint>

#include "critic_adam.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kMaxRows = 100;   // rows per tile at most (ops/critic.py ROWS)
constexpr int kPR = 10;         // rows of a forward / dz1 patch; a tile
                                // is a multiple (ops/critic.py PATCH_ROWS)
constexpr int kPC = 4;          // its columns
constexpr int kGJ = 4;          // rows of a g2 patch (the h1 index)
constexpr int kGC = 10;         // its columns (the dz2 index)
constexpr int kSlack = 16;      // floats past the tiles g2's loads may reach
constexpr int kAdam = 24;       // Adam's elements a thread loads at once
constexpr int kDz = 5;          // rows of the dz2 pass loaded at once
constexpr int kG1K = 3;         // rows (inputs) of a g1 patch; its columns: 4
constexpr int kSmemPerBlock = 232448;

struct Hyper {
  int d1, h, T, iters, rows, ldw, xrows;
  float lr, b1, omb1, b2, omb2, lb1, lb2, eps, two_over_t;
};

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ constexpr int round4(int a) { return (a + 3) & ~3; }

// Shared memory of one block in floats, the arrays up to v's partial sums
// 16-byte aligned (mirrored by ops/critic.py smem_bytes).  W1 (d1 rows) and W2 (h + 1 rows
// and zero rows up to a multiple of 4) with rows of ldw floats, w3; the
// gradient in the packed layout; X (xrows x round4(d1): the whole batch,
// T rounded up to the tile, where it fits, else one tile), h1 and h2 / dz2
// (rows x round4(h + 1) each), v's partial sums (rows x ceil(h / 4)), dv
// (rows) and the returns (xrows).
struct Layout {
  int ldx, ldh, npc;
  int w2, w3, grad, x, h1, s, pv, dv, ret, total;
  __host__ __device__ Layout(int d1, int h, int rows, int ldw, int xrows)
      : ldx(round4(d1)), ldh(round4(h + 1)), npc(ceil_div(h, kPC)) {
    const int p = d1 * h + (h + 1) * h + (h + 1);
    w2 = d1 * ldw;
    w3 = w2 + round4(h + 1) * ldw;
    grad = w3 + round4(h + 1);
    x = grad + round4(p);
    h1 = x + xrows * ldx;
    s = h1 + rows * ldh;
    pv = s + rows * ldh;
    dv = pv + rows * npc;
    ret = dv + rows;
    total = ret + xrows + kSlack;
  }
};

// The row tile, the W row stride and the rows of X of a shape: the
// largest tile (a multiple of kPR, at most kMaxRows and T rounded up) that
// fits in a block's shared memory; for it the whole batch in X where that
// fits, and W rows of an odd number of float4s where that fits, else of
// round4(h).  False when not even kPR rows fit.
bool choose_layout(int d1, int h, int T, int* rows, int* ldw, int* xrows) {
  const int top = kPR * ceil_div(T < kMaxRows ? T : kMaxRows, kPR);
  for (int r = top; r >= kPR; r -= kPR) {
    for (int whole = 1; whole >= 0; --whole) {
      for (int odd = 1; odd >= 0; --odd) {
        const int w = odd ? 4 * (ceil_div(h, 4) | 1) : round4(h);
        const int xr = whole ? r * ceil_div(T, r) : r;
        if (4 * static_cast<int64_t>(Layout(d1, h, r, w, xr).total)
            <= kSmemPerBlock) {
          *rows = r;
          *ldw = w;
          *xrows = xr;
          return true;
        }
      }
    }
  }
  return false;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// acc[a][b] = sum over k < 4 kchunks of A(a, k) B(k, b) for one kPR x kPC
// patch.  A(a, k) = arow[a * lda + k] (each row's k contiguous, 16-byte
// aligned).  kBT false: B(k, b) = b0[k * ldb + b] (the patch's columns
// contiguous); kBT true: B(k, b) = bcol[b][k] (each column's k
// contiguous).  One 128-bit load of each A row and four of B per chunk.
// acc[a][b] = sum over k < 4 kchunks of A(a, k) B(k, b) for one kPR x kPC
// patch.  A(a, k) = arow[a * lda + k] (each row's k contiguous, 16-byte
// aligned).  kBT false: B(k, b) = b0[k * ldb + b] (the patch's columns
// contiguous); kBT true: B(k, b) = bcol[b][k] (each column's k
// contiguous).  One 128-bit load of each A row and four of B per chunk.
template <bool kBT>
__device__ __forceinline__ void row_patch(const float* arow, int lda,
                                          const float* b0, int ldb,
                                          const float* const (&bcol)[kPC],
                                          int kchunks,
                                          float (&acc)[kPR][kPC]) {
#pragma unroll
  for (int a = 0; a < kPR; ++a) {
#pragma unroll
    for (int b = 0; b < kPC; ++b) acc[a][b] = 0.0f;
  }
#pragma unroll 2
  for (int kc = 0; kc < kchunks; ++kc) {
    float bv[4][kPC];   // bv[kk][b] = B(4 kc + kk, b)
    if (kBT) {
#pragma unroll
      for (int b = 0; b < kPC; ++b) {
        const float4 t = ld4(bcol[b] + 4 * kc);
        bv[0][b] = t.x;
        bv[1][b] = t.y;
        bv[2][b] = t.z;
        bv[3][b] = t.w;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 t = ld4(b0 + (4 * kc + kk) * ldb);
        bv[kk][0] = t.x;
        bv[kk][1] = t.y;
        bv[kk][2] = t.z;
        bv[kk][3] = t.w;
      }
    }
#pragma unroll
    for (int a = 0; a < kPR; ++a) {
      const float4 av = ld4(arow + a * lda + 4 * kc);
#pragma unroll
      for (int b = 0; b < kPC; ++b) {
        float s = acc[a][b];
        s = fmaf(av.x, bv[0][b], s);
        s = fmaf(av.y, bv[1][b], s);
        s = fmaf(av.z, bv[2][b], s);
        s = fmaf(av.w, bv[3][b], s);
        acc[a][b] = s;
      }
    }
  }
}

// shared-memory offset of packed parameter i (W rows are ldw apart)
__device__ __forceinline__ int param_offset(int i, int d1, int h, int ldw,
                                            int w2, int w3) {
  const int n1 = d1 * h;
  const int n2 = (h + 1) * h;
  if (i < n1) {
    const int k = i / h;
    return k * ldw + (i - k * h);
  }
  if (i < n1 + n2) {
    const int j = (i - n1) / h;
    return w2 + j * ldw + (i - n1 - j * h);
  }
  return w3 + (i - n1 - n2);
}

// offset in shared memory of the element in row r, column c of the packed
// parameters read as rows of h (W1's d1 rows, W2's h + 1, then w3's h + 1
// elements as one row of h and one of 1)
__device__ __forceinline__ int walk_offset(int r, int c, int d1, int h,
                                           int ldw, int w2, int w3) {
  if (r < d1) return r * ldw + c;
  if (r <= d1 + h) return w2 + (r - d1) * ldw + c;
  return w3 + (r - d1 - h - 1) * h + c;
}

__global__ void __launch_bounds__(kThreads, 1)
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
  const int d1 = hp.d1;
  const int d = d1 - 1;
  const int h = hp.h;
  const int T = hp.T;
  const int rows = hp.rows;
  const int ldw = hp.ldw;
  const int xrows = hp.xrows;
  const bool whole = xrows >= T;     // the batch stays in X
  const Layout L(d1, h, rows, ldw, xrows);
  const int ldx = L.ldx;
  const int ldh = L.ldh;
  const int npc = L.npc;
  const int n1 = d1 * h;
  const int n2 = (h + 1) * h;
  const int P = n1 + n2 + (h + 1);

  extern __shared__ float4 smem4[];
  float* theta = reinterpret_cast<float*>(smem4);
  float* W1 = theta;                 // d1 x ldw
  float* W2 = theta + L.w2;          // round4(h + 1) x ldw
  float* w3 = theta + L.w3;          // h + 1
  float* G = theta + L.grad;         // the gradient, packed
  float* Xs = theta + L.x;           // xrows x ldx
  float* H1 = theta + L.h1;          // rows x ldh: h1 (ones at h), then dz1
  float* S = theta + L.s;            // rows x ldh: h2, then dz2; g1's parts
  float* PV = theta + L.pv;          // rows x npc: v over a patch's columns
  float* DV = theta + L.dv;          // rows: dv
  float* RETs = theta + L.ret;       // xrows: returns

  const int64_t pbase = static_cast<int64_t>(agent) * P;
  const int64_t rbase = static_cast<int64_t>(agent) * T;
  // rows r0.. of the batch into X and the returns: x = [obs, 1] on the
  // batch's rows, 0 past its end
  auto load_rows = [&](int r0, int n) {
#pragma unroll 4
    for (int i = tid; i < n * d1; i += kThreads) {
      const int r = i / d1;
      const int k = i - r * d1;
      float x = 0.0f;
      if (r0 + r < T) x = k < d ? obs[(rbase + r0 + r) * d + k] : 1.0f;
      Xs[(r0 % xrows + r) * ldx + k] = x;
    }
    for (int r = tid; r < n; r += kThreads) {
      RETs[r0 % xrows + r] = r0 + r < T ? rets[rbase + r0 + r] : 0.0f;
    }
  };
  // zeros everywhere (the padding of W, X, h1 and dz2 stays zero), then
  // the parameters, h1's ones column and, where it fits, the batch
  for (int i = tid; i < L.total; i += kThreads) theta[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < P; i += kThreads) {
    theta[param_offset(i, d1, h, ldw, L.w2, L.w3)] = theta_in[pbase + i];
  }
  for (int r = tid; r < rows; r += kThreads) H1[r * ldh + h] = 1.0f;
  if (whole) load_rows(0, xrows);
  const int c0 = count_in[agent];
  if (hp.iters == 0) {
    for (int i = tid; i < P; i += kThreads) {
      mu_out[pbase + i] = mu_in[pbase + i];
      nu_out[pbase + i] = nu_in[pbase + i];
    }
  }
  __syncthreads();

  // the patches: forward and dz1 (nrg x npc of kPR x kPC), g2 (ngj x ngc
  // of kGJ x kGC; h1 index j < h, dz2 index j' < h: its ones row comes
  // from the column pass), g1 (nkb x npc of kG1K x 4)
  const int nrg = rows / kPR;
  const int nrow = nrg * npc;
  const int ngj = ceil_div(h, kGJ);
  const int ngc = ceil_div(h, kGC);
  const int ng2 = ngj * ngc;
  const bool g2reg = ng2 <= kThreads;   // one patch a thread: in registers
  const int nkb = ceil_div(d1, kG1K);
  const int ng1 = nkb * npc;
  const bool g1reg = ng1 <= kThreads;   // one patch a thread: in registers
  const int kc1 = ceil_div(d1, 4);
  const int kc2 = ceil_div(h + 1, 4);
  const int kcb = ceil_div(h, 4);
  const int half = rows / 2;
  const float* const nocol[kPC] = {W2, W2, W2, W2};
  // Adam's walk: this thread's first element and its step, in rows of h
  const int ar0 = tid / h;
  const int ac0 = tid - ar0 * h;
  const int adr = kThreads / h;
  const int adc = kThreads - adr * h;
  float g2acc[kGJ][kGC];
  float acc[kPR][kPC];
  float g1acc[kG1K][4];

  for (int it = 0; it < hp.iters; ++it) {
#pragma unroll
    for (int a = 0; a < kGJ; ++a) {
#pragma unroll
      for (int b = 0; b < kGC; ++b) g2acc[a][b] = 0.0f;
    }
#pragma unroll
    for (int a = 0; a < kG1K; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) g1acc[a][b] = 0.0f;
    }

    for (int r0 = 0; r0 < T; r0 += rows) {
      const float* X = Xs + (whole ? r0 : 0) * ldx;
      const float* RET = RETs + (whole ? r0 : 0);
      if (!whole) {
        // @phase X tile
        load_rows(r0, rows);
        // @phase barriers
        __syncthreads();
      }

      // @phase forward layer 1
      for (int p = tid; p < nrow; p += kThreads) {
        const int i = p / npc;
        const int c = p - i * npc;
        row_patch<false>(X + kPR * i * ldx, ldx, W1 + kPC * c, ldw, nocol,
                         kc1, acc);
        const bool full = kPC * c + kPC <= h;
#pragma unroll
        for (int a = 0; a < kPR; ++a) {
          float y[kPC];
#pragma unroll
          for (int b = 0; b < kPC; ++b) y[b] = tanhf(acc[a][b]);
          float* dst = H1 + (kPR * i + a) * ldh + kPC * c;
          if (full) {
            *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2],
                                                          y[3]);
          } else {
#pragma unroll
            for (int b = 0; b < kPC; ++b) {
              if (kPC * c + b < h) dst[b] = y[b];
            }
          }
        }
      }
      // @phase barriers
      __syncthreads();

      // @phase forward layer 2
      for (int p = tid; p < nrow; p += kThreads) {
        const int i = p / npc;
        const int c = p - i * npc;
        row_patch<false>(H1 + kPR * i * ldh, ldh, W2 + kPC * c, ldw, nocol,
                         kc2, acc);
        const bool full = kPC * c + kPC <= h;
        float wv[kPC];
#pragma unroll
        for (int b = 0; b < kPC; ++b) {
          wv[b] = kPC * c + b < h ? w3[kPC * c + b] : 0.0f;
        }
#pragma unroll
        for (int a = 0; a < kPR; ++a) {
          float y[kPC];
          float pv = 0.0f;
#pragma unroll
          for (int b = 0; b < kPC; ++b) {
            y[b] = tanhf(acc[a][b]);
            pv = fmaf(y[b], wv[b], pv);
          }
          const int r = kPR * i + a;
          float* dst = S + r * ldh + kPC * c;
          if (full) {
            *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2],
                                                          y[3]);
          } else {
#pragma unroll
            for (int b = 0; b < kPC; ++b) {
              if (kPC * c + b < h) dst[b] = y[b];
            }
          }
          PV[r * npc + c] = pv;
        }
      }
      // @phase barriers
      __syncthreads();

      // @phase v, dv
      // v = [h2 1] w3, dv = (2/T)(v - ret); 0 on padding rows
      for (int r = tid; r < rows; r += kThreads) {
        float v = 0.0f;
        for (int c = 0; c < npc; ++c) v += PV[r * npc + c];
        v += w3[h];
        DV[r] = r0 + r < T ? hp.two_over_t * (v - RET[r]) : 0.0f;
      }
      // @phase barriers
      __syncthreads();

      // @phase dz2, g3
      // by columns, two lanes a column (one half of the rows each):
      // dz2 = dv w3^T (1 - h2^2) in place of h2; g2's ones row += the
      // column sums of dz2; g3 += h2^T dv (column h: the sum of dv)
      for (int base = 0; base < 2 * (h + 1); base += kThreads) {
        const int n = (base + tid) >> 1;
        const int part = (base + tid) & 1;
        float cs = 0.0f;
        float g3s = 0.0f;
        if (n < h) {
          const float wn = w3[n];
          // kDz rows loaded before they are stored (as in dz1's epilogue)
          for (int r0 = part * half; r0 < (part + 1) * half; r0 += kDz) {
            float y[kDz];
            float dvr[kDz];
#pragma unroll
            for (int u = 0; u < kDz; ++u) {
              y[u] = S[(r0 + u) * ldh + n];
              dvr[u] = DV[r0 + u];
            }
#pragma unroll
            for (int u = 0; u < kDz; ++u) {
              const float dz = dvr[u] * wn * (1.0f - y[u] * y[u]);
              S[(r0 + u) * ldh + n] = dz;
              cs += dz;
              g3s = fmaf(y[u], dvr[u], g3s);
            }
          }
        } else if (n == h) {
          for (int r = part * half; r < (part + 1) * half; ++r) g3s += DV[r];
        }
        cs += __shfl_xor_sync(0xffffffffu, cs, 1);
        g3s += __shfl_xor_sync(0xffffffffu, g3s, 1);
        if (part == 0 && n <= h) {
          if (n < h) G[n1 + h * h + n] += cs;
          G[n1 + n2 + n] += g3s;
        }
      }
      // @phase barriers
      __syncthreads();

      // @phase g2
      // g2 += h1^T dz2 over the tile's rows, a 4 x 10 patch a thread
      for (int p = tid; p < ng2; p += kThreads) {
        const int gj = p / ngc;
        const int gc = p - gj * ngc;
        if (!g2reg) {
#pragma unroll
          for (int a = 0; a < kGJ; ++a) {
#pragma unroll
            for (int b = 0; b < kGC; ++b) g2acc[a][b] = 0.0f;
          }
        }
        const float* ap = H1 + kGJ * gj;
        const float* bp = S + kGC * gc;
#pragma unroll 5
        for (int r = 0; r < rows; ++r) {
          const float4 av = ld4(ap + r * ldh);
          const float a4[kGJ] = {av.x, av.y, av.z, av.w};
          float bv[kGC];
#pragma unroll
          for (int q = 0; q < kGC / 2; ++q) {
            const float2 t = ld2(bp + r * ldh + 2 * q);
            bv[2 * q] = t.x;
            bv[2 * q + 1] = t.y;
          }
#pragma unroll
          for (int a = 0; a < kGJ; ++a) {
#pragma unroll
            for (int b = 0; b < kGC; ++b) {
              g2acc[a][b] = fmaf(a4[a], bv[b], g2acc[a][b]);
            }
          }
        }
        if (!g2reg) {
#pragma unroll
          for (int a = 0; a < kGJ; ++a) {
#pragma unroll
            for (int b = 0; b < kGC; ++b) {
              const int j = kGJ * gj + a;
              const int jp = kGC * gc + b;
              if (j < h && jp < h) G[n1 + j * h + jp] += g2acc[a][b];
            }
          }
        }
      }
      // @phase barriers
      __syncthreads();

      // @phase dz1
      // dz1 = (dz2 W2[:h]^T)(1 - h1^2) in place of h1; the patch's
      // columns npc apart
      for (int p = tid; p < nrow; p += kThreads) {
        const int i = p / npc;
        const int c = p - i * npc;
        const float* bcol[kPC];
#pragma unroll
        for (int b = 0; b < kPC; ++b) {
          const int j = c + npc * b;
          bcol[b] = W2 + (j < h ? j : 0) * ldw;
        }
        row_patch<true>(S + kPR * i * ldh, ldh, W2, 0, bcol, kcb, acc);
        // every h1 of the patch is loaded before any dz1 is stored: the
        // compiler cannot tell the rows apart and would wait for each
        // store before the next load
        float* patch = H1 + kPR * i * ldh + c;
        float y[kPR][kPC];
#pragma unroll
        for (int a = 0; a < kPR; ++a) {
#pragma unroll
          for (int b = 0; b < kPC; ++b) {
            y[a][b] = c + npc * b < h ? patch[a * ldh + npc * b] : 0.0f;
          }
        }
#pragma unroll
        for (int a = 0; a < kPR; ++a) {
#pragma unroll
          for (int b = 0; b < kPC; ++b) {
            if (c + npc * b < h) {
              patch[a * ldh + npc * b] =
                  acc[a][b] * (1.0f - y[a][b] * y[a][b]);
            }
          }
        }
      }
      // @phase barriers
      __syncthreads();

      // @phase g1
      // g1 += X^T dz1 over the tile's rows, kG1K x 4 a thread
      for (int p = tid; p < ng1; p += kThreads) {
        const int c = p % npc;
        const int kb = p / npc;
        if (!g1reg) {
#pragma unroll
          for (int a = 0; a < kG1K; ++a) {
#pragma unroll
            for (int b = 0; b < 4; ++b) g1acc[a][b] = 0.0f;
          }
        }
        const float* xp = X + kG1K * kb;
        const float* dp = H1 + 4 * c;
#pragma unroll 5
        for (int r = 0; r < rows; ++r) {
          const float4 t = ld4(dp + r * ldh);
#pragma unroll
          for (int a = 0; a < kG1K; ++a) {
            const float x = xp[r * ldx + a];
            g1acc[a][0] = fmaf(x, t.x, g1acc[a][0]);
            g1acc[a][1] = fmaf(x, t.y, g1acc[a][1]);
            g1acc[a][2] = fmaf(x, t.z, g1acc[a][2]);
            g1acc[a][3] = fmaf(x, t.w, g1acc[a][3]);
          }
        }
        if (!g1reg) {
#pragma unroll
          for (int a = 0; a < kG1K; ++a) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int k = kG1K * kb + a;
              if (k < d1 && 4 * c + b < h) G[k * h + 4 * c + b] += g1acc[a][b];
            }
          }
        }
      }
      // @phase barriers
      __syncthreads();
    }

    // @phase gradient out
    if (g1reg && tid < ng1) {
      const int c = tid % npc;
      const int kb = tid / npc;
#pragma unroll
      for (int a = 0; a < kG1K; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = kG1K * kb + a;
          if (k < d1 && 4 * c + b < h) G[k * h + 4 * c + b] = g1acc[a][b];
        }
      }
    }
    if (g2reg && tid < ng2) {
      const int gj = tid / ngc;
      const int gc = tid - gj * ngc;
#pragma unroll
      for (int a = 0; a < kGJ; ++a) {
#pragma unroll
        for (int b = 0; b < kGC; ++b) {
          const int j = kGJ * gj + a;
          const int jp = kGC * gc + b;
          if (j < h && jp < h) G[n1 + j * h + jp] = g2acc[a][b];
        }
      }
    }
    // @phase barriers
    __syncthreads();

    // @phase Adam
    // Adam at t = count + it + 1; moments from the inputs on the first
    // iteration, from the outputs after it (each thread keeps its
    // elements).  kAdam elements a thread at a time, their moments all
    // loaded before any is stored (the loads and stores may name the same
    // arrays, so the compiler would not hoist a load above a store); the
    // divisions and the square root by their exact fast paths
    // (critic_adam.cuh), `/` and sqrtf where an operand is out of their
    // range.
    const float t = static_cast<float>(c0 + it + 1);
    const float bc1 = 1.0f - expf(t * hp.lb1);
    const float bc2 = 1.0f - expf(t * hp.lb2);
    const float* msrc = it == 0 ? mu_in : mu_out;
    const float* vsrc = it == 0 ? nu_in : nu_out;
    const AdamScalars as = adam_scalars(bc1, bc2, hp.eps);
    int ar = ar0;
    int ac = ac0;
    for (int i0 = tid; i0 < P; i0 += kThreads * kAdam) {
      // @phase Adam loads
      float mo[kAdam];
      float vo[kAdam];
      float step[kAdam];
      float th[kAdam];
      int at[kAdam];
#pragma unroll
      for (int u = 0; u < kAdam; ++u) {
        const int i = i0 + u * kThreads;
        mo[u] = i < P ? msrc[pbase + i] : 0.0f;
        vo[u] = i < P ? vsrc[pbase + i] : 1.0f;
      }
      // @phase Adam steps
      bool bad = !as.ok;
#pragma unroll
      for (int u = 0; u < kAdam; ++u) {
        const int i = i0 + u * kThreads;
        at[u] = walk_offset(ar, ac, d1, h, ldw, L.w2, L.w3);
        ac += adc;
        ar += adr;
        if (ac >= h) {
          ac -= h;
          ++ar;
        }
        const float g = i < P ? G[i] : 0.0f;
        th[u] = i < P ? theta[at[u]] : 0.0f;
        const float m = hp.b1 * mo[u] + hp.omb1 * g;
        const float v = hp.b2 * vo[u] + hp.omb2 * g * g;
        mo[u] = m;
        vo[u] = v;
        bool off = false;
        step[u] = adam_step(m, v, as, off);
        bad |= i < P && off;
      }
      if (bad) {
#pragma unroll
        for (int u = 0; u < kAdam; ++u) {
          step[u] = (mo[u] / bc1) / (sqrtf(vo[u] / bc2) + hp.eps);
        }
      }
      // @phase Adam stores
#pragma unroll
      for (int u = 0; u < kAdam; ++u) {
        const int i = i0 + u * kThreads;
        if (i < P) {
          mu_out[pbase + i] = mo[u];
          nu_out[pbase + i] = vo[u];
          theta[at[u]] = th[u] - hp.lr * step[u];
          G[i] = 0.0f;
        }
      }
    }
    // @phase barriers
    __syncthreads();
  }

  for (int i = tid; i < P; i += kThreads) {
    theta_out[pbase + i] = theta[param_offset(i, d1, h, ldw, L.w2, L.w3)];
  }
  if (tid == 0) count_out[agent] = c0 + hp.iters;
}

}  // namespace

// C entry, bound with ctypes.  theta, mu, nu: (A, P) float32; count (A,)
// int32; obs (A, T, d1 - 1); rets (A, T); the outputs alike, all on
// `device`.  The scalars are float32 as the plain version rounds them:
// lr, beta1, 1 - beta1, beta2, 1 - beta2, log beta1, log beta2, eps, 2 / T.
// Launches on `stream` and does not synchronise.  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue when not even
// a tile of kPR rows fits in a block's shared memory beside the parameters
// and their gradient, or the error of cudaFuncSetAttribute.
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
  int rows = 0;
  int ldw = 0;
  int xrows = 0;
  if (h < 1 || d1 < 1 || T < 1 || iters < 0 ||
      !choose_layout(d1, h, T, &rows, &ldw, &xrows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      4 * static_cast<size_t>(Layout(d1, h, rows, ldw, xrows).total);
  err = cudaFuncSetAttribute(critic_train_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Hyper hp{d1, h, T, iters, rows, ldw, xrows, lr, b1, omb1, b2, omb2,
                 lb1, lb2, eps, two_over_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  critic_train_kernel<<<A, kThreads, smem, s>>>(theta, mu, nu, count, obs,
                                                rets, theta_out, mu_out,
                                                nu_out, count_out, hp);
  return static_cast<int>(cudaGetLastError());
}
