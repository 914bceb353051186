// Whole-trajectory PPO rollout — actor MLP, env transition and transfer
// fidelity for T steps — one block per agent, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel code_robchar_tpu/ops/pallas_rollout.py
// make_actor_env_rollout (body _step_math): for every agent and step s,
//
//   obs   = (action, t)                         the carry, d = n + 1 floats
//   mu    = W3 tanh(W2 tanh(W1 obs + b1) + b2) + b3      (d -> h -> h -> d)
//   a     = mu + exp(log_std) * eps[s]
//   raw   = action + a[:n]; the whole vector wraps, raw % (sign(raw) bmax),
//           when any |raw_k| > bmax (floor remainder, as jnp's %)
//   t'    = |t + a[n]|, taken mod maxtime above maxtime; done = t' > t + a[n]
//   H     = h0 + diag(action' [+ zdiag[s]]) [+ znn[s] on the off-diagonals]
//   fid   = |<out| exp(-i t' H) |in>|^2                 (symmetric Jacobi)
//   timeout = (ep + 1 == max_ep_len); on done or timeout the carry resets
//
// with the arithmetic of the plain torch version
// (code_robchar_tpu_torch/ops/rollout.py actor_env_rollout_plain,
// order="roundrobin"), whose Jacobi is that of sym_jacobi_amp.cu
// (jacobi_common.cuh SymState, the same round-robin schedule).
//
// What bounds it on the H100.  The work is ~30k flops per agent-step at
// n = 7, h = 100 (the MLP's 11.6k MACs and ~6.3k flops of Jacobi): at
// A = 1024, T = 500, 15 GFLOP, 0.23 ms at the float32 peak; the bytes
// (the weights once, the noise in and the trajectory out, ~130 MB) take
// 0.04 ms.  What actually bounds it is latency: each agent's T steps are a
// dependent chain through the MLP, and one agent's per-agent weights share
// no product with another's.
//
// What the design does about it.
// - The fidelity does not feed the chain: the next obs is (action', t'),
//   and done / timeout depend on t' and the episode length only.  So the
//   block runs the chain first (phase 1: MLP, wrap, bookkeeping, writing
//   a, obs2, done and timeout), and then all its threads run the T Jacobi
//   diagonalisations in parallel, one step per thread (phase 2), reading
//   the action' and t' they need back from obs2.  The serial chain per step
//   is the MLP alone.
// - The agent's weights (~47 KB at h = 100: W1 (d+1, h), W2 (h+1, h),
//   W3 (h+1, d), bias as the last row) go into shared memory once, as the
//   TPU kernel DMA's them into VMEM once per agent tile; the activations
//   live in shared memory; thread j computes hidden unit j, reading W[k][j]
//   (consecutive threads, consecutive addresses) and broadcasting h[k].
// - The Jacobi state (the lower triangle and the in and out rows of V) is
//   held in registers with compile-time indices: the matrix size n is the
//   template parameter N (2..10), as in the other Jacobi kernels.
//
// Two instances.  The generic one (actor_env_rollout_kernel, any h that
// fits) keeps W2 in shared memory, one hidden unit a thread, and crosses
// four block barriers a step; layer 3 runs on D threads as 100-term serial
// chains and thread 0 alone wraps.  Measured at the PPO path's width (h =
// 100, A = 1024, T = 500, H100): ~5,600 clocks a step, layers 2 and 3 74%
// of them.  The path's width h = kRegHidden has
// actor_env_rollout_reg_kernel: h a compile-time constant, each thread's
// column of W2 in registers, every warp computing layer 3 and the wrap
// itself, two barriers a step (its note below).  Each kernel has its own C
// entry at the end of the file: the caller picks the kernel.
//
// Layout: weights agent-major (A, rows, cols); carry action (n, A), t (A,),
// ep (A,) int32; streams and trajectory (T, feat, A), done and timeout
// (T, A) as bytes (torch.bool).  Precision: IEEE division and sqrtf, tanhf,
// expf, sinf/cosf with full range reduction; build without --use_fast_math.

#include <cuda_runtime.h>

#include <cstdint>

#include "jacobi_common.cuh"

namespace {

// jnp.remainder and torch.remainder for floats: the C remainder, moved by
// one divisor when its sign differs from the divisor's
__device__ __forceinline__ float floor_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r += y;
  return r;
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

struct Streams {
  const float* eps;     // (T, N+1, A)
  const float* zdiag;   // (T, N, A), read when NOISY
  const float* znn;     // (T, N-1, A), read when NOISY
  float* a;             // (T, N+1, A)
  float* fid;           // (T, A)
  float* obs2;          // (T, N+1, A)
  unsigned char* done;  // (T, A)
  unsigned char* tto;   // (T, A)
};

struct Scalars {
  int h, in_spin, out_spin, sweeps, max_ep_len, T, A;
  float eps_rot, bmax, maxtime;
};

constexpr int kMaxThreads = 256;

template <int N, bool NOISY>
__global__ void __launch_bounds__(kMaxThreads) actor_env_rollout_kernel(
    const float* __restrict__ w1, const float* __restrict__ w2,
    const float* __restrict__ w3, const float* __restrict__ log_std,
    const float* __restrict__ h0, const float* __restrict__ act_in,
    const float* __restrict__ t_in, const int* __restrict__ ep_in,
    Streams io, float* __restrict__ act_out, float* __restrict__ t_out,
    int* __restrict__ ep_out, Scalars sc) {
  constexpr int D = N + 1;
  const int h = sc.h;
  const int A = sc.A;
  const int agent = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  extern __shared__ float smem[];
  float* sw1 = smem;                    // (D + 1) x h
  float* sw2 = sw1 + (D + 1) * h;       // (h + 1) x h
  float* sw3 = sw2 + (h + 1) * h;       // (h + 1) x D
  float* sh1 = sw3 + (h + 1) * D;       // h
  float* sh2 = sh1 + h;                 // h
  __shared__ float s_obs[D];            // the carry (action, t)
  __shared__ float s_a[D];              // this step's action sample
  __shared__ float s_std[D];
  __shared__ float s_h0[N * N];

  const int64_t n1 = static_cast<int64_t>(D + 1) * h;
  const int64_t n2 = static_cast<int64_t>(h + 1) * h;
  const int64_t n3 = static_cast<int64_t>(h + 1) * D;
  for (int64_t i = tid; i < n1; i += nthr) sw1[i] = w1[agent * n1 + i];
  for (int64_t i = tid; i < n2; i += nthr) sw2[i] = w2[agent * n2 + i];
  for (int64_t i = tid; i < n3; i += nthr) sw3[i] = w3[agent * n3 + i];
  for (int i = tid; i < N * N; i += nthr) s_h0[i] = h0[i];
  if (tid < D) {
    s_std[tid] = expf(log_std[static_cast<int64_t>(agent) * D + tid]);
  }
  if (tid < N) s_obs[tid] = act_in[static_cast<int64_t>(tid) * A + agent];
  if (tid == 0) s_obs[N] = t_in[agent];
  int ep = ep_in[agent];                // used by thread 0
  __syncthreads();
  // @phase load

  // ---- phase 1: the dependent chain, step by step ----
  for (int s = 0; s < sc.T; ++s) {
    for (int j = tid; j < h; j += nthr) {
      float z = sw1[N * h + j] * s_obs[N] + sw1[D * h + j];
#pragma unroll
      for (int k = 0; k < N; ++k) z = z + sw1[k * h + j] * s_obs[k];
      sh1[j] = tanhf(z);
    }
    // @phase layer 1
    __syncthreads();
    // @phase barriers
    for (int j = tid; j < h; j += nthr) {
      float z = sw2[h * h + j];
      for (int k = 0; k < h; ++k) z = z + sw2[k * h + j] * sh1[k];
      sh2[j] = tanhf(z);
    }
    // @phase layer 2
    __syncthreads();
    // @phase barriers
    for (int j = tid; j < D; j += nthr) {
      float mu = sw3[h * D + j];
      for (int k = 0; k < h; ++k) mu = mu + sw3[k * D + j] * sh2[k];
      const int64_t at = (static_cast<int64_t>(s) * D + j) * A + agent;
      const float a = mu + s_std[j] * io.eps[at];
      s_a[j] = a;
      io.a[at] = a;
    }
    // @phase layer 3
    __syncthreads();
    // @phase barriers
    if (tid == 0) {
      float raw[N];
      bool over = false;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        raw[k] = s_obs[k] + s_a[k];
        over = over || fabsf(raw[k]) > sc.bmax;
      }
      const float raw_t = s_obs[N] + s_a[N];
      const float abs_t = fabsf(raw_t);
      const float tt = abs_t > sc.maxtime ? floor_mod(abs_t, sc.maxtime)
                                          : abs_t;
      const bool done = tt > raw_t;
      const int ep1 = ep + 1;
      const bool tto = ep1 == sc.max_ep_len;
      const bool term = done || tto;
      const int64_t row = static_cast<int64_t>(s) * A + agent;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float den = sign_of(raw[k]) * sc.bmax
                          + (raw[k] == 0.0f ? 1.0f : 0.0f);
        const float na = over ? floor_mod(raw[k], den) : raw[k];
        io.obs2[(static_cast<int64_t>(s) * D + k) * A + agent] = na;
        s_obs[k] = term ? 0.0f : na;
      }
      io.obs2[(static_cast<int64_t>(s) * D + N) * A + agent] = tt;
      io.done[row] = done;
      io.tto[row] = tto;
      s_obs[N] = term ? 0.0f : tt;
      ep = term ? 0 : ep1;
    }
    // @phase wrap
    __syncthreads();
    // @phase barriers
  }
  if (tid < D) {
    if (tid < N) act_out[static_cast<int64_t>(tid) * A + agent] = s_obs[tid];
    else t_out[agent] = s_obs[N];
  }
  if (tid == 0) ep_out[agent] = ep;

  // ---- phase 2: the T transfer fidelities, one step per thread; obs2 of
  // this agent was written by this block before the barrier above ----
  for (int s = tid; s < sc.T; s += nthr) {
    jacobi::SymState<N, 2> st;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float add = io.obs2[(static_cast<int64_t>(s) * D + i) * A + agent];
      if (NOISY) {
        add = add + io.zdiag[(static_cast<int64_t>(s) * N + i) * A + agent];
      }
      st.d[i] = s_h0[i * N + i] + add;
#pragma unroll
      for (int j = 0; j < i; ++j) {
        float x = s_h0[i * N + j];
        if (NOISY && j == i - 1) {
          x = x + io.znn[(static_cast<int64_t>(s) * (N - 1) + j) * A + agent];
        }
        st.l[jacobi::tri(i, j)] = x;
      }
      st.v[0][i] = (i == sc.in_spin) ? 1.0f : 0.0f;
      st.v[1][i] = (i == sc.out_spin) ? 1.0f : 0.0f;
    }
    jacobi::jacobi_sweeps<N>(st, sc.sweeps, sc.eps_rot);
    const float tt = io.obs2[(static_cast<int64_t>(s) * D + N) * A + agent];
    float phr = 0.0f;
    float phi = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float w = st.v[0][k] * st.v[1][k];
      const float ang = st.d[k] * tt;
      phr = phr + w * cosf(ang);
      phi = phi - w * sinf(ang);
    }
    io.fid[static_cast<int64_t>(s) * A + agent] = phr * phr + phi * phi;
  }
  // @phase jacobi
}

// ---- the path's width: h = kRegHidden, each thread's W2 column in registers

// the hidden width of the kernel below (the PPO path's actor, (100, 100);
// ops/rollout.py REG_HIDDEN); the other widths take the kernel above
constexpr int kRegHidden = 100;
constexpr int kRegThreads = 128;
// blocks an SM holds by the kernel's registers (at most 168 a thread)
constexpr int kRegBlocksPerSm = 3;

// outputs of layer 3 that one warp reduces side by side: the smallest power
// of two >= D (so 32 / kSlots lanes end up holding each output)
constexpr int kMaxSlots = 16;
template <int D>
struct OutSlots {
  static constexpr int kSlots = D <= 4 ? 4 : (D <= 8 ? 8 : 16);
  static constexpr int kLanes = 32 / kSlots;
  static_assert(D <= 16, "at most 16 outputs");
};

// Reduce-scatter of SL partial sums over the 32 lanes of a warp: at each
// level a lane keeps half of its block of outputs and adds its partner's
// partial sums of them (lane ^ 16, then ^ 8, ...), then the lanes that hold
// one output sum among themselves; lane L ends with the total of output
// L / (32 / SL).  SL - 1 + log2(32 / SL) shuffles instead of 5 SL.
template <int SL>
__device__ __forceinline__ float reduce_outputs(float (&v)[SL], int lane) {
#pragma unroll
  for (int half = SL / 2, mask = 16; half >= 1; half /= 2, mask /= 2) {
    const bool up = (lane & mask) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(jacobi::kFullMask, send, mask);
    }
  }
  float x = v[0];
#pragma unroll
  for (int mask = 16 / SL; mask >= 1; mask /= 2) {
    x = x + __shfl_xor_sync(jacobi::kFullMask, x, mask);
  }
  return x;
}

// The same rollout, shaped for the path's width H (a compile-time constant,
// so every loop over the hidden units unrolls).  A step crosses two block
// barriers, not four:
// - layer 1: thread j < H computes unit j from the carry, which every
//   thread holds in registers;                                    barrier
// - layers 2 and 3: thread j < H computes unit j of layer 2 from its column
//   of W2, held in registers (H + 1 of them: no shared-memory load per
//   product), in four independent partial sums over h1 read as float4
//   broadcasts, then multiplies it into its row of W3, also in registers;
//   a reduce-scatter sums the D products over the warp's lanes, and each
//   warp leaves its D partial sums in shared memory;             barrier
// - every warp adds the four warps' partial sums (in one fixed order) and
//   computes the noise, the wrap and the bookkeeping itself, the same
//   arithmetic in the same order, so every thread has the next carry
//   without a barrier: output lane o adds exp(log_std) times its noise
//   (loaded one step ahead), D shuffles give every lane the whole action,
//   and the wrap and the time modulus are taken in every lane (floor_mod
//   of an action coordinate, on the rare steps whose vector wraps, by its
//   own lane and a second round of shuffles).  Warp 0 alone stores a,
//   obs2, done and timeout.
// Registers: the W2 column, the W3 row and ~40 others, <= 168 by the launch
// bounds, so an SM holds 3 blocks.  Then the T fidelities as in the kernel
// above, by the hoisted, branch-free sweep (jacobi_common.cuh
// hoisted_sweeps: each pivot's angle chain overlaps the previous rotation;
// the same bits as jacobi_sweeps).
template <int N, bool NOISY, int H>
__global__ void __launch_bounds__(kRegThreads, kRegBlocksPerSm)
actor_env_rollout_reg_kernel(
    const float* __restrict__ w1, const float* __restrict__ w2,
    const float* __restrict__ w3, const float* __restrict__ log_std,
    const float* __restrict__ h0, const float* __restrict__ act_in,
    const float* __restrict__ t_in, const int* __restrict__ ep_in,
    Streams io, float* __restrict__ act_out, float* __restrict__ t_out,
    int* __restrict__ ep_out, Scalars sc) {
  constexpr int D = N + 1;
  constexpr int SL = OutSlots<D>::kSlots;
  constexpr int LPO = OutSlots<D>::kLanes;
  constexpr int W = kRegThreads / 32;
  static_assert(H % 4 == 0 && H <= kRegThreads, "hidden width");
  const int A = sc.A;
  const int T = sc.T;
  const int agent = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int o = lane / LPO;             // the output this lane ends with
  const bool out_lane = o < D;

  __shared__ __align__(16) float sh1[H];
  __shared__ float sw1[(D + 1) * H];    // W1, bias last
  __shared__ float s_part[W][kMaxSlots];
  __shared__ float s_h0[N * N];

  const float* w1a = w1 + static_cast<int64_t>(agent) * (D + 1) * H;
  for (int i = tid; i < (D + 1) * H; i += kRegThreads) sw1[i] = w1a[i];
  for (int i = tid; i < N * N; i += kRegThreads) s_h0[i] = h0[i];
  float w2c[H + 1];                     // column tid of W2, bias last
  const float* w2a = w2 + static_cast<int64_t>(agent) * (H + 1) * H;
#pragma unroll
  for (int k = 0; k <= H; ++k) {
    w2c[k] = tid < H ? w2a[static_cast<int64_t>(k) * H + tid] : 0.0f;
  }
  float w3r[D];                         // row tid of W3
  const float* w3a = w3 + static_cast<int64_t>(agent) * (H + 1) * D;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    w3r[j] = tid < H ? w3a[static_cast<int64_t>(tid) * D + j] : 0.0f;
  }
  const float bias_o = out_lane ? w3a[static_cast<int64_t>(H) * D + o] : 0.0f;
  const float std_o =
      out_lane ? expf(log_std[static_cast<int64_t>(agent) * D + o]) : 0.0f;
  float obs[D];                         // the carry (action, t)
#pragma unroll
  for (int k = 0; k < N; ++k) obs[k] = act_in[static_cast<int64_t>(k) * A + agent];
  obs[N] = t_in[agent];
  int ep = ep_in[agent];
  float eps_next = (out_lane && T > 0)
      ? io.eps[static_cast<int64_t>(o) * A + agent] : 0.0f;
  __syncthreads();
  // @phase load

#pragma unroll 1
  for (int s = 0; s < T; ++s) {
    if (tid < H) {
      float z = sw1[N * H + tid] * obs[N] + sw1[D * H + tid];
#pragma unroll
      for (int k = 0; k < N; ++k) z = z + sw1[k * H + tid] * obs[k];
      sh1[tid] = tanhf(z);
    }
    // @phase layer 1
    __syncthreads();
    // @phase barriers
    float part[SL];
#pragma unroll
    for (int j = 0; j < SL; ++j) part[j] = 0.0f;
    if (tid < H) {
      const float4* h4 = reinterpret_cast<const float4*>(sh1);
      float z0 = 0.0f, z1 = 0.0f, z2 = 0.0f, z3 = 0.0f;
#pragma unroll
      for (int k = 0; k < H; k += 4) {
        const float4 x = h4[k / 4];
        z0 = fmaf(w2c[k], x.x, z0);
        z1 = fmaf(w2c[k + 1], x.y, z1);
        z2 = fmaf(w2c[k + 2], x.z, z2);
        z3 = fmaf(w2c[k + 3], x.w, z3);
      }
      const float h2 = tanhf(w2c[H] + ((z0 + z1) + (z2 + z3)));
#pragma unroll
      for (int j = 0; j < D; ++j) part[j] = w3r[j] * h2;
    }
    // @phase layer 2
    const float red = reduce_outputs<SL>(part, lane);
    if (out_lane && lane % LPO == 0) s_part[warp][o] = red;
    // @phase layer 3
    __syncthreads();
    // @phase barriers

    float sum = out_lane ? s_part[0][o] : 0.0f;
#pragma unroll
    for (int w = 1; w < W; ++w) sum = sum + (out_lane ? s_part[w][o] : 0.0f);
    const float a = (bias_o + sum) + std_o * eps_next;
    eps_next = (out_lane && s + 1 < T)
        ? io.eps[(static_cast<int64_t>(s + 1) * D + o) * A + agent] : 0.0f;
    float raw[D];                       // the raw action and time, all lanes
    bool over = false;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      raw[j] = obs[j] + __shfl_sync(jacobi::kFullMask, a, j * LPO);
      if (j < N) over = over || fabsf(raw[j]) > sc.bmax;
    }
    const float abs_t = fabsf(raw[N]);
    const float tt = abs_t > sc.maxtime ? floor_mod(abs_t, sc.maxtime)
                                        : abs_t;
    const bool done = tt > raw[N];
    const int ep1 = ep + 1;
    const bool tto = ep1 == sc.max_ep_len;
    const bool term = done || tto;
    if (over) {                         // the same in every lane
      float mine = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) mine = (o == j) ? raw[j] : mine;
      const float den = sign_of(mine) * sc.bmax + (mine == 0.0f ? 1.0f : 0.0f);
      const float wrapped = floor_mod(mine, den);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        raw[j] = __shfl_sync(jacobi::kFullMask, wrapped, j * LPO);
      }
    }
    raw[N] = tt;                        // raw is now obs2
    if (tid < 32 && out_lane && lane % LPO == 0) {
      float val = raw[0];
#pragma unroll
      for (int j = 1; j < D; ++j) val = (o == j) ? raw[j] : val;
      const int64_t at = (static_cast<int64_t>(s) * D + o) * A + agent;
      io.a[at] = a;
      io.obs2[at] = val;
    }
    if (tid == 0) {
      const int64_t row = static_cast<int64_t>(s) * A + agent;
      io.done[row] = done;
      io.tto[row] = tto;
    }
#pragma unroll
    for (int j = 0; j < D; ++j) obs[j] = term ? 0.0f : raw[j];
    ep = term ? 0 : ep1;
    // @phase wrap
  }
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) act_out[static_cast<int64_t>(k) * A + agent] = obs[k];
    t_out[agent] = obs[N];
    ep_out[agent] = ep;
  }
  // obs2 of this agent, written by warp 0 above, is read back below
  __syncthreads();

  for (int s = tid; s < T; s += kRegThreads) {
    jacobi::SymState<N, 2> st;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float add = io.obs2[(static_cast<int64_t>(s) * D + i) * A + agent];
      if (NOISY) {
        add = add + io.zdiag[(static_cast<int64_t>(s) * N + i) * A + agent];
      }
      st.d[i] = s_h0[i * N + i] + add;
#pragma unroll
      for (int j = 0; j < i; ++j) {
        float x = s_h0[i * N + j];
        if (NOISY && j == i - 1) {
          x = x + io.znn[(static_cast<int64_t>(s) * (N - 1) + j) * A + agent];
        }
        st.l[jacobi::tri(i, j)] = x;
      }
      st.v[0][i] = (i == sc.in_spin) ? 1.0f : 0.0f;
      st.v[1][i] = (i == sc.out_spin) ? 1.0f : 0.0f;
    }
    jacobi::hoisted_sweeps<N>(st, sc.sweeps, sc.eps_rot);
    const float tt = io.obs2[(static_cast<int64_t>(s) * D + N) * A + agent];
    float phr = 0.0f;
    float phi = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float w = st.v[0][k] * st.v[1][k];
      const float ang = st.d[k] * tt;
      phr = phr + w * cosf(ang);
      phi = phi - w * sinf(ang);
    }
    io.fid[static_cast<int64_t>(s) * A + agent] = phr * phr + phi * phi;
  }
  // @phase jacobi
}

template <int N, bool NOISY, int H>
cudaError_t launch_reg(const float* w1, const float* w2, const float* w3,
                       const float* ls, const float* h0, const float* act_in,
                       const float* t_in, const int* ep_in, const Streams& io,
                       float* act_out, float* t_out, int* ep_out,
                       const Scalars& sc, cudaStream_t stream) {
  // all of its shared memory is static: h1, W1, the warps' partial sums of
  // layer 3 and h0
  actor_env_rollout_reg_kernel<N, NOISY, H><<<sc.A, kRegThreads, 0, stream>>>(
      w1, w2, w3, ls, h0, act_in, t_in, ep_in, io, act_out, t_out, ep_out,
      sc);
  return cudaGetLastError();
}

template <int N, bool NOISY>
cudaError_t launch(bool reg, const float* w1, const float* w2,
                   const float* w3, const float* ls, const float* h0,
                   const float* act_in, const float* t_in, const int* ep_in,
                   const Streams& io, float* act_out, float* t_out,
                   int* ep_out, const Scalars& sc, cudaStream_t stream) {
  if (reg) {
    if (sc.h != kRegHidden) return cudaErrorInvalidValue;
    return launch_reg<N, NOISY, kRegHidden>(w1, w2, w3, ls, h0, act_in,
                                            t_in, ep_in, io, act_out, t_out,
                                            ep_out, sc, stream);
  }
  constexpr int D = N + 1;
  const int h = sc.h;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(D + 1) * h + static_cast<size_t>(h + 1) * h
       + static_cast<size_t>(h + 1) * D + 2 * static_cast<size_t>(h));
  auto kernel = actor_env_rollout_kernel<N, NOISY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // one thread per hidden unit, in whole warps (wider layers loop)
  int threads = ((h > D ? h : D) + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  kernel<<<sc.A, threads, smem, stream>>>(w1, w2, w3, ls, h0, act_in, t_in,
                                         ep_in, io, act_out, t_out, ep_out,
                                         sc);
  return cudaGetLastError();
}

template <int N>
cudaError_t dispatch_noise(bool noisy, bool reg, const float* w1,
                           const float* w2, const float* w3, const float* ls,
                           const float* h0, const float* act_in,
                           const float* t_in, const int* ep_in,
                           const Streams& io, float* act_out, float* t_out,
                           int* ep_out, const Scalars& sc,
                           cudaStream_t stream) {
  if (noisy) {
    return launch<N, true>(reg, w1, w2, w3, ls, h0, act_in, t_in, ep_in, io,
                           act_out, t_out, ep_out, sc, stream);
  }
  return launch<N, false>(reg, w1, w2, w3, ls, h0, act_in, t_in, ep_in, io,
                          act_out, t_out, ep_out, sc, stream);
}

int rollout_entry(
    bool reg, const float* w1, const float* w2, const float* w3,
    const float* log_std, const float* h0, const float* act_in,
    const float* t_in, const int* ep_in, const float* eps, const float* zdiag,
    const float* znn, float* a_out, float* fid_out, float* obs2_out,
    unsigned char* done_out, unsigned char* tto_out, float* act_out,
    float* t_out, int* ep_out, int n, int h, int in_spin, int out_spin,
    int sweeps, float eps_rot, float bmax, float maxtime, int max_ep_len,
    int ham_noisy, int T, int A, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (A <= 0) return static_cast<int>(cudaSuccess);
  if (h < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Streams io{eps, zdiag, znn, a_out, fid_out, obs2_out, done_out,
                   tto_out};
  const Scalars sc{h, in_spin, out_spin, sweeps, max_ep_len, T, A, eps_rot,
                   bmax, maxtime};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool noisy = ham_noisy != 0;
#define ROLLOUT_CASE(NN)                                                    \
  case NN:                                                                  \
    return dispatch_noise<NN>(noisy, reg, w1, w2, w3, log_std, h0, act_in,  \
                              t_in, ep_in, io, act_out, t_out, ep_out, sc,  \
                              s);
  switch (n) {
    ROLLOUT_CASE(2)
    ROLLOUT_CASE(3)
    ROLLOUT_CASE(4)
    ROLLOUT_CASE(5)
    ROLLOUT_CASE(6)
    ROLLOUT_CASE(7)
    ROLLOUT_CASE(8)
    ROLLOUT_CASE(9)
    ROLLOUT_CASE(10)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ROLLOUT_CASE
}

}  // namespace

// C entries, bound with ctypes, one a kernel: actor_env_rollout launches
// actor_env_rollout_kernel (any h whose weights fit in a block's shared
// memory), actor_env_rollout_reg the kernel of the path's width (h must be
// kRegHidden).  Shapes in the note above (d = n + 1); zdiag and znn may be
// null when ham_noisy is 0.  All pointers on `device`; launches on `stream`
// and does not synchronise.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for n outside 2..10, h < 1, or another h than
// kRegHidden on actor_env_rollout_reg; an error from cudaFuncSetAttribute
// when the weights do not fit in a block's shared memory).
#define ROLLOUT_ENTRY(NAME, REG)                                              \
  extern "C" int NAME(                                                        \
      const float* w1, const float* w2, const float* w3,                      \
      const float* log_std, const float* h0, const float* act_in,             \
      const float* t_in, const int* ep_in, const float* eps,                  \
      const float* zdiag, const float* znn, float* a_out, float* fid_out,     \
      float* obs2_out, unsigned char* done_out, unsigned char* tto_out,       \
      float* act_out, float* t_out, int* ep_out, int n, int h, int in_spin,   \
      int out_spin, int sweeps, float eps_rot, float bmax, float maxtime,     \
      int max_ep_len, int ham_noisy, int T, int A, int device,                \
      void* stream) {                                                         \
    return rollout_entry(REG, w1, w2, w3, log_std, h0, act_in, t_in, ep_in,   \
                         eps, zdiag, znn, a_out, fid_out, obs2_out, done_out, \
                         tto_out, act_out, t_out, ep_out, n, h, in_spin,      \
                         out_spin, sweeps, eps_rot, bmax, maxtime,            \
                         max_ep_len, ham_noisy, T, A, device, stream);        \
  }

ROLLOUT_ENTRY(actor_env_rollout, false)
ROLLOUT_ENTRY(actor_env_rollout_reg, true)
#undef ROLLOUT_ENTRY
