// The Monte-Carlo sweep's draws of one chunk, in the lanes layout, one
// thread per lattice element, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these draws to XLA
// (code_robchar_tpu/mc/engine.py _chunk_kernel_lanes, its vmapped
// jax.random.split / normal and the .at[].add assembly).  The port's plain
// version, prng.fold_in of the chunk's global ids and noise.assemble_lanes
// (ops/mc_draws.draw_lanes_plain), runs them as ~600 int64 torch ops a
// chunk, each a launch and a pass of (B, up to 21) words through HBM; here
// they are one launch that reads a few words per element and writes its
// matrix.
//
// For element b of the chunk (local flat id start + b in the (L, C, B)
// lattice of the controller block, bootstrap axis fastest) the thread
//   1. takes its global id gid = (l * c_global + c + c_offset) * bootreps +
//      rep in 64-bit integers, as mc/engine does, and keeps its low 32 bits
//      only as fold_in's counter (prng.fold_in masks there too);
//   2. runs threefry2x32 (20 rounds, uint32 arithmetic, prng.threefry2x32's
//      rotations and key schedule): fold_in(key, gid) = threefry(key, (0,
//      gid)), then split(., 3)'s first 2 (or, with complex couplings, 3)
//      keys = threefry(k, (0, j)), then the counters 0..n-1 of the diagonal
//      key and 0..n-2 of the coupling keys, a 32-bit draw being the XOR of
//      the two output words;
//   3. turns each draw into prng.normal's float32 normal operation by
//      operation: the mantissa fill, u = f * (hi - lo) + lo clamped at lo
//      with the bounds rounded as prng.uniform rounds them, w =
//      -log1pf(-u * u), XLA's erf_inv polynomial (Giles) in w - 2.5 or
//      sqrt(w) - 3 selected by w < 5, times u, times float32(sqrt 2), times
//      the level's sigma.  Every operation is rounded on its own
//      (__fmul_rn / __fadd_rn): -O3 would contract a product and a sum into
//      one FMA, which the torch ops never do, so the normals are those of
//      the torch route on the card bit for bit;
//   4. writes noise.assemble_lanes's matrix: ar[i][i] = h0[i][i] + (diag_i
//      + x_i), ar[i][i-1] = ar[i-1][i] = h0 + nn_{i-1}, ai[i][i-1] =
//      nn2_{i-1} = -ai[i-1][i], every other ar entry h0 and ai entry 0, and
//      t = |x[n]|.
//
// What bounds it on the H100: the bytes written, 2 n^2 + 1 floats an
// element (99 at n = 7, 52 MB a chunk of 131,072: ~15.5 us at 3.35 TB/s);
// the integer work, 4 + 3n - 2 threefry hashes of ~90 uint32 operations
// (23 at n = 7), comes second.  Measured on the H100 at n = 7: 0.027 ms a
// chunk, 58% of the byte bound, against 7-10 ms for the torch ops.  Writes go with the batch axis fastest
// ((n*n, B) layout), so a warp stores 128 contiguous bytes per entry; the
// draws stay in registers (3n - 2 floats), so the matrix size is a template
// parameter (n = 2..10).  The key words are read from device memory, so a
// chunk needs no host sync, and the ids come as (start, count), so a chunk
// enqueues no index tensors.  Build without --use_fast_math: log1pf and the
// square root must be those of the torch route.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = ((x1 << R) | (x1 >> (32 - R))) ^ x0;
}

// Threefry-2x32, 20 rounds, on the counter (x0, x1) under key (k0, k1).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  mix<17>(x0, x1); mix<29>(x0, x1); mix<16>(x0, x1); mix<24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  mix<17>(x0, x1); mix<29>(x0, x1); mix<16>(x0, x1); mix<24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
}

// The 32-bit draw of counter i under key (k0, k1): both words XORed.
__device__ __forceinline__ uint32_t draw32(uint32_t k0, uint32_t k1,
                                           uint32_t i) {
  uint32_t x0 = 0u;
  uint32_t x1 = i;
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
}

// One Horner step of the torch route, c + p * z, rounded twice.
__device__ __forceinline__ float horner(float p, float z, double c) {
  return __fadd_rn(static_cast<float>(c), __fmul_rn(p, z));
}

// prng.normal at float32 from one 32-bit draw.  The constants are Python's
// doubles cast to float32, as torch casts a scalar operand.
__device__ __forceinline__ float normal(uint32_t bits) {
  const float lo = -0x1.fffffep-1f;       // nextafter(-1, 0)
  const float span = 2.0f;                // float32(1 - lo)
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float u = fmaxf(__fadd_rn(__fmul_rn(f, span), lo), lo);
  const float w = -log1pf(-__fmul_rn(u, u));
  // w < 5
  const float z0 = __fsub_rn(w, 2.5f);
  float p0 = static_cast<float>(2.81022636e-08);
  p0 = horner(p0, z0, 3.43273939e-07);
  p0 = horner(p0, z0, -3.5233877e-06);
  p0 = horner(p0, z0, -4.39150654e-06);
  p0 = horner(p0, z0, 0.00021858087);
  p0 = horner(p0, z0, -0.00125372503);
  p0 = horner(p0, z0, -0.00417768164);
  p0 = horner(p0, z0, 0.246640727);
  p0 = horner(p0, z0, 1.50140941);
  // w >= 5
  const float z1 = __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p1 = static_cast<float>(-0.000200214257);
  p1 = horner(p1, z1, 0.000100950558);
  p1 = horner(p1, z1, 0.00134934322);
  p1 = horner(p1, z1, -0.00367342844);
  p1 = horner(p1, z1, 0.00573950773);
  p1 = horner(p1, z1, -0.0076224613);
  p1 = horner(p1, z1, 0.00943887047);
  p1 = horner(p1, z1, 1.00167406);
  p1 = horner(p1, z1, 2.83297682);
  const float erfinv = __fmul_rn(w < 5.0f ? p0 : p1, u);
  return __fmul_rn(static_cast<float>(1.4142135623730951), erfinv);
}

template <int N, bool COMPLEX>
__global__ void __launch_bounds__(kThreads)
mc_draw_lanes_kernel(const long long* __restrict__ key,
                     const float* __restrict__ h0,
                     const float* __restrict__ ctrl,
                     const float* __restrict__ noises,
                     float* __restrict__ ar, float* __restrict__ ai,
                     float* __restrict__ t, int64_t start, int64_t count,
                     int64_t bootreps, int64_t num_c, int64_t c_offset,
                     int64_t c_global) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= count) return;

  const int64_t id = start + b;
  const int64_t cell = id / bootreps;
  const int64_t l = cell / num_c;
  const int64_t c = cell % num_c;
  const int64_t gid = (l * c_global + c + c_offset) * bootreps + id % bootreps;

  // fold_in(key, gid), then the split keys
  uint32_t f0 = 0u;
  uint32_t f1 = static_cast<uint32_t>(gid);
  threefry(static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1]), f0,
           f1);
  uint32_t kd0 = 0u, kd1 = 0u, kr0 = 0u, kr1 = 1u, ki0 = 0u, ki1 = 2u;
  threefry(f0, f1, kd0, kd1);
  threefry(f0, f1, kr0, kr1);
  if (COMPLEX) threefry(f0, f1, ki0, ki1);

  const float scale = noises[l];
  const float* x = ctrl + c * (N + 1);
  float diag[N];
  float nn[N - 1];
  float nn2[N - 1];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    diag[i] = __fmul_rn(normal(draw32(kd0, kd1, i)), scale);
  }
#pragma unroll
  for (int i = 0; i < N - 1; ++i) {
    nn[i] = __fmul_rn(normal(draw32(kr0, kr1, i)), scale);
    nn2[i] = COMPLEX ? __fmul_rn(normal(draw32(ki0, ki1, i)), scale) : 0.0f;
  }

#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float vr = h0[i * N + j];
      float vi = 0.0f;
      if (i == j) {
        vr = __fadd_rn(vr, __fadd_rn(diag[i], x[i]));
      } else if (i == j + 1) {
        vr = __fadd_rn(vr, nn[j]);
        if (COMPLEX) vi = nn2[j];
      } else if (j == i + 1) {
        vr = __fadd_rn(vr, nn[i]);
        if (COMPLEX) vi = -nn2[i];
      }
      const int64_t at = static_cast<int64_t>(i * N + j) * count + b;
      ar[at] = vr;
      ai[at] = vi;
    }
  }
  t[b] = fabsf(x[N]);
}

template <int N>
cudaError_t launch(const long long* key, const float* h0, const float* ctrl,
                   const float* noises, float* ar, float* ai, float* t,
                   int64_t start, int64_t count, int64_t bootreps,
                   int64_t num_c, int64_t c_offset, int64_t c_global,
                   bool complex_offdiag, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((count + kThreads - 1) / kThreads);
  if (complex_offdiag) {
    mc_draw_lanes_kernel<N, true><<<blocks, kThreads, 0, stream>>>(
        key, h0, ctrl, noises, ar, ai, t, start, count, bootreps, num_c,
        c_offset, c_global);
  } else {
    mc_draw_lanes_kernel<N, false><<<blocks, kThreads, 0, stream>>>(
        key, h0, ctrl, noises, ar, ai, t, start, count, bootreps, num_c,
        c_offset, c_global);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes.  key: 2 int64 words; h0: (n, n); ctrl:
// (C, n+1) the controller block; noises: (L,); ar, ai: (n*n, count) and t:
// (count,) outputs; all float32 but the key, on `device`.  Draws the local
// flat ids start .. start + count - 1 of the (L, C, bootreps) lattice,
// whose controller block starts at c_offset of c_global.  Launches on
// `stream` and does not synchronise.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for n outside 2..10).
extern "C" int mc_draw_lanes(const long long* key, const float* h0,
                             const float* ctrl, const float* noises,
                             float* ar, float* ai, float* t, long long start,
                             long long count, long long bootreps,
                             long long num_c, long long c_offset,
                             long long c_global, int n, int complex_offdiag,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cx = complex_offdiag != 0;
#define MC_DRAW_CASE(NN)                                                     \
  case NN:                                                                   \
    return static_cast<int>(launch<NN>(key, h0, ctrl, noises, ar, ai, t,     \
                                       start, count, bootreps, num_c,        \
                                       c_offset, c_global, cx, s));
  switch (n) {
    MC_DRAW_CASE(2)
    MC_DRAW_CASE(3)
    MC_DRAW_CASE(4)
    MC_DRAW_CASE(5)
    MC_DRAW_CASE(6)
    MC_DRAW_CASE(7)
    MC_DRAW_CASE(8)
    MC_DRAW_CASE(9)
    MC_DRAW_CASE(10)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MC_DRAW_CASE
}
