// Shared pieces of K4 (aggregate_fwd.cu) and K5 (aggregate_bwd.cu): the
// network's widths, the feature map W_t f, the pair geometry and neighbour
// rule, the logit, a lane's slice of W_d for the gate W_d emb(mu_j - mu_i),
// and the warp reductions.
//
// Widths are the dynamics network's (pigs_tpu/models/dynamics.py:24-34):
// L = 16 latent features, K = 16 query/key features, F = 6 frequencies,
// d = 2, so E = 1 + 2 F d = 25 embedding components per octave and 2E = 50.
//
// Warp layout: lane = h * 16 + l.  Lane l (of either half) owns output
// feature l; half h owns octave h of the embedding, i.e. columns
// [h E, (h + 1) E) of the distance transform, and keeps that row slice of
// W_d in registers (25 floats).  Both kernels stage the sincos of a chunk's
// pairs in shared memory, sincos(f_k (scale_h rel_a)) at q = 2 k + a (the
// dense layout, flat index k d + a) with scale_h = 1 or 2: no double-angle
// rewrite, and the same arithmetic as the plain twin's
// positional_embedding(2 rel).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace agg {

constexpr int kL = 16;
constexpr int kK = 16;
constexpr int kF = 6;
constexpr int kFD = 12;  // F * d sin (and cos) components per octave
constexpr int kE = 25;   // 1 + 2 F d components per octave
constexpr int k2E = 50;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// Radius as the kernel reads it: a non-finite radius (an inactive Gaussian
// has -inf) becomes -1e30, as pallas_aggregate.py::_prep does, so that it
// joins no pair through the cut > 0 test.
__device__ __forceinline__ float finite_radius(float r) {
  return isfinite(r) ? r : -1e30f;
}

// Displacement component mu_j - mu_i, wrapped onto the torus when periodic:
// rel - P * round(rel / P), round half to even as torch.round and
// jnp.round.  Every step is rounded on its own (no contraction), so the
// result has the same bits as the plain twin's.
__device__ __forceinline__ float displacement(float to, float from,
                                              int periodic, float period) {
  const float rel = __fsub_rn(to, from);
  if (!periodic) return rel;
  return __fsub_rn(rel, __fmul_rn(period, rintf(__fdiv_rn(rel, period))));
}

// The kernel's neighbour rule (pallas_aggregate.py:135-141):
// dist^2 <= cut^2 and cut > 0 and i != j, cut = sigma_cut (r_i + r_j), in
// float32 without contraction, so the plain twin decides every pair alike.
__device__ __forceinline__ bool neighbours(float rx, float ry, float ri,
                                           float rj, float sigma_cut, int i,
                                           int j) {
  const float d2 = __fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry));
  const float cut = __fmul_rn(sigma_cut, __fadd_rn(ri, rj));
  return d2 <= __fmul_rn(cut, cut) && cut > 0.0f && i != j;
}

// <q, k> / sqrt(K) with q in registers and k a row in device memory.
__device__ __forceinline__ float logit(const float (&q)[kK],
                                       const float* __restrict__ k) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < kK; ++c) acc = fmaf(q[c], k[c], acc);
  return acc / 4.0f;  // sqrt(16)
}

// mapped[j, l] = sum_m W_t[l, m] f[j, m], one thread per entry: the
// feature map both K4 and K5 start from (the TPU kernel forms it in its
// body, pallas_aggregate.py:261).
__global__ void __launch_bounds__(kThreads) mapped_kernel(
    const float* __restrict__ features, const float* __restrict__ transform,
    int n, float* __restrict__ mapped) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n * kL) return;
  const int j = idx / kL, l = idx % kL;
  float acc = 0.0f;
#pragma unroll
  for (int m = 0; m < kL; ++m)
    acc = fmaf(transform[l * kL + m], features[j * kL + m], acc);
  mapped[idx] = acc;
}

// One lane's slice of the distance transform W_d (L, 2E): row l, octave h.
struct GateRow {
  float w0;         // constant component
  float ws[kFD];    // sin components
  float wc[kFD];    // cos components

  __device__ __forceinline__ void load(const float* __restrict__ dist, int l,
                                       int h) {
    const float* row = dist + l * k2E + h * kE;
    w0 = row[0];
#pragma unroll
    for (int p = 0; p < kFD; ++p) {
      ws[p] = row[1 + p];
      wc[p] = row[1 + kFD + p];
    }
  }
};

// Sum over the 16 lanes of a half (both halves get their own half's sum).
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

}  // namespace agg
