// K2 and K3: the backward of the fused 2D mixture forward (K1).
//
// K2 replaces pigs_tpu/ops/pallas_mixture.py::_bwd_gauss_kernel and K3
// replaces ::_bwd_sample_kernel (both launched by _pallas_backward).  Given
// the packed cotangents of K1's outputs (cot_k for the K = 1, 3, 6 or 10
// components up to ORDER, column k*C + ch of each group), every pair
// (sample j, Gaussian i) contributes the hand-derived adjoint fields of
// pallas_mixture.py::_adjoint_fields, with r_k(j, i) = sum_ch cot_k[j, ch] *
// v[i, ch]:
//   E_dx, E_dy               d(pair term)/d(delta)
//   E_cxx, E_cxy, E_cyy      d(pair term)/d(packed conic)
//   A g = sum_k r_k W_k      the pair term itself
// K2 sums them over samples (column sums): gm = -sum_j (E_dx, E_dy),
// gc = sum_j (E_cxx, E_cxy, E_cyy), gv[ch] = sum_j sum_k cot_k[j, ch] W_k.
// K3 sums E_dx, E_dy over Gaussians (row sums): gx.  The packed cxy stands
// for both off-diagonal entries, so gc's middle column is the gradient of
// that one number.
//
// What bounds them on an H100: per pair one exp and 19-225 FLOP, nothing per
// pair from device memory (the staged tile sits in shared memory and every
// thread of a block reads the same word, a broadcast), so the exp and FMA
// issue rate, not bytes.  At the training shapes (4096 samples over 1664
// Gaussians) K2's bound is 2.8 us (order 0) and 7.9 us (order 2), next to a
// launch floor of a few microseconds; what decides the time is whether the
// pairs reach every SM and keep its schedulers issuing.
//
// K2 design: a 2-D grid of Gaussian tiles x sample slices.  A block of 128
// threads takes 128 Gaussians, one a thread, each keeping its mu, C and v
// and its 5 + C gradient sums in registers; the samples of the block's
// slice (position and K*C cotangents) are staged through shared memory and
// read as broadcasts.  The wrapper cuts the sample axis into `slices` runs
// of `slice_len` (a multiple of 32, mixture_kernel.py::gauss_geometry) so
// that the grid holds about 6 blocks (24 warps) per SM, at least 2, where
// the first design's slices of 256 samples gave 208 blocks, 1-2 per SM.
// chip_smoke.py phase 8 times that choice against 2-8 blocks per SM; two
// Gaussians a thread, tried as well, were no faster than one.  At order 0
// the adjoint skips the terms that are zero there (adjoint_order0): IEEE
// arithmetic keeps 0 * x, so adjoint_fields pays for them.  Within a slice a
// shared tile of up to 128 samples is summed plainly and added into the
// running totals with Kahan compensation, as the TPU kernel does across
// sample tiles.  With several slices each block writes its slice's sums to
// scratch (slices, 5 + C, n) and a second pass adds the slices in a fixed
// order with Kahan compensation (mixture_common.cuh); with one slice the
// block writes the output directly.  No atomics and a
// geometry fixed by (m, n, the SM count): the result is deterministic, bit
// for bit.  C = 1 takes the rank-1 route of the TPU kernel: r_k is the
// cotangent itself, the value factor multiplies gm and gc once at the end
// of each slice, and gv = sum_j A g.
//
// K3 design: K1's grid over K3's pair arithmetic.  A block of 128 threads
// takes a tile of 128 samples, one a thread, each holding its K*C
// cotangents and its gx(2) sums in registers; blockIdx.y takes one slice of
// the Gaussian axis, whose Gaussians are staged through shared memory in
// tiles of up to 128 as two float4 (K1's layout: two broadcast loads a
// pair) and summed plainly within a tile, Kahan across tiles.  The wrapper
// cuts the Gaussian axis as K1's (mixture_kernel.py::fwd_geometry: a
// multiple of 8, about 6 blocks per SM), where the first design, one block
// column over all n Gaussians, gave 32 blocks at 4096 samples: a quarter of
// a block per SM, each walking 1664 Gaussians.  With several slices each
// block writes (slices, 2, m) partials and the combine pass sums them in a
// fixed order (mixture_common.cuh); with one slice the block writes gx.
// The pair arithmetic is the first design's (expf, adjoint_fields; C = 1
// folds v into g).  K3 does not run on the main path (the samples need no
// gradient there).
//
// The TPU design's transposed (comp, n) tiles and the cotangent split done
// outside the kernel exist for Mosaic and are not carried over.

#include <cuda_runtime.h>

#include "mixture_common.cuh"

namespace {

using mixture::Comps;
using mixture::group_of;
using mixture::group_offset;
using mixture::kahan_add;

constexpr int kThreads = 128;  // Gaussians (K2) or samples (K3) per block
constexpr int kTile = 128;     // samples (K2) or Gaussians (K3) per tile

struct Pair {
  float dx, dy, px, py, g;
};

// kExp2: g = exp2(c q) with c = -log2(e) / 2 folded into the multiply the
// quadratic form q needs anyway (K2); else expf (K3, unchanged since its
// first design).
template <bool kExp2 = false>
__device__ __forceinline__ Pair pair_geometry(float x, float y, float mx,
                                              float my, float cxx, float cxy,
                                              float cyy, int periodic,
                                              float period, float inv_period) {
  Pair q;
  q.dx = x - mx;
  q.dy = y - my;
  if (periodic) {
    // rintf rounds half to even, as jnp.round does.
    q.dx = q.dx - period * rintf(q.dx * inv_period);
    q.dy = q.dy - period * rintf(q.dy * inv_period);
  }
  q.px = cxx * q.dx + cxy * q.dy;
  q.py = cxy * q.dx + cyy * q.dy;
  if constexpr (kExp2)
    q.g = exp2f(-0.72134752044448170368f * (q.dx * q.px + q.dy * q.py));
  else
    q.g = expf(-0.5f * (q.dx * q.px + q.dy * q.py));
  return q;
}

// The packed output weights W_k = P_k(p, C) * g of K1, in output order.
template <int ORDER>
__device__ __forceinline__ void pair_weights(const Pair& q, float cxx,
                                             float cxy, float cyy, float* w) {
  const float px = q.px, py = q.py, g = q.g;
  w[0] = g;
  if constexpr (ORDER >= 1) {
    w[1] = -px * g;
    w[2] = -py * g;
  }
  if constexpr (ORDER >= 2) {
    w[3] = (px * px - cxx) * g;
    w[4] = (px * py - cxy) * g;
    w[5] = (py * py - cyy) * g;
  }
  if constexpr (ORDER >= 3) {
    w[6] = (3.0f * cxx * px - px * px * px) * g;
    w[7] = (cxx * py + 2.0f * cxy * px - px * px * py) * g;
    w[8] = (cyy * px + 2.0f * cxy * py - px * py * py) * g;
    w[9] = (3.0f * cyy * py - py * py * py) * g;
  }
}

struct Adjoint {
  float edx, edy, ecxx, ecxy, ecyy, ag;
};

// pallas_mixture.py::_adjoint_fields, term for term.
template <int ORDER>
__device__ __forceinline__ Adjoint adjoint_fields(const Pair& q, float cxx,
                                                  float cxy, float cyy,
                                                  const float* r) {
  const float dx = q.dx, dy = q.dy, px = q.px, py = q.py, g = q.g;
  float A = r[0], Q = 0.0f, R = 0.0f;
  float Dxx = 0.0f, Dxy = 0.0f, Dyy = 0.0f;
  if constexpr (ORDER >= 1) {
    Q = Q - r[1];
    R = R - r[2];
    A = A - px * r[1] - py * r[2];
  }
  if constexpr (ORDER >= 2) {
    const float rxx = r[3], rxy = r[4], ryy = r[5];
    Q = Q + 2.0f * px * rxx + py * rxy;
    R = R + px * rxy + 2.0f * py * ryy;
    A = A + ((px * px - cxx) * rxx + (px * py - cxy) * rxy +
             (py * py - cyy) * ryy);
    Dxx = Dxx - rxx;
    Dxy = Dxy - rxy;
    Dyy = Dyy - ryy;
  }
  if constexpr (ORDER >= 3) {
    const float rxxx = r[6], rxxy = r[7], rxyy = r[8], ryyy = r[9];
    Q = Q + ((3.0f * cxx - 3.0f * px * px) * rxxx +
             (2.0f * cxy - 2.0f * px * py) * rxxy + (cyy - py * py) * rxyy);
    R = R + ((cxx - px * px) * rxxy + (2.0f * cxy - 2.0f * px * py) * rxyy +
             (3.0f * cyy - 3.0f * py * py) * ryyy);
    A = A + ((3.0f * cxx * px - px * px * px) * rxxx +
             (cxx * py + 2.0f * cxy * px - px * px * py) * rxxy +
             (cyy * px + 2.0f * cxy * py - px * py * py) * rxyy +
             (3.0f * cyy * py - py * py * py) * ryyy);
    Dxx = Dxx + 3.0f * px * rxxx + py * rxxy;
    Dxy = Dxy + 2.0f * px * rxxy + 2.0f * py * rxyy;
    Dyy = Dyy + px * rxyy + 3.0f * py * ryyy;
  }
  Adjoint e;
  e.edx = g * (Q * cxx + R * cxy - A * px);
  e.edy = g * (Q * cxy + R * cyy - A * py);
  e.ecxx = g * (Q * dx + Dxx - 0.5f * A * dx * dx);
  e.ecxy = g * (Q * dy + R * dx + Dxy - A * dx * dy);
  e.ecyy = g * (R * dy + Dyy - 0.5f * A * dy * dy);
  e.ag = A * g;
  return e;
}

// Read packed component `comp` (channel ch) of sample j from the group
// buffers cot0..cot3, whose rows are (G * C) wide.
template <int C>
__device__ __forceinline__ float cot_at(const float* const* cots, int comp,
                                        int ch, int j) {
  const int group = group_of(comp);
  const int k = comp - group_offset(group);
  return cots[group][(size_t)j * (group + 1) * C + k * C + ch];
}

struct Cots {
  const float* p[4];
};

// ------------------------------------------------------------------ K2 ----

// The adjoint fields at order 0, where Q = R = D = 0: E_d = -A g p,
// E_cxx = -A g dx^2 / 2, E_cxy = -A g dx dy, E_cyy = -A g dy^2 / 2.
// K2 only; K3 keeps adjoint_fields' arithmetic.
__device__ __forceinline__ Adjoint adjoint_order0(const Pair& q, float r0) {
  Adjoint e;
  e.ag = r0 * q.g;
  const float half = -0.5f * e.ag;
  e.edx = -e.ag * q.px;
  e.edy = -e.ag * q.py;
  e.ecxx = half * q.dx * q.dx;
  e.ecxy = -e.ag * q.dx * q.dy;
  e.ecyy = half * q.dy * q.dy;
  return e;
}

template <int ORDER, int C>
__global__ void __launch_bounds__(kThreads) bwd_gauss_partial_kernel(
    const float* __restrict__ samples,  // (m, 2)
    const float* __restrict__ means,    // (n, 2)
    const float* __restrict__ conics,   // (n, 3) packed [cxx, cxy, cyy]
    const float* __restrict__ values,   // (n, C), mask folded in
    Cots cots, int m, int n, int slice_len, int periodic, float period,
    float inv_period,
    float* __restrict__ partials,       // (slices, 5 + C, n), or null
    float* __restrict__ out) {          // (n, 5 + C) when partials is null
  constexpr int K = Comps<ORDER>::value;
  constexpr int W = 5 + C;
  // Sample t of the tile as one record [x, y, cot_0 .. cot_{K*C-1}] of R
  // float4s, read with R broadcast loads a pair.
  constexpr int R = (2 + K * C + 3) / 4;
  __shared__ float4 s_rec[kTile][R];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  const float mx = live ? means[2 * i] : 0.0f;
  const float my = live ? means[2 * i + 1] : 0.0f;
  const float cxx = live ? conics[3 * i] : 1.0f;
  const float cxy = live ? conics[3 * i + 1] : 0.0f;
  const float cyy = live ? conics[3 * i + 2] : 1.0f;
  float v[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) v[ch] = live ? values[i * C + ch] : 0.0f;

  float total[W], carry[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    total[k] = 0.0f;
    carry[k] = 0.0f;
  }

  const int begin = blockIdx.y * slice_len;
  const int end = min(m, begin + slice_len);
  for (int base = begin; base < end; base += kTile) {
    const int len = min(kTile, end - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const int j = base + t;
      float* rec = reinterpret_cast<float*>(s_rec[t]);
      rec[0] = samples[2 * j];
      rec[1] = samples[2 * j + 1];
#pragma unroll
      for (int comp = 0; comp < K; ++comp) {
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
          rec[2 + comp * C + ch] = cot_at<C>(cots.p, comp, ch, j);
      }
    }
    __syncthreads();

    float part[W];
#pragma unroll
    for (int k = 0; k < W; ++k) part[k] = 0.0f;

#pragma unroll 2
    for (int t = 0; t < len; ++t) {
      float4 rec4[R];
#pragma unroll
      for (int b = 0; b < R; ++b) rec4[b] = s_rec[t][b];
      const float* rec = reinterpret_cast<const float*>(rec4);
      const float* cot = rec + 2;
      const Pair q = pair_geometry<true>(rec[0], rec[1], mx, my, cxx, cxy,
                                         cyy, periodic, period, inv_period);
      float r[K];
      if constexpr (C == 1) {
        // Rank-1 route: r_k = cot_k (the value factor comes at the end).
#pragma unroll
        for (int k = 0; k < K; ++k) r[k] = cot[k];
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float acc = 0.0f;
#pragma unroll
          for (int ch = 0; ch < C; ++ch) acc = fmaf(cot[k * C + ch], v[ch], acc);
          r[k] = acc;
        }
      }
      Adjoint e;
      if constexpr (ORDER == 0)
        e = adjoint_order0(q, r[0]);
      else
        e = adjoint_fields<ORDER>(q, cxx, cxy, cyy, r);
      part[0] -= e.edx;
      part[1] -= e.edy;
      part[2] += e.ecxx;
      part[3] += e.ecxy;
      part[4] += e.ecyy;
      if constexpr (C == 1) {
        part[5] += e.ag;
      } else {
        float w[K];
        pair_weights<ORDER>(q, cxx, cxy, cyy, w);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          float acc = part[5 + ch];
#pragma unroll
          for (int k = 0; k < K; ++k) acc = fmaf(cot[k * C + ch], w[k], acc);
          part[5 + ch] = acc;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < W; ++k) kahan_add(total[k], carry[k], part[k]);
  }

  if (!live) return;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    // C = 1: the rank-1 route's value factor on gm and gc.
    const float val = (C == 1 && k < 5) ? total[k] * v[0] : total[k];
    if (partials != nullptr)
      partials[((size_t)blockIdx.y * W + k) * n + i] = val;
    else
      out[(size_t)i * W + k] = val;
  }
}

// The second pass's store: entry e = k * n + i of the scratch layout to
// out (n, W).
struct GaussStore {
  float* out;
  int n, W;
  __device__ void operator()(int e, float sum) const {
    const int k = e / n, i = e - k * n;
    out[(size_t)i * W + k] = sum;
  }
};

// ------------------------------------------------------------------ K3 ----

template <int ORDER, int C>
__global__ void __launch_bounds__(kThreads) bwd_sample_kernel(
    const float* __restrict__ samples, const float* __restrict__ means,
    const float* __restrict__ conics, const float* __restrict__ values,
    Cots cots, int m, int n, int slice_len, int periodic, float period,
    float inv_period,
    float* __restrict__ partials,       // (slices, 2, m), or null
    float* __restrict__ gx) {           // (m, 2) when partials is null
  constexpr int K = Comps<ORDER>::value;

  // Gaussian t of the tile: (mx, my, cxx, cxy) and (cyy, v0, v1, -).
  __shared__ float4 s_a[kTile];
  __shared__ float4 s_b[kTile];

  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool live = j < m;
  const float x = live ? samples[2 * j] : 0.0f;
  const float y = live ? samples[2 * j + 1] : 0.0f;
  float cot[K * C];
#pragma unroll
  for (int comp = 0; comp < K; ++comp) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      cot[comp * C + ch] = live ? cot_at<C>(cots.p, comp, ch, j) : 0.0f;
  }

  float total[2] = {0.0f, 0.0f}, carry[2] = {0.0f, 0.0f};
  const int begin = blockIdx.y * slice_len;
  const int end = min(n, begin + slice_len);
  for (int base = begin; base < end; base += kTile) {
    const int len = min(kTile, end - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const int i = base + t;
      s_a[t] = make_float4(means[2 * i], means[2 * i + 1], conics[3 * i],
                           conics[3 * i + 1]);
      s_b[t] = make_float4(conics[3 * i + 2], values[i * C],
                           C > 1 ? values[i * C + C - 1] : 0.0f, 0.0f);
    }
    __syncthreads();

    float part[2] = {0.0f, 0.0f};
#pragma unroll 2
    for (int t = 0; t < len; ++t) {
      const float4 a = s_a[t];
      const float4 b = s_b[t];
      const float cxx = a.z, cxy = a.w, cyy = b.x;
      const float v[2] = {b.y, b.z};
      Pair q = pair_geometry(x, y, a.x, a.y, cxx, cxy, cyy, periodic, period,
                             inv_period);
      float r[K];
      if constexpr (C == 1) {
        q.g *= v[0];  // rank-1 route: fold v into g
#pragma unroll
        for (int k = 0; k < K; ++k) r[k] = cot[k];
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float acc = 0.0f;
#pragma unroll
          for (int ch = 0; ch < C; ++ch) acc = fmaf(cot[k * C + ch], v[ch], acc);
          r[k] = acc;
        }
      }
      const Adjoint e = adjoint_fields<ORDER>(q, cxx, cxy, cyy, r);
      part[0] += e.edx;
      part[1] += e.edy;
    }
    kahan_add(total[0], carry[0], part[0]);
    kahan_add(total[1], carry[1], part[1]);
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (partials != nullptr)
      partials[((size_t)blockIdx.y * 2 + k) * m + j] = total[k];
    else
      gx[2 * j + k] = total[k];
  }
}

// The second pass's store: entry e = k * m + j of the scratch layout to
// gx (m, 2).
struct SampleStore {
  float* gx;
  int m;
  __device__ void operator()(int e, float sum) const {
    const int k = e / m, j = e - k * m;
    gx[2 * j + k] = sum;
  }
};

// ------------------------------------------------------------ dispatch ----

struct Args {
  const float *samples, *means, *conics, *values;
  Cots cots;
  int m, n, slices, slice_len, periodic;
  float period, inv_period;
  float *partials, *out;
  cudaStream_t stream;
};

template <int ORDER, int C>
cudaError_t launch_gauss(const Args& a) {
  const dim3 grid((a.n + kThreads - 1) / kThreads, a.slices);
  bwd_gauss_partial_kernel<ORDER, C><<<grid, kThreads, 0, a.stream>>>(
      a.samples, a.means, a.conics, a.values, a.cots, a.m, a.n, a.slice_len,
      a.periodic, a.period, a.inv_period,
      a.slices > 1 ? a.partials : nullptr, a.out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.slices == 1) return err;
  return mixture::combine_slices(a.partials, a.slices, a.n * (5 + C),
                                 GaussStore{a.out, a.n, 5 + C}, a.stream);
}

template <int ORDER, int C>
cudaError_t launch_sample(const Args& a) {
  const dim3 grid((a.m + kThreads - 1) / kThreads, a.slices);
  bwd_sample_kernel<ORDER, C><<<grid, kThreads, 0, a.stream>>>(
      a.samples, a.means, a.conics, a.values, a.cots, a.m, a.n, a.slice_len,
      a.periodic, a.period, a.inv_period,
      a.slices > 1 ? a.partials : nullptr, a.out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.slices == 1) return err;
  return mixture::combine_slices(a.partials, a.slices, 2 * a.m,
                                 SampleStore{a.out, a.m}, a.stream);
}

template <template <int, int> class Launch>
cudaError_t dispatch(int order, int c, const Args& a) {
  switch (c * 10 + order) {
    case 10: return Launch<0, 1>::run(a);
    case 11: return Launch<1, 1>::run(a);
    case 12: return Launch<2, 1>::run(a);
    case 13: return Launch<3, 1>::run(a);
    case 20: return Launch<0, 2>::run(a);
    case 21: return Launch<1, 2>::run(a);
    case 22: return Launch<2, 2>::run(a);
    case 23: return Launch<3, 2>::run(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int ORDER, int C>
struct GaussLaunch {
  static cudaError_t run(const Args& a) { return launch_gauss<ORDER, C>(a); }
};

template <int ORDER, int C>
struct SampleLaunch {
  static cudaError_t run(const Args& a) { return launch_sample<ORDER, C>(a); }
};

Args make_args(const void* samples, const void* means, const void* conics,
               const void* values, const void* cot0, const void* cot1,
               const void* cot2, const void* cot3, int m, int n, int periodic,
               float period, void* stream) {
  Args a;
  a.samples = static_cast<const float*>(samples);
  a.means = static_cast<const float*>(means);
  a.conics = static_cast<const float*>(conics);
  a.values = static_cast<const float*>(values);
  a.cots.p[0] = static_cast<const float*>(cot0);
  a.cots.p[1] = static_cast<const float*>(cot1);
  a.cots.p[2] = static_cast<const float*>(cot2);
  a.cots.p[3] = static_cast<const float*>(cot3);
  a.m = m;
  a.n = n;
  a.slices = 1;
  a.slice_len = m;
  a.periodic = periodic;
  a.period = period;
  a.inv_period = periodic ? 1.0f / period : 0.0f;
  a.partials = nullptr;
  a.out = nullptr;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each launches on `stream`
// without synchronising and returns the launches' cudaGetLastError() (0 on
// success).  cot0..cot3 are the packed cotangents (m, C), (m, 2C), (m, 3C),
// (m, 4C); those past `order` may be null.  `period` is read only when
// `periodic` is non-zero.

// K2: out (n, 5 + C) = [gm_x, gm_y, gc_xx, gc_xy, gc_yy, gv_0..gv_C-1]; the
// sample axis is cut into `slices` runs of `slice_len` samples and, with
// slices > 1, partials is scratch of (slices, 5 + C, n) floats.
extern "C" int pigs_mixture_bwd_gauss(int order, int c, const void* samples,
                                      const void* means, const void* conics,
                                      const void* values, const void* cot0,
                                      const void* cot1, const void* cot2,
                                      const void* cot3, int m, int n,
                                      int slices, int slice_len, int periodic,
                                      float period, void* partials, void* out,
                                      void* stream) {
  if (n == 0) return 0;
  if (slices < 1 || slice_len < 1 || (long long)slices * slice_len < m ||
      (slices > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(samples, means, conics, values, cot0, cot1, cot2, cot3,
                     m, n, periodic, period, stream);
  a.slices = slices;
  a.slice_len = slice_len;
  a.partials = static_cast<float*>(partials);
  a.out = static_cast<float*>(out);
  return static_cast<int>(dispatch<GaussLaunch>(order, c, a));
}

// K3: gx (m, 2); the Gaussian axis is cut into `slices` runs of
// `slice_len` Gaussians and, with slices > 1, partials is scratch of
// (slices, 2, m) floats.
extern "C" int pigs_mixture_bwd_sample(int order, int c, const void* samples,
                                       const void* means, const void* conics,
                                       const void* values, const void* cot0,
                                       const void* cot1, const void* cot2,
                                       const void* cot3, int m, int n,
                                       int slices, int slice_len, int periodic,
                                       float period, void* partials, void* gx,
                                       void* stream) {
  if (m == 0) return 0;
  if (slices < 1 || slice_len < 1 || (long long)slices * slice_len < n ||
      (slices > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(samples, means, conics, values, cot0, cot1, cot2, cot3,
                     m, n, periodic, period, stream);
  a.slices = slices;
  a.slice_len = slice_len;
  a.partials = static_cast<float*>(partials);
  a.out = static_cast<float*>(gx);
  return static_cast<int>(dispatch<SampleLaunch>(order, c, a));
}
