// K1: fused forward of the 2D Gaussian-mixture field and its derivatives.
//
// Replaces pigs_tpu/ops/pallas_mixture.py::_fwd_kernel (launched by
// _pallas_forward).  For every (sample j, Gaussian i) pair it forms
//   d = x_j - mu_i (wrapped onto the torus when `periodic`),  p = C_i d,
//   g = exp(-1/2 d.p),
// and accumulates sum_i W_k(p, C_i) g v_i for the packed outputs
//   out0 (m, C)     u
//   out1 (m, 2C)    [u_x, u_y]
//   out2 (m, 3C)    Hessian [xx, xy, yy]
//   out3 (m, 4C)    third derivative [xxx, xxy, xyy, yyy]
// (column k*C + ch), up to ORDER.  The mask is folded into the values by the
// caller, so a masked Gaussian contributes exactly zero (a masked slot with a
// non-finite conic still gives NaN, as in the TPU kernel and the plain twin).
//
// What bounds it on an H100: per pair one exp (the SFU) and 14-94 FLOP;
// nothing per pair comes from device memory, and a 4096 x 1664 call moves
// under 200 KB.  At the main path's shapes (1664 or 4096 samples over 1664
// Gaussians, 640 or 4096 over 640 for Navier-Stokes) the whole call is
// 0.4-7 M pairs, a 0.6-3.6 us bound, so what decides the time is whether
// the pairs reach every SM and keep its schedulers issuing, plus a launch
// floor of a few microseconds.  The first design, one thread per sample
// over all n Gaussians, gave 5-32 blocks of 4 warps: most SMs idled, and
// each busy one had 4 warps to hide the latency of its exp and FMA chains.
//
// Design: a 2-D grid of sample tiles x Gaussian slices.
//  * A block of 128 threads takes a tile of 128 samples, one a thread.  The
//    Gaussians of the block's slice are staged through shared memory in
//    tiles of up to 128 as two float4 per Gaussian (two broadcast loads a
//    pair), and the pair loop is unrolled by 2 so that two exp and FMA
//    chains are in flight per thread.
//  * The wrapper cuts the Gaussian axis into `slices` runs of `slice_len`
//    (a multiple of 8, mixture_kernel.py::fwd_geometry) so that the grid
//    holds about 6 blocks (24 warps) per SM, at least 2, at every
//    main-path shape (chip_smoke.py phase 8 times that choice against 2-8
//    blocks per SM; two samples a thread, tried as well, halved the tiles
//    and were no faster).  With one slice (large m, or n <= 8) the block
//    writes the outputs directly.
//  * g = exp2(c q) with c = -1/2 log2(e) folded into the one multiply the
//    quadratic form q needs anyway: the SFU's exp2 without expf's range
//    reduction.
//  * With several slices each block writes its slice's sums to scratch
//    (slices, K*C, m) and a second pass adds the slices in a fixed order
//    with Kahan compensation (mixture_common.cuh).
// Within a slice each thread sums a shared tile plainly and adds it into
// its running total with Kahan compensation, as the TPU kernel does across
// Gaussian tiles.  No atomics and a geometry fixed by (m, n, the SM count):
// the result is deterministic, bit for bit, from launch to launch.  The
// ragged edges are masked in the kernel: samples past m load nothing and
// write nothing, and the last tile stops at the slice's end.

#include <cuda_runtime.h>

#include "mixture_common.cuh"

namespace {

using mixture::Comps;
using mixture::group_of;
using mixture::group_offset;
using mixture::kahan_add;

constexpr int kThreads = 128;  // samples per block, one a thread
constexpr int kTileN = 128;    // Gaussians per shared-memory tile
constexpr float kNegHalfLog2e = -0.72134752044448170368f;  // -log2(e) / 2

struct Outs {
  float* p[4];
};

// Output entry (sample j, component k, channel ch) in its packed group.
// The group's pointer is picked by selects, not by indexing the parameter
// array, which would copy it to local memory when k is not a constant.
template <int C>
__device__ __forceinline__ float* out_entry(const Outs& outs, int j, int k,
                                            int ch) {
  const int group = group_of(k);
  float* base = group == 0   ? outs.p[0]
                : group == 1 ? outs.p[1]
                : group == 2 ? outs.p[2]
                             : outs.p[3];
  return base + (size_t)j * (group + 1) * C + (k - group_offset(group)) * C +
         ch;
}

// The second pass's store: entry e = (k*C + ch) * m + j of the scratch
// layout to its place in the packed outputs.
template <int C>
struct FwdStore {
  Outs outs;
  int m;
  __device__ void operator()(int e, float sum) const {
    const int w = e / m, j = e - w * m;
    *out_entry<C>(outs, j, w / C, w % C) = sum;
  }
};

template <int ORDER, int C>
__global__ void __launch_bounds__(kThreads) mixture_fwd_kernel(
    const float* __restrict__ samples,  // (m, 2)
    const float* __restrict__ means,    // (n, 2)
    const float* __restrict__ conics,   // (n, 3) packed [cxx, cxy, cyy]
    const float* __restrict__ values,   // (n, C), mask folded in
    int m, int n, int slice_len, int periodic, float period,
    float inv_period, Outs outs,
    float* __restrict__ partials) {     // (slices, K*C, m), or null
  constexpr int K = Comps<ORDER>::value;

  // Gaussian t of the tile: (mx, my, cxx, cxy) and (cyy, v0, v1, -).
  __shared__ float4 s_a[kTileN];
  __shared__ float4 s_b[kTileN];

  const int j = blockIdx.x * kThreads + threadIdx.x;
  const float x = j < m ? samples[2 * j] : 0.0f;
  const float y = j < m ? samples[2 * j + 1] : 0.0f;

  float total[K][C], carry[K][C];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      total[k][ch] = 0.0f;
      carry[k][ch] = 0.0f;
    }
  }

  const int begin = blockIdx.y * slice_len;
  const int end = min(n, begin + slice_len);
  for (int base = begin; base < end; base += kTileN) {
    const int len = min(kTileN, end - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const int i = base + t;
      s_a[t] = make_float4(means[2 * i], means[2 * i + 1], conics[3 * i],
                           conics[3 * i + 1]);
      s_b[t] = make_float4(conics[3 * i + 2], values[i * C],
                           C > 1 ? values[i * C + C - 1] : 0.0f, 0.0f);
    }
    __syncthreads();

    float part[K][C];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) part[k][ch] = 0.0f;
    }

#pragma unroll 2
    for (int t = 0; t < len; ++t) {
      const float4 a = s_a[t];
      const float4 b = s_b[t];
      const float cxx = a.z, cxy = a.w, cyy = b.x;
      const float v[2] = {b.y, b.z};
      float dx = x - a.x;
      float dy = y - a.y;
      if (periodic) {
        // rintf rounds half to even, as jnp.round does.
        dx = dx - period * rintf(dx * inv_period);
        dy = dy - period * rintf(dy * inv_period);
      }
      const float px = cxx * dx + cxy * dy;
      const float py = cxy * dx + cyy * dy;
      const float g = exp2f(kNegHalfLog2e * (dx * px + dy * py));

      float w[K];
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
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          part[k][ch] = fmaf(w[k], v[ch], part[k][ch]);
      }
    }

    // Kahan-compensated add of this tile's sums into the running totals.
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        kahan_add(total[k][ch], carry[k][ch], part[k][ch]);
    }
  }

  if (j >= m) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      if (partials != nullptr)
        partials[((size_t)blockIdx.y * K * C + k * C + ch) * m + j] =
            total[k][ch];
      else
        *out_entry<C>(outs, j, k, ch) = total[k][ch];
    }
  }
}

struct Args {
  const float *samples, *means, *conics, *values;
  int m, n, slices, slice_len, periodic;
  float period;
  Outs outs;
  float* partials;
  cudaStream_t stream;
};

template <int ORDER, int C>
cudaError_t launch(const Args& a) {
  const float inv_period = a.periodic ? 1.0f / a.period : 0.0f;
  const dim3 grid((a.m + kThreads - 1) / kThreads, a.slices);
  mixture_fwd_kernel<ORDER, C><<<grid, kThreads, 0, a.stream>>>(
      a.samples, a.means, a.conics, a.values, a.m, a.n, a.slice_len,
      a.periodic, a.period, inv_period, a.outs,
      a.slices > 1 ? a.partials : nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.slices == 1) return err;
  return mixture::combine_slices(a.partials, a.slices,
                                 Comps<ORDER>::value * C * a.m,
                                 FwdStore<C>{a.outs, a.m}, a.stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` without
// synchronising and returns the launches' cudaGetLastError() (0 on
// success).  The Gaussian axis is cut into `slices` runs of `slice_len`;
// with slices > 1, `partials` is scratch of (slices, K*C, m) floats, K the
// packed components up to `order`.  `period` is read only when `periodic`
// is non-zero; out1..out3 may be null past `order`.
extern "C" int pigs_mixture_fwd(int order, int c, const void* samples,
                                const void* means, const void* conics,
                                const void* values, int m, int n, int slices,
                                int slice_len, int periodic, float period,
                                void* out0, void* out1, void* out2,
                                void* out3, void* partials, void* stream) {
  if (m == 0) return 0;
  if (slices < 1 || slice_len < 1 || (long long)slices * slice_len < n ||
      (slices > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.samples = static_cast<const float*>(samples);
  a.means = static_cast<const float*>(means);
  a.conics = static_cast<const float*>(conics);
  a.values = static_cast<const float*>(values);
  a.m = m;
  a.n = n;
  a.slices = slices;
  a.slice_len = slice_len;
  a.periodic = periodic;
  a.period = period;
  a.outs = {{static_cast<float*>(out0), static_cast<float*>(out1),
             static_cast<float*>(out2), static_cast<float*>(out3)}};
  a.partials = static_cast<float*>(partials);
  a.stream = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (c * 10 + order) {
    case 10: err = launch<0, 1>(a); break;
    case 11: err = launch<1, 1>(a); break;
    case 12: err = launch<2, 1>(a); break;
    case 13: err = launch<3, 1>(a); break;
    case 20: err = launch<0, 2>(a); break;
    case 21: err = launch<1, 2>(a); break;
    case 22: err = launch<2, 2>(a); break;
    case 23: err = launch<3, 2>(a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
