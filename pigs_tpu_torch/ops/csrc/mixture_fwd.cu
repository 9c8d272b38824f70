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
// caller, so a masked Gaussian contributes exactly zero.
//
// What bounds it on an H100: per pair it does one exp and 10-40 FMAs and
// reads nothing from device memory (the Gaussian tile sits in shared memory
// and every thread of a block reads the same word, a broadcast).  It is bound
// by the issue of exp (the SFU) and FMA instructions, not by bytes: a
// 4096 x 1664 order-0 call reads under 100 KB.
//
// Design: one thread per sample, 128 samples per block.  The block stages
// the Gaussian parameters (mu 2, conic 3, value C) through shared memory in
// tiles of 128; each thread keeps its C * (1+2+3+4)[:ORDER+1] partial sums in
// registers, sums one tile plainly and adds the tile's sum into its running
// total with Kahan compensation, as the TPU kernel does across Gaussian
// tiles.  There are no atomics, so the result is deterministic.  The ragged
// edges are masked in the kernel: threads past m load no sample and write
// nothing, and the last tile stops at n.  The TPU design's transposed
// (comp, n) tiles and its tile_m halving exist for the TPU's vector memory and
// are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // samples per block, one per thread
constexpr int kTileN = 128;    // Gaussians per shared-memory tile

template <int ORDER>
struct Comps {
  // Number of packed components up to ORDER: 1, 3, 6, 10.
  static constexpr int value = (ORDER + 1) * (ORDER + 2) / 2;
};

template <int ORDER, int C>
__global__ void __launch_bounds__(kThreads) mixture_fwd_kernel(
    const float* __restrict__ samples,  // (m, 2)
    const float* __restrict__ means,    // (n, 2)
    const float* __restrict__ conics,   // (n, 3) packed [cxx, cxy, cyy]
    const float* __restrict__ values,   // (n, C), mask folded in
    int m, int n, int periodic, float period, float inv_period,
    float* __restrict__ out0, float* __restrict__ out1,
    float* __restrict__ out2, float* __restrict__ out3) {
  constexpr int K = Comps<ORDER>::value;

  __shared__ float s_mx[kTileN];
  __shared__ float s_my[kTileN];
  __shared__ float s_cxx[kTileN];
  __shared__ float s_cxy[kTileN];
  __shared__ float s_cyy[kTileN];
  __shared__ float s_v[C][kTileN];

  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool live = j < m;
  const float x = live ? samples[2 * j] : 0.0f;
  const float y = live ? samples[2 * j + 1] : 0.0f;

  float total[K][C];
  float carry[K][C];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      total[k][ch] = 0.0f;
      carry[k][ch] = 0.0f;
    }
  }

  for (int base = 0; base < n; base += kTileN) {
    const int len = min(kTileN, n - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const int i = base + t;
      s_mx[t] = means[2 * i];
      s_my[t] = means[2 * i + 1];
      s_cxx[t] = conics[3 * i];
      s_cxy[t] = conics[3 * i + 1];
      s_cyy[t] = conics[3 * i + 2];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) s_v[ch][t] = values[i * C + ch];
    }
    __syncthreads();

    float part[K][C];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) part[k][ch] = 0.0f;
    }

#pragma unroll 4
    for (int t = 0; t < len; ++t) {
      float dx = x - s_mx[t];
      float dy = y - s_my[t];
      if (periodic) {
        // rintf rounds half to even, as jnp.round does.
        dx = dx - period * rintf(dx * inv_period);
        dy = dy - period * rintf(dy * inv_period);
      }
      const float cxx = s_cxx[t], cxy = s_cxy[t], cyy = s_cyy[t];
      const float px = cxx * dx + cxy * dy;
      const float py = cxy * dx + cyy * dy;
      const float g = expf(-0.5f * (dx * px + dy * py));

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
        const float v = s_v[ch][t];
#pragma unroll
        for (int k = 0; k < K; ++k) part[k][ch] = fmaf(w[k], v, part[k][ch]);
      }
    }

    // Kahan-compensated add of this tile's sums into the running totals.
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        const float yk = part[k][ch] - carry[k][ch];
        const float tk = total[k][ch] + yk;
        carry[k][ch] = (tk - total[k][ch]) - yk;
        total[k][ch] = tk;
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) out0[j * C + ch] = total[0][ch];
  if constexpr (ORDER >= 1) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        out1[j * 2 * C + k * C + ch] = total[1 + k][ch];
    }
  }
  if constexpr (ORDER >= 2) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        out2[j * 3 * C + k * C + ch] = total[3 + k][ch];
    }
  }
  if constexpr (ORDER >= 3) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        out3[j * 4 * C + k * C + ch] = total[6 + k][ch];
    }
  }
}

template <int ORDER, int C>
cudaError_t launch(const float* samples, const float* means,
                   const float* conics, const float* values, int m, int n,
                   int periodic, float period, float* out0, float* out1,
                   float* out2, float* out3, cudaStream_t stream) {
  const float inv_period = periodic ? 1.0f / period : 0.0f;
  const dim3 grid((m + kThreads - 1) / kThreads);
  mixture_fwd_kernel<ORDER, C><<<grid, kThreads, 0, stream>>>(
      samples, means, conics, values, m, n, periodic, period, inv_period,
      out0, out1, out2, out3);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_order(int order, const float* samples, const float* means,
                         const float* conics, const float* values, int m,
                         int n, int periodic, float period, float* out0,
                         float* out1, float* out2, float* out3,
                         cudaStream_t stream) {
  switch (order) {
    case 0:
      return launch<0, C>(samples, means, conics, values, m, n, periodic,
                          period, out0, out1, out2, out3, stream);
    case 1:
      return launch<1, C>(samples, means, conics, values, m, n, periodic,
                          period, out0, out1, out2, out3, stream);
    case 2:
      return launch<2, C>(samples, means, conics, values, m, n, periodic,
                          period, out0, out1, out2, out3, stream);
    case 3:
      return launch<3, C>(samples, means, conics, values, m, n, periodic,
                          period, out0, out1, out2, out3, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` without
// synchronising and returns the launch's cudaGetLastError() (0 on success).
// `period` is read only when `periodic` is non-zero; out1..out3 may be null
// past `order`.
extern "C" int pigs_mixture_fwd(int order, int c, const void* samples,
                                const void* means, const void* conics,
                                const void* values, int m, int n, int periodic,
                                float period, void* out0, void* out1,
                                void* out2, void* out3, void* stream) {
  if (m == 0) return 0;
  const float* s = static_cast<const float*>(samples);
  const float* mu = static_cast<const float*>(means);
  const float* co = static_cast<const float*>(conics);
  const float* v = static_cast<const float*>(values);
  float* o0 = static_cast<float*>(out0);
  float* o1 = static_cast<float*>(out1);
  float* o2 = static_cast<float*>(out2);
  float* o3 = static_cast<float*>(out3);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (c) {
    case 1:
      err = launch_order<1>(order, s, mu, co, v, m, n, periodic, period, o0,
                            o1, o2, o3, st);
      break;
    case 2:
      err = launch_order<2>(order, s, mu, co, v, m, n, periodic, period, o0,
                            o1, o2, o3, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
