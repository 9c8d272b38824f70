// K5: the backward of the fused neighbour aggregation (K4).
//
// Replaces pigs_tpu/ops/pallas_aggregate.py::_bwd_kernel (with _chunk_bwd
// and the vjp of _tile_alpha; launched by _backward).  With K4's notation
// (aggregate_fwd.cu) and the cotangent g (n, L) of out, per pair (i, j):
//   gate_l     = sum_e W_d[l, e] emb_e(rel_ij),  rel_ij = wrap(mu_j - mu_i)
//   dalpha_ij  = sum_l g_il mapped_jl gate_l
//   D_i        = sum_j alpha_ij dalpha_ij
//   dlogit_ij  = alpha_ij (dalpha_ij - D_i)        (the row max is constant)
//   ggate_l    = alpha_ij g_il mapped_jl
// and the seven gradients are
//   queries    gq_i   = sum_j dlogit_ij k_j / sqrt(K)
//   keys       gk_j   = sum_i dlogit_ij q_i / sqrt(K)
//   mapped     gm_jl  = sum_i alpha_ij g_il gate_l
//   features   gf_j   = W_t^T gm_j
//   transform  gW_t   = sum_j gm_j f_j^T
//   dist. tr.  gW_d   = sum_ij ggate emb(rel_ij)^T
//   freqs      gf_k   = sum_ij sum_l ggate_l d gate_l / d f_k
//   means      gmu_j  = sum_i grel_ij - sum_i' grel_ji',
//              grel_ij = sum_l ggate_l d gate_l / d rel_ij
// The wrap and the neighbour test carry no gradient (stop_gradient in the
// TPU kernel), and the radii get none.  With u_p = cos(theta_p) W_d[l, sin_p]
// - sin(theta_p) W_d[l, cos_p] for theta_p = f_k (scale rel_a), p = 2 k + a,
// d gate_l / d rel_a = scale sum_k u_(2k+a) f_k and d gate_l / d f_k = scale
// sum_a u_(2k+a) rel_a.
//
// What bounds it on an H100: as K4, the per-pair instruction rate: a
// neighbour pair is visited twice (once from its row, once from its
// column), each time with one sincos per lane, the gate's 25 FMAs and
// shuffles, and the gradient terms (~60 FMAs per lane).
//
// Design (deterministic, no floating-point atomics, as K2):
//   1. mapped = features @ W_t^T (aggregate_common.cuh::mapped_kernel).
//   2. Row pass, one warp per query row (a fixed grid of `blocks` blocks
//      whose warps stride the rows): the row statistics as in K4, then the
//      neighbours one after another by ballot.  It writes gq_i (as
//      sum alpha dalpha k - D sum alpha k, so one pass suffices), the
//      i-side means gradient, the row statistics (max, denominator, D) for
//      the column pass, and per block the partial sums of gW_d (each of the
//      800 entries owned by one lane of each warp) and of the frequency
//      gradient.
//   3. Column pass, one warp per key column j: the neighbours i of j by
//      ballot, alpha_ij from the row statistics, dlogit_ij, and so gk_j,
//      gm_j (hence gf_j = W_t^T gm_j in the same warp), the j-side means
//      gradient added to the i-side one, and per block the partial sums of
//      gW_t.  Both passes compute each pair's logit, displacement and gate
//      with the same code, so they see the same bits.
//   4. A small kernel adds the per-block partials in block order.

#include <cuda_runtime.h>

#include "aggregate_common.cuh"

namespace {

using namespace agg;

constexpr int kRowPartial = k2E * kL + kF;  // gW_d (L, 2E) then gfreq (F)
constexpr int kColPartial = kL * kL;        // gW_t (L, L)

// d gate_l / d rel (x, y) and d gate_l / d f_k for this lane's octave.
struct GateGrad {
  float drx, dry;
  float df[kF];
};

__device__ __forceinline__ GateGrad gate_grad(const GateRow& w,
                                              const Trig& t, float rx,
                                              float ry,
                                              const float* __restrict__ freqs,
                                              int h) {
  const float scale = h ? 2.0f : 1.0f;
  GateGrad g;
  float drx = 0.0f, dry = 0.0f;
#pragma unroll
  for (int k = 0; k < kF; ++k) {
    const float ux = t.c[2 * k] * w.ws[2 * k] - t.s[2 * k] * w.wc[2 * k];
    const float uy =
        t.c[2 * k + 1] * w.ws[2 * k + 1] - t.s[2 * k + 1] * w.wc[2 * k + 1];
    const float f = freqs[k];
    drx = fmaf(ux, f, drx);
    dry = fmaf(uy, f, dry);
    g.df[k] = scale * (ux * rx + uy * ry);
  }
  g.drx = scale * drx;
  g.dry = scale * dry;
  return g;
}

__global__ void __launch_bounds__(kThreads) aggregate_bwd_row_kernel(
    const float* __restrict__ queries, const float* __restrict__ keys,
    const float* __restrict__ means, const float* __restrict__ radii,
    const float* __restrict__ mapped, const float* __restrict__ freqs,
    const float* __restrict__ dist, const float* __restrict__ cot, int n,
    float sigma_cut, int periodic, float period,
    float* __restrict__ gq, float* __restrict__ gmi,
    float* __restrict__ stats, float* __restrict__ partial) {
  __shared__ float s_part[kWarps][32][kE + kF];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int l = lane & 15, h = lane >> 4;
  GateRow w;
  w.load(dist, l, h);

  // This lane's share of gW_d (row l, octave h) and of the frequency
  // gradient, over every row the warp takes.
  float gw0 = 0.0f, gws[kFD], gwc[kFD], gfr[kF];
#pragma unroll
  for (int p = 0; p < kFD; ++p) gws[p] = gwc[p] = 0.0f;
#pragma unroll
  for (int k = 0; k < kF; ++k) gfr[k] = 0.0f;

  const int stride = gridDim.x * kWarps;
  for (int i = blockIdx.x * kWarps + warp; i < n; i += stride) {
    float q[kK];
#pragma unroll
    for (int c = 0; c < kK; ++c) q[c] = queries[i * kK + c];
    const float mxi = means[2 * i], myi = means[2 * i + 1];
    const float ri = finite_radius(radii[i]);
    const float gil = cot[i * kL + l];
    float m_row, s_row;
    row_stats(i, q, mxi, myi, ri, keys, means, radii, n, sigma_cut, periodic,
              period, lane, m_row, s_row);

    float d_row = 0.0f;          // D_i
    // Lane c: sum_j alpha dalpha k_jc and sum_j alpha k_jc.
    float a1 = 0.0f, a2 = 0.0f;
    float grx = 0.0f, gry = 0.0f;
    if (s_row > 0.0f) {  // warp-uniform
      for (int base = 0; base < n; base += 32) {
        const int j = base + lane;
        float rx = 0.0f, ry = 0.0f, lg = 0.0f;
        bool nb = false;
        if (j < n) {
          rx = displacement(means[2 * j], mxi, periodic, period);
          ry = displacement(means[2 * j + 1], myi, periodic, period);
          nb = neighbours(rx, ry, ri, finite_radius(radii[j]), sigma_cut, i,
                          j);
          if (nb) lg = logit(q, keys + j * kK);
        }
        unsigned todo = __ballot_sync(kFull, nb);
        while (todo) {
          const int src = __ffs(todo) - 1;
          todo &= todo - 1;
          const int jj = base + src;
          const float alpha =
              expf(__shfl_sync(kFull, lg, src) - m_row) / s_row;
          const float px = __shfl_sync(kFull, rx, src);
          const float py = __shfl_sync(kFull, ry, src);
          Trig t;
          const float gate = pair_gate(px, py, freqs, w, lane, t);
          const float mjl = mapped[jj * kL + l];
          const float dalpha = half_sum(gil * mjl * gate);
          d_row = fmaf(alpha, dalpha, d_row);
          const float kjc = keys[jj * kK + l];
          a1 = fmaf(alpha * dalpha, kjc, a1);
          a2 = fmaf(alpha, kjc, a2);

          const float gg = alpha * gil * mjl;  // ggate_l
          gw0 += gg;
#pragma unroll
          for (int p = 0; p < kFD; ++p) {
            gws[p] = fmaf(gg, t.s[p], gws[p]);
            gwc[p] = fmaf(gg, t.c[p], gwc[p]);
          }
          const GateGrad dg = gate_grad(w, t, px, py, freqs, h);
          grx = fmaf(gg, dg.drx, grx);
          gry = fmaf(gg, dg.dry, gry);
#pragma unroll
          for (int k = 0; k < kF; ++k) gfr[k] = fmaf(gg, dg.df[k], gfr[k]);
        }
      }
    }
    grx = warp_sum(grx);
    gry = warp_sum(gry);
    if (lane < kK) gq[i * kK + lane] = (a1 - d_row * a2) / 4.0f;
    if (lane == 0) {
      gmi[2 * i] = -grx;
      gmi[2 * i + 1] = -gry;
      stats[3 * i] = s_row > 0.0f ? m_row : 0.0f;
      stats[3 * i + 1] = s_row;
      stats[3 * i + 2] = d_row;
    }
  }

  // Per-block partials, summed over the warps in order.
  s_part[warp][lane][0] = gw0;
#pragma unroll
  for (int p = 0; p < kFD; ++p) {
    s_part[warp][lane][1 + p] = gws[p];
    s_part[warp][lane][1 + kFD + p] = gwc[p];
  }
#pragma unroll
  for (int k = 0; k < kF; ++k) s_part[warp][lane][kE + k] = gfr[k];
  __syncthreads();
  float* out = partial + blockIdx.x * kRowPartial;
  for (int t = threadIdx.x; t < kRowPartial; t += kThreads) {
    float acc = 0.0f;
    if (t < k2E * kL) {
      const int ll = t / k2E, e = t % k2E;
      const int src = (e / kE) * 16 + ll;
      for (int wi = 0; wi < kWarps; ++wi) acc += s_part[wi][src][e % kE];
    } else {
      const int k = t - k2E * kL;
      for (int wi = 0; wi < kWarps; ++wi)
        for (int src = 0; src < 32; ++src) acc += s_part[wi][src][kE + k];
    }
    out[t] = acc;
  }
}

__global__ void __launch_bounds__(kThreads) aggregate_bwd_col_kernel(
    const float* __restrict__ features, const float* __restrict__ transform,
    const float* __restrict__ queries, const float* __restrict__ keys,
    const float* __restrict__ means, const float* __restrict__ radii,
    const float* __restrict__ mapped, const float* __restrict__ freqs,
    const float* __restrict__ dist, const float* __restrict__ cot,
    const float* __restrict__ stats, const float* __restrict__ gmi, int n,
    float sigma_cut, int periodic, float period, float* __restrict__ gk,
    float* __restrict__ gf, float* __restrict__ gmeans,
    float* __restrict__ partial) {
  __shared__ float s_part[kWarps][32][kL / 2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int l = lane & 15, h = lane >> 4;
  GateRow w;
  w.load(dist, l, h);

  // Lane (h, l) keeps gW_t[l, 8h .. 8h + 7] over every key the warp takes.
  float gt[kL / 2];
#pragma unroll
  for (int c = 0; c < kL / 2; ++c) gt[c] = 0.0f;

  const int stride = gridDim.x * kWarps;
  for (int j = blockIdx.x * kWarps + warp; j < n; j += stride) {
    const float mxj = means[2 * j], myj = means[2 * j + 1];
    const float rj = finite_radius(radii[j]);
    const float mjl = mapped[j * kL + l];

    float gkc = 0.0f;  // lane c: sum_i dlogit_ij q_ic
    float gml = 0.0f;  // gm_jl
    float grx = 0.0f, gry = 0.0f;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      float rx = 0.0f, ry = 0.0f, lg = 0.0f;
      bool nb = false;
      if (i < n) {
        // rel_ij = mu_j - mu_i, exactly as the row pass forms it.
        rx = displacement(mxj, means[2 * i], periodic, period);
        ry = displacement(myj, means[2 * i + 1], periodic, period);
        nb = neighbours(rx, ry, finite_radius(radii[i]), rj, sigma_cut, i, j);
        if (nb) {
          float q[kK];
#pragma unroll
          for (int c = 0; c < kK; ++c) q[c] = queries[i * kK + c];
          lg = logit(q, keys + j * kK);
        }
      }
      unsigned todo = __ballot_sync(kFull, nb);
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int ii = base + src;
        const float alpha =
            expf(__shfl_sync(kFull, lg, src) - stats[3 * ii]) /
            stats[3 * ii + 1];
        const float px = __shfl_sync(kFull, rx, src);
        const float py = __shfl_sync(kFull, ry, src);
        Trig t;
        const float gate = pair_gate(px, py, freqs, w, lane, t);
        const float gil = cot[ii * kL + l];
        const float dalpha = half_sum(gil * mjl * gate);
        const float dlogit = alpha * (dalpha - stats[3 * ii + 2]);
        gkc = fmaf(dlogit, queries[ii * kK + l], gkc);
        gml = fmaf(alpha * gil, gate, gml);
        const float gg = alpha * gil * mjl;
        const GateGrad dg = gate_grad(w, t, px, py, freqs, h);
        grx = fmaf(gg, dg.drx, grx);
        gry = fmaf(gg, dg.dry, gry);
      }
    }
    grx = warp_sum(grx);
    gry = warp_sum(gry);
    // gf_jm = sum_l W_t[l, m] gm_jl, lane m.
    float gfm = 0.0f;
#pragma unroll
    for (int ll = 0; ll < kL; ++ll)
      gfm = fmaf(transform[ll * kL + l], __shfl_sync(kFull, gml, ll), gfm);
#pragma unroll
    for (int c = 0; c < kL / 2; ++c)
      gt[c] = fmaf(gml, features[j * kL + h * (kL / 2) + c], gt[c]);
    if (lane < kK) {
      gk[j * kK + lane] = gkc / 4.0f;
      gf[j * kL + lane] = gfm;
    }
    if (lane == 0) {
      gmeans[2 * j] = gmi[2 * j] + grx;
      gmeans[2 * j + 1] = gmi[2 * j + 1] + gry;
    }
  }

#pragma unroll
  for (int c = 0; c < kL / 2; ++c) s_part[warp][lane][c] = gt[c];
  __syncthreads();
  float* out = partial + blockIdx.x * kColPartial;
  for (int t = threadIdx.x; t < kColPartial; t += kThreads) {
    const int ll = t / kL, m = t % kL;
    const int src = (m / (kL / 2)) * 16 + ll;
    float acc = 0.0f;
    for (int wi = 0; wi < kWarps; ++wi) acc += s_part[wi][src][m % (kL / 2)];
    out[t] = acc;
  }
}

// gW_d, gfreq and gW_t: the per-block partials added in block order.
__global__ void __launch_bounds__(kThreads) reduce_kernel(
    const float* __restrict__ row_partial,
    const float* __restrict__ col_partial,
    int blocks, float* __restrict__ gdist, float* __restrict__ gfreq,
    float* __restrict__ gtransform) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t < kRowPartial) {
    float acc = 0.0f;
    for (int b = 0; b < blocks; ++b) acc += row_partial[b * kRowPartial + t];
    if (t < k2E * kL) gdist[t] = acc;
    else gfreq[t - k2E * kL] = acc;
  } else if (t < kRowPartial + kColPartial) {
    const int u = t - kRowPartial;
    float acc = 0.0f;
    for (int b = 0; b < blocks; ++b) acc += col_partial[b * kColPartial + u];
    gtransform[u] = acc;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Inputs as pigs_aggregate_fwd
// plus `cot` (n, 16), the cotangent of its output.  Scratch: mapped (n, 16),
// stats (n, 3), gmi (n, 2), row_partial (blocks, 806), col_partial
// (blocks, 256); `blocks` is the grid of both passes.  Outputs: gf, gq, gk
// (n, 16), gtransform (16, 16), gfreq (6,), gdist (16, 50), gmeans (n, 2).
// Launches on `stream` without synchronising and returns the first failing
// launch's cudaGetLastError() (0 on success).
extern "C" int pigs_aggregate_bwd(
    int n, const void* features, const void* transform, const void* queries,
    const void* keys, const void* frequencies, const void* distance_transform,
    const void* means, const void* radii, const void* cot, float sigma_cut,
    int periodic, float period, int blocks, void* mapped, void* stats,
    void* gmi, void* row_partial, void* col_partial, void* gf,
    void* gtransform, void* gq, void* gk, void* gfreq, void* gdist,
    void* gmeans, void* stream) {
  if (n == 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(features);
  const float* tr = static_cast<const float*>(transform);
  const float* q = static_cast<const float*>(queries);
  const float* k = static_cast<const float*>(keys);
  const float* fr = static_cast<const float*>(frequencies);
  const float* di = static_cast<const float*>(distance_transform);
  const float* mu = static_cast<const float*>(means);
  const float* r = static_cast<const float*>(radii);
  const float* g = static_cast<const float*>(cot);
  float* mp = static_cast<float*>(mapped);
  float* sts = static_cast<float*>(stats);
  float* gm_i = static_cast<float*>(gmi);
  float* rp = static_cast<float*>(row_partial);
  float* cp = static_cast<float*>(col_partial);

  mapped_kernel<<<(n * kL + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      f, tr, n, mp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  aggregate_bwd_row_kernel<<<blocks, kThreads, 0, st>>>(
      q, k, mu, r, mp, fr, di, g, n, sigma_cut, periodic, period,
      static_cast<float*>(gq), gm_i, sts, rp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  aggregate_bwd_col_kernel<<<blocks, kThreads, 0, st>>>(
      f, tr, q, k, mu, r, mp, fr, di, g, sts, gm_i, n, sigma_cut, periodic,
      period, static_cast<float*>(gk), static_cast<float*>(gf),
      static_cast<float*>(gmeans), cp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<(kRowPartial + kColPartial + kThreads - 1) / kThreads,
                  kThreads, 0, st>>>(rp, cp, blocks,
                                     static_cast<float*>(gdist),
                                     static_cast<float*>(gfreq),
                                     static_cast<float*>(gtransform));
  return static_cast<int>(cudaGetLastError());
}
