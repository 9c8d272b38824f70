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
// What bounds it on an H100: as K4, the latency of the warps with the most
// neighbour pairs.  A pair is visited twice, once from its row and once
// from its column, each time with 24 angles, the gate's 25 FMAs a lane and
// the gradient terms (~110 floating-point instructions a lane in the row
// pass, ~60 in the column pass); the inputs are tiny and stay in L1/L2.
// The first design gave each row (and each column) one warp over all n
// keys, 264 blocks at most, and scanned the keys twice in the row pass;
// the models keep their active Gaussians in the first slots, so a few
// warps walked 190-520 pairs one after another while the card idled.
//
// Design: K4's grid for every pass over pairs (aggregate_kernel.py::
// fwd_geometry: tiles of 4 rows, or 4 columns, x slices of the other axis,
// slice s taking its 32-wide chunks s, s + S, s + 2 S, ...), so that every
// slice holds a share of each row's neighbours.  Per chunk, as in K4, a
// warp tests its 32 candidates, ranks the neighbours into a per-warp stage
// in shared memory and spreads the chunk's sincos over the lanes; then,
// two pairs in flight (four in the column pass, which holds fewer
// accumulators), lane (octave h, feature l) reads its octave's sin and cos
// as float4s.  Seven kernels, all on `stream`:
//   1. mapped = features @ W_t^T (aggregate_common.cuh::mapped_kernel).
//   2. Statistics: warp (row i, slice s) takes the neighbour test and the
//      logit only and writes an online (max, sum) record of the row in the
//      slice.
//   3. Row pass: warp (row i, slice s) merges the row's statistics records
//      in slice order (merge_stats: a slice with no neighbour is skipped,
//      so no -inf - -inf reaches an exp), so it knows alpha_ij, and writes
//      a record of D's share, sum alpha dalpha k_j, sum alpha k_j and the
//      i-side means gradient; per block, the partial sums of gW_d (lane
//      (h, l) owns row l, octave h) and of gfreq.
//   4. Row merge, in slice order: gq_i = (a1 - D_i a2) / 4, the i-side
//      means gradient, and the row's (max, sum, D) for the column pass.  A
//      row with no neighbour gets exact zeros.
//   5. Column pass: warp (column j, slice s of the rows) reads (max, sum,
//      D) of each neighbour row i and writes a record of sum dlogit q_i,
//      gm_j and the j-side means gradient.  It forms rel_ij, the neighbour
//      test and the logit exactly as the row pass does, so both passes
//      decide every pair alike and see the same alpha.
//   6. Column merge, in slice order: gk_j, gm_j, gf_j = W_t^T gm_j and
//      gmeans_j; per block (a fixed grid whose warps stride the columns),
//      the partial sums of gW_t = sum_j gm_j f_j^T.
//   7. gW_d, gfreq and gW_t from the block partials in two levels: 16
//      runs of blocks each summed in order, then the runs in order.
// No floating-point atomics: every sum has a fixed order set by n and the
// slice count, so two launches give the same bits.

#include <cuda_runtime.h>

#include "aggregate_common.cuh"

namespace {

using namespace agg;

constexpr int kTrig = 2 * kFD;             // sin and cos of one octave
constexpr int kStat = 2;                   // a row's (max, sum) in a slice
constexpr int kRowRec = 1 + 2 * kK + 2;    // D, a1[K], a2[K], grel (x, y)
constexpr int kColRec = kK + kL + 2;       // gk[K], gm[L], grel (x, y)
constexpr int kRowPartial = k2E * kL + kF;  // gW_d (L, 2E) then gfreq (F)
constexpr int kColPartial = kL * kL;        // gW_t (L, L)
constexpr int kMaxMergeBlocks = 264;        // the column merge's grid
constexpr int kReduceEntries = 32;          // entries a reduce block sums
constexpr int kReduceRuns = 16;             // runs of blocks per entry

// One warp's staging area for the neighbours of a 32-wide chunk, by rank
// (aggregate_fwd.cu's Stage, with alpha, D_i and the warp's own query or
// key row): displacement, alpha, D_i (column pass), the other index, and
// the sin and cos of both octaves.
struct Stage {
  float rx[32], ry[32], alpha[32], d[32];
  int idx[32];
  float vec[kK];
  float4 trig[32][2][kTrig / 4];  // [rank][octave]: sin[12], cos[12]
};

// A lane's share of gW_d (row l, octave h) and of gfreq.
struct WeightGrad {
  float w0;
  float s[kFD], c[kFD];
  float fr[kF];
};

// Row i's (max, sum) over every key from its slice records, in slice
// order: the max over the slices with a neighbour, then the sum of their
// sums rescaled to it.  (0, 0) for a row with no neighbour.
__device__ __forceinline__ void merge_stats(const float* __restrict__ stat,
                                            int slices, int n, int i,
                                            float& m_row, float& s_row) {
  float top = -INFINITY;
  for (int s = 0; s < slices; ++s) {
    const float* r = stat + ((size_t)s * n + i) * kStat;
    if (r[1] > 0.0f) top = fmaxf(top, r[0]);
  }
  float den = 0.0f;
  for (int s = 0; s < slices; ++s) {
    const float* r = stat + ((size_t)s * n + i) * kStat;
    if (r[1] > 0.0f) den = fmaf(expf(r[0] - top), r[1], den);
  }
  m_row = den > 0.0f ? top : 0.0f;
  s_row = den;
}

// The sincos of a chunk's `count` staged pairs spread over the lanes, entry
// e = (rank, octave, k): sincos(f_(k/2) scale_octave rel_(k%2)), as K4.
__device__ __forceinline__ void fill_trig(Stage& st, int count,
                                          const float* __restrict__ freqs,
                                          int lane) {
  for (int e = lane; e < count * kTrig; e += 32) {
    const int rank = e / kTrig, r = e - rank * kTrig;
    const int oct = r / kFD, k = r - oct * kFD;
    float rel = (k & 1) ? st.ry[rank] : st.rx[rank];
    if (oct) rel = 2.0f * rel;
    float sn, cs;
    sincosf(rel * freqs[k >> 1], &sn, &cs);
    float* t = reinterpret_cast<float*>(st.trig[rank][oct]);
    t[k] = sn;
    t[kFD + k] = cs;
  }
}

// One staged pair for lane (h, l): returns this octave's share of gate_l
// (the sin and the cos terms in two chains) and sets (tx, ty) = sum_k f_k
// u_(2k+a), a = x, y; with kWeights, also adds ggate_l = gg times the
// pair's embedding to gW_d's share in `acc` and ggs d gate_l / d f_k /
// scale to gfreq's (ggs = scale gg); without, `acc` is not read.
template <bool kWeights>
__device__ __forceinline__ float staged_gate(const float4* __restrict__ trig,
                                             const GateRow& w,
                                             const float (&f)[kF], float rx,
                                             float ry, float gg, float ggs,
                                             float& tx, float& ty,
                                             WeightGrad* acc) {
  float part_s = w.w0, part_c = 0.0f;
  tx = 0.0f;
  ty = 0.0f;
#pragma unroll
  for (int b = 0; b < kFD / 4; ++b) {
    const float4 sv = trig[b], cv = trig[kFD / 4 + b];
    const float sn[4] = {sv.x, sv.y, sv.z, sv.w};
    const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = 4 * b + u;
      part_s = fmaf(w.ws[p], sn[u], part_s);
      part_c = fmaf(w.wc[p], cs[u], part_c);
      if constexpr (kWeights) {
        acc->s[p] = fmaf(gg, sn[u], acc->s[p]);
        acc->c[p] = fmaf(gg, cs[u], acc->c[p]);
      }
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int k = 2 * b + v, p = 2 * k;
      const float ux = cs[2 * v] * w.ws[p] - sn[2 * v] * w.wc[p];
      const float uy =
          cs[2 * v + 1] * w.ws[p + 1] - sn[2 * v + 1] * w.wc[p + 1];
      tx = fmaf(ux, f[k], tx);
      ty = fmaf(uy, f[k], ty);
      if constexpr (kWeights)
        acc->fr[k] = fmaf(ggs, fmaf(ux, rx, uy * ry), acc->fr[k]);
    }
  }
  return part_s + part_c;
}

// 2. Warp (row i, slice blockIdx.y): the row's online (max, sum) over the
// slice's neighbours; (-inf, 0) where the slice holds none.
__global__ void __launch_bounds__(kThreads) aggregate_bwd_stats_kernel(
    const float* __restrict__ queries, const float* __restrict__ keys,
    const float* __restrict__ means, const float* __restrict__ radii, int n,
    float sigma_cut, int periodic, float period, float* __restrict__ stat) {
  __shared__ float sq[kWarps][kK];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= n) return;  // the whole warp leaves together
  if (lane < kK) sq[warp][lane] = queries[i * kK + lane];
  __syncwarp();
  const float mxi = means[2 * i], myi = means[2 * i + 1];
  const float ri = finite_radius(radii[i]);
  float m = -INFINITY, s = 0.0f;
  for (int j = blockIdx.y * 32 + lane; j < n; j += gridDim.y * 32) {
    const float rx = displacement(means[2 * j], mxi, periodic, period);
    const float ry = displacement(means[2 * j + 1], myi, periodic, period);
    if (!neighbours(rx, ry, ri, finite_radius(radii[j]), sigma_cut, i, j))
      continue;
    const float lg = logit(sq[warp], keys + j * kK);
    if (lg > m) {
      s = s * expf(m - lg) + 1.0f;
      m = lg;
    } else {
      s += expf(lg - m);
    }
  }
  const float m_row = warp_max(m);
  const float s_row = warp_sum(s > 0.0f ? s * expf(m - m_row) : 0.0f);
  if (lane == 0) {
    float* rec = stat + ((size_t)blockIdx.y * n + i) * kStat;
    rec[0] = m_row;
    rec[1] = s_row;
  }
}

// 3. Warp (row i, slice blockIdx.y): the row's record in the slice, and the
// block's partial sums of gW_d and gfreq.
union RowShared {
  Stage st[kWarps];
  float part[kWarps][32][kE + kF];  // after the pairs: the lanes' shares
};

__global__ void __launch_bounds__(kThreads) aggregate_bwd_row_kernel(
    const float* __restrict__ queries, const float* __restrict__ keys,
    const float* __restrict__ means, const float* __restrict__ radii,
    const float* __restrict__ mapped, const float* __restrict__ freqs,
    const float* __restrict__ dist, const float* __restrict__ cot,
    const float* __restrict__ stat, int n, float sigma_cut, int periodic,
    float period, float* __restrict__ row_rec, float* __restrict__ partial) {
  __shared__ RowShared sh;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarps + warp;
  const int l = lane & 15, h = lane >> 4;
  Stage& st = sh.st[warp];
  GateRow w;
  w.load(dist, l, h);
  float f[kF];
#pragma unroll
  for (int k = 0; k < kF; ++k) f[k] = freqs[k];
  WeightGrad acc;
  acc.w0 = 0.0f;
#pragma unroll
  for (int p = 0; p < kFD; ++p) acc.s[p] = acc.c[p] = 0.0f;
#pragma unroll
  for (int k = 0; k < kF; ++k) acc.fr[k] = 0.0f;

  if (i < n) {  // warp-uniform; every warp meets the block's barriers below
    float m_row, s_row;
    merge_stats(stat, gridDim.y, n, i, m_row, s_row);
    if (lane < kK) st.vec[lane] = queries[i * kK + lane];
    __syncwarp();
    const float mxi = means[2 * i], myi = means[2 * i + 1];
    const float ri = finite_radius(radii[i]);
    const float gil = cot[i * kL + l];
    float d_row = 0.0f;          // D's share
    float a1 = 0.0f, a2 = 0.0f;  // lane c: sum alpha dalpha k_jc, alpha k_jc
    float grx = 0.0f, gry = 0.0f;
    if (s_row > 0.0f) {  // warp-uniform
      for (int base = blockIdx.y * 32; base < n; base += gridDim.y * 32) {
        const int j = base + lane;
        float rx = 0.0f, ry = 0.0f, lg = 0.0f;
        bool nb = false;
        if (j < n) {
          rx = displacement(means[2 * j], mxi, periodic, period);
          ry = displacement(means[2 * j + 1], myi, periodic, period);
          nb = neighbours(rx, ry, ri, finite_radius(radii[j]), sigma_cut, i,
                          j);
          if (nb) lg = logit(st.vec, keys + j * kK);
        }
        const unsigned todo = __ballot_sync(kFull, nb);
        if (!todo) continue;  // warp-uniform
        const int count = __popc(todo);
        if (nb) {
          const int rank = __popc(todo & ((1u << lane) - 1u));
          st.rx[rank] = rx;
          st.ry[rank] = ry;
          st.alpha[rank] = expf(lg - m_row) / s_row;
          st.idx[rank] = j;
        }
        __syncwarp();
        fill_trig(st, count, freqs, lane);
        __syncwarp();
#pragma unroll 2
        for (int rank = 0; rank < count; ++rank) {
          const int jj = st.idx[rank];
          const float alpha = st.alpha[rank];
          const float gm = gil * mapped[jj * kL + l];
          const float gg = alpha * gm;  // ggate_l
          const float ggs = h ? 2.0f * gg : gg;
          float tx, ty;
          const float part = staged_gate<true>(st.trig[rank][h], w, f,
                                               st.rx[rank], st.ry[rank], gg,
                                               ggs, tx, ty, &acc);
          acc.w0 += gg;
          grx = fmaf(ggs, tx, grx);
          gry = fmaf(ggs, ty, gry);
          const float gate = part + __shfl_xor_sync(kFull, part, 16);
          const float dalpha = half_sum(gm * gate);
          d_row = fmaf(alpha, dalpha, d_row);
          const float kjc = keys[jj * kK + l];
          a1 = fmaf(alpha * dalpha, kjc, a1);
          a2 = fmaf(alpha, kjc, a2);
        }
        __syncwarp();  // the stage is read before the next chunk writes it
      }
    }
    grx = warp_sum(grx);
    gry = warp_sum(gry);
    float* rec = row_rec + ((size_t)blockIdx.y * n + i) * kRowRec;
    if (lane < kK) {
      rec[1 + lane] = a1;
      rec[1 + kK + lane] = a2;
    }
    if (lane == 0) {
      rec[0] = d_row;
      rec[1 + 2 * kK] = grx;
      rec[2 + 2 * kK] = gry;
    }
  }

  // Per-block partials, summed over the warps in order.
  __syncthreads();  // every stage is read: the shared memory takes the shares
  float* share = sh.part[warp][lane];
  share[0] = acc.w0;
#pragma unroll
  for (int p = 0; p < kFD; ++p) {
    share[1 + p] = acc.s[p];
    share[1 + kFD + p] = acc.c[p];
  }
#pragma unroll
  for (int k = 0; k < kF; ++k) share[kE + k] = acc.fr[k];
  __syncthreads();
  float* out =
      partial + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kRowPartial;
  for (int t = threadIdx.x; t < kRowPartial; t += kThreads) {
    float sum = 0.0f;
    if (t < k2E * kL) {
      const int ll = t / k2E, e = t % k2E;
      const int src = (e / kE) * 16 + ll;
      for (int wi = 0; wi < kWarps; ++wi) sum += sh.part[wi][src][e % kE];
    } else {
      const int k = t - k2E * kL;
      for (int wi = 0; wi < kWarps; ++wi)
        for (int src = 0; src < 32; ++src) sum += sh.part[wi][src][kE + k];
    }
    out[t] = sum;
  }
}

// 4. Row i's records in slice order, one thread per (row, feature c):
// gq, and from c = 0 the i-side means gradient and (max, sum, D).
__global__ void __launch_bounds__(kThreads) aggregate_bwd_row_merge_kernel(
    const float* __restrict__ stat, const float* __restrict__ row_rec,
    int slices, int n, float* __restrict__ gq, float* __restrict__ gmi,
    float* __restrict__ stats) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n * kK) return;
  const int i = idx / kK, c = idx % kK;
  float d = 0.0f, a1 = 0.0f, a2 = 0.0f, grx = 0.0f, gry = 0.0f;
  for (int s = 0; s < slices; ++s) {
    const float* rec = row_rec + ((size_t)s * n + i) * kRowRec;
    d += rec[0];
    a1 += rec[1 + c];
    a2 += rec[1 + kK + c];
    grx += rec[1 + 2 * kK];
    gry += rec[2 + 2 * kK];
  }
  gq[idx] = (a1 - d * a2) / 4.0f;
  if (c == 0) {
    gmi[2 * i] = -grx;
    gmi[2 * i + 1] = -gry;
    float m_row, s_row;
    merge_stats(stat, slices, n, i, m_row, s_row);
    stats[3 * i] = m_row;
    stats[3 * i + 1] = s_row;
    stats[3 * i + 2] = d;
  }
}

// 5. Warp (column j, slice blockIdx.y of the rows): the column's record.
__global__ void __launch_bounds__(kThreads) aggregate_bwd_col_kernel(
    const float* __restrict__ queries, const float* __restrict__ keys,
    const float* __restrict__ means, const float* __restrict__ radii,
    const float* __restrict__ mapped, const float* __restrict__ freqs,
    const float* __restrict__ dist, const float* __restrict__ cot,
    const float* __restrict__ stats, int n, float sigma_cut, int periodic,
    float period, float* __restrict__ col_rec) {
  __shared__ Stage stages[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kWarps + warp;
  if (j >= n) return;  // the whole warp leaves together
  const int l = lane & 15, h = lane >> 4;
  Stage& st = stages[warp];
  GateRow w;
  w.load(dist, l, h);
  float f[kF];
#pragma unroll
  for (int k = 0; k < kF; ++k) f[k] = freqs[k];
  if (lane < kK) st.vec[lane] = keys[j * kK + lane];
  __syncwarp();
  const float mxj = means[2 * j], myj = means[2 * j + 1];
  const float rj = finite_radius(radii[j]);
  const float mjl = mapped[j * kL + l];

  float gkc = 0.0f;  // lane c: sum_i dlogit_ij q_ic
  float gml = 0.0f;  // gm_jl
  float grx = 0.0f, gry = 0.0f;
  for (int base = blockIdx.y * 32; base < n; base += gridDim.y * 32) {
    const int i = base + lane;
    float rx = 0.0f, ry = 0.0f, lg = 0.0f;
    bool nb = false;
    if (i < n) {
      // rel_ij = mu_j - mu_i, exactly as the row pass forms it.
      rx = displacement(mxj, means[2 * i], periodic, period);
      ry = displacement(myj, means[2 * i + 1], periodic, period);
      nb = neighbours(rx, ry, finite_radius(radii[i]), rj, sigma_cut, i, j);
      // logit(k_j, q_i): fmaf(k, q, acc) = fmaf(q, k, acc) bit for bit, so
      // this is the row pass's logit(q_i, k_j).
      if (nb) lg = logit(st.vec, queries + i * kK);
    }
    const unsigned todo = __ballot_sync(kFull, nb);
    if (!todo) continue;  // warp-uniform
    const int count = __popc(todo);
    if (nb) {
      const int rank = __popc(todo & ((1u << lane) - 1u));
      st.rx[rank] = rx;
      st.ry[rank] = ry;
      st.alpha[rank] = expf(lg - stats[3 * i]) / stats[3 * i + 1];
      st.d[rank] = stats[3 * i + 2];
      st.idx[rank] = i;
    }
    __syncwarp();
    fill_trig(st, count, freqs, lane);
    __syncwarp();
#pragma unroll 4
    for (int rank = 0; rank < count; ++rank) {
      const int ii = st.idx[rank];
      const float alpha = st.alpha[rank];
      const float gil = cot[ii * kL + l];
      const float gm = gil * mjl;
      const float gg = alpha * gm;
      const float ggs = h ? 2.0f * gg : gg;
      float tx, ty;
      const float part = staged_gate<false>(st.trig[rank][h], w, f,
                                            st.rx[rank], st.ry[rank], gg,
                                            ggs, tx, ty, nullptr);
      grx = fmaf(ggs, tx, grx);
      gry = fmaf(ggs, ty, gry);
      const float gate = part + __shfl_xor_sync(kFull, part, 16);
      const float dalpha = half_sum(gm * gate);
      const float dlogit = alpha * (dalpha - st.d[rank]);
      gkc = fmaf(dlogit, queries[ii * kK + l], gkc);
      gml = fmaf(alpha * gil, gate, gml);
    }
    __syncwarp();
  }
  grx = warp_sum(grx);
  gry = warp_sum(gry);
  float* rec = col_rec + ((size_t)blockIdx.y * n + j) * kColRec;
  if (lane < kK) {
    rec[lane] = gkc;
    rec[kK + lane] = gml;
  }
  if (lane == 0) {
    rec[kK + kL] = grx;
    rec[kK + kL + 1] = gry;
  }
}

// 6. Column j's records in slice order, one warp a column (the block's
// warps stride the columns): gk, gf, gmeans, and the block's partial sums
// of gW_t (lane (h, l) keeps gW_t[l, 8h .. 8h + 7]).
__global__ void __launch_bounds__(kThreads) aggregate_bwd_col_merge_kernel(
    const float* __restrict__ features, const float* __restrict__ transform,
    const float* __restrict__ col_rec, const float* __restrict__ gmi,
    int slices, int n, float* __restrict__ gk, float* __restrict__ gf,
    float* __restrict__ gmeans, float* __restrict__ partial) {
  __shared__ float s_part[kWarps][32][kL / 2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int l = lane & 15, h = lane >> 4;
  float gt[kL / 2];
#pragma unroll
  for (int c = 0; c < kL / 2; ++c) gt[c] = 0.0f;
  for (int j = blockIdx.x * kWarps + warp; j < n; j += gridDim.x * kWarps) {
    float gkc = 0.0f, gml = 0.0f, grx = 0.0f, gry = 0.0f;
    for (int s = 0; s < slices; ++s) {
      const float* rec = col_rec + ((size_t)s * n + j) * kColRec;
      gkc += rec[l];
      gml += rec[kK + l];
      grx += rec[kK + kL];
      gry += rec[kK + kL + 1];
    }
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
  float* out = partial + (size_t)blockIdx.x * kColPartial;
  for (int t = threadIdx.x; t < kColPartial; t += kThreads) {
    const int ll = t / kL, m = t % kL;
    const int src = (m / (kL / 2)) * 16 + ll;
    float sum = 0.0f;
    for (int wi = 0; wi < kWarps; ++wi) sum += s_part[wi][src][m % (kL / 2)];
    out[t] = sum;
  }
}

// 7. gW_d, gfreq (from the row pass's blocks) and gW_t (from the column
// merge's): block b takes 32 entries; warp r of the block adds run r of
// the blocks in order, then the runs are added in order.
__global__ void __launch_bounds__(kReduceEntries* kReduceRuns)
    aggregate_bwd_reduce_kernel(const float* __restrict__ row_partial,
                                int row_blocks,
                                const float* __restrict__ col_partial,
                                int col_blocks, float* __restrict__ gdist,
                                float* __restrict__ gfreq,
                                float* __restrict__ gtransform) {
  __shared__ float runs[kReduceRuns][kReduceEntries];
  constexpr int kRowTiles =
      (kRowPartial + kReduceEntries - 1) / kReduceEntries;
  const int lane = threadIdx.x % kReduceEntries;
  const int r = threadIdx.x / kReduceEntries;
  const bool row = blockIdx.x < kRowTiles;
  const int width = row ? kRowPartial : kColPartial;
  const int blocks = row ? row_blocks : col_blocks;
  const float* src = row ? row_partial : col_partial;
  const int t =
      (row ? blockIdx.x : blockIdx.x - kRowTiles) * kReduceEntries + lane;
  float sum = 0.0f;
  if (t < width) {
    const int lo = r * blocks / kReduceRuns;
    const int hi = (r + 1) * blocks / kReduceRuns;
    for (int b = lo; b < hi; ++b) sum += src[(size_t)b * width + t];
  }
  runs[r][lane] = sum;
  __syncthreads();
  if (r != 0 || t >= width) return;
  float total = 0.0f;
  for (int q = 0; q < kReduceRuns; ++q) total += runs[q][lane];
  if (!row) gtransform[t] = total;
  else if (t < k2E * kL) gdist[t] = total;
  else gfreq[t - k2E * kL] = total;
}

// The scratch of one launch, in floats, in this order.
struct Scratch {
  size_t mapped, stat, row_rec, row_partial, stats, gmi, col_rec,
      col_partial, total;
  __host__ Scratch(int n, int slices) {
    const size_t nn = n, ss = slices;
    const size_t tiles = (n + kWarps - 1) / kWarps;
    mapped = 0;
    stat = mapped + nn * kL;
    row_rec = stat + ss * nn * kStat;
    row_partial = row_rec + ss * nn * kRowRec;
    stats = row_partial + tiles * ss * kRowPartial;
    gmi = stats + nn * 3;
    col_rec = gmi + nn * 2;
    col_partial = col_rec + ss * nn * kColRec;
    total = col_partial + merge_blocks(n) * (size_t)kColPartial;
  }
  static int merge_blocks(int n) {
    const int tiles = (n + kWarps - 1) / kWarps;
    return tiles < kMaxMergeBlocks ? tiles : kMaxMergeBlocks;
  }
};

}  // namespace

// Floats of scratch pigs_aggregate_bwd takes for n Gaussians in `slices`
// slices.
extern "C" long long pigs_aggregate_bwd_scratch(int n, int slices) {
  return static_cast<long long>(Scratch(n, slices).total);
}

// Plain C entry point, loaded with ctypes.  Inputs as pigs_aggregate_fwd
// plus `cot` (n, 16), the cotangent of its output; `slices` cuts the
// summed axis of the statistics, row and column passes as K4's `slices`
// (slice s takes the 32-wide chunks s, s + slices, ...; 1 <= slices <= the
// number of chunks), and `scratch` holds pigs_aggregate_bwd_scratch(n,
// slices) floats.  Outputs: gf, gq, gk (n, 16), gtransform (16, 16), gfreq
// (6,), gdist (16, 50), gmeans (n, 2).  Launches on `stream` without
// synchronising and returns the first failing launch's cudaGetLastError()
// (0 on success).
extern "C" int pigs_aggregate_bwd(
    int n, const void* features, const void* transform, const void* queries,
    const void* keys, const void* frequencies, const void* distance_transform,
    const void* means, const void* radii, const void* cot, float sigma_cut,
    int periodic, float period, int slices, void* scratch, void* gf,
    void* gtransform, void* gq, void* gk, void* gfreq, void* gdist,
    void* gmeans, void* stream) {
  if (n <= 0 || slices < 1 || slices > (n + 31) / 32 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
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
  const Scratch at(n, slices);
  float* base = static_cast<float*>(scratch);
  float* mp = base + at.mapped;
  float* stat = base + at.stat;
  float* row_rec = base + at.row_rec;
  float* row_partial = base + at.row_partial;
  float* stats = base + at.stats;
  float* gmi = base + at.gmi;
  float* col_rec = base + at.col_rec;
  float* col_partial = base + at.col_partial;
  const int tiles = (n + kWarps - 1) / kWarps;
  const int merge_blocks = Scratch::merge_blocks(n);
  const dim3 grid(tiles, slices);
  const int entry_blocks = (n * kK + kThreads - 1) / kThreads;

  mapped_kernel<<<(n * kL + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      f, tr, n, mp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  aggregate_bwd_stats_kernel<<<grid, kThreads, 0, st>>>(
      q, k, mu, r, n, sigma_cut, periodic, period, stat);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  aggregate_bwd_row_kernel<<<grid, kThreads, 0, st>>>(
      q, k, mu, r, mp, fr, di, g, stat, n, sigma_cut, periodic, period,
      row_rec, row_partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  aggregate_bwd_row_merge_kernel<<<entry_blocks, kThreads, 0, st>>>(
      stat, row_rec, slices, n, static_cast<float*>(gq), gmi, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  aggregate_bwd_col_kernel<<<grid, kThreads, 0, st>>>(
      q, k, mu, r, mp, fr, di, g, stats, n, sigma_cut, periodic, period,
      col_rec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  aggregate_bwd_col_merge_kernel<<<merge_blocks, kThreads, 0, st>>>(
      f, tr, col_rec, gmi, slices, n, static_cast<float*>(gk),
      static_cast<float*>(gf), static_cast<float*>(gmeans), col_partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kReduceBlocks =
      (kRowPartial + kReduceEntries - 1) / kReduceEntries +
      (kColPartial + kReduceEntries - 1) / kReduceEntries;
  aggregate_bwd_reduce_kernel<<<kReduceBlocks, kReduceEntries * kReduceRuns,
                                0, st>>>(
      row_partial, tiles * slices, col_partial, merge_blocks,
      static_cast<float*>(gdist), static_cast<float*>(gfreq),
      static_cast<float*>(gtransform));
  return static_cast<int>(cudaGetLastError());
}
