// K4: fused forward of the masked-softmax neighbour aggregation.
//
// Replaces pigs_tpu/ops/pallas_aggregate.py::_fwd_kernel (with _tile_alpha
// and _chunk_out; launched by _forward).  For each query Gaussian i over all
// keys j:
//   mapped_j = W_t f_j
//   logit_ij = <q_i, k_j> / sqrt(K)
//   nb_ij    = the neighbour rule (aggregate_common.cuh)
//   alpha_ij = exp(logit_ij - max_j' logit_ij') / sum_j' exp(...) over the
//              neighbours, 0 elsewhere; a row with no neighbour is exactly 0
//   out_i    = sum_j alpha_ij mapped_j * (W_d emb(mu_j - mu_i)),
//              emb = [pe(r), pe(2r)], pe(r) = [1, sin(f_k r_a), cos(f_k r_a)]
// with the distance transform W_d in the dense layout (flat index k d + a in
// each sin/cos block, octave 2 at offset E): the TPU kernel's grouped layout
// and its _group_permutation are not carried over.
//
// What bounds it on an H100: the inputs are tiny (n x 52 floats) and stay in
// L1/L2; the work is per pair.  Every pair pays the neighbour test; a
// neighbour pair pays its logit (16 FMAs), 24 sincos and, per lane of the
// warp, 25 FMAs for its gate.  At the models' states an active Gaussian
// has 130-240 neighbours of 640-1664 slots (up to 523), so the neighbour
// pairs dominate, and a row's pairs are walked one after another: the
// kernel is bound by the latency of the warps with the most pairs, not by
// bytes or by the card's issue rate.
//
// Design: a first small kernel forms mapped = features @ W_t^T (n, L), one
// thread per entry (aggregate_common.cuh::mapped_kernel).  The main kernel
// runs a 2-D grid of query-row tiles x key slices: a block of 4 warps takes
// 4 query rows, one a warp, and blockIdx.y one slice of the key axis.  The
// first design gave one warp to each row over all n keys, so its grid was
// n / 4 blocks (160 at n = 640, 1.2 per SM), and each warp scanned the keys
// twice: a pass for the row's max and denominator, then a pass that
// recomputed the neighbour test and the logit.
//  * Slices.  The wrapper picks their number as the mixture kernels do
//    (aggregate_kernel.py::fwd_geometry: about 6 blocks, 24 warps, per SM,
//    at least 2; at n = 1664 two slices, at n = 640 five, from n = 4096 on
//    one), and the keys are dealt out in chunks of 32 (one ballot): slice s
//    takes chunks s, s + S, s + 2 S, ...  The models keep their active
//    Gaussians in the first slots (0-583 of 1664 in the training state), so
//    runs of keys would give one slice every neighbour of every row and
//    leave the other idle; dealt chunks give each slice a share.  The time
//    is set by the warps with the most neighbour pairs.
//  * One pass with an online softmax.  Per chunk the lanes test their keys
//    and take their logits; a ballot finds the neighbours; when a logit
//    passes the running max m (a vote), the warp's max rescales acc and the
//    sums by exp(m_old - m); each neighbour lane forms p = exp(logit - m)
//    and adds it to its own sum (the lanes' sums meet once, at the end).
//  * The gates of a chunk's neighbours.  The neighbours are ranked into a
//    per-warp stage in shared memory; the lanes then share the chunk's
//    sincos work, 24 angles a pair, instead of 12 lanes of the warp taking
//    one pair's angles while 20 wait; then, two pairs in flight, lane
//    (octave h, feature l) reads its octave's 12 sin and 12 cos as float4s
//    and forms its GateRow's sum w0 + sum_k (ws_k sin_k + wc_k cos_k)
//    (aggregate_common.cuh), the halves meet by one shuffle, and lane l
//    adds p mapped_jl gate_l to acc_l.  A pair's gate costs 6 shared loads
//    and one shuffle on the warp's path, not a sincos and 25 shuffles, as
//    a gate formed by one lane a pair would.
//  * With one slice the warp writes acc / s, or exactly 0 for a row with no
//    neighbour.  With several it writes (m, s, acc) to scratch
//    (slices, n, 18), and a last small kernel merges a row's slices in
//    slice order: M = max m over the slices with s > 0, out = sum e^(m - M)
//    acc / sum e^(m - M) s over those slices; a slice with no neighbour is
//    skipped, so no -inf - -inf reaches an exp, and a row empty in every
//    slice writes exactly 0.
// No atomics: every sum has a fixed order set by n and the SM count, so
// the result is deterministic.

#include <cuda_runtime.h>

#include "aggregate_common.cuh"

namespace {

using namespace agg;

constexpr int kRecord = 2 + kL;  // a row's (m, s, acc[16]) in one slice
constexpr int kTrig = 2 * kFD;    // sin and cos of one octave

// One warp's staging area for the neighbours of a 32-key chunk, by rank:
// displacement, weight p, key index, and the sin and cos of both octaves.
struct Stage {
  float rx[32], ry[32], p[32];
  int j[32];
  float4 trig[32][2][kTrig / 4];  // [rank][octave]: sin[12], cos[12]
};

__global__ void __launch_bounds__(kThreads) aggregate_fwd_kernel(
    const float* __restrict__ queries, const float* __restrict__ keys,
    const float* __restrict__ means, const float* __restrict__ radii,
    const float* __restrict__ mapped, const float* __restrict__ freqs,
    const float* __restrict__ dist, int n, float sigma_cut, int periodic,
    float period,
    float* __restrict__ partials,       // (slices, n, kRecord), or null
    float* __restrict__ out) {          // (n, kL) when partials is null
  __shared__ Stage stages[kWarps];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp leaves together
  Stage& st = stages[threadIdx.x >> 5];
  const int l = lane & 15;
  const int h = lane >> 4;

  GateRow w;
  w.load(dist, l, h);
  float q[kK];
#pragma unroll
  for (int c = 0; c < kK; ++c) q[c] = queries[i * kK + c];
  const float mxi = means[2 * i], myi = means[2 * i + 1];
  const float ri = finite_radius(radii[i]);

  // The running max is the same in every lane; each lane sums the p of its
  // own keys (s_lane), and lane l (either half) holds feature l of acc.
  float m_run = -INFINITY, s_lane = 0.0f, acc = 0.0f;
  for (int base = blockIdx.y * 32; base < n; base += gridDim.y * 32) {
    const int j = base + lane;
    float rx = 0.0f, ry = 0.0f, lg = -INFINITY;
    bool nb = false;
    if (j < n) {
      rx = displacement(means[2 * j], mxi, periodic, period);
      ry = displacement(means[2 * j + 1], myi, periodic, period);
      nb = neighbours(rx, ry, ri, finite_radius(radii[j]), sigma_cut, i, j);
      if (nb) lg = logit(q, keys + j * kK);
    }
    const unsigned todo = __ballot_sync(kFull, nb);
    if (!todo) continue;  // warp-uniform
    if (__any_sync(kFull, lg > m_run)) {  // acc = s = 0 before the first
      const float top = warp_max(lg);
      const float scale = expf(m_run - top);
      acc *= scale;
      s_lane *= scale;
      m_run = top;
    }
    const float p = nb ? expf(lg - m_run) : 0.0f;
    s_lane += p;
    const int count = __popc(todo);
    if (nb) {
      const int rank = __popc(todo & ((1u << lane) - 1u));
      st.rx[rank] = rx;
      st.ry[rank] = ry;
      st.p[rank] = p;
      st.j[rank] = j;
    }
    __syncwarp();
    // The chunk's angles spread over the lanes, entry e = (rank, octave,
    // k): sincos(f_(k/2) scale_octave rel_(k%2)), pair_gate's argument.
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
    __syncwarp();
    // The gates, pair_gate's sums in its order; two pairs in flight.
#pragma unroll 2
    for (int rank = 0; rank < count; ++rank) {
      float4 v[kTrig / 4];
#pragma unroll
      for (int b = 0; b < kTrig / 4; ++b) v[b] = st.trig[rank][h][b];
      const float* t = reinterpret_cast<const float*>(v);
      float part = w.w0;
#pragma unroll
      for (int k = 0; k < kFD; ++k) {
        part = fmaf(w.ws[k], t[k], part);
        part = fmaf(w.wc[k], t[kFD + k], part);
      }
      const float gate = part + __shfl_xor_sync(kFull, part, 16);
      acc = fmaf(st.p[rank], mapped[st.j[rank] * kL + l] * gate, acc);
    }
    __syncwarp();  // the stage is read before the next chunk writes it
  }
  const float s_run = warp_sum(s_lane);
  if (partials != nullptr) {
    float* rec = partials + ((size_t)blockIdx.y * n + i) * kRecord;
    if (lane == 0) {
      rec[0] = m_run;
      rec[1] = s_run;
    }
    if (lane < kL) rec[2 + l] = acc;
  } else if (lane < kL) {
    out[i * kL + l] = s_run > 0.0f ? acc / s_run : 0.0f;
  }
}

// out[i, l] from row i's records in every slice, one thread per entry: the
// slices with a neighbour, rescaled to their common max, in slice order.
__global__ void __launch_bounds__(kThreads) aggregate_merge_kernel(
    const float* __restrict__ partials, int slices, int n,
    float* __restrict__ out) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n * kL) return;
  const int i = idx / kL, l = idx % kL;
  float top = -INFINITY;
  for (int s = 0; s < slices; ++s) {
    const float* rec = partials + ((size_t)s * n + i) * kRecord;
    if (rec[1] > 0.0f) top = fmaxf(top, rec[0]);
  }
  float num = 0.0f, den = 0.0f;
  for (int s = 0; s < slices; ++s) {
    const float* rec = partials + ((size_t)s * n + i) * kRecord;
    if (rec[1] > 0.0f) {
      const float e = expf(rec[0] - top);
      num = fmaf(e, rec[2 + l], num);
      den = fmaf(e, rec[1], den);
    }
  }
  out[idx] = den > 0.0f ? num / den : 0.0f;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All pointers are float32 device
// arrays: features (n, 16), transform (16, 16), queries and keys (n, 16),
// frequencies (6,), distance_transform (16, 50), means (n, 2), radii (n,);
// `mapped` (n, 16) is scratch and `out` (n, 16) the result.  Slice s of
// the key axis takes the 32-key chunks s, s + slices, s + 2 slices, ...
// (1 <= slices <= the number of chunks); with slices > 1, `partials` is
// scratch of (slices, n, 18) floats.  Launches on `stream`
// without synchronising and returns the first failing launch's
// cudaGetLastError() (0 on success).  `period` is read only when
// `periodic` is non-zero.
extern "C" int pigs_aggregate_fwd(int n, const void* features,
                                  const void* transform, const void* queries,
                                  const void* keys, const void* frequencies,
                                  const void* distance_transform,
                                  const void* means, const void* radii,
                                  float sigma_cut, int periodic, float period,
                                  int slices, void* mapped, void* partials,
                                  void* out, void* stream) {
  if (n == 0) return 0;
  if (slices < 1 || slices > (n + 31) / 32 ||
      (slices > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(mapped);
  float* part = slices > 1 ? static_cast<float*>(partials) : nullptr;
  mapped_kernel<<<(n * kL + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(features), static_cast<const float*>(transform),
      n, mp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kWarps - 1) / kWarps, slices);
  aggregate_fwd_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(keys),
      static_cast<const float*>(means), static_cast<const float*>(radii), mp,
      static_cast<const float*>(frequencies),
      static_cast<const float*>(distance_transform), n, sigma_cut, periodic,
      period, part, static_cast<float*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  aggregate_merge_kernel<<<(n * kL + kThreads - 1) / kThreads, kThreads, 0,
                           st>>>(part, slices, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
