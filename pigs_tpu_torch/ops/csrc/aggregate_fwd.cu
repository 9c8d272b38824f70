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
// L1/L2; the work is per pair.  Every pair pays a logit (16 FMAs) and the
// neighbour test; a neighbour pair pays one sincos per lane, 24 shuffles and
// 25 FMAs per lane for its gate.  At the models' states a Gaussian has
// 130-240 neighbours of 640-1664 slots, so the neighbour pairs dominate and
// the kernel is bound by instruction throughput and shuffle latency, not
// bytes.
//
// Design: a first small kernel forms mapped = features @ W_t^T (n, L), one
// thread per entry (aggregate_common.cuh::mapped_kernel).  The main
// kernel gives one warp to each query row: a first pass over the keys (lanes
// striding them) takes the row max and denominator online; a second pass
// finds the neighbours of each 32-key chunk with a ballot and visits them
// one after another with the whole warp (a real mask is 8-37 % dense, so a
// lane per key would leave most lanes idle): the warp builds the pair's gate
// for all 16 features at once (aggregate_common.cuh::pair_gate) and lane l
// adds alpha_ij mapped_jl gate_l to its output.  No shared memory, no
// atomics: every sum has a fixed order, so the result is deterministic.  A
// row with no neighbour never leaves the first pass and writes 0; the row
// max of an empty row is never used, so no -inf - -inf can make a NaN.

#include <cuda_runtime.h>

#include "aggregate_common.cuh"

namespace {

using namespace agg;

__global__ void __launch_bounds__(kThreads) aggregate_fwd_kernel(
    const float* __restrict__ queries, const float* __restrict__ keys,
    const float* __restrict__ means, const float* __restrict__ radii,
    const float* __restrict__ mapped, const float* __restrict__ freqs,
    const float* __restrict__ dist, int n, float sigma_cut, int periodic,
    float period, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp leaves together
  const int l = lane & 15;

  GateRow w;
  w.load(dist, l, lane >> 4);
  float q[kK];
#pragma unroll
  for (int c = 0; c < kK; ++c) q[c] = queries[i * kK + c];
  const float mxi = means[2 * i], myi = means[2 * i + 1];
  const float ri = finite_radius(radii[i]);

  float m_row, s_row;
  row_stats(i, q, mxi, myi, ri, keys, means, radii, n, sigma_cut, periodic,
            period, lane, m_row, s_row);

  float acc = 0.0f;
  if (s_row > 0.0f) {  // warp-uniform
    for (int base = 0; base < n; base += 32) {
      const int j = base + lane;
      float rx = 0.0f, ry = 0.0f, lg = 0.0f;
      bool nb = false;
      if (j < n) {
        rx = displacement(means[2 * j], mxi, periodic, period);
        ry = displacement(means[2 * j + 1], myi, periodic, period);
        nb = neighbours(rx, ry, ri, finite_radius(radii[j]), sigma_cut, i, j);
        if (nb) lg = logit(q, keys + j * kK);
      }
      unsigned todo = __ballot_sync(kFull, nb);
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int jj = base + src;
        const float alpha =
            expf(__shfl_sync(kFull, lg, src) - m_row) / s_row;
        Trig t;
        const float gate = pair_gate(__shfl_sync(kFull, rx, src),
                                     __shfl_sync(kFull, ry, src), freqs, w,
                                     lane, t);
        acc = fmaf(alpha, mapped[jj * kL + l] * gate, acc);
      }
    }
  }
  if (lane < kL) out[i * kL + l] = acc;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All pointers are float32 device
// arrays: features (n, 16), transform (16, 16), queries and keys (n, 16),
// frequencies (6,), distance_transform (16, 50), means (n, 2), radii (n,);
// `mapped` (n, 16) is scratch and `out` (n, 16) the result.  Launches on
// `stream` without synchronising and returns the first failing launch's
// cudaGetLastError() (0 on success).  `period` is read only when
// `periodic` is non-zero.
extern "C" int pigs_aggregate_fwd(int n, const void* features,
                                  const void* transform, const void* queries,
                                  const void* keys, const void* frequencies,
                                  const void* distance_transform,
                                  const void* means, const void* radii,
                                  float sigma_cut, int periodic, float period,
                                  void* mapped, void* out, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(mapped);
  mapped_kernel<<<(n * kL + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(features), static_cast<const float*>(transform),
      n, mp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  aggregate_fwd_kernel<<<(n + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(keys),
      static_cast<const float*>(means), static_cast<const float*>(radii), mp,
      static_cast<const float*>(frequencies),
      static_cast<const float*>(distance_transform), n, sigma_cut, periodic,
      period, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
