// K6: one optax Adam step over a list of float32 tensors, in one launch.
//
// Replaces no TPU kernel: the JAX package updates its parameters with optax
// (inject_hyperparams(adam), chained after clip_by_global_norm), which XLA
// fuses on the TPU.  The port's plain path (train/optim.py::
// adam_update_plain) runs the same arithmetic as about 500 small PyTorch
// operations a step over the PN network's 92 tensors; this kernel runs it
// as one.  For tensors (p, g, mu, nu) and, over every element of every g,
// norm = sqrt(sum g^2) and finite = no g is NaN or inf:
//   gc     = norm < clip ? g : g / norm * clip          (no clip: gc = g)
//   mu'    = (1 - b1) gc + b1 mu,   nu' = (1 - b2) gc^2 + b2 nu
//   count' = count + 1
//   p     += (-lr) (mu' / (1 - b1^count')) / (sqrt(nu' / (1 - b2^count')) + eps)
// With skip_nonfinite, where some g is not finite, p, mu, nu and count keep
// their values (mu' and nu' are then copies of mu and nu).  mu' and nu' go
// to fresh flat buffers, so the caller's old state stays as it was; p is
// written in place.  Each operation is rounded as the plain path rounds it
// (explicit _rn intrinsics, no contraction into FMAs), so the two differ
// only in the norm's summation order and in powf.
//
// What bounds it on an H100: about 32 bytes an element (g read twice; p,
// mu, nu read; p, mu', nu' written), 0.9 MB at the PN network's 28-30 k
// elements, 0.27 us at 3.35 TB/s.  At that size the time is the launch and
// rounds of memory latency, and what the kernel removes is the host's work
// of launching ~500 operations.  One block of 1024 threads took 31 us
// there, each thread waiting out ~11 rounds of latency in turn; a cluster
// of kCluster blocks on as many SMs takes 14 us.
//
// Design:
//  * The tensor table (pointers of p, g, mu, nu and the running element
//    count) travels by value in the kernel parameters: up to kMaxSlots
//    tensors, under the 4 KB parameter limit, so nothing is copied to the
//    device before the launch.  Each block copies it to shared memory.
//  * The tensors form one flat index range, tensor after tensor.  Thread t
//    takes elements t, t + blockDim, ... of its block's range and walks a
//    cursor forward through the table; a warp's 32 consecutive elements
//    mostly share a tensor, so the lookups are broadcasts.  Loads are
//    unrolled (kUnrollSum, kUnrollUpdate) to keep several rounds of memory
//    latency in flight per thread.
//  * One cluster of kCluster blocks does both passes in one launch, for
//    any total: block r takes the r-th of kCluster equal chunks of the
//    range, sums its squares, the blocks meet at a cluster barrier, and
//    each reads the others' sums from their shared memory, in rank order,
//    before it updates its chunk.  Every caller has at most ~30 k elements
//    (the PN network; the no-MLP and fit parameters are smaller), where a
//    grid of 2-16 blocks in two kernels was no faster; a far larger total
//    would want more blocks than one cluster holds.
//  * The sum of squares is taken in double, per thread in a fixed order and
//    then over a fixed tree; no atomics.  The result is the same bits from
//    launch to launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kCluster = 8;  // the portable cluster size
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 104;
constexpr int kUnrollSum = 8;
constexpr int kUnrollUpdate = 4;

struct Slot {
  float* param;
  const float* grad;
  const float* mu;
  const float* nu;
};

struct Params {
  Slot slot[kMaxSlots];
  int end[kMaxSlots];  // running element count after each tensor
  int n_slots;
  int total;
  int chunk;           // elements a block takes
  int has_clip;
  int skip_nonfinite;
  float clip;
  float lr_value;      // read when lr is null
  float b1, b2, one_minus_b1, one_minus_b2, eps;
  const float* lr;     // a device scalar, or null
  const int* count_in;
  int* count_out;
  float* mu_out;
  float* nu_out;
};
static_assert(sizeof(Params) <= 4096, "K6's parameters exceed 4 KB");

struct Table {
  Slot slot[kMaxSlots];
  int end[kMaxSlots];
};

__device__ __forceinline__ void load_table(const Params& p, Table& t) {
  for (int i = threadIdx.x; i < p.n_slots; i += kThreads) {
    t.slot[i] = p.slot[i];
    t.end[i] = p.end[i];
  }
  __syncthreads();
}

// The tensor holding flat element e, from cursor s on (e only grows).
__device__ __forceinline__ int advance(const Table& t, int s, int e) {
  while (e >= t.end[s]) ++s;
  return s;
}

__device__ __forceinline__ int slot_start(const Table& t, int s) {
  return s ? t.end[s - 1] : 0;
}

// This thread's sum of squares and non-finite flag over [begin, stop).
__device__ void sum_range(const Table& t, int begin, int stop, double& sq,
                          int& bad) {
  int s = 0;
  for (int base = begin + threadIdx.x; base < stop;
       base += kUnrollSum * kThreads) {
    float g[kUnrollSum];
#pragma unroll
    for (int u = 0; u < kUnrollSum; ++u) {
      const int e = base + u * kThreads;
      g[u] = 0.0f;
      if (e < stop) {
        s = advance(t, s, e);
        g[u] = __ldg(t.slot[s].grad + (e - slot_start(t, s)));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnrollSum; ++u) {
      sq += static_cast<double>(g[u]) * static_cast<double>(g[u]);
      bad |= !isfinite(g[u]);
    }
  }
}

// The block's sum of v, the same in every thread; fixed order.
__device__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  return red[kWarps];
}

struct Step {
  float norm, clip, b1, b2, one_minus_b1, one_minus_b2, eps;
  float bias1, bias2, neg_lr;
  bool keep;   // the gradients go in unclipped
  bool apply;  // the update is taken (not skipped)
};

// The step's scalars from the sum of squares and the non-finite flag; in
// block 0 the new count is written too.
__device__ Step make_step(const Params& p, double sq, bool bad) {
  Step st;
  st.norm = static_cast<float>(sqrt(sq));
  st.clip = p.clip;
  st.keep = !p.has_clip || st.norm < p.clip;
  st.apply = !(p.skip_nonfinite && bad);
  st.b1 = p.b1;
  st.b2 = p.b2;
  st.one_minus_b1 = p.one_minus_b1;
  st.one_minus_b2 = p.one_minus_b2;
  st.eps = p.eps;
  const int count = *p.count_in;
  const float steps = __int2float_rn(count + 1);
  st.bias1 = __fsub_rn(1.0f, powf(p.b1, steps));
  st.bias2 = __fsub_rn(1.0f, powf(p.b2, steps));
  st.neg_lr = -(p.lr != nullptr ? *p.lr : p.lr_value);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *p.count_out = st.apply ? count + 1 : count;
  return st;
}

// The update of [begin, stop): new moments to the flat outputs, parameters
// in place (or, skipped, the old moments copied and the parameters left).
__device__ void update_range(const Params& p, const Table& t, int begin,
                             int stop, const Step& st) {
  int s = 0;
  for (int base = begin + threadIdx.x; base < stop;
       base += kUnrollUpdate * kThreads) {
    int slot[kUnrollUpdate], idx[kUnrollUpdate];
    float g[kUnrollUpdate], m0[kUnrollUpdate], v0[kUnrollUpdate],
        p0[kUnrollUpdate];
#pragma unroll
    for (int u = 0; u < kUnrollUpdate; ++u) {
      const int e = base + u * kThreads;
      slot[u] = -1;
      if (e < stop) {
        s = advance(t, s, e);
        slot[u] = s;
        idx[u] = e - slot_start(t, s);
        m0[u] = __ldg(t.slot[s].mu + idx[u]);
        v0[u] = __ldg(t.slot[s].nu + idx[u]);
        if (st.apply) {
          g[u] = __ldg(t.slot[s].grad + idx[u]);
          p0[u] = t.slot[s].param[idx[u]];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnrollUpdate; ++u) {
      if (slot[u] < 0) continue;
      const int e = base + u * kThreads;
      if (!st.apply) {
        p.mu_out[e] = m0[u];
        p.nu_out[e] = v0[u];
        continue;
      }
      const float gc =
          st.keep ? g[u] : __fmul_rn(__fdiv_rn(g[u], st.norm), st.clip);
      const float m = __fadd_rn(__fmul_rn(gc, st.one_minus_b1),
                                __fmul_rn(m0[u], st.b1));
      const float v = __fadd_rn(__fmul_rn(__fmul_rn(gc, gc), st.one_minus_b2),
                                __fmul_rn(v0[u], st.b2));
      const float denom =
          __fadd_rn(__fsqrt_rn(__fdiv_rn(v, st.bias2)), st.eps);
      const float upd =
          __fmul_rn(__fdiv_rn(__fdiv_rn(m, st.bias1), denom), st.neg_lr);
      p.mu_out[e] = m;
      p.nu_out[e] = v;
      t.slot[slot[u]].param[idx[u]] = __fadd_rn(p0[u], upd);
    }
  }
}

// One cluster, both passes, one block's share of the range each.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    adam_cluster_kernel(const __grid_constant__ Params p) {
  __shared__ Table t;
  __shared__ double red[kWarps + 1];
  __shared__ double part[2];  // this block's sum of squares, flag
  cg::cluster_group cluster = cg::this_cluster();
  load_table(p, t);
  const int begin = static_cast<int>(cluster.block_rank()) * p.chunk;
  const int stop = min(p.total, begin + p.chunk);
  double sq = 0.0;
  int bad = 0;
  sum_range(t, begin, stop, sq, bad);
  const bool any_bad = __syncthreads_or(bad) != 0;
  const double mine = block_sum(sq, red);
  if (threadIdx.x == 0) {
    part[0] = mine;
    part[1] = any_bad ? 1.0 : 0.0;
  }
  cluster.sync();
  double total = 0.0;
  bool bad_all = false;
  for (int r = 0; r < kCluster; ++r) {
    const double* q = cluster.map_shared_rank(part, r);
    total += q[0];
    bad_all |= q[1] != 0.0;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
  update_range(p, t, begin, stop, make_step(p, total, bad_all));
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).  `table`
// holds, for each of the `n` tensors, five int64: the addresses of the
// parameter, gradient, mu and nu (contiguous float32, one layout) and the
// element count.  mu_out and nu_out are fresh buffers of the total count
// each; count_in and count_out int32 scalars; lr a float32 device scalar
// or null (then lr_value).
extern "C" int pigs_adam(int n, const long long* table, void* mu_out,
                         void* nu_out, const void* count_in, void* count_out,
                         const void* lr, float lr_value, int has_clip,
                         float clip, int skip_nonfinite, float b1, float b2,
                         float one_minus_b1, float one_minus_b2, float eps,
                         void* stream) {
  if (n < 1 || n > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  long long total = 0;
  for (int i = 0; i < n; ++i) {
    const long long* row = table + 5 * i;
    p.slot[i] = {reinterpret_cast<float*>(row[0]),
                 reinterpret_cast<const float*>(row[1]),
                 reinterpret_cast<const float*>(row[2]),
                 reinterpret_cast<const float*>(row[3])};
    total += row[4];
    // The cursors index with int, past the end by up to a round of loads.
    if (row[4] < 0 || total > (1LL << 30))
      return static_cast<int>(cudaErrorInvalidValue);
    p.end[i] = static_cast<int>(total);
  }
  p.n_slots = n;
  p.total = static_cast<int>(total);
  p.chunk = static_cast<int>((total + kCluster - 1) / kCluster);
  p.has_clip = has_clip;
  p.skip_nonfinite = skip_nonfinite;
  p.clip = clip;
  p.lr_value = lr_value;
  p.b1 = b1;
  p.b2 = b2;
  p.one_minus_b1 = one_minus_b1;
  p.one_minus_b2 = one_minus_b2;
  p.eps = eps;
  p.lr = static_cast<const float*>(lr);
  p.count_in = static_cast<const int*>(count_in);
  p.count_out = static_cast<int*>(count_out);
  p.mu_out = static_cast<float*>(mu_out);
  p.nu_out = static_cast<float*>(nu_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  adam_cluster_kernel<<<kCluster, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
