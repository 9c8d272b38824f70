// What K1 (mixture_fwd.cu) and K2/K3 (mixture_bwd.cu) share: the packed
// component layout, Kahan's compensated add, and the second pass of K1 and
// K2, the sum over the slices of a split axis in a fixed order.
//
// The second pass: partials holds `slices` rows of `count` entries.  A
// block takes 32 consecutive entries with 8 warps: warp w sums its run of
// the slices, [w * per, (w + 1) * per) with per = ceil(slices / 8), in
// slice order (each warp's loads contiguous), and warp 0 then adds the 8
// runs' sums in run order, Kahan throughout.  Both orders depend on
// `slices` alone, so the result is the same bits from launch to launch; no
// atomics.  One thread per entry walking every slice, the first form, left
// 40-300 blocks each running a chain of up to 200 dependent loads and adds.

#pragma once

#include <cuda_runtime.h>

namespace mixture {

// Number of packed components up to ORDER: 1, 3, 6, 10.
template <int ORDER>
struct Comps {
  static constexpr int value = (ORDER + 1) * (ORDER + 2) / 2;
};

// Derivative group of packed component k, and a group's first component.
__host__ __device__ constexpr int group_of(int k) {
  return k >= 6 ? 3 : (k >= 3 ? 2 : (k >= 1 ? 1 : 0));
}
__host__ __device__ constexpr int group_offset(int group) {
  return group * (group + 1) / 2;
}

__device__ __forceinline__ void kahan_add(float& total, float& carry,
                                          float inc) {
  const float y = inc - carry;
  const float t = total + y;
  carry = (t - total) - y;
  total = t;
}

constexpr int kCombineEntries = 32;  // entries per combine block
constexpr int kCombineRuns = 8;      // warps per combine block
constexpr int kCombineThreads = kCombineEntries * kCombineRuns;

// Launch with ceil(count / kCombineEntries) blocks of kCombineThreads;
// store(e, sum) writes entry e's sum where the kernel's output wants it.
template <class Store>
__global__ void __launch_bounds__(kCombineThreads) combine_slices_kernel(
    const float* __restrict__ partials, int slices, int count, Store store) {
  __shared__ float s_run[kCombineRuns][kCombineEntries];
  const int lane = threadIdx.x % kCombineEntries;
  const int run = threadIdx.x / kCombineEntries;
  const int e = blockIdx.x * kCombineEntries + lane;
  const int per = (slices + kCombineRuns - 1) / kCombineRuns;
  const int begin = run * per, end = min(slices, begin + per);
  float total = 0.0f, carry = 0.0f;
  if (e < count) {
#pragma unroll 4
    for (int s = begin; s < end; ++s)
      kahan_add(total, carry, partials[(size_t)s * count + e]);
  }
  s_run[run][lane] = total - carry;  // the run's compensated sum
  __syncthreads();
  if (run != 0 || e >= count) return;
  total = 0.0f;
  carry = 0.0f;
#pragma unroll
  for (int r = 0; r < kCombineRuns; ++r) kahan_add(total, carry, s_run[r][lane]);
  store(e, total);
}

template <class Store>
cudaError_t combine_slices(const float* partials, int slices, int count,
                           Store store, cudaStream_t stream) {
  const int blocks = (count + kCombineEntries - 1) / kCombineEntries;
  combine_slices_kernel<Store><<<blocks, kCombineThreads, 0, stream>>>(
      partials, slices, count, store);
  return cudaGetLastError();
}

}  // namespace mixture
