// Shared helpers of the port's hand-written Hopper kernels.
//
// Keys: a canonical k-mer code c (2k bits, unsigned) is stored biased so
// that signed order equals unsigned order and the all-ones sentinel sorts
// last: k <= 16 as int32 (c ^ 0x80000000), k > 16 as int64 (c ^ 2^63).
// The sentinel (all-ones code: the all-T k-mer, never canonical because its
// reverse complement is all-A) becomes INT32_MAX / INT64_MAX.
//
// Every exported function takes the CUDA device index of its tensors,
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() after its launches.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define KRUST_API extern "C" __attribute__((visibility("default")))

// This library links its own CUDA runtime, whose current device is per
// thread and separate from PyTorch's: select the tensors' device first.
inline int set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}

template <typename Key>
struct KeyTraits;

template <>
struct KeyTraits<int32_t> {
  static constexpr int32_t kSentinel = 0x7FFFFFFF;
  __device__ static int32_t from_code(uint64_t c) {
    return static_cast<int32_t>(static_cast<uint32_t>(c) ^ 0x80000000u);
  }
};

template <>
struct KeyTraits<int64_t> {
  static constexpr int64_t kSentinel = 0x7FFFFFFFFFFFFFFFll;
  __device__ static int64_t from_code(uint64_t c) {
    return static_cast<int64_t>(c ^ 0x8000000000000000ull);
  }
};

// Exclusive scan of one value per thread across the block (blockDim.x a
// multiple of 32, every thread of the block calling). *total receives the
// block's sum. Warp shuffles, then one warp scans the per-warp sums.
__device__ __forceinline__ long long block_exclusive_scan(long long v,
                                                          long long* total) {
  __shared__ long long warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  long long incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    long long y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      long long y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const long long before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + incl - v;
}
