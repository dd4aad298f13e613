// Shared helpers of the port's hand-written Hopper kernels: the exported
// functions' linkage (KRUST_API), the device selection every entry point
// starts with (DeviceScope) and the key form (KeyTraits: bias and sentinel
// per key width). What only the two codec kernels share, their tile's
// window arithmetic, poison step and staged store, is in codec_tile.cuh.
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

// This library links its own CUDA runtime; the current device is per
// thread, and both runtimes read it from the thread's current context. An
// entry point selects its tensors' device for its launches and gives the
// thread back the device it found, so that one thread can launch on
// several cards and nothing of the caller's depends on the last launch.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = static_cast<int>(cudaGetDevice(&prev_));
    if (err_ == 0 && prev_ != device) {
      err_ = static_cast<int>(cudaSetDevice(device));
      restore_ = err_ == 0;
    }
  }
  ~DeviceScope() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
  int error() const { return err_; }

 private:
  int prev_ = 0;
  int err_ = 0;
  bool restore_ = false;
};

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
