// K1: packed 2-bit bases -> biased canonical k-mer keys, window poisoning
// included.
//
// Replaces krust_tpu/ops/pallas_fused.py:encode_packed_pallas together with
// the window poisoning krust_tpu/models/engines.py:_count_flat_step does
// around it (scatter of the invalid positions, log-step dilation, covered
// mask, sentinel where).
//
// Bound on the H100: bytes. A batch reads 0.25 B/base of packed input and
// writes 4 B (k <= 16) or 8 B (k > 16) per window, so the write dominates;
// the arithmetic (k + 3 base extractions and shift/or pairs for four
// windows) is far below the card's integer rate. Design: one thread per
// group of four windows (one packed byte of window starts). The nine bytes
// that cover the group's bases load once into two registers; the first
// window's forward and reverse-complement codes build in k steps and the
// next three roll in one step each. Validity needs no scatter: the sorted
// invalid positions are binary-searched once per group, so a window is bad
// iff it is at or past `covered` or an invalid base lies in [j, j + k - 1].
// Keys are written in window order, four consecutive keys per thread.

#include "common.cuh"

namespace {

template <typename Key>
__global__ void encode_windows_kernel(const uint8_t* __restrict__ packed,
                                      const int32_t* __restrict__ invpos,
                                      int64_t n_inv, int64_t covered, int k,
                                      int64_t n_groups,
                                      Key* __restrict__ out) {
  const int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (q >= n_groups) return;
  const uint8_t* p = packed + q;
  uint64_t w0 = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) w0 = (w0 << 8) | p[i];
  const uint32_t w1 = p[8];
  uint64_t canon[4];
  group_canonical(w0, w1, k, canon);

  const int64_t j0 = 4 * q;
  // first invalid position >= j0
  int64_t lo = 0, hi = n_inv;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (invpos[mid] < j0) lo = mid + 1; else hi = mid;
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t j = j0 + r;
    while (lo < n_inv && invpos[lo] < j) ++lo;
    const bool bad = j >= covered || (lo < n_inv && invpos[lo] <= j + k - 1);
    out[j] = bad ? KeyTraits<Key>::kSentinel : KeyTraits<Key>::from_code(canon[r]);
  }
}

template <typename Key>
int launch(const void* packed, const void* invpos, int64_t n_inv,
           int64_t covered, int k, int64_t n_windows, void* out,
           void* stream) {
  const int64_t n_groups = n_windows / 4;
  if (n_groups > 0) {
    const int threads = 256;
    const int64_t blocks = (n_groups + threads - 1) / threads;
    encode_windows_kernel<Key><<<static_cast<unsigned>(blocks), threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed),
        static_cast<const int32_t*>(invpos), n_inv, covered, k, n_groups,
        static_cast<Key*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// packed: >= n_windows / 4 + 8 bytes; invpos: n_inv sorted int32;
// out: n_windows keys (int32 for k <= 16, int64 otherwise); n_windows % 4 == 0
KRUST_API int krust_encode_windows_i32(int device, const void* packed, const void* invpos,
                                       int64_t n_inv, int64_t covered, int k,
                                       int64_t n_windows, void* out,
                                       void* stream) {
  const int err = set_device(device);
  if (err) return err;
  return launch<int32_t>(packed, invpos, n_inv, covered, k, n_windows, out,
                         stream);
}

KRUST_API int krust_encode_windows_i64(int device, const void* packed, const void* invpos,
                                       int64_t n_inv, int64_t covered, int k,
                                       int64_t n_windows, void* out,
                                       void* stream) {
  const int err = set_device(device);
  if (err) return err;
  return launch<int64_t>(packed, invpos, n_inv, covered, k, n_windows, out,
                         stream);
}

KRUST_API const char* krust_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
