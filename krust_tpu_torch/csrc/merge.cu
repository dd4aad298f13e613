// K3: merge of two key-sorted compacted parts (keys + int32 counts), and
// K5: merge of two sorted uint32 key arrays (no payload).
//
// K3 replaces krust_tpu/ops/pallas_merge.py:merge_sorted_kv (64-bit keys,
// k > 16) and merge_sorted_lv (32-bit keys, k <= 16): one kernel
// templated on the key width. Sentinel tails are ordinary maximal keys.
// K5 replaces krust_tpu/ops/pallas_merge.py:merge_sorted, the keys-only
// merge of two equal-length uint32 arrays (0xFFFFFFFF padding allowed):
// the same kernel instantiated for uint32_t keys, so keys compare
// unsigned, and no counts.
//
// Bound on the H100: the binary searches' dependent loads (log2 of the
// other part's length per entry, mostly L2 hits near the top of the
// search); the bytes moved are one read and one write of both parts. The
// TPU kernels split the output along merge-path diagonals and run a
// Batcher network per chunk in VMEM. This first Hopper version is a
// rank-scatter merge instead: a[i] lands at i + lower_bound(b, a[i]) and
// b[j] at j + upper_bound(a, b[j]). Equal keys keep a-before-b order, every
// entry lands in exactly one slot, so no count is lost or cloned, and the
// result is the stable merge. A merge-path partition with a tile merge in
// shared memory is the faster version for a later change.

#include "common.cuh"

namespace {

template <typename Key>
__device__ __forceinline__ int64_t lower_bound(const Key* __restrict__ x,
                                               int64_t n, Key v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (x[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename Key>
__device__ __forceinline__ int64_t upper_bound(const Key* __restrict__ x,
                                               int64_t n, Key v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (x[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename Key>
__global__ void merge_rank_kernel(const Key* __restrict__ a,
                                  const int32_t* __restrict__ ac, int64_t ma,
                                  const Key* __restrict__ b,
                                  const int32_t* __restrict__ bc, int64_t mb,
                                  Key* __restrict__ out_keys,
                                  int32_t* __restrict__ out_cnt) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t < ma) {
    const Key v = a[t];
    const int64_t pos = t + lower_bound(b, mb, v);
    out_keys[pos] = v;
    if (out_cnt != nullptr) out_cnt[pos] = ac[t];
  } else if (t < ma + mb) {
    const int64_t j = t - ma;
    const Key v = b[j];
    const int64_t pos = j + upper_bound(a, ma, v);
    out_keys[pos] = v;
    if (out_cnt != nullptr) out_cnt[pos] = bc[j];
  }
}

template <typename Key>
int launch(const void* a, const void* ac, int64_t ma, const void* b,
           const void* bc, int64_t mb, void* out_keys, void* out_cnt,
           void* stream) {
  const int64_t total = ma + mb;
  if (total > 0) {
    const int threads = 256;
    merge_rank_kernel<Key><<<static_cast<unsigned>((total + threads - 1) / threads),
                             threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const Key*>(a), static_cast<const int32_t*>(ac), ma,
        static_cast<const Key*>(b), static_cast<const int32_t*>(bc), mb,
        static_cast<Key*>(out_keys), static_cast<int32_t*>(out_cnt));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out_keys / out_cnt: ma + mb entries each; K3
KRUST_API int krust_merge_i32(int device, const void* a, const void* ac, int64_t ma,
                              const void* b, const void* bc, int64_t mb,
                              void* out_keys, void* out_cnt, void* stream) {
  const int err = set_device(device);
  if (err) return err;
  return launch<int32_t>(a, ac, ma, b, bc, mb, out_keys, out_cnt, stream);
}

KRUST_API int krust_merge_i64(int device, const void* a, const void* ac, int64_t ma,
                              const void* b, const void* bc, int64_t mb,
                              void* out_keys, void* out_cnt, void* stream) {
  const int err = set_device(device);
  if (err) return err;
  return launch<int64_t>(a, ac, ma, b, bc, mb, out_keys, out_cnt, stream);
}

// K5: a and b m uint32 keys each, out 2m; compared unsigned
KRUST_API int krust_merge_keys_u32(int device, const void* a, const void* b,
                                   int64_t m, void* out, void* stream) {
  const int err = set_device(device);
  if (err) return err;
  return launch<uint32_t>(a, nullptr, m, b, nullptr, m, out, nullptr, stream);
}
