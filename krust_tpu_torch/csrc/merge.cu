// K3: merge of two key-sorted compacted parts (keys + int32 counts), and
// K5: merge of two sorted uint32 key arrays (no payload).
//
// K3 replaces krust_tpu/ops/pallas_merge.py:522 merge_sorted_kv (64-bit
// keys, k > 16) and :414 merge_sorted_lv (32-bit keys, k <= 16); K5
// replaces :248 merge_sorted, the keys-only merge of two equal-length
// uint32 arrays (0xFFFFFFFF padding allowed). All three are instantiations
// of one template over the key type, with or without counts: int64 biased
// keys (bit 63 flipped), int32 biased keys, uint32 keys compared unsigned.
// Sentinel tails are ordinary maximal keys.
//
// Bound on the H100: bytes, one read and one write of both parts. The
// design is a merge-path tiled merge, as the TPU kernels cut the output
// along merge-path diagonals and merged each chunk in VMEM. Two launches:
//   A. merge_partition: for every tile edge d = t * kOut, one thread finds
//      the split (i, d - i) by a binary search over a and b: the first i
//      entries of a and the first d - i of b are exactly the first d merged
//      entries. Ties go to a: a[i] comes before b[j] iff a[i] <= b[j], and
//      each side keeps its own order, so the merge is the stable merge of
//      cat(a, b) and every entry lands in exactly one slot (no count lost
//      or cloned). The splits are int64, one per tile edge.
//   B. merge_tiles: one block per tile of kOut outputs loads a[i0:i1] and
//      b[j0:j1] into shared memory with coalesced loads (all of a thread's
//      loads in flight before its stores), then each thread finds its own
//      sub-diagonal in shared memory (log2(kOut) steps) and merges kItems
//      entries serially in registers, counts following their keys. The
//      block stages its outputs in shared memory and writes them as
//      coalesced 16-byte stores. Each key is read from device memory once,
//      and only the partition's log2 searches per tile touch it again.
// Shared memory rows carry one pad slot per thread's kItems entries, so
// the blocked stores and the vector reads of the staged outputs hit
// distinct banks.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// outputs per thread and per tile: 64 bytes of keys a thread
template <typename Key>
struct Tile {
  static constexpr int kItems = 64 / sizeof(Key);        // 8 int64, 16 int32 / uint32
  static constexpr int kOut = kThreads * kItems;         // 2048 / 4096
  static constexpr int kPad = kOut + kOut / kItems;      // one pad per thread's row
};

template <typename Key>
__device__ __forceinline__ int slot(int x) {
  return x + x / Tile<Key>::kItems;
}

// The merge-path split of diagonal d of two sorted sequences of na and nb
// entries read through at(i) and bt(j): the number of a's entries among the
// first d merged ones, with ties to a.
template <typename Index, typename A, typename B>
__device__ __forceinline__ Index merge_path(Index na, Index nb, Index d, A at, B bt) {
  Index lo = d > nb ? d - nb : 0;
  Index hi = d < na ? d : na;
  while (lo < hi) {
    const Index mid = lo + ((hi - lo) >> 1);
    if (at(mid) <= bt(d - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename Key>
__global__ void __launch_bounds__(kThreads)
merge_partition(const Key* __restrict__ a, int64_t ma, const Key* __restrict__ b,
                int64_t mb, int64_t tiles, int64_t* __restrict__ splits) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t > tiles) return;
  const int64_t d = t < tiles ? t * Tile<Key>::kOut : ma + mb;
  splits[t] = merge_path<int64_t>(ma, mb, d, [&](int64_t i) { return a[i]; },
                                  [&](int64_t j) { return b[j]; });
}

// kVec entries of T at staged tile position x (a multiple of kVec, so all
// in one thread's row) as one 16-byte vector
template <typename Key, typename T>
__device__ __forceinline__ int4 gather16(const T* s, int x) {
  constexpr int kVec = 16 / sizeof(T);
  union {
    int4 q;
    T t[kVec];
  } u;
#pragma unroll
  for (int v = 0; v < kVec; ++v) u.t[v] = s[slot<Key>(x + v)];
  return u.q;
}

// The tile's n staged entries of T to dst: 16-byte stores for a whole,
// aligned tile, else entry by entry.
template <typename Key, typename T>
__device__ __forceinline__ void store_tile(const T* s, int n, T* __restrict__ dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kOut = Tile<Key>::kOut;
  if (n == kOut && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
    for (int r = 0; r < kOut / kVec / kThreads; ++r) {
      const int q = threadIdx.x + r * kThreads;
      reinterpret_cast<int4*>(dst)[q] = gather16<Key>(s, q * kVec);
    }
  } else {
    for (int x = threadIdx.x; x < n; x += kThreads) dst[x] = s[slot<Key>(x)];
  }
}

template <typename Key, bool kCounts>
__global__ void __launch_bounds__(kThreads)
merge_tiles(const Key* __restrict__ a, const int32_t* __restrict__ ac, int64_t ma,
            const Key* __restrict__ b, const int32_t* __restrict__ bc, int64_t mb,
            const int64_t* __restrict__ splits, Key* __restrict__ o_keys,
            int32_t* __restrict__ o_cnt) {
  constexpr int kItems = Tile<Key>::kItems;
  constexpr int kOut = Tile<Key>::kOut;
  // the tile's inputs, a's entries then b's; then its staged outputs
  __shared__ Key s_keys[Tile<Key>::kPad];
  __shared__ int32_t s_cnt[kCounts ? Tile<Key>::kPad : 1];

  const int64_t d0 = blockIdx.x * static_cast<int64_t>(kOut);
  const int64_t a0 = splits[blockIdx.x];
  const int64_t b0 = d0 - a0;
  const int n = static_cast<int>(ma + mb - d0 < kOut ? ma + mb - d0 : kOut);
  const int na = static_cast<int>(splits[blockIdx.x + 1] - a0);

  Key k[kItems];
  int32_t c[kItems];
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int x = threadIdx.x + e * kThreads;
    if (x < na) {
      k[e] = a[a0 + x];
      if constexpr (kCounts) c[e] = ac[a0 + x];
    } else if (x < n) {
      k[e] = b[b0 + x - na];
      if constexpr (kCounts) c[e] = bc[b0 + x - na];
    }
  }
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int x = threadIdx.x + e * kThreads;
    if (x < n) {
      s_keys[slot<Key>(x)] = k[e];
      if constexpr (kCounts) s_cnt[slot<Key>(x)] = c[e];
    }
  }
  __syncthreads();

  // this thread's outputs d .. d + kItems - 1: a at staged positions
  // [0, na), b at [na, n)
  const int d = min(static_cast<int>(threadIdx.x) * kItems, n);
  int ia = merge_path<int>(na, n - na, d, [&](int i) { return s_keys[slot<Key>(i)]; },
                           [&](int j) { return s_keys[slot<Key>(na + j)]; });
  int ib = na + d - ia;
  Key ka = ia < na ? s_keys[slot<Key>(ia)] : Key();
  Key kb = ib < n ? s_keys[slot<Key>(ib)] : Key();
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const bool take_a = ia < na && (ib >= n || ka <= kb);
    const int src = take_a ? ia : ib;  // >= n only past the tile's end
    k[e] = take_a ? ka : kb;
    if constexpr (kCounts) c[e] = src < n ? s_cnt[slot<Key>(src)] : 0;
    if (take_a) {
      if (++ia < na) ka = s_keys[slot<Key>(ia)];
    } else {
      if (++ib < n) kb = s_keys[slot<Key>(ib)];
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int x = static_cast<int>(threadIdx.x) * kItems + e;
    s_keys[slot<Key>(x)] = k[e];
    if constexpr (kCounts) s_cnt[slot<Key>(x)] = c[e];
  }
  __syncthreads();
  store_tile<Key>(s_keys, n, o_keys + d0);
  if constexpr (kCounts) store_tile<Key>(s_cnt, n, o_cnt + d0);
}

int64_t n_tiles(int64_t total, int key_bytes) {
  const int64_t tile = key_bytes == 8 ? Tile<int64_t>::kOut : Tile<int32_t>::kOut;
  return (total + tile - 1) / tile;
}

template <typename Key>
int launch(const void* a, const void* ac, int64_t ma, const void* b, const void* bc,
           int64_t mb, void* out_keys, void* out_cnt, void* splits, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = n_tiles(ma + mb, sizeof(Key));
  if (tiles == 0) return static_cast<int>(cudaGetLastError());
  auto ka = static_cast<const Key*>(a);
  auto kb = static_cast<const Key*>(b);
  auto sp = static_cast<int64_t*>(splits);
  merge_partition<Key><<<static_cast<unsigned>(tiles / kThreads + 1), kThreads, 0, s>>>(
      ka, ma, kb, mb, tiles, sp);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const auto grid = static_cast<unsigned>(tiles);
  if (out_cnt == nullptr) {
    merge_tiles<Key, false><<<grid, kThreads, 0, s>>>(ka, nullptr, ma, kb, nullptr, mb, sp,
                                                     static_cast<Key*>(out_keys), nullptr);
  } else {
    merge_tiles<Key, true><<<grid, kThreads, 0, s>>>(
        ka, static_cast<const int32_t*>(ac), ma, kb, static_cast<const int32_t*>(bc), mb, sp,
        static_cast<Key*>(out_keys), static_cast<int32_t*>(out_cnt));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Outputs per tile for a key width of key_bytes (4 or 8); the caller's
// splits hold ceil((ma + mb) / tile) + 1 int64 entries.
KRUST_API int64_t krust_merge_tile(int key_bytes) {
  return key_bytes == 8 ? Tile<int64_t>::kOut : Tile<int32_t>::kOut;
}

// K3: out_keys / out_cnt ma + mb entries each
KRUST_API int krust_merge_i32(int device, const void* a, const void* ac, int64_t ma,
                              const void* b, const void* bc, int64_t mb,
                              void* out_keys, void* out_cnt, void* splits, void* stream) {
  const DeviceScope scope(device);
  if (scope.error()) return scope.error();
  return launch<int32_t>(a, ac, ma, b, bc, mb, out_keys, out_cnt, splits, stream);
}

KRUST_API int krust_merge_i64(int device, const void* a, const void* ac, int64_t ma,
                              const void* b, const void* bc, int64_t mb,
                              void* out_keys, void* out_cnt, void* splits, void* stream) {
  const DeviceScope scope(device);
  if (scope.error()) return scope.error();
  return launch<int64_t>(a, ac, ma, b, bc, mb, out_keys, out_cnt, splits, stream);
}

// K5: a and b m uint32 keys each, out 2m; compared unsigned
KRUST_API int krust_merge_keys_u32(int device, const void* a, const void* b, int64_t m,
                                   void* out, void* splits, void* stream) {
  const DeviceScope scope(device);
  if (scope.error()) return scope.error();
  return launch<uint32_t>(a, nullptr, m, b, nullptr, m, out, nullptr, splits, stream);
}
