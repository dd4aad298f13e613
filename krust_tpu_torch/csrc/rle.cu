// K2: run-length compaction (reduce-by-key) of a key-sorted stream.
//
// Replaces krust_tpu/ops/pallas_rle.py:rle_compact. Input: n biased keys
// sorted ascending, sentinel keys (INT32_MAX / INT64_MAX) at the back, and
// optional int32 weights (none = every entry counts 1). Output, n long:
// the distinct non-sentinel keys with their summed weights packed to the
// front, sentinel keys and zero counts after them, and n_unique in a
// device scalar (read by the host only when it needs it).
//
// Bound on the H100: bytes. Keys are read twice (reduce, then scatter) and
// the distinct keys written once; everything else is per-block scalars.
// The TPU kernel walks its chunks in order and carries the open run in
// SMEM; blocks here run in parallel in no order, so the carry becomes a
// decoupled scan instead:
//   1. rle_reduce: per tile of TILE keys, count run heads (first entry of
//      each non-sentinel run) and sum the weights of non-sentinel entries;
//   2. rle_scan_tiles: one block scans the per-tile sums (exclusive), and
//      writes the totals (n_unique, total weight);
//   3. rle_scatter: each tile rescans its heads (warp shuffles + per-warp
//      sums), and each head writes its key to out_keys[rank] and the weight
//      of everything before it to wpre[rank];
//   4. rle_finish: count[r] = wpre[r + 1] - wpre[r] (the total for the
//      last run), and the sentinel/zero tail past n_unique.
// Non-sentinel entries form a prefix of the sorted stream, so the weight
// between two heads is exactly the run's sum.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

template <typename Key, bool kUnit>
__device__ __forceinline__ void thread_sums(const Key* __restrict__ keys,
                                            const int32_t* __restrict__ cnt,
                                            int64_t n, int64_t i0,
                                            long long* heads,
                                            long long* weight) {
  long long h = 0, w = 0;
  Key prev = i0 > 0 && i0 - 1 < n ? keys[i0 - 1] : KeyTraits<Key>::kSentinel;
  for (int t = 0; t < kItems; ++t) {
    const int64_t i = i0 + t;
    if (i >= n) break;
    const Key v = keys[i];
    if (v != KeyTraits<Key>::kSentinel) {
      h += (i == 0 || v != prev);
      w += kUnit ? 1 : cnt[i];
    }
    prev = v;
  }
  *heads = h;
  *weight = w;
}

template <typename Key, bool kUnit>
__global__ void rle_reduce(const Key* __restrict__ keys,
                           const int32_t* __restrict__ cnt, int64_t n,
                           long long* __restrict__ tile_heads,
                           long long* __restrict__ tile_weight) {
  const int64_t i0 = blockIdx.x * static_cast<int64_t>(kTile) +
                     threadIdx.x * static_cast<int64_t>(kItems);
  long long h, w, th, tw;
  thread_sums<Key, kUnit>(keys, cnt, n, i0, &h, &w);
  block_exclusive_scan(h, &th);
  block_exclusive_scan(w, &tw);
  if (threadIdx.x == 0) {
    tile_heads[blockIdx.x] = th;
    tile_weight[blockIdx.x] = tw;
  }
}

// one block: exclusive scan of both per-tile arrays in place; totals to
// totals[0] (n_unique) and totals[1] (total weight)
__global__ void rle_scan_tiles(long long* __restrict__ tile_heads,
                               long long* __restrict__ tile_weight,
                               int64_t n_tiles, long long* __restrict__ totals) {
  const int64_t per = (n_tiles + blockDim.x - 1) / blockDim.x;
  const int64_t b0 = threadIdx.x * per;
  const int64_t b1 = b0 + per < n_tiles ? b0 + per : n_tiles;
  long long h = 0, w = 0;
  for (int64_t b = b0; b < b1; ++b) {
    h += tile_heads[b];
    w += tile_weight[b];
  }
  long long th, tw;
  long long oh = block_exclusive_scan(h, &th);
  long long ow = block_exclusive_scan(w, &tw);
  for (int64_t b = b0; b < b1; ++b) {
    const long long vh = tile_heads[b], vw = tile_weight[b];
    tile_heads[b] = oh;
    tile_weight[b] = ow;
    oh += vh;
    ow += vw;
  }
  if (threadIdx.x == 0) {
    totals[0] = th;
    totals[1] = tw;
  }
}

template <typename Key, bool kUnit>
__global__ void rle_scatter(const Key* __restrict__ keys,
                            const int32_t* __restrict__ cnt, int64_t n,
                            const long long* __restrict__ tile_heads,
                            const long long* __restrict__ tile_weight,
                            Key* __restrict__ out_keys,
                            long long* __restrict__ wpre) {
  const int64_t i0 = blockIdx.x * static_cast<int64_t>(kTile) +
                     threadIdx.x * static_cast<int64_t>(kItems);
  long long h, w, th, tw;
  thread_sums<Key, kUnit>(keys, cnt, n, i0, &h, &w);
  long long rank = block_exclusive_scan(h, &th) + tile_heads[blockIdx.x];
  long long before = block_exclusive_scan(w, &tw) + tile_weight[blockIdx.x];
  Key prev = i0 > 0 && i0 - 1 < n ? keys[i0 - 1] : KeyTraits<Key>::kSentinel;
  for (int t = 0; t < kItems; ++t) {
    const int64_t i = i0 + t;
    if (i >= n) break;
    const Key v = keys[i];
    if (v != KeyTraits<Key>::kSentinel) {
      if (i == 0 || v != prev) {
        out_keys[rank] = v;
        wpre[rank] = before;
        ++rank;
      }
      before += kUnit ? 1 : cnt[i];
    }
    prev = v;
  }
}

template <typename Key>
__global__ void rle_finish(int64_t n, const long long* __restrict__ totals,
                           const long long* __restrict__ wpre,
                           Key* __restrict__ out_keys,
                           int32_t* __restrict__ out_cnt) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (r >= n) return;
  const long long nu = totals[0];
  if (r < nu) {
    const long long next = r + 1 < nu ? wpre[r + 1] : totals[1];
    out_cnt[r] = static_cast<int32_t>(next - wpre[r]);
  } else {
    out_keys[r] = KeyTraits<Key>::kSentinel;
    out_cnt[r] = 0;
  }
}

template <typename Key>
int launch(const void* keys_v, const void* cnt_v, int64_t n, void* out_keys_v,
           void* out_cnt, void* wpre, void* tiles, void* totals,
           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto keys = static_cast<const Key*>(keys_v);
  auto cnt = static_cast<const int32_t*>(cnt_v);
  auto out_keys = static_cast<Key*>(out_keys_v);
  auto tot = static_cast<long long*>(totals);
  const int64_t n_tiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  auto tile_heads = static_cast<long long*>(tiles);
  auto tile_weight = tile_heads + n_tiles;
  const auto grid = static_cast<unsigned>(n_tiles);
  if (cnt == nullptr) {
    rle_reduce<Key, true><<<grid, kThreads, 0, s>>>(keys, cnt, n, tile_heads,
                                                    tile_weight);
  } else {
    rle_reduce<Key, false><<<grid, kThreads, 0, s>>>(keys, cnt, n, tile_heads,
                                                     tile_weight);
  }
  rle_scan_tiles<<<1, 1024, 0, s>>>(tile_heads, tile_weight, n_tiles, tot);
  if (cnt == nullptr) {
    rle_scatter<Key, true><<<grid, kThreads, 0, s>>>(
        keys, cnt, n, tile_heads, tile_weight, out_keys,
        static_cast<long long*>(wpre));
  } else {
    rle_scatter<Key, false><<<grid, kThreads, 0, s>>>(
        keys, cnt, n, tile_heads, tile_weight, out_keys,
        static_cast<long long*>(wpre));
  }
  if (n > 0) {
    const int threads = 256;
    rle_finish<Key><<<static_cast<unsigned>((n + threads - 1) / threads),
                      threads, 0, s>>>(n, tot,
                                       static_cast<const long long*>(wpre),
                                       out_keys,
                                       static_cast<int32_t*>(out_cnt));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch sizes the caller allocates: wpre n int64, tiles 2 * n_tiles int64
// (n_tiles = max(ceil(n / krust_rle_tile()), 1)), totals 2 int64.
// cnt may be null (unit weights).
KRUST_API int64_t krust_rle_tile() { return kTile; }

KRUST_API int krust_rle_i32(int device, const void* keys, const void* cnt, int64_t n,
                            void* out_keys, void* out_cnt, void* wpre,
                            void* tiles, void* totals, void* stream) {
  const int err = set_device(device);
  if (err) return err;
  return launch<int32_t>(keys, cnt, n, out_keys, out_cnt, wpre, tiles, totals,
                         stream);
}

KRUST_API int krust_rle_i64(int device, const void* keys, const void* cnt, int64_t n,
                            void* out_keys, void* out_cnt, void* wpre,
                            void* tiles, void* totals, void* stream) {
  const int err = set_device(device);
  if (err) return err;
  return launch<int64_t>(keys, cnt, n, out_keys, out_cnt, wpre, tiles, totals,
                         stream);
}
