// K2: run-length compaction (reduce-by-key) of a key-sorted stream.
//
// Replaces krust_tpu/ops/pallas_rle.py:rle_compact. Input: n biased keys
// sorted ascending, sentinel keys (INT32_MAX / INT64_MAX) at the back, and
// optional int32 weights (none = every entry counts 1). Output, n long:
// the distinct non-sentinel keys with their summed weights packed to the
// front, sentinel keys and zero counts after them, and n_unique in a
// device scalar (read by the host only when it needs it).
//
// Bound on the H100: bytes. The keys (and weights) are read once and the n
// keys and n counts written once; the scratch is 16 bytes per tile of
// 16 KB of keys. The TPU kernel walks its chunks in order and
// carries the open run in SMEM; blocks here run in parallel, so the carry
// becomes a single-pass decoupled look-back scan (Merrill and Garland) of
// the pair (heads so far, weight since the last head) under the segmented
// sum. Two launches:
//   A. rle_tiles: each block takes the next tile from an atomic ticket (so
//      every earlier tile is already running and look-back always makes
//      progress), loads its keys, the key before the tile and the key after
//      it with coalesced 16-byte loads into shared memory, and reads them
//      back as a blocked run of kItems keys per thread. A thread turns its
//      run into bit masks (valid, head, run end) and its pair into popcounts
//      (unit weights) or a short sum; the block scans the pairs in 32 bits.
//      Warp 0 publishes the tile's aggregate (flag 1), looks back over its
//      predecessors, a warp-wide window of 32 a round, until it meets an
//      inclusive prefix (flag 2), and publishes its own; meanwhile the other
//      warps stage their heads' keys and their run ends' sums in shared
//      memory at tile-local ranks. Then the block writes both ranges out
//      coalesced (a tile's ranks are contiguous), adding the weight carried
//      into the tile to the sum of the run it starts inside of; the last
//      non-sentinel entry gives n_unique (0 when tile 0 starts with a
//      sentinel).
//   B. rle_tail: sentinel keys and zero counts for n_unique <= r < n, as
//      16-byte vector stores, over a grid fixed at launch that reads
//      n_unique once per block (no host sync).
// No fence orders a tile's status words (each carries its flag), and the
// caller's status words and ticket are zeroed on the stream first.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// keys per thread and per tile: every tile is 16 KB of keys
template <typename Key>
struct Tile {
  static constexpr int kItems = 128 / sizeof(Key);       // 32 int32, 16 int64
  static constexpr int kKeys = kThreads * kItems;        // 4096 / 2048
  static constexpr int kPad = kKeys + kThreads;          // one pad per row
};

// (heads so far, weight since the last head) under the segmented sum
struct Run {
  long long h, w;
};

// a before b
__device__ __forceinline__ Run combine(Run a, Run b) {
  return {a.h + b.h, b.h ? b.w : a.w + b.w};
}

// The same pair inside one tile, in 32 bits (weights add modulo 2^32, as
// the int32 counts they end in).
struct Local {
  int h;
  uint32_t w;
};

__device__ __forceinline__ Local combine(Local a, Local b) {
  return {a.h + b.h, b.h ? b.w : a.w + b.w};
}

__device__ __forceinline__ Local shfl_up(Local r, int o) {
  return {__shfl_up_sync(0xffffffffu, r.h, o), __shfl_up_sync(0xffffffffu, r.w, o)};
}

__device__ __forceinline__ Run shfl_down(Run r, int o) {
  return {__shfl_down_sync(0xffffffffu, r.h, o), __shfl_down_sync(0xffffffffu, r.w, o)};
}

// A tile's status: two 8-byte words, heads << 2 | flag and weight << 2 |
// flag (the weight modulo 2^32, as the int32 counts it ends in), flag 0 =
// not yet, 1 = the tile's aggregate, 2 = its inclusive prefix. Each word is
// stored and loaded whole (relaxed, L2), and a reader takes the pair only
// when both carry the same flag, so no fence orders the two stores.
struct Status {
  unsigned long long h, w;
};

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void publish(Status* st, Run r, unsigned flag) {
  store_relaxed(&st->h, static_cast<unsigned long long>(r.h) << 2 | flag);
  store_relaxed(&st->w, static_cast<unsigned long long>(static_cast<uint32_t>(r.w)) << 2 | flag);
}

// The status of tile q once both words carry one nonzero flag: the flag
// and the pair.
__device__ __forceinline__ int await(const Status* st, Run* r) {
  unsigned long long h, w;
  do {
    h = load_relaxed(&st->h);
    w = load_relaxed(&st->w);
  } while ((h & 3) == 0 || (h & 3) != (w & 3));
  *r = Run{static_cast<long long>(h >> 2), static_cast<long long>(w >> 2)};
  return static_cast<int>(h & 3);
}

// smem slot of tile element e: one pad slot after every thread's row, so
// the blocked reads (row stride kItems + 1) hit distinct banks
template <typename Key>
__device__ __forceinline__ int slot(int e) {
  return e + e / Tile<Key>::kItems;
}

// One thread's share of a whole tile of T, fetched with 16-byte loads into
// registers (all in flight at once), then stored to the padded smem tile.
template <typename Key, typename T>
struct Fetch {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kN = Tile<Key>::kKeys / kVec / kThreads;
  int4 q[kN];

  __device__ __forceinline__ void load(const T* __restrict__ src) {
    const int4* v = reinterpret_cast<const int4*>(src);
#pragma unroll
    for (int r = 0; r < kN; ++r) q[r] = __ldg(v + threadIdx.x + r * kThreads);
  }

  __device__ __forceinline__ void store(T* dst) const {
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      union {
        int4 q;
        T t[kVec];
      } u;
      u.q = q[r];
      const int e = (threadIdx.x + r * kThreads) * kVec;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dst[slot<Key>(e + i)] = u.t[i];
    }
  }
};

// The ragged last tile, element by element, the rest filled with fill.
template <typename Key, typename T>
__device__ __forceinline__ void load_part(const T* __restrict__ src, int count, T fill,
                                          T* dst) {
  for (int i = threadIdx.x; i < Tile<Key>::kKeys; i += kThreads)
    dst[slot<Key>(i)] = i < count ? src[i] : fill;
}

template <typename Key, bool kUnit>
__global__ void __launch_bounds__(kThreads)
rle_tiles(const Key* __restrict__ keys, const int32_t* __restrict__ cnt, int64_t n,
          Key* __restrict__ o_keys, int32_t* __restrict__ o_cnt,
          long long* __restrict__ n_unique, Status* __restrict__ status,
          int* __restrict__ ticket) {
  constexpr Key kS = KeyTraits<Key>::kSentinel;
  constexpr int kItems = Tile<Key>::kItems;
  constexpr int kKeys = Tile<Key>::kKeys;
  constexpr int kWarps = kThreads / 32;
  // the tile's keys and weights; once in registers, its staged outputs at
  // tile-local ranks
  __shared__ Key s_keys[Tile<Key>::kPad];
  __shared__ uint32_t s_w[Tile<Key>::kPad];
  __shared__ Key s_edge[2];  // the key before the tile and the key after it
  __shared__ Local s_warp[kWarps];
  __shared__ Run s_prefix;
  __shared__ long long s_tile;
  __shared__ int s_cont, s_open, s_last;  // starts / ends inside a run; n_unique here

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = atomicAdd(ticket, 1);
    s_last = -1;
  }
  __syncthreads();
  const long long tile = s_tile;
  const int64_t start = tile * kKeys;
  const int count = static_cast<int>(n - start < kKeys ? n - start : kKeys);

  if (threadIdx.x == 0) {
    s_edge[0] = start > 0 ? keys[start - 1] : kS;
    s_edge[1] = start + kKeys < n ? keys[start + kKeys] : kS;
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(keys + start) & 15) == 0 &&
                       (kUnit || (reinterpret_cast<uintptr_t>(cnt + start) & 15) == 0);
  if (count == kKeys && aligned) {
    Fetch<Key, Key> fk;
    Fetch<Key, uint32_t> fw;
    fk.load(keys + start);
    if constexpr (!kUnit) fw.load(reinterpret_cast<const uint32_t*>(cnt) + start);
    fk.store(s_keys);
    if constexpr (!kUnit) fw.store(s_w);
  } else {
    load_part<Key>(keys + start, count, kS, s_keys);
    if constexpr (!kUnit)
      load_part<Key>(reinterpret_cast<const uint32_t*>(cnt) + start, count, 0u, s_w);
  }
  __syncthreads();

  // this thread's blocked run of kItems keys as bit masks: valid (not the
  // sentinel), head (first of its run), end (last of its run)
  const int e0 = threadIdx.x * kItems;
  Key v[kItems];
  uint32_t w[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    v[j] = s_keys[slot<Key>(e0 + j)];
    if constexpr (kUnit) {
      w[j] = 1;
    } else {
      w[j] = s_w[slot<Key>(e0 + j)];
    }
  }
  const Key before = threadIdx.x ? s_keys[slot<Key>(e0 - 1)] : s_edge[0];
  const Key after = threadIdx.x + 1 < kThreads ? s_keys[slot<Key>(e0 + kItems)] : s_edge[1];
  uint32_t vm = 0, hm = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    vm |= static_cast<uint32_t>(v[j] != kS) << j;
    hm |= static_cast<uint32_t>(v[j] != (j ? v[j - 1] : before)) << j;
  }
  hm &= vm;
  const uint32_t next_valid = (vm >> 1) | static_cast<uint32_t>(after != kS) << (kItems - 1);
  const uint32_t next_head = (hm >> 1) | static_cast<uint32_t>(after != v[kItems - 1])
                                             << (kItems - 1);
  const uint32_t em = vm & (next_head | ~next_valid);
  if (threadIdx.x == 0) s_cont = (vm & ~hm) & 1;
  if (threadIdx.x + 1 == kThreads) s_open = (vm & ~em) >> (kItems - 1) & 1;

  Local agg{__popc(hm), 0};
  if constexpr (kUnit) {
    agg.w = __popc(hm ? vm >> (31 - __clz(hm)) : vm);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (hm >> j & 1) {
        agg.w = w[j];
      } else if (vm >> j & 1) {
        agg.w += w[j];
      }
    }
  }

  // block scan: warp inclusive scans, then one warp scans the warp totals
  Local incl = agg;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Local y = shfl_up(incl, o);
    if (lane >= o) incl = combine(y, incl);
  }
  Local excl = shfl_up(incl, 1);
  if (lane == 0) excl = Local{0, 0};
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    Local t = lane < kWarps ? s_warp[lane] : Local{0, 0};
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const Local y = shfl_up(t, o);
      if (lane >= o) t = combine(y, t);
    }
    if (lane < kWarps) s_warp[lane] = t;
  }
  __syncthreads();
  if (warp) excl = combine(s_warp[warp - 1], excl);
  const Local tile_agg = s_warp[kWarps - 1];
  const Run tile_run{tile_agg.h, tile_agg.w};

  // Warp 0 looks back for the tile's prefix while the other warps go on.
  if (warp == 0) {
    Run prefix{0, 0};
    if (tile == 0) {
      if (lane == 0) publish(status, tile_run, 2);
    } else {
      if (lane == 0) publish(status + tile, tile_run, 1);
      for (long long last = tile - 1;; last -= 32) {
        const long long q = last - lane;  // lane 0: the nearest predecessor
        int f = 2;
        Run r{0, 0};
        if (q >= 0) f = await(status + q, &r);
        const unsigned done = __ballot_sync(0xffffffffu, f == 2);
        const int stop = done ? __ffs(done) - 1 : 32;
        if (lane > stop) r = Run{0, 0};
        // fold the window, earliest tile (highest lane) first, into lane 0
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) r = combine(shfl_down(r, o), r);
        r = Run{__shfl_sync(0xffffffffu, r.h, 0), __shfl_sync(0xffffffffu, r.w, 0)};
        prefix = combine(r, prefix);
        if (done) break;
      }
      if (lane == 0) publish(status + tile, combine(prefix, tile_run), 2);
    }
    if (lane == 0) s_prefix = prefix;
  }

  // Stage at tile-local ranks: a head's key at its rank, a run end's sum
  // (without the weight carried into the tile) at its rank + cont; and the
  // local n_unique where the last non-sentinel entry lies.
  {
    const int cont = s_cont;
    int r = excl.h;
    uint32_t run_w = excl.w;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (hm >> j & 1) {
        s_keys[r++] = v[j];
        run_w = w[j];
      } else if (vm >> j & 1) {
        run_w += w[j];
      }
      if (em >> j & 1) {
        s_w[r - 1 + cont] = run_w;
        if (!(next_valid >> j & 1)) s_last = r;
      }
    }
  }
  __syncthreads();

  // coalesced stores of the staged keys and sums; the first sum, if the
  // tile starts inside a run, takes the weight carried into the tile
  const long long k0 = s_prefix.h;
  const int cont = s_cont;
  const int ends = tile_agg.h + cont - s_open;
  for (int i = threadIdx.x; i < tile_agg.h; i += kThreads) o_keys[k0 + i] = s_keys[i];
  for (int i = threadIdx.x; i < ends; i += kThreads) {
    const uint32_t carry = i == 0 && cont ? static_cast<uint32_t>(s_prefix.w) : 0u;
    o_cnt[k0 - cont + i] = static_cast<int32_t>(s_w[i] + carry);
  }
  if (threadIdx.x == 0) {
    if (s_last >= 0) *n_unique = k0 + s_last;
    if (tile == 0 && v[0] == kS) *n_unique = 0;
  }
}

constexpr int kTailThreads = 256;

// out[i] = value for nu <= i < n, grid-strided 16-byte stores from the
// 512-byte group that holds nu, so every warp's store covers whole lines.
template <typename T>
__device__ __forceinline__ void fill_from(T* __restrict__ out, long long nu, int64_t n,
                                          T value) {
  constexpr int kV = 16 / sizeof(T);
  union {
    int4 q;
    T t[kV];
  } u;
#pragma unroll
  for (int e = 0; e < kV; ++e) u.t[e] = value;
  const long long stride = static_cast<long long>(gridDim.x) * kTailThreads * kV;
  long long i = (nu / kV / 32 * 32 + blockIdx.x * static_cast<long long>(kTailThreads) +
                 threadIdx.x) * kV;
  for (; i < n; i += stride) {
    if (i >= nu && i + kV <= n) {
      reinterpret_cast<int4*>(out)[i / kV] = u.q;
    } else {
      for (int e = 0; e < kV; ++e)
        if (i + e >= nu && i + e < n) out[i + e] = value;
    }
  }
}

template <typename Key>
__global__ void __launch_bounds__(kTailThreads)
rle_tail(Key* __restrict__ o_keys, int32_t* __restrict__ o_cnt, int64_t n,
         const long long* __restrict__ n_unique) {
  __shared__ long long s_nu;
  if (threadIdx.x == 0) s_nu = *n_unique;
  __syncthreads();
  fill_from(o_keys, s_nu, n, KeyTraits<Key>::kSentinel);
  fill_from(o_cnt, s_nu, n, 0);
}

int64_t n_tiles(int64_t n, int key_bytes) {
  const int64_t tile = key_bytes == 4 ? Tile<int32_t>::kKeys : Tile<int64_t>::kKeys;
  return n > 0 ? (n + tile - 1) / tile : 1;
}

template <typename Key>
int launch(const void* keys_v, const void* cnt_v, int64_t n, void* out_keys,
           void* out_cnt, void* n_unique, void* scratch, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = n_tiles(n, sizeof(Key));
  auto status = static_cast<Status*>(scratch);
  auto ticket = reinterpret_cast<int*>(status + tiles);
  const cudaError_t err = cudaMemsetAsync(scratch, 0, tiles * sizeof(Status) + sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto keys = static_cast<const Key*>(keys_v);
  auto cnt = static_cast<const int32_t*>(cnt_v);
  auto o_keys = static_cast<Key*>(out_keys);
  auto o_cnt = static_cast<int32_t*>(out_cnt);
  auto nu = static_cast<long long*>(n_unique);
  const auto grid = static_cast<unsigned>(tiles);
  if (cnt == nullptr) {
    rle_tiles<Key, true><<<grid, kThreads, 0, s>>>(keys, cnt, n, o_keys, o_cnt, nu, status,
                                                    ticket);
  } else {
    rle_tiles<Key, false><<<grid, kThreads, 0, s>>>(keys, cnt, n, o_keys, o_cnt, nu, status,
                                                     ticket);
  }
  if (n > 0) {
    const int64_t per_block = kTailThreads * (16 / sizeof(Key));
    const int64_t blocks = (n + per_block - 1) / per_block;
    rle_tail<Key><<<static_cast<unsigned>(blocks < 2048 ? blocks : 2048), kTailThreads, 0,
                    s>>>(o_keys, o_cnt, n, nu);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Keys per tile for a key width of key_bytes (4 or 8).
KRUST_API int64_t krust_rle_tile(int key_bytes) {
  return key_bytes == 4 ? Tile<int32_t>::kKeys : Tile<int64_t>::kKeys;
}

// Bytes of scratch the caller allocates (8-byte aligned): a status per
// tile and the ticket. out_keys and out_cnt are n long and 16-byte
// aligned, n_unique one int64; cnt may be null (unit weights).
KRUST_API int64_t krust_rle_scratch_bytes(int64_t n, int key_bytes) {
  return n_tiles(n, key_bytes) * static_cast<int64_t>(sizeof(Status)) + sizeof(int);
}

KRUST_API int krust_rle_i32(int device, const void* keys, const void* cnt, int64_t n,
                            void* out_keys, void* out_cnt, void* n_unique,
                            void* scratch, void* stream) {
  const DeviceScope scope(device);
  if (scope.error()) return scope.error();
  return launch<int32_t>(keys, cnt, n, out_keys, out_cnt, n_unique, scratch, stream);
}

KRUST_API int krust_rle_i64(int device, const void* keys, const void* cnt, int64_t n,
                            void* out_keys, void* out_cnt, void* n_unique,
                            void* scratch, void* stream) {
  const DeviceScope scope(device);
  if (scope.error()) return scope.error();
  return launch<int64_t>(keys, cnt, n, out_keys, out_cnt, n_unique, scratch, stream);
}
