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
// the arithmetic is far below the card's integer rate. Design: one block
// per tile of kTile windows.
//   - The tile's packed bytes and the halo after them (kTile / 4 + 8 bytes,
//     never past n_windows / 4 + 8) load into shared memory with 16-byte
//     loads.
//   - Two warps find the ends of the tile's slice of the sorted invalid
//     positions, the ones in bases [tile, tile + kTile + k - 1), each by a
//     32-way search (four dependent loads for 335K positions), and the
//     block sets them in a shared bad-base bitmask. A window is bad iff
//     its k bits of the mask hold a 1, or it lies at or past `covered`: no
//     per-thread search, no dilation pass over memory.
//   - Each thread keys a run of kRun = 32 consecutive windows from 16
//     packed bytes and its 64 bits of the mask, and the tile leaves as
//     coalesced 16-byte stores: the tile of csrc/codec_tile.cuh, shared
//     with K4.

#include "codec_tile.cuh"

namespace {

constexpr int kTileBytes = kTile / 4;       // their packed bytes
constexpr int kHalo = 8;                    // bytes the contract adds past them
constexpr int kBufBytes = kTileBytes + 16;  // the last thread reads 16 bytes
constexpr int kBadWords = kTile / 32 + 2;   // bits of kTile + 31 bases

// First index i in [0, n) with a[i] >= x (n if none), by one whole warp:
// 32 probes a step, so about log32(n) dependent loads.
__device__ __forceinline__ int64_t warp_lower_bound(const int32_t* __restrict__ a,
                                                    int64_t n, int64_t x) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = n;
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + lane * step;
    const unsigned less = __ballot_sync(0xffffffffu, p < hi && a[p] < x);
    const int c = __popc(less);  // sorted: lanes 0..c-1 probe below x
    const int64_t top = lo + c * step;
    if (c) lo += (c - 1) * step + 1;
    if (top < hi) hi = top;
  }
  const int64_t p = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, p < hi && a[p] < x));
}

template <typename Key>
__global__ void __launch_bounds__(kThreads)
encode_windows_kernel(const uint8_t* __restrict__ packed,
                      const int32_t* __restrict__ invpos, int64_t n_inv,
                      int64_t covered, int k, int64_t n_windows,
                      Key* __restrict__ out) {
  __shared__ __align__(16) uint8_t s_bytes[kBufBytes];
  __shared__ uint32_t s_bad[kBadWords];
  __shared__ __align__(16) Key s_out[KeyRun<Key>::kStage];
  __shared__ int64_t s_range[2];

  const int t = threadIdx.x;
  const int64_t start = blockIdx.x * static_cast<int64_t>(kTile);
  const int windows = static_cast<int>(n_windows - start < kTile ? n_windows - start : kTile);

  // packed bytes [start / 4, start / 4 + windows / 4 + kHalo), zero after
  const uint8_t* src = packed + start / 4;
  const int nb = windows / 4 + kHalo;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = nb / 16 * 16;
    for (int i = t; i < nb / 16; i += kThreads)
      reinterpret_cast<int4*>(s_bytes)[i] = __ldg(reinterpret_cast<const int4*>(src) + i);
  }
  for (int i = done + t; i < kBufBytes; i += kThreads) s_bytes[i] = i < nb ? src[i] : 0;
  for (int i = t; i < kBadWords; i += kThreads) s_bad[i] = 0;
  // the tile's slice of invpos: bases [start, start + windows + k - 1)
  if (t < 64) {
    const int64_t x = t < 32 ? start : start + windows + k - 1;
    const int64_t i = warp_lower_bound(invpos, n_inv, x);
    if ((t & 31) == 0) s_range[t >> 5] = i;
  }
  __syncthreads();
  for (int64_t i = s_range[0] + t; i < s_range[1]; i += kThreads) {
    const int p = static_cast<int>(invpos[i] - start);
    atomicOr(&s_bad[p >> 5], 1u << (p & 31));
  }
  __syncthreads();

  const int j0 = t * kRun;  // this thread's first window in the tile
  if (j0 < windows) {
    // bases j0 .. j0 + 63 as four big-endian words
    const uint32_t* src_w = reinterpret_cast<const uint32_t*>(s_bytes + j0 / 4);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __byte_perm(src_w[i], 0, 0x0123);
    // the window holds a bad base, or lies past covered
    uint32_t poison = window_poison(
        static_cast<uint64_t>(s_bad[j0 / 32 + 1]) << 32 | s_bad[j0 / 32], k);
    const int64_t live = covered - (start + j0);
    if (live < kRun) poison |= live <= 0 ? ~0u : ~0u << live;
    KeyRun<Key> keys;
    key_run<Key>(w, poison, k, keys);
    stage_run<Key>(keys, s_out, t);
  }
  __syncthreads();
  store_tile<Key>(s_out, out + start, windows, t);
}

template <typename Key>
int launch(const void* packed, const void* invpos, int64_t n_inv,
           int64_t covered, int k, int64_t n_windows, void* out,
           void* stream) {
  if (n_windows > 0) {
    const int64_t blocks = (n_windows + kTile - 1) / kTile;
    encode_windows_kernel<Key><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed),
        static_cast<const int32_t*>(invpos), n_inv, covered, k, n_windows,
        static_cast<Key*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Windows per block.
KRUST_API int64_t krust_encode_windows_tile() { return kTile; }

// packed: >= n_windows / 4 + 8 bytes; invpos: n_inv sorted int32;
// out: n_windows keys (int32 for k <= 16, int64 otherwise), 16-byte
// aligned; n_windows % 4 == 0
KRUST_API int krust_encode_windows_i32(int device, const void* packed, const void* invpos,
                                       int64_t n_inv, int64_t covered, int k,
                                       int64_t n_windows, void* out,
                                       void* stream) {
  const DeviceScope scope(device);
  if (scope.error()) return scope.error();
  return launch<int32_t>(packed, invpos, n_inv, covered, k, n_windows, out,
                         stream);
}

KRUST_API int krust_encode_windows_i64(int device, const void* packed, const void* invpos,
                                       int64_t n_inv, int64_t covered, int k,
                                       int64_t n_windows, void* out,
                                       void* stream) {
  const DeviceScope scope(device);
  if (scope.error()) return scope.error();
  return launch<int64_t>(packed, invpos, n_inv, covered, k, n_windows, out,
                         stream);
}

KRUST_API const char* krust_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
