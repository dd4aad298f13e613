// K6: the count-of-counts (histogram) of a table's int32 counts.
//
// Replaces no krust_tpu kernel: krust_tpu pulls a table's counts and takes
// their histogram on the host (np.unique, a sort of every count). It was
// added because that sort was the largest host step of a `-f histogram`
// count (113M counts a pass of a 128 Mbase assembly at k = 31), while the
// counts lie on the card as int32 until the pull widens them.
//
// Input: n int32 counts, any values. Output: bins[v], how many counts equal
// v, for 0 <= v < n_bins (u64), then n_over, how many lie outside
// [0, n_bins). When n_over > 0 the host reads it and a second launch
// gathers those counts, in any order, into a buffer of exactly n_over
// entries, which the host counts exactly; so the histogram is exact for
// every int32 count.
//
// Bound on the H100: bytes, 4 B a count read once (the bins are 8 B each).
// Design: each block keeps n_bins u32 bins of its own in shared memory and
// walks the counts grid-stride in 16-byte loads. A warp adds each of its 32
// values through __match_any_sync, so the lanes that hold one value make
// one shared atomic between them: most of a table's counts are 1, 2 or 3,
// and a warp of equal values would otherwise serialise 32 atomics on one
// word. Counts outside the bins are tallied by ballot, one atomic a warp.
// Each block then adds its nonzero bins to the global u64 bins.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

// Walks the counts with every lane of a warp in step: the 16-byte-aligned
// body four counts a lane, the unaligned head and tail (at most 3 counts
// each) by the grid's first warp. visit(value, valid) is called by all 32
// lanes of a warp together, so it may use warp collectives; a lane past the
// end passes valid = false.
template <typename Visit>
__device__ __forceinline__ void walk(const int32_t* counts, int64_t n, Visit visit) {
  const auto addr = reinterpret_cast<uintptr_t>(counts);
  int64_t head = static_cast<int64_t>(((16 - (addr & 15)) & 15) / 4);
  if (head > n) head = n;
  const int64_t n_vec = (n - head) / 4;
  const int64_t tail = head + n_vec * 4;
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int4* vec = reinterpret_cast<const int4*>(counts + head);
  for (int64_t base = warp * 32; base < n_vec; base += warps * 32) {
    const int64_t i = base + lane;
    const bool ok = i < n_vec;
    const int4 v = ok ? __ldg(vec + i) : make_int4(0, 0, 0, 0);
    visit(v.x, ok);
    visit(v.y, ok);
    visit(v.z, ok);
    visit(v.w, ok);
  }
  if (warp == 0) {
    visit(lane < head ? counts[lane] : 0, lane < head);
    visit(lane < n - tail ? counts[tail + lane] : 0, lane < n - tail);
  }
}

__global__ void __launch_bounds__(kThreads)
    count_bins(const int32_t* counts, int64_t n, int n_bins, unsigned long long* bins,
               unsigned long long* n_over) {
  extern __shared__ unsigned s_bins[];
  __shared__ unsigned s_over;
  for (int b = threadIdx.x; b < n_bins; b += kThreads) s_bins[b] = 0;
  if (threadIdx.x == 0) s_over = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  walk(counts, n, [&](int32_t c, bool ok) {
    const bool in = ok && static_cast<uint32_t>(c) < static_cast<uint32_t>(n_bins);
    const unsigned over = __ballot_sync(kFull, ok && !in);
    const unsigned peers = __match_any_sync(kFull, in ? c : -1);
    if (in && lane == __ffs(peers) - 1) atomicAdd(&s_bins[c], __popc(peers));
    if (lane == 0 && over) atomicAdd(&s_over, __popc(over));
  });
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += kThreads) {
    const unsigned v = s_bins[b];
    if (v) atomicAdd(&bins[b], static_cast<unsigned long long>(v));
  }
  if (threadIdx.x == 0 && s_over) atomicAdd(n_over, static_cast<unsigned long long>(s_over));
}

__global__ void __launch_bounds__(kThreads)
    gather_over(const int32_t* counts, int64_t n, int n_bins, int32_t* out,
                unsigned long long* pos) {
  const int lane = threadIdx.x & 31;
  walk(counts, n, [&](int32_t c, bool ok) {
    const bool take = ok && static_cast<uint32_t>(c) >= static_cast<uint32_t>(n_bins);
    const unsigned m = __ballot_sync(kFull, take);
    if (!m) return;
    unsigned long long base = 0;
    if (lane == 0) base = atomicAdd(pos, static_cast<unsigned long long>(__popc(m)));
    base = __shfl_sync(kFull, base, 0);
    if (take) out[base + __popc(m & ((1u << lane) - 1))] = c;
  });
}

// Enough blocks to fill the card, none with less than a load a thread.
template <typename Kernel>
int grid_for(Kernel kernel, int64_t n, size_t smem, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (n / 4 + kThreads - 1) / kThreads;
  const int64_t full = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<unsigned>(want < 1 ? 1 : (want < full ? want : full));
  return 0;
}

}  // namespace

// acc: n_bins + 1 u64, zeroed here on the stream: the bins, then n_over.
// n > 0; n_bins * 4 bytes of shared memory a block (at most 48 KB).
KRUST_API int krust_count_histogram(int device, const void* counts, int64_t n, int n_bins,
                                    void* acc, void* stream) {
  const DeviceScope scope(device);
  if (scope.error()) return scope.error();
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(n_bins) * sizeof(unsigned);
  unsigned grid = 0;
  int err = grid_for(count_bins, n, smem, &grid);
  if (err) return err;
  err = static_cast<int>(cudaMemsetAsync(acc, 0, (n_bins + 1) * sizeof(unsigned long long), s));
  if (err) return err;
  auto bins = static_cast<unsigned long long*>(acc);
  count_bins<<<grid, kThreads, smem, s>>>(static_cast<const int32_t*>(counts), n, n_bins, bins,
                                          bins + n_bins);
  return static_cast<int>(cudaGetLastError());
}

// out: n_over int32 (the n_over of krust_count_histogram over the same
// counts); pos: one u64, zeroed here on the stream.
KRUST_API int krust_histogram_over(int device, const void* counts, int64_t n, int n_bins,
                                   void* out, void* pos, void* stream) {
  const DeviceScope scope(device);
  if (scope.error()) return scope.error();
  auto s = static_cast<cudaStream_t>(stream);
  unsigned grid = 0;
  int err = grid_for(gather_over, n, 0, &grid);
  if (err) return err;
  err = static_cast<int>(cudaMemsetAsync(pos, 0, sizeof(unsigned long long), s));
  if (err) return err;
  gather_over<<<grid, kThreads, 0, s>>>(static_cast<const int32_t*>(counts), n, n_bins,
                                        static_cast<int32_t*>(out),
                                        static_cast<unsigned long long*>(pos));
  return static_cast<int>(cudaGetLastError());
}
