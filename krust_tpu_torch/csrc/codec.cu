// K4: dense 2-bit rows + invalid bitmask -> biased canonical k-mer keys,
// window poisoning included.
//
// Replaces krust_tpu/ops/pallas_codec.py:encode_blocks_pallas together
// with the unpack before it (krust_tpu/ops/codec.py:unpack_2bit) and the
// sentinel step after it (krust_tpu/models/engines.py:_sentinel_part), the
// dense path's step (_dense_raw_step).
//
// Input: rows of a dense batch, each its own haloed row of W + k - 1 bases
// (W = block_windows): packed2 [rows, p4] with 4 bases per byte, first base
// in the high bits, and badbits [rows, p8] with 8 flags per byte, first
// base in bit 7, set = invalid (padding rows and bases past the stream's
// end are set). Output: rows * W keys in row-major window order, the
// sentinel for a window holding a bad base.
//
// Bound on the H100: bytes. A row reads 0.375 B/base and writes 4 B
// (k <= 16) or 8 B (k > 16) per window, so the write dominates; the
// arithmetic is far below the card's integer rate. Design: one thread per
// group of four windows of one row. The TPU kernel's
// pack-doubling (fewer vector ops on the VPU) and 128-lane padding answer
// the TPU's layout and are not carried over. The thread loads only the
// ceil((k + 3) / 4) packed bytes its bases [4q, 4q + k + 2] occupy and the
// at most 5 badbits bytes that hold their flags, so no load leaves the row
// (the last group of the last row included). Validity needs no unpacked
// mask, scatter or dilation: the flags go into one 64-bit word, base 4q in
// bit 63, and window 4q + r is bad iff the k bits from bit 63 - r hold a 1.

#include "common.cuh"

namespace {

// Base t (0..35) of a group of four windows, from the group's first eight
// packed bytes in w0 (big-endian: base 0 in the top two bits) and its
// ninth byte in w1.
__device__ __forceinline__ uint64_t base_at(uint64_t w0, uint32_t w1, int t) {
  return t < 32 ? (w0 >> (62 - 2 * t)) & 3ull
                : static_cast<uint64_t>((w1 >> (70 - 2 * t)) & 3u);
}

// Canonical codes (min of forward and reverse complement) of the four
// windows that start at bases 0..3 of a group: the first window's codes
// build in k steps and the next three roll in one step each.
__device__ __forceinline__ void group_canonical(uint64_t w0, uint32_t w1, int k,
                                                uint64_t canon[4]) {
  const uint64_t mask = k == 32 ? ~0ull : ((1ull << (2 * k)) - 1);
  const int top = 2 * (k - 1);
  uint64_t fwd = 0, rc = 0;
  for (int t = 0; t < k; ++t) {
    const uint64_t c = base_at(w0, w1, t);
    fwd = (fwd << 2) | c;
    rc = (rc >> 2) | ((3ull - c) << top);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r) {
      const uint64_t c = base_at(w0, w1, k - 1 + r);
      fwd = ((fwd << 2) | c) & mask;
      rc = (rc >> 2) | ((3ull - c) << top);
    }
    canon[r] = rc < fwd ? rc : fwd;
  }
}

template <typename Key>
__global__ void encode_dense_kernel(const uint8_t* __restrict__ packed2,
                                    const uint8_t* __restrict__ badbits,
                                    int64_t rows, int64_t p4, int64_t p8,
                                    int k, int64_t w, Key* __restrict__ out) {
  const int64_t groups_per_row = w / 4;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= rows * groups_per_row) return;
  const int64_t row = t / groups_per_row;
  const int64_t q = t - row * groups_per_row;

  // bases 4q .. 4q + k + 2 sit in packed bytes q .. q + ceil((k + 3) / 4) - 1
  const uint8_t* p = packed2 + row * p4 + q;
  const int n4 = (k + 6) / 4;
  uint64_t w0 = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) w0 = (w0 << 8) | (i < n4 ? p[i] : 0u);
  const uint32_t w1 = n4 > 8 ? p[8] : 0u;
  uint64_t canon[4];
  group_canonical(w0, w1, k, canon);

  // their flags sit in badbits bytes (4q) / 8 .. (4q + k + 2) / 8: at most 5
  const uint8_t* b = badbits + row * p8 + q / 2;
  const int n8 = static_cast<int>((4 * q + k + 2) / 8 - q / 2) + 1;
  uint64_t bits = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) bits = (bits << 8) | (i < n8 ? b[i] : 0u);
  bits <<= 24 + 4 * (q & 1);  // base 4q's flag in bit 63

  Key* o = out + row * w + 4 * q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool bad = ((bits << r) >> (64 - k)) != 0;
    o[r] = bad ? KeyTraits<Key>::kSentinel : KeyTraits<Key>::from_code(canon[r]);
  }
}

template <typename Key>
int launch(const void* packed2, const void* badbits, int64_t rows, int64_t p4,
           int64_t p8, int k, int64_t w, void* out, void* stream) {
  const int64_t n_groups = rows * (w / 4);
  if (n_groups > 0) {
    const int threads = 256;
    const int64_t blocks = (n_groups + threads - 1) / threads;
    encode_dense_kernel<Key><<<static_cast<unsigned>(blocks), threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed2),
        static_cast<const uint8_t*>(badbits), rows, p4, p8, k, w,
        static_cast<Key*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// packed2: rows x p4 bytes, p4 = ceil((w + k - 1) / 4); badbits: rows x p8
// bytes, p8 = ceil((w + k - 1) / 8); out: rows * w keys (int32 for k <= 16,
// int64 otherwise); w % 4 == 0
KRUST_API int krust_encode_dense_i32(int device, const void* packed2,
                                     const void* badbits, int64_t rows,
                                     int64_t p4, int64_t p8, int k, int64_t w,
                                     void* out, void* stream) {
  const int err = set_device(device);
  if (err) return err;
  return launch<int32_t>(packed2, badbits, rows, p4, p8, k, w, out, stream);
}

KRUST_API int krust_encode_dense_i64(int device, const void* packed2,
                                     const void* badbits, int64_t rows,
                                     int64_t p4, int64_t p8, int k, int64_t w,
                                     void* out, void* stream) {
  const int err = set_device(device);
  if (err) return err;
  return launch<int64_t>(packed2, badbits, rows, p4, p8, k, w, out, stream);
}
