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
// A second, code form (encode_codes_kernel) serves the public codec
// encode_blocks (krust_tpu/ops/codec.py:encode_blocks, whose Pallas twin
// substitutes alike): every window's canonical code with a bad base taken
// as code 0 on the forward strand and 0 on the complement strand, and no
// sentinel; validity goes to a plane of its own, the run's 32 poison bits
// as one uint32 a run (1/8 B a window against 4 or 8 B of key, one store a
// thread that its neighbours' make coalesced; the glue widens it to bool).
// A thread masks its run's words once (codec_tile.cuh substitute_run), so
// a window costs what it costs in the counting form. Both forms are one
// body, encode_rows<Key, kCodes>, and the counting form's instantiation
// reads and computes nothing of the code form's.
//
// Bound on the H100: bytes. A row reads 0.375 B/base and writes 4 B
// (k <= 16) or 8 B (k > 16) per window, so the write dominates; the
// arithmetic is far below the card's integer rate. Design: the tile of
// csrc/codec_tile.cuh (128 threads, a run of 32 consecutive windows of one
// row each), fed from the dense layout. The TPU kernel's pack-doubling and
// 128-lane padding answer the TPU's layout and are not carried over.
//   - A row is cut into runs of 32 windows (the last one partial when
//     W % 32 != 0). A block keys up to 128 runs: a slice of 128 runs of one
//     row when the row has that many (W >= 4096: one row a block at the
//     default W = 4096, several blocks a row above it), else as many whole
//     rows as fit (W = 256: 16 rows a block).
//   - Each of the block's row segments loads once into shared memory, the
//     packed bytes and the badbits bytes alike. Row strides are odd (1029
//     and 515 bytes at W = 4096, k = 21), so a segment starts at any byte:
//     it is placed in shared memory at its own offset mod 16, the 16-byte
//     chunks that lie wholly inside the row load as one vector each, and
//     the chunks at its two ends load bytewise, zero past the row's end.
//     No load leaves the row, so none leaves the tensor.
//   - A thread reads its 64 bases as five aligned words that __byte_perm
//     turns into four big-endian words at the segment's byte offset, and
//     its 64 bad bits as three words turned MSB-first to LSB-first by
//     __brev. The halo is the row's own next bytes; bits past the row's
//     width touch no window below W. Padding is bad bits already: no
//     positions, no search, no covered count.
//   - W % 32 == 0 (every W users run): a block's keys are contiguous in the
//     output and leave through the shared stage as coalesced 16-byte
//     stores. Any other W % 4 == 0: each thread stores its run's windows
//     below W itself as 16-byte vectors (a run starts at a multiple of four
//     keys), uncoalesced; simple, and held against the plain version too.

#include "codec_tile.cuh"

namespace {

// How a batch of rows of w windows maps onto blocks and shared memory.
struct DenseTile {
  int runs_per_row;  // runs of kRun windows in a row, a partial last one included
  int seg_runs;      // runs of one row a block keys
  int segs;          // rows a block keys
  int col_tiles;     // blocks a row takes
  int seg4;          // shared bytes a segment's packed bytes take
  int seg8;          // shared bytes a segment's badbits bytes take

  __host__ __device__ explicit DenseTile(int64_t w) {
    runs_per_row = static_cast<int>((w + kRun - 1) / kRun);
    seg_runs = runs_per_row < kThreads ? runs_per_row : kThreads;
    segs = kThreads / seg_runs;
    col_tiles = (runs_per_row + kThreads - 1) / kThreads;
    // a thread reads 20 (12) bytes from the word at or below its run's
    // first byte, 8 (4) bytes a run, and a segment starts up to 15 bytes in
    seg4 = (8 * seg_runs + 27 + 15) / 16 * 16;
    seg8 = (4 * seg_runs + 23 + 15) / 16 * 16;
  }

  __host__ __device__ int smem_bytes() const { return segs * (seg4 + seg8); }
};

// Bytes [off, stride) of rows row0 .. row0 + segs - 1 (those below `rows`)
// of a [rows, stride] byte tensor into shared memory: segment s at
// dst + s * seg, its first byte at its own address mod 16, zero past the
// row's end. Chunks of 16 bytes wholly inside the row load as one vector.
__device__ __forceinline__ void load_segments(const uint8_t* __restrict__ base,
                                              int64_t stride, int off, int64_t row0,
                                              int64_t rows, int segs, int seg,
                                              uint8_t* dst) {
  const int chunks = seg / 16;
  const int n = static_cast<int>(stride) - off;  // bytes of a row from off
  for (int f = threadIdx.x; f < segs * chunks; f += kThreads) {
    const int s = f / chunks;
    const int c = f - s * chunks;
    if (row0 + s >= rows) break;
    const uint8_t* src = base + (row0 + s) * stride + off;
    const int lo = 16 * c - static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
    uint8_t* d = dst + s * seg + 16 * c;
    if (lo >= 0 && lo + 16 <= n) {
      *reinterpret_cast<int4*>(d) = __ldg(reinterpret_cast<const int4*>(src + lo));
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b) d[b] = lo + b >= 0 && lo + b < n ? src[lo + b] : 0;
    }
  }
}

// Big-endian word of the four bytes at byte offset sh (0..3) of the
// little-endian words (lo, hi).
__device__ __forceinline__ uint32_t be_word(uint32_t lo, uint32_t hi, int sh) {
  return __byte_perm(lo, hi, 0x0123 + 0x1111 * sh);
}

// The rows' keys (kCodes false: the counting form, the sentinel for a
// poisoned window) or codes (kCodes true: the code form, every window's
// code with bad bases substituted, and each run's poison bits, windows past
// w set, to poison[row * runs_per_row + run]). The kernels below share it;
// the counting form reads and computes nothing of the code form's.
template <typename Key, bool kCodes>
__device__ __forceinline__ void encode_rows(const uint8_t* __restrict__ packed2,
                                            const uint8_t* __restrict__ badbits,
                                            int64_t rows, int64_t p4, int64_t p8, int k,
                                            int64_t w, Key* __restrict__ out,
                                            uint32_t* __restrict__ poison) {
  extern __shared__ __align__(16) uint8_t s_in[];
  __shared__ __align__(16) Key s_out[KeyRun<Key>::kStage];

  const DenseTile tile(w);
  const int t = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / tile.col_tiles) * tile.segs;
  const int run0 = static_cast<int>(blockIdx.x % tile.col_tiles) * kThreads;
  uint8_t* s4 = s_in;
  uint8_t* s8 = s_in + tile.segs * tile.seg4;
  load_segments(packed2, p4, run0 * (kRun / 4), row0, rows, tile.segs, tile.seg4, s4);
  load_segments(badbits, p8, run0 * (kRun / 8), row0, rows, tile.segs, tile.seg8, s8);
  __syncthreads();

  const bool staged = w % kRun == 0;
  const int s = t / tile.seg_runs;      // this thread's segment
  const int j = t - s * tile.seg_runs;  // and its run in it
  const int64_t row = row0 + s;
  const int run = run0 + j;
  if (s < tile.segs && row < rows && run < tile.runs_per_row) {
    // bases 32 run .. 32 run + 63 of the row as four big-endian words
    const uint8_t* src4 = packed2 + row * p4 + run0 * (kRun / 4);
    const int a4 = s * tile.seg4 + static_cast<int>(reinterpret_cast<uintptr_t>(src4) & 15) +
                   j * (kRun / 4);
    const uint32_t* v = reinterpret_cast<const uint32_t*>(s4 + (a4 & ~3));
    uint32_t b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = be_word(v[i], v[i + 1], a4 & 3);
    // their bad bits, bit i for base 32 run + i
    const uint8_t* src8 = badbits + row * p8 + run0 * (kRun / 8);
    const int a8 = s * tile.seg8 + static_cast<int>(reinterpret_cast<uintptr_t>(src8) & 15) +
                   j * (kRun / 8);
    const uint32_t* u = reinterpret_cast<const uint32_t*>(s8 + (a8 & ~3));
    const uint64_t bad = static_cast<uint64_t>(__brev(be_word(u[1], u[2], a8 & 3))) << 32 |
                         __brev(be_word(u[0], u[1], a8 & 3));
    KeyRun<Key> keys;
    if constexpr (kCodes) {
      uint32_t fw[4], cw[4];
      substitute_run(b, bad, fw, cw);
      code_run<Key>(fw, cw, k, keys);
      // windows past w (a partial last run) are no windows: poisoned
      const int64_t left = w - static_cast<int64_t>(run) * kRun;
      const uint32_t past = left < kRun ? ~0u << left : 0u;
      poison[row * tile.runs_per_row + run] = window_poison(bad, k) | past;
    } else {
      key_run<Key>(b, window_poison(bad, k), k, keys);
    }
    if (staged) {
      stage_run<Key>(keys, s_out, t);
    } else {
      // the run's windows below w, a multiple of four
      const int col = run * kRun;
      const int vecs = static_cast<int>(w - col < kRun ? w - col : kRun) / KeyRun<Key>::kVec;
      int4* dst = reinterpret_cast<int4*>(out + row * w + col);
#pragma unroll
      for (int i = 0; i < KeyRun<Key>::kVecs; ++i)
        if (i < vecs) dst[i] = keys.q[i];
    }
  }
  if (staged) {
    __syncthreads();
    // the block's runs are threads 0 .. n - 1 and contiguous in the output
    const int64_t left = rows - row0 < tile.segs ? rows - row0 : tile.segs;
    const int in_row = tile.runs_per_row - run0 < tile.seg_runs ? tile.runs_per_row - run0
                                                                : tile.seg_runs;
    store_tile<Key>(s_out, out + row0 * w + static_cast<int64_t>(run0) * kRun,
                    static_cast<int>(left) * in_row * kRun, t);
  }
}

// The counting form: the dense path's keys.
template <typename Key>
__global__ void __launch_bounds__(kThreads)
encode_dense_kernel(const uint8_t* __restrict__ packed2,
                    const uint8_t* __restrict__ badbits, int64_t rows, int64_t p4,
                    int64_t p8, int k, int64_t w, Key* __restrict__ out) {
  encode_rows<Key, false>(packed2, badbits, rows, p4, p8, k, w, out, nullptr);
}

// The code form: encode_blocks' codes and poison bits.
template <typename Key>
__global__ void __launch_bounds__(kThreads)
encode_codes_kernel(const uint8_t* __restrict__ packed2,
                    const uint8_t* __restrict__ badbits, int64_t rows, int64_t p4,
                    int64_t p8, int k, int64_t w, Key* __restrict__ out,
                    uint32_t* __restrict__ poison) {
  encode_rows<Key, true>(packed2, badbits, rows, p4, p8, k, w, out, poison);
}

template <typename Key>
int launch(const void* packed2, const void* badbits, int64_t rows, int64_t p4,
           int64_t p8, int k, int64_t w, void* out, void* poison, void* stream) {
  if (rows > 0 && w > 0) {
    const DenseTile tile(w);
    const int64_t blocks = (rows + tile.segs - 1) / tile.segs * tile.col_tiles;
    const auto in2 = static_cast<const uint8_t*>(packed2);
    const auto in8 = static_cast<const uint8_t*>(badbits);
    const auto s = static_cast<cudaStream_t>(stream);
    if (poison == nullptr) {
      encode_dense_kernel<Key><<<static_cast<unsigned>(blocks), kThreads, tile.smem_bytes(),
                                 s>>>(in2, in8, rows, p4, p8, k, w, static_cast<Key*>(out));
    } else {
      encode_codes_kernel<Key><<<static_cast<unsigned>(blocks), kThreads, tile.smem_bytes(),
                                 s>>>(in2, in8, rows, p4, p8, k, w, static_cast<Key*>(out),
                                      static_cast<uint32_t*>(poison));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// packed2: rows x p4 bytes, p4 = ceil((w + k - 1) / 4); badbits: rows x p8
// bytes, p8 = ceil((w + k - 1) / 8); out: rows * w keys (int32 for k <= 16,
// int64 otherwise), 16-byte aligned; w % 4 == 0
KRUST_API int krust_encode_dense_i32(int device, const void* packed2,
                                     const void* badbits, int64_t rows,
                                     int64_t p4, int64_t p8, int k, int64_t w,
                                     void* out, void* stream) {
  const DeviceScope scope(device);
  if (scope.error()) return scope.error();
  return launch<int32_t>(packed2, badbits, rows, p4, p8, k, w, out, nullptr, stream);
}

KRUST_API int krust_encode_dense_i64(int device, const void* packed2,
                                     const void* badbits, int64_t rows,
                                     int64_t p4, int64_t p8, int k, int64_t w,
                                     void* out, void* stream) {
  const DeviceScope scope(device);
  if (scope.error()) return scope.error();
  return launch<int64_t>(packed2, badbits, rows, p4, p8, k, w, out, nullptr, stream);
}

// The code form, as above plus poison: rows * ceil(w / 32) uint32 words,
// bit r of word (row, run) set where window 32 run + r of the row holds a
// bad base or lies past w.
KRUST_API int krust_encode_codes_i32(int device, const void* packed2,
                                     const void* badbits, int64_t rows,
                                     int64_t p4, int64_t p8, int k, int64_t w,
                                     void* out, void* poison, void* stream) {
  const DeviceScope scope(device);
  if (scope.error()) return scope.error();
  return launch<int32_t>(packed2, badbits, rows, p4, p8, k, w, out, poison, stream);
}

KRUST_API int krust_encode_codes_i64(int device, const void* packed2,
                                     const void* badbits, int64_t rows,
                                     int64_t p4, int64_t p8, int k, int64_t w,
                                     void* out, void* poison, void* stream) {
  const DeviceScope scope(device);
  if (scope.error()) return scope.error();
  return launch<int64_t>(packed2, badbits, rows, p4, p8, k, w, out, poison, stream);
}
