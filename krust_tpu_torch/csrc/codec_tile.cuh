// The tile both codec kernels (K1 csrc/fused_codec.cu, K4 csrc/codec.cu)
// key: kThreads threads, a run of kRun = 32 consecutive windows each.
//
// A kernel brings a tile's packed bases and bad-base bits into shared
// memory in its own way and hands each thread the 64 bases from its run's
// first base as four big-endian words (16 bases each, first base in the top
// bits) and the 64 bad-base bits from the same base (bit i: base i is
// bad). From there the work is shared:
//   - window_poison: the run's 32 validity bits in log2(k) shift-or steps;
//   - Window<Key>::key: window r's canonical code in a constant handful of
//     operations (a funnel shift for the forward code, a bit reversal of
//     the complement with the bit pairs swapped back for the reverse
//     complement; 32-bit arithmetic for k <= 16), so no window waits on
//     another;
//   - key_run / stage_run / store_tile: the run's keys, staged in shared
//     memory (one pad vector per thread row, no bank conflicts) and written
//     out as coalesced 16-byte stores.
// K4's code form (krust_tpu's encode_blocks output) keys every window, a
// window that holds a bad base included, with krust_tpu's substitution: a
// bad base is code 0 on the forward strand and 0 on the complement strand
// too (not 3 - 0). substitute_run masks the run's forward and complement
// words once, and WindowCode<Key>::code / code_run key its windows from them
// with the same handful of operations as Window<Key>::key.
#pragma once

#include "common.cuh"

constexpr int kThreads = 128;
constexpr int kRun = 32;                // windows per thread
constexpr int kTile = kThreads * kRun;  // windows per block

// The top 32 bits of the base stream w[0..3] (big-endian words, 16 bases
// each) shifted left by r bases (r < 48): bases r .. r + 15.
__device__ __forceinline__ uint32_t bases_at(const uint32_t (&w)[4], int r) {
  return __funnelshift_l(w[r / 16 + 1], w[r / 16], 2 * (r % 16));
}

// Reverse of the 2-bit groups of a bit-reversed word: the bit pairs of
// __brev back in order.
__device__ __forceinline__ uint32_t swap_pairs(uint32_t y) {
  return ((y >> 1) & 0x55555555u) | ((y << 1) & 0xAAAAAAAAu);
}

__device__ __forceinline__ uint64_t swap_pairs(uint64_t y) {
  return ((y >> 1) & 0x5555555555555555ull) | ((y << 1) & 0xAAAAAAAAAAAAAAAAull);
}

// Canonical code of window r of the stream, biased, for k <= 16 (32-bit
// arithmetic) or k > 16: the forward code is the window's top bits, the
// reverse complement the complement of the window bit-reversed with its
// bit pairs swapped back, masked to 2k bits.
template <typename Key>
struct Window;

template <>
struct Window<int32_t> {
  static __device__ __forceinline__ int32_t key(const uint32_t (&w)[4], int r, int k) {
    const uint32_t x = bases_at(w, r);
    const uint32_t fwd = x >> (32 - 2 * k);
    const uint32_t mask = k == 16 ? ~0u : (1u << (2 * k)) - 1;
    const uint32_t rc = ~swap_pairs(__brev(x)) & mask;
    return KeyTraits<int32_t>::from_code(rc < fwd ? rc : fwd);
  }
};

template <>
struct Window<int64_t> {
  static __device__ __forceinline__ int64_t key(const uint32_t (&w)[4], int r, int k) {
    const uint64_t x = static_cast<uint64_t>(bases_at(w, r)) << 32 | bases_at(w, r + 16);
    const uint64_t fwd = x >> (64 - 2 * k);
    const uint64_t mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
    const uint64_t rc = ~swap_pairs(static_cast<uint64_t>(__brevll(x))) & mask;
    return KeyTraits<int64_t>::from_code(rc < fwd ? rc : fwd);
  }
};

// K4's code form: window r's canonical code, biased, from the run's
// substituted forward words fw and complement words cw (substitute_run):
// the forward code as Window<Key>::key takes it, the reverse complement the
// complement words bit-reversed with their bit pairs swapped back, masked
// to 2k bits (the complement is taken already, so no NOT).
template <typename Key>
struct WindowCode;

template <>
struct WindowCode<int32_t> {
  static __device__ __forceinline__ int32_t code(const uint32_t (&fw)[4],
                                                 const uint32_t (&cw)[4], int r, int k) {
    const uint32_t fwd = bases_at(fw, r) >> (32 - 2 * k);
    const uint32_t mask = k == 16 ? ~0u : (1u << (2 * k)) - 1;
    const uint32_t rc = swap_pairs(__brev(bases_at(cw, r))) & mask;
    return KeyTraits<int32_t>::from_code(rc < fwd ? rc : fwd);
  }
};

template <>
struct WindowCode<int64_t> {
  static __device__ __forceinline__ int64_t code(const uint32_t (&fw)[4],
                                                 const uint32_t (&cw)[4], int r, int k) {
    const uint64_t x = static_cast<uint64_t>(bases_at(fw, r)) << 32 | bases_at(fw, r + 16);
    const uint64_t c = static_cast<uint64_t>(bases_at(cw, r)) << 32 | bases_at(cw, r + 16);
    const uint64_t fwd = x >> (64 - 2 * k);
    const uint64_t mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
    const uint64_t rc = swap_pairs(static_cast<uint64_t>(__brevll(c))) & mask;
    return KeyTraits<int64_t>::from_code(rc < fwd ? rc : fwd);
  }
};

// The 16 bad bits b (bit j: base j) as a big-endian pair mask: both bits
// of base j's pair (bits 31 - 2j and 30 - 2j) set where it is bad. The bits
// spread to bit 2j, double to the pair, and __brev turns the word round.
__device__ __forceinline__ uint32_t pair_mask(uint32_t b) {
  b &= 0xFFFFu;
  b = (b | b << 8) & 0x00FF00FFu;
  b = (b | b << 4) & 0x0F0F0F0Fu;
  b = (b | b << 2) & 0x33333333u;
  b = (b | b << 1) & 0x55555555u;
  return __brev(b | b << 1);
}

// krust_tpu's substitution over a run's 64 bases w and their bad bits d
// (bit i: base i): the forward words with a bad base's pair cleared, and
// the complement words (~w) with it cleared too.
__device__ __forceinline__ void substitute_run(const uint32_t (&w)[4], uint64_t d,
                                               uint32_t (&fw)[4], uint32_t (&cw)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t good = ~pair_mask(static_cast<uint32_t>(d >> (16 * q)));
    fw[q] = w[q] & good;
    cw[q] = ~w[q] & good;
  }
}

// Bit r (r < 32): window r holds a bad base, from the bad-base bits d of
// the 64 bases from the run's first: the OR of bits [r, r + k), by doubling
// to the largest power of two len <= k.
__device__ __forceinline__ uint32_t window_poison(uint64_t d, int k) {
  int len = 1;
  for (; 2 * len <= k; len *= 2) d |= d >> len;
  return static_cast<uint32_t>(d | d >> (k - len));
}

// A run's keys in registers, as keys and as the 16-byte vectors they leave in.
template <typename Key>
struct KeyRun {
  static constexpr int kVec = 16 / sizeof(Key);  // keys per 16-byte vector
  static constexpr int kVecs = kRun / kVec;      // vectors per run
  // keys in a tile's stage: one pad vector after each thread's row
  static constexpr int kStage = kThreads * (kRun + kVec);
  union {
    int4 q[kVecs];
    Key key[kRun];
  };
};

// The keys of the run whose bases are w: the sentinel where poison has the
// window's bit.
template <typename Key>
__device__ __forceinline__ void key_run(const uint32_t (&w)[4], uint32_t poison, int k,
                                        KeyRun<Key>& keys) {
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    keys.key[r] = (poison >> r) & 1 ? KeyTraits<Key>::kSentinel : Window<Key>::key(w, r, k);
  }
}

// K4's code form: the codes of every window of the run, bad bases
// substituted (substitute_run), no sentinel.
template <typename Key>
__device__ __forceinline__ void code_run(const uint32_t (&fw)[4], const uint32_t (&cw)[4],
                                         int k, KeyRun<Key>& keys) {
#pragma unroll
  for (int r = 0; r < kRun; ++r) keys.key[r] = WindowCode<Key>::code(fw, cw, r, k);
}

// Thread t's run into its row of the stage.
template <typename Key>
__device__ __forceinline__ void stage_run(const KeyRun<Key>& keys, Key* s_out, int t) {
  int4* row = reinterpret_cast<int4*>(s_out) + t * (KeyRun<Key>::kVecs + 1);
#pragma unroll
  for (int v = 0; v < KeyRun<Key>::kVecs; ++v) row[v] = keys.q[v];
}

// The first `windows` keys of the stage (the runs of threads 0 ..
// windows / kRun, in order) to dst as coalesced 16-byte stores; dst is
// 16-byte aligned and windows a multiple of the vector's keys. Call after
// a __syncthreads() that follows the last stage_run.
template <typename Key>
__device__ __forceinline__ void store_tile(const Key* s_out, Key* dst, int windows, int t) {
  constexpr int kVec = KeyRun<Key>::kVec;
  constexpr int kVecs = KeyRun<Key>::kVecs;
  int4* out = reinterpret_cast<int4*>(dst);
  const int4* stage = reinterpret_cast<const int4*>(s_out);
  for (int v = t; v < windows / kVec; v += kThreads)
    out[v] = stage[v / kVecs * (kVecs + 1) + v % kVecs];
}
