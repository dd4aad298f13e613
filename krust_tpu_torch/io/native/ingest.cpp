// Range-parallel FASTA/FASTQ ingest for krust_tpu_torch.
//
// The same parse as krust_native.cpp's krust_parse_fasta / krust_parse_fastq
// (codes stream, separators, quality bytes with 0xFF pads, record and base
// counts, error codes; differentially tested), split over threads at line
// starts, optionally over a read-only mapping of the file itself:
//   pass 1: each range counts what it will emit (FASTQ: its lines and their
//           lengths by local line index mod 4, since a line's role depends on
//           its global index; FASTA: headers, bases, content before a header)
//   prefix: each range's first global line (FASTQ) or whether a header came
//           before it (FASTA), and its output offset
//   pass 2: each range validates and writes its own slice of the output.
// The earliest range's first error wins, which is the error the sequential
// parse meets first; FASTQ's line-count check comes after every line passed.
// A FASTQ quality stream is written only when out_qual is non-null; its
// lengths are checked either way.
//
// Beside the parse, the scan of the parsed code stream (krust_scan_pack), in
// two threaded passes over the same ranges: the first counts each range's
// invalid bases, which decides the route; the second writes every base's 2-bit
// byte and either each range's invalid positions at its offset (flat: their
// total fits the budget) or the invalid mask (dense; a dense scan that asks for
// no mask ends after the count). No range keeps a buffer of its own and no
// thread waits on another.

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <sys/mman.h>

namespace {

constexpr uint8_t kInvalid = 4;
constexpr uint8_t kQualPad = 0xFF;

enum : int32_t {
    kOk = 0,
    kContentBeforeHeader = 1,
    kBadLineCount = 2,
    kBadFastqHeader = 3,
    kBadFastqPlus = 4,
    kQualLenMismatch = 5,
};

struct Lut {
    uint8_t table[256];
    constexpr Lut() : table() {
        for (int i = 0; i < 256; ++i) table[i] = kInvalid;
        table['A'] = table['a'] = 0;
        table['C'] = table['c'] = 1;
        table['G'] = table['g'] = 2;
        table['T'] = table['t'] = 3;
    }
};
constexpr Lut kLut;

// End of the line starting at i within [i, b): the index of its '\n', or b.
inline int64_t line_end(const uint8_t* d, int64_t i, int64_t b) {
    const void* nl = std::memchr(d + i, '\n', static_cast<size_t>(b - i));
    return nl ? static_cast<const uint8_t*>(nl) - d : b;
}

// Cut [0, len) into at most n ranges, each starting at a line start.
std::vector<int64_t> cut_at_lines(const uint8_t* d, int64_t len, int n) {
    std::vector<int64_t> cuts{0};
    for (int t = 1; t < n; ++t) {
        const int64_t p = len * t / n;
        if (p <= cuts.back()) continue;
        const int64_t c = line_end(d, p - 1, len) + 1;  // d[p - 1] may be the '\n'
        if (c < len && c > cuts.back()) cuts.push_back(c);
    }
    cuts.push_back(len);
    return cuts;
}

template <class F>
void run_ranges(size_t n, F&& body) {
    if (n == 1) {
        body(0);
        return;
    }
    std::vector<std::thread> workers;
    workers.reserve(n);
    for (size_t r = 0; r < n; ++r) workers.emplace_back(body, r);
    for (auto& w : workers) w.join();
}

// ---- FASTQ -------------------------------------------------------------------

struct FastqRange {
    int64_t lines[4] = {0, 0, 0, 0};  // lines by local index mod 4
    int64_t bytes[4] = {0, 0, 0, 0};  // their lengths, '\r' stripped
    int64_t first_line = 0;           // global index of the range's first line
    int64_t out = 0;                  // output offset
    int32_t err = kOk;
};

// The line before the line start e, '\r' stripped: [*s, *e_out).
inline void line_before(const uint8_t* d, int64_t e, int64_t* s, int64_t* e_out) {
    int64_t end = e - 1;  // d[end] == '\n'
    const void* nl = end > 0 ? memrchr(d, '\n', static_cast<size_t>(end)) : nullptr;
    const int64_t start = nl ? static_cast<const uint8_t*>(nl) - d + 1 : 0;
    if (end > start && d[end - 1] == '\r') --end;
    *s = start;
    *e_out = end;
}

void fastq_count(const uint8_t* d, int64_t a, int64_t b, FastqRange* r) {
    int64_t j = 0;
    for (int64_t i = a; i < b; ++j) {
        const int64_t start = i;
        i = line_end(d, i, b);
        int64_t end = i;
        if (end > start && d[end - 1] == '\r') --end;
        if (i < b) ++i;
        r->lines[j & 3] += 1;
        r->bytes[j & 3] += end - start;
    }
}

void fastq_write(const uint8_t* d, int64_t a, int64_t b, FastqRange* r,
                 uint8_t* codes, uint8_t* qual) {
    int64_t g = r->first_line;
    int64_t out = r->out;
    int64_t seq_len = 0;
    if (a < b && (g & 3) >= 2) {  // this record's sequence line is in an earlier range
        int64_t s, e;
        line_before(d, a, &s, &e);
        if ((g & 3) == 3) line_before(d, s, &s, &e);
        seq_len = e - s;
    }
    for (int64_t i = a; i < b; ++g) {
        const int64_t start = i;
        i = line_end(d, i, b);
        int64_t end = i;
        if (end > start && d[end - 1] == '\r') --end;
        if (i < b) ++i;
        switch (g & 3) {
            case 0:
                if (end == start || d[start] != '@') {
                    r->err = kBadFastqHeader;
                    return;
                }
                if (g > 0) {
                    codes[out] = kInvalid;
                    if (qual) qual[out] = kQualPad;
                    ++out;
                }
                break;
            case 1:
                seq_len = end - start;
                for (int64_t j = start; j < end; ++j) codes[out++] = kLut.table[d[j]];
                break;
            case 2:
                if (end == start || d[start] != '+') {
                    r->err = kBadFastqPlus;
                    return;
                }
                break;
            default:
                if (end - start != seq_len) {
                    r->err = kQualLenMismatch;
                    return;
                }
                if (qual)
                    std::memcpy(qual + out - seq_len, d + start,
                                static_cast<size_t>(seq_len));
        }
    }
}

int32_t ingest_fastq(const uint8_t* d, int64_t len, int n_threads, uint8_t* codes,
                     uint8_t* qual, int64_t* out_len, int64_t* n_records,
                     int64_t* n_bases) {
    // strip exactly one final line terminator, as the sequential parse does
    if (len > 0 && d[len - 1] == '\n') {
        --len;
        if (len > 0 && d[len - 1] == '\r') --len;
    }
    const std::vector<int64_t> cuts = cut_at_lines(d, len, n_threads);
    const size_t n = cuts.size() - 1;
    std::vector<FastqRange> ranges(n);
    run_ranges(n, [&](size_t r) { fastq_count(d, cuts[r], cuts[r + 1], &ranges[r]); });

    int64_t line = 0, out = 0, records = 0, bases = 0;
    for (auto& r : ranges) {
        r.first_line = line;
        r.out = out;
        int64_t in_range = 0;
        for (int c = 0; c < 4; ++c) {
            const int phase = static_cast<int>((line + c) & 3);
            if (phase == 0) {
                records += r.lines[c];
                out += r.lines[c];  // a separator before every record but the first
            } else if (phase == 1) {
                bases += r.bytes[c];
                out += r.bytes[c];
            }
            in_range += r.lines[c];
        }
        if (line == 0 && in_range > 0) --out;
        line += in_range;
    }
    run_ranges(n, [&](size_t r) { fastq_write(d, cuts[r], cuts[r + 1], &ranges[r], codes, qual); });
    for (const auto& r : ranges)
        if (r.err != kOk) return r.err;
    if (line % 4 != 0) return kBadLineCount;
    *out_len = out;
    *n_records = records;
    *n_bases = bases;
    return kOk;
}

// ---- FASTA -------------------------------------------------------------------

struct FastaRange {
    int64_t headers = 0;
    int64_t bases = 0;
    bool content_first = false;  // content at a line start before the range's first header
    bool seen_before = false;    // a header in an earlier range
    int64_t out = 0;
};

// One pass of the sequential state machine over the line-aligned range
// [a, b): with codes null it only counts, else it writes from r->out.
void fasta_range(const uint8_t* d, int64_t a, int64_t b, FastaRange* r, uint8_t* codes) {
    bool seen = r->seen_before;
    int64_t out = r->out;
    for (int64_t i = a; i < b;) {
        const int64_t end = line_end(d, i, b);
        if (d[i] == '>') {
            if (codes) {
                if (seen) codes[out++] = kInvalid;
            } else {
                ++r->headers;
            }
            seen = true;
        } else {
            if (!seen && d[i] != '\n' && d[i] != '\r') r->content_first = true;
            if (codes) {
                for (int64_t j = i; j < end; ++j)
                    if (d[j] != '\r') codes[out++] = kLut.table[d[j]];
            } else {
                int64_t cr = 0;
                for (int64_t j = i; j < end; ++j) cr += d[j] == '\r';
                r->bases += end - i - cr;
            }
        }
        i = end < b ? end + 1 : b;
    }
}

int32_t ingest_fasta(const uint8_t* d, int64_t len, int n_threads, uint8_t* codes,
                     int64_t* out_len, int64_t* n_records, int64_t* n_bases) {
    const std::vector<int64_t> cuts = cut_at_lines(d, len, n_threads);
    const size_t n = cuts.size() - 1;
    std::vector<FastaRange> ranges(n);
    run_ranges(n, [&](size_t r) { fasta_range(d, cuts[r], cuts[r + 1], &ranges[r], nullptr); });

    int64_t out = 0, records = 0, bases = 0;
    for (auto& r : ranges) {
        if (records == 0 && r.content_first) return kContentBeforeHeader;
        r.seen_before = records > 0;
        r.out = out;
        out += r.bases + r.headers - (records == 0 && r.headers > 0 ? 1 : 0);
        records += r.headers;
        bases += r.bases;
    }
    run_ranges(n, [&](size_t r) { fasta_range(d, cuts[r], cuts[r + 1], &ranges[r], codes); });
    *out_len = out;
    *n_records = records;
    *n_bases = bases;
    return kOk;
}

int32_t ingest(const uint8_t* d, int64_t len, int32_t fastq, int32_t threads,
               uint8_t* codes, uint8_t* qual, int64_t* out_len, int64_t* n_records,
               int64_t* n_bases) {
    const int n = threads < 1 ? 1 : threads;
    return fastq ? ingest_fastq(d, len, n, codes, qual, out_len, n_records, n_bases)
                 : ingest_fasta(d, len, n, codes, out_len, n_records, n_bases);
}

// ---- the code stream's scan and 2-bit pack -------------------------------------

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__, "the 8-base loads assume it");

// Invalid mask of the 8 codes in x (byte j = base j): bit 7 - j set when
// code j is past 3.
inline uint8_t code_mask(uint64_t x) {
    const uint64_t hi = x & 0xFCFCFCFCFCFCFCFCull;  // a byte's bits past the 2-bit code
    const uint64_t nz = (((hi & 0x7F7F7F7F7F7F7F7Full) + 0x7F7F7F7F7F7F7F7Full) | hi) &
                        0x8080808080808080ull;  // bit 7 of each byte with any of them
    return static_cast<uint8_t>(((nz >> 7) * 0x8040201008040201ull) >> 56);
}

// The 2-bit byte of the 4 codes in the low 32 bits of y (each masked to 2
// bits): the first base in the high 2 bits.
inline uint8_t pack4(uint64_t y) {
    return static_cast<uint8_t>((((y & 0xFFFFFFFFull) * 0x40100401ull) >> 24) & 0xFF);
}

template <bool kQual>
inline uint8_t group_mask(const uint8_t* codes, const uint8_t* qual, int32_t thr, int64_t g,
                          uint64_t* x) {
    std::memcpy(x, codes + 8 * g, 8);
    uint8_t m = code_mask(*x);
    if (kQual) {
        const uint8_t* q = qual + 8 * g;
        for (int j = 0; j < 8; ++j) m |= static_cast<uint8_t>((q[j] < thr) << (7 - j));
    }
    return m;
}

// Invalid bases of groups [g0, g1) of 8 bases.
template <bool kQual>
int64_t count_groups(const uint8_t* codes, const uint8_t* qual, int32_t thr, int64_t g0,
                     int64_t g1) {
    int64_t count = 0;
    uint64_t x;
    for (int64_t g = g0; g < g1; ++g)
        count += __builtin_popcount(group_mask<kQual>(codes, qual, thr, g, &x));
    return count;
}

// Groups [g0, g1) of 8 bases: the 2-bit bytes, and the invalid positions from
// pos on (kPos) or the invalid mask; returns the invalid bases.
template <bool kPos, bool kQual>
int64_t pack_groups(const uint8_t* codes, const uint8_t* qual, int32_t thr, int64_t g0,
                    int64_t g1, uint8_t* packed2, uint8_t* badbits, int64_t* pos) {
    int64_t count = 0;
    uint64_t x;
    for (int64_t g = g0; g < g1; ++g) {
        const uint8_t m = group_mask<kQual>(codes, qual, thr, g, &x);
        const uint64_t y = x & 0x0303030303030303ull;
        packed2[2 * g] = pack4(y);
        packed2[2 * g + 1] = pack4(y >> 32);
        if (!kPos) badbits[g] = m;
        if (m) {
            count += __builtin_popcount(m);
            if (kPos)
                for (int j = 0; j < 8; ++j)
                    if (m & (0x80 >> j)) *pos++ = 8 * g + j;
        }
    }
    return count;
}

// Groups [g0, g1): without packed2 the count alone, else the pack with the
// positions (pos non-null) or the mask.
template <bool kQual>
int64_t pack_range(const uint8_t* codes, const uint8_t* qual, int32_t thr, int64_t g0,
                   int64_t g1, uint8_t* packed2, uint8_t* badbits, int64_t* pos) {
    if (!packed2) return count_groups<kQual>(codes, qual, thr, g0, g1);
    if (pos) return pack_groups<true, kQual>(codes, qual, thr, g0, g1, packed2, badbits, pos);
    return pack_groups<false, kQual>(codes, qual, thr, g0, g1, packed2, badbits, pos);
}

// The last n % 8 bases (from group `groups` on): 2-bit bytes zero-padded,
// mask bits past n set, positions from pos on; returns the invalid bases.
int64_t pack_tail(const uint8_t* codes, int64_t n, const uint8_t* qual, int32_t thr,
                  int64_t groups, uint8_t* packed2, uint8_t* badbits, int64_t* pos) {
    const int64_t t0 = groups * 8;
    if (n == t0) return 0;
    if (packed2)
        for (int64_t b = 2 * groups; b < (n + 3) / 4; ++b) packed2[b] = 0;
    int64_t count = 0;
    uint8_t m = 0;
    for (int64_t i = t0; i < n; ++i) {
        const bool bad = codes[i] > 3 || (qual && qual[i] < thr);
        if (packed2) packed2[i / 4] |= static_cast<uint8_t>((codes[i] & 3) << (6 - 2 * (i % 4)));
        m |= static_cast<uint8_t>(bad << (7 - (i - t0)));
        if (bad) {
            ++count;
            if (pos) *pos++ = i;
        }
    }
    if (badbits) badbits[groups] = m | static_cast<uint8_t>(0xFF >> (n - t0));
    return count;
}

int64_t scan_pack(const uint8_t* codes, int64_t n, const uint8_t* qual, int32_t thr,
                  int32_t threads, uint8_t* packed2, int64_t packed_len, int64_t* invpos,
                  int64_t max_inv, uint8_t* badbits, int64_t bad_len) {
    const int64_t groups = n / 8;
    const int64_t nt = std::max(1, std::min(threads, 64));
    const int64_t per = (groups + nt - 1) / nt;
    std::vector<int64_t> counts(nt + 1, 0);  // invalid bases a range; the last: the tail

    // One pass over every range and the tail: what the non-null outputs ask
    // for, range t's positions from invpos + at[t].
    auto pass = [&](uint8_t* p2, uint8_t* bb, const int64_t* at) {
        run_ranges(static_cast<size_t>(nt), [&](size_t t) {
            const int64_t g0 = std::min(static_cast<int64_t>(t) * per, groups);
            const int64_t g1 = std::min(g0 + per, groups);
            int64_t* pos = at ? invpos + at[t] : nullptr;
            counts[t] = qual ? pack_range<true>(codes, qual, thr, g0, g1, p2, bb, pos)
                             : pack_range<false>(codes, qual, thr, g0, g1, p2, bb, pos);
        });
        counts[nt] = pack_tail(codes, n, qual, thr, groups, p2, bb,
                               at ? invpos + at[nt] : nullptr);
    };

    auto total = [&] {
        int64_t count = 0;
        for (const int64_t c : counts) count += c;
        return count;
    };

    std::vector<int64_t> at;  // each range's offset into invpos, when the route is flat
    if (max_inv >= 0) {
        pass(nullptr, nullptr, nullptr);
        at.assign(nt + 2, 0);
        for (int64_t t = 0; t <= nt; ++t) at[t + 1] = at[t] + counts[t];
        if (at[nt + 1] > max_inv) at.clear();
    }
    if (at.empty() && !badbits) return total();  // dense, and no mask asked for
    uint8_t* bb = at.empty() ? badbits : nullptr;
    pass(packed2, bb, at.empty() ? nullptr : at.data());
    if (packed_len > (n + 3) / 4)
        std::memset(packed2 + (n + 3) / 4, 0, static_cast<size_t>(packed_len - (n + 3) / 4));
    if (bb && bad_len > (n + 7) / 8)
        std::memset(bb + (n + 7) / 8, 0xFF, static_cast<size_t>(bad_len - (n + 7) / 8));
    return total();
}

}  // namespace

extern "C" {

// Scan the code stream codes[0, n) (0..3 a base, past 3 invalid; a base is
// also invalid where qual is non-null and qual[i] < thr) on up to `threads`
// threads, in 8-base groups split evenly between them. Returns the exact
// count of invalid bases. With max_inv >= 0 a counting pass comes first, and
// when the count is at most max_inv (the flat route) the pass that packs
// writes the positions; otherwise it writes the mask, or, with badbits null,
// it does not run and no output is written:
//   packed2: ceil(n/4) 2-bit bytes (first base in the high bits, an invalid
//            base as its code & 3, the last byte zero-padded), then zeros up
//            to packed_len;
//   invpos:  the invalid positions, ascending (capacity max_inv);
//   badbits: ceil(n/8) mask bytes (bit 7 the first base; set: invalid, and
//            past n), then 0xFF up to bad_len; required with max_inv < 0.
int64_t krust_scan_pack(const uint8_t* codes, int64_t n, const uint8_t* qual, int32_t thr,
                        int32_t threads, uint8_t* packed2, int64_t packed_len,
                        int64_t* invpos, int64_t max_inv, uint8_t* badbits,
                        int64_t bad_len) {
    return scan_pack(codes, n, qual, thr, threads, packed2, packed_len, invpos, max_inv,
                     badbits, bad_len);
}

// Parse len bytes at data (fastq: FASTQ, else FASTA) on up to `threads`
// threads. codes (and qual, when non-null) hold at least len bytes. Returns
// 0 or krust_native.cpp's error code.
int32_t krust_ingest(const uint8_t* data, int64_t len, int32_t fastq, int32_t threads,
                     uint8_t* codes, uint8_t* qual, int64_t* out_len, int64_t* n_records,
                     int64_t* n_bases) {
    return ingest(data, len, fastq, threads, codes, qual, out_len, n_records, n_bases);
}

// The same over the first `size` bytes of the open file fd, mapped read-only
// for the call and unmapped before it returns. -errno when the map fails.
int32_t krust_ingest_fd(int32_t fd, int64_t size, int32_t fastq, int32_t threads,
                        uint8_t* codes, uint8_t* qual, int64_t* out_len,
                        int64_t* n_records, int64_t* n_bases) {
    int flags = MAP_PRIVATE;
#ifdef MAP_POPULATE
    flags |= MAP_POPULATE;
#endif
    void* m = mmap(nullptr, static_cast<size_t>(size), PROT_READ, flags, fd, 0);
    if (m == MAP_FAILED) return -errno;
    const int32_t status = ingest(static_cast<const uint8_t*>(m), size, fastq, threads,
                                  codes, qual, out_len, n_records, n_bases);
    munmap(m, static_cast<size_t>(size));
    return status;
}

}  // extern "C"
