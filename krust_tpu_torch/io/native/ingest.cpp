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

}  // namespace

extern "C" {

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
