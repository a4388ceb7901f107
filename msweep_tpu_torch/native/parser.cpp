// Fast Themisto plaintext tokenizer (host-side hot path).
//
// The reference spends real time in plaintext parsing
// (ReadPlaintextAlignment, include/mSWEEP_alignment.hpp:68-94, noted as a
// hot loop in SURVEY.md section 4.1); this is the equivalent native component
// for msweep-tpu: an OpenMP-chunked integer scanner that turns the whole
// buffer into flat (read_id, target_id) pair arrays consumed by the
// numpy/JAX pipeline. Exposed to Python via ctypes (no pybind11 in this
// environment).
//
// Contract (matches io/themisto.py::parse_plaintext_pairs):
//   line := read_id (' ' target_id)*
//   pairs emitted in file order; n_lines counts newline-terminated plus a
//   trailing partial line.

#include <cstdint>
#include <cstddef>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct ChunkResult {
    int64_t n_pairs = 0;
    int64_t n_lines = 0;
};

// Scan [begin, end) where begin is at a line start and end is at a line
// start (or buffer end). If out arrays are null, only count.
ChunkResult scan(const char* buf, int64_t begin, int64_t end,
                 uint64_t* reads, uint64_t* tgts, int64_t out_off) {
    ChunkResult res;
    int64_t i = begin;
    while (i < end) {
        // parse read id
        uint64_t read_id = 0;
        bool any_digit = false;
        while (i < end && buf[i] >= '0' && buf[i] <= '9') {
            read_id = read_id * 10 + (uint64_t)(buf[i] - '0');
            ++i;
            any_digit = true;
        }
        if (!any_digit && i < end && buf[i] != '\n' && buf[i] != '\r') {
            return {-1, -1};  // non-numeric garbage -> caller raises
        }
        // parse targets until newline
        while (i < end && buf[i] != '\n') {
            if (buf[i] == ' ' || buf[i] == '\t' || buf[i] == '\r') {
                ++i;
                continue;
            }
            uint64_t t = 0;
            bool dig = false;
            while (i < end && buf[i] >= '0' && buf[i] <= '9') {
                t = t * 10 + (uint64_t)(buf[i] - '0');
                ++i;
                dig = true;
            }
            if (!dig) return {-1, -1};
            if (reads) {
                reads[out_off + res.n_pairs] = read_id;
                tgts[out_off + res.n_pairs] = t;
            }
            ++res.n_pairs;
        }
        if (i < end && buf[i] == '\n') ++i;
        ++res.n_lines;
    }
    return res;
}

std::vector<int64_t> chunk_starts(const char* buf, int64_t n, int n_chunks) {
    std::vector<int64_t> starts;
    starts.push_back(0);
    for (int c = 1; c < n_chunks; ++c) {
        int64_t pos = n * c / n_chunks;
        while (pos < n && buf[pos] != '\n') ++pos;
        if (pos < n) ++pos;  // start of next line
        starts.push_back(pos);
    }
    starts.push_back(n);
    return starts;
}

}  // namespace

extern "C" {

// Host-parallelism control: the CLI's -t flag reaches OpenMP here exactly
// like the reference's omp_set_num_threads (src/mSWEEP.cpp:254-256).
void msweep_set_threads(int n) {
#ifdef _OPENMP
    if (n > 0) omp_set_num_threads(n);
#else
    (void)n;
#endif
}

// Pass 1: count pairs and lines. Returns 0 on success, -1 on parse error.
// pair_counts/line_counts must have room for n_chunks entries.
int msweep_count(const char* buf, int64_t n, int n_chunks,
                 int64_t* pair_counts, int64_t* line_counts) {
    auto starts = chunk_starts(buf, n, n_chunks);
    int err = 0;
#pragma omp parallel for schedule(static)
    for (int c = 0; c < n_chunks; ++c) {
        ChunkResult r = scan(buf, starts[c], starts[c + 1], nullptr, nullptr, 0);
        if (r.n_pairs < 0) {
#pragma omp atomic write
            err = -1;
        }
        pair_counts[c] = r.n_pairs;
        line_counts[c] = r.n_lines;
    }
    return err;
}

// Pass 2: fill the pair arrays using exclusive-prefix offsets computed by
// the caller from pass 1's pair_counts.
int msweep_fill(const char* buf, int64_t n, int n_chunks,
                const int64_t* offsets, uint64_t* reads, uint64_t* tgts) {
    auto starts = chunk_starts(buf, n, n_chunks);
    int err = 0;
#pragma omp parallel for schedule(static)
    for (int c = 0; c < n_chunks; ++c) {
        ChunkResult r = scan(buf, starts[c], starts[c + 1], reads, tgts, offsets[c]);
        if (r.n_pairs < 0) {
#pragma omp atomic write
            err = -1;
        }
    }
    return err;
}

// Linear intersection of two sorted unique uint64 arrays (the paired-end
// AND-merge, include/mSWEEP_alignment.hpp:126-129). Returns output count.
int64_t msweep_intersect(const uint64_t* a, int64_t na,
                         const uint64_t* b, int64_t nb, uint64_t* out) {
    int64_t i = 0, j = 0, k = 0;
    while (i < na && j < nb) {
        uint64_t x = a[i], y = b[j];
        if (x == y) { out[k++] = x; ++i; ++j; }
        else if (x < y) ++i;
        else ++j;
    }
    return k;
}

// Linear union of two sorted unique uint64 arrays (the OR-merge).
int64_t msweep_union(const uint64_t* a, int64_t na,
                     const uint64_t* b, int64_t nb, uint64_t* out) {
    int64_t i = 0, j = 0, k = 0;
    while (i < na && j < nb) {
        uint64_t x = a[i], y = b[j];
        if (x == y) { out[k++] = x; ++i; ++j; }
        else if (x < y) { out[k++] = x; ++i; }
        else { out[k++] = y; ++j; }
    }
    while (i < na) out[k++] = a[i++];
    while (j < nb) out[k++] = b[j++];
    return k;
}

// One linear pass over sorted (read << shift | target) keys: per-read run
// starts, lengths and the reference's chained pattern hash
// (include/mSWEEP_alignment.hpp:150-155).  `shift` is the power-of-two
// key radix exponent (io.themisto.key_radix).  Outputs are sized for the
// worst case (one read per key); returns the number of aligned reads.
int64_t msweep_hash_runs(const uint64_t* keys, int64_t n, uint64_t shift,
                         uint64_t* reads, int64_t* starts, int64_t* counts,
                         uint64_t* hashes) {
    const uint64_t MIX = 0x517cc1b727220a95ULL;
    const uint64_t mask = (1ULL << shift) - 1;
    int64_t nr = -1;
    uint64_t prev_read = ~0ULL;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t r = keys[i] >> shift;
        uint64_t t = keys[i] & mask;
        if (r != prev_read) {
            ++nr;
            reads[nr] = r;
            starts[nr] = i;
            counts[nr] = 0;
            hashes[nr] = 0;
            prev_read = r;
        }
        ++counts[nr];
        uint64_t h = hashes[nr];
        hashes[nr] = h ^ (t + MIX + (h << 6) + (h >> 2));
    }
    return nr + 1;
}

}  // extern "C"
