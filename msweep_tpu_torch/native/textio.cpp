// Fast bulk text formatting/parsing for the likelihood and probs files.
//
// The reference streams these through C++ ostream/getline
// (include/Likelihood.hpp:224-311, src/Sample.cpp:63-85); at its own
// benchmark scale (~2.3M ECs x hundreds of groups) per-value Python
// formatting dominates wall time, so the block formatter/parser is native:
// OpenMP rows-in-parallel snprintf("%.6g") — the same formatting C++
// default ostream precision produces — and strtod parsing.
//
// Exposed via ctypes from msweep_tpu_torch.native (numpy fallbacks remain).

#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Worst-case "%.6g" of a double: "-1.23457e-308" = 13 chars.
constexpr int64_t kValWidth = 14;   // + separator
constexpr int64_t kLeadWidth = 22;  // int64 + separator

inline char* fmt_val(char* p, double v) {
    int n = snprintf(p, kValWidth + 1, "%.6g", v);
    return p + (n > 0 ? n : 0);
}

}  // namespace

extern "C" {

// Format nrows x ncols doubles as text rows into `out` (capacity `cap`).
//
//   pair_mode=0: [lead\t] v<TAB>v<TAB>... [<TAB>0 x n_zero_cols] \n
//                (the _likelihoods.tsv / _probs.tsv row shape)
//   pair_mode=1: "1 v1 2 v2 ... ncols vncols\n" space-separated 1-based
//                (id, value) pairs, newline-terminated, no lead/zero
//                columns (the BitSeq per-EC alignment body)
//
// `lead` (nullable) supplies a leading int64 column (EC count or ec_id).
// Returns bytes written, or -1 when `cap` would overflow (caller grows).
int64_t msweep_format_block(const double* mat, int64_t nrows, int64_t ncols,
                            const int64_t* lead, int64_t n_zero_cols,
                            int pair_mode, char* out, int64_t cap) {
    if (nrows == 0) return 0;
    const int64_t stride =
        kLeadWidth + ncols * (pair_mode ? kValWidth + 12 : kValWidth) +
        n_zero_cols * 2 + 2;
    if (nrows * stride <= 0) return -1;
    char* scratch = (char*)malloc((size_t)(nrows * stride));
    int64_t* lens = (int64_t*)malloc((size_t)nrows * sizeof(int64_t));
    if (!scratch || !lens) {
        free(scratch);
        free(lens);
        return -1;
    }

#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < nrows; ++r) {
        char* p = scratch + r * stride;
        const char* row_start = p;
        const double* row = mat + r * ncols;
        if (pair_mode) {
            for (int64_t c = 0; c < ncols; ++c) {
                if (c) *p++ = ' ';
                p += snprintf(p, kLeadWidth, "%" PRId64 " ", c + 1);
                p = fmt_val(p, row[c]);
            }
            *p++ = '\n';  // row separator; the caller splits lines
        } else {
            if (lead) {
                p += snprintf(p, kLeadWidth, "%" PRId64, lead[r]);
                *p++ = '\t';
            }
            for (int64_t c = 0; c < ncols; ++c) {
                if (c) *p++ = '\t';
                p = fmt_val(p, row[c]);
            }
            for (int64_t z = 0; z < n_zero_cols; ++z) {
                *p++ = '\t';
                *p++ = '0';
            }
            *p++ = '\n';
        }
        lens[r] = p - row_start;
    }

    int64_t total = 0;
    for (int64_t r = 0; r < nrows; ++r) {
        if (total + lens[r] > cap) {
            free(scratch);
            free(lens);
            return -1;
        }
        memcpy(out + total, scratch + r * stride, (size_t)lens[r]);
        total += lens[r];
    }
    free(scratch);
    free(lens);
    return total;
}

// Parse rows of `int64 \t double x ncols` (the --read-likelihood format,
// include/Likelihood.hpp:224-253).  Rows split at '\n'; a trailing
// unterminated row counts.  Returns the number of rows parsed, or
// -(row_index+1) when a row does not have exactly ncols+1 fields.
int64_t msweep_parse_ll(const char* buf, int64_t n, int64_t ncols,
                        int64_t* counts, double* out, int64_t max_rows) {
    // Chunk at line boundaries, count lines per chunk, then parse in
    // parallel with per-chunk row offsets.
    int n_chunks = 1;
#ifdef _OPENMP
    n_chunks = omp_get_max_threads();
#endif
    if (n_chunks < 1) n_chunks = 1;
    if (n_chunks > 64) n_chunks = 64;

    int64_t* starts = (int64_t*)malloc((size_t)(n_chunks + 1) * sizeof(int64_t));
    int64_t* rows_in = (int64_t*)malloc((size_t)(n_chunks + 1) * sizeof(int64_t));
    if (!starts || !rows_in) {
        free(starts);
        free(rows_in);
        return INT64_MIN;  // internal failure, distinct from row errors
    }
    starts[0] = 0;
    for (int c = 1; c < n_chunks; ++c) {
        int64_t pos = n * c / n_chunks;
        while (pos < n && buf[pos] != '\n') ++pos;
        if (pos < n) ++pos;
        starts[c] = pos;
    }
    starts[n_chunks] = n;

#pragma omp parallel for schedule(static)
    for (int c = 0; c < n_chunks; ++c) {
        int64_t rows = 0;
        const char* p = buf + starts[c];
        const char* end = buf + starts[c + 1];
        while (p < end) {
            const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
            if (!nl) {  // trailing unterminated row
                if (nl == p) break;
                ++rows;
                break;
            }
            if (nl > p) ++rows;  // skip empty lines (trailing newline)
            p = nl + 1;
        }
        rows_in[c] = rows;
    }
    int64_t total_rows = 0;
    for (int c = 0; c < n_chunks; ++c) {
        int64_t r = rows_in[c];
        rows_in[c] = total_rows;  // exclusive prefix = first row of chunk
        total_rows += r;
    }
    if (total_rows > max_rows) {
        free(starts);
        free(rows_in);
        return INT64_MIN;
    }

    int64_t err = 0;  // 0 = ok; else -(row+1)
#pragma omp parallel for schedule(static)
    for (int c = 0; c < n_chunks; ++c) {
        int64_t row = rows_in[c];
        const char* p = buf + starts[c];
        const char* end = buf + starts[c + 1];
        while (p < end) {
            const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
            const char* line_end = nl ? nl : end;
            if (line_end > p) {
                char* q = (char*)p;
                // leading count column
                int64_t cnt = strtoll(q, &q, 10);
                counts[row] = cnt;
                int64_t got = 0;
                double* orow = out + row * ncols;
                while (q < line_end) {
                    if (*q == '\t' || *q == ' ' || *q == '\r') {
                        ++q;
                        continue;
                    }
                    char* next;
                    double v = strtod(q, &next);
                    if (next == q) break;  // non-numeric
                    if (got < ncols) orow[got] = v;
                    ++got;
                    q = next;
                }
                if (got != ncols) {
                    int64_t e = -(row + 1);
#pragma omp critical
                    {
                        if (err == 0 || e > err) err = e;  // smallest row
                    }
                }
                ++row;
            }
            if (!nl) break;
            p = nl + 1;
        }
    }
    free(starts);
    free(rows_in);
    return err != 0 ? err : total_rows;
}

}  // extern "C"
