// Native CSV scanner/parser for heat_tpu_torch's IO layer (a copy of
// heat_tpu/native/fastcsv.cpp: the port keeps its own source).
//
// The reference's load_csv (reference heat/core/io.py:665-885) partitions
// the file into per-rank byte ranges with a line-boundary fixup rule: a
// rank owns every line whose first byte falls inside its range.  Here the
// same partitioning runs across threads of the single IO controller: pass
// 1 counts rows per range (memchr over the mapped file), a prefix sum
// yields each range's output offset, pass 2 parses values with strtod
// straight into the caller-provided buffer.  Exposed as plain C symbols
// for ctypes.
//
// Error contract: functions return 0 on success, negative codes otherwise
// (-1 open/map failure, -2 inconsistent column count, -3 bad args).

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;
    bool ok() const { return data != nullptr; }  // empty files get data=(1)
};

Mapped map_file(const char* path) {
    Mapped m;
    m.fd = ::open(path, O_RDONLY);
    if (m.fd < 0) return m;
    struct stat st;
    if (fstat(m.fd, &st) != 0) { ::close(m.fd); m.fd = -1; return m; }
    m.size = static_cast<size_t>(st.st_size);
    if (m.size == 0) { m.data = reinterpret_cast<const char*>(1); return m; }
    void* p = mmap(nullptr, m.size, PROT_READ, MAP_PRIVATE, m.fd, 0);
    if (p == MAP_FAILED) { ::close(m.fd); m.fd = -1; return m; }
    m.data = static_cast<const char*>(p);
    return m;
}

void unmap(Mapped& m) {
    if (m.data && m.size) munmap(const_cast<char*>(static_cast<const char*>(m.data)), m.size);
    if (m.fd >= 0) ::close(m.fd);
}

// Start of the line following `skip` newlines from the file start.
size_t skip_lines(const char* d, size_t n, int64_t skip) {
    size_t pos = 0;
    while (skip-- > 0 && pos < n) {
        const char* nl = static_cast<const char*>(memchr(d + pos, '\n', n - pos));
        if (!nl) return n;
        pos = static_cast<size_t>(nl - d) + 1;
    }
    return pos;
}

// A line is blank (skipped, genfromtxt semantics) iff every character is
// whitespace AND none of them is the separator — with a whitespace sep
// (tab/space) a separators-only line is a real row of empty fields.
bool is_blank(const char* d, size_t pos, size_t line_end, char sep) {
    for (size_t i = pos; i < line_end; ++i) {
        if (d[i] == sep || !isspace(static_cast<unsigned char>(d[i]))) return false;
    }
    return true;
}

// Number of data rows in [start, end).  Also the line-boundary rule:
// caller passes range-aligned offsets.
int64_t count_rows(const char* d, size_t start, size_t end, char sep) {
    int64_t rows = 0;
    size_t pos = start;
    while (pos < end) {
        const char* nl = static_cast<const char*>(memchr(d + pos, '\n', end - pos));
        size_t line_end = nl ? static_cast<size_t>(nl - d) : end;
        if (!is_blank(d, pos, line_end, sep)) ++rows;
        pos = line_end + 1;
    }
    return rows;
}

// Parse one field [p, field_end).  When the field is followed by a real
// character (sep or newline) strtod can run on the mapped bytes directly —
// it stops at the terminator, no copy, no length limit.  Only the final
// field of a file with no trailing newline needs a bounded copy (the
// mapping may end exactly at a page boundary).
double parse_field(const char* d, size_t p, size_t field_end, bool at_map_end) {
    if (p == field_end) return __builtin_nan("");
    if (!at_map_end) {
        // strtod skips leading whitespace without bound — on an
        // all-whitespace field it would run past the terminator (and past
        // the mapping on a page-aligned file).  Resolve such fields to NaN
        // here so strtod always starts inside the field.
        size_t q = p;
        while (q < field_end && isspace(static_cast<unsigned char>(d[q]))) ++q;
        if (q == field_end) return __builtin_nan("");
        char* endp = nullptr;
        double v = strtod(d + p, &endp);
        size_t stop = static_cast<size_t>(endp - d);
        if (endp == d + p || stop > field_end) return __builtin_nan("");
        while (stop < field_end && isspace(static_cast<unsigned char>(d[stop]))) ++stop;
        return stop == field_end ? v : __builtin_nan("");
    }
    std::string buf(d + p, field_end - p);
    char* endp = nullptr;
    double v = strtod(buf.c_str(), &endp);
    if (endp == buf.c_str()) return __builtin_nan("");
    while (*endp && isspace(static_cast<unsigned char>(*endp))) ++endp;
    return *endp == '\0' ? v : __builtin_nan("");
}

// Parse rows of `cols` sep-separated doubles from [start, end) into out.
// Empty/unparseable fields become NaN (genfromtxt semantics).  `map_end` is
// the mapped-file size, so the final field of a file with no trailing
// newline takes the bounded-copy path in parse_field.  Returns rows parsed,
// or -2 on a column-count mismatch.
int64_t parse_rows(const char* d, size_t start, size_t end, char sep,
                   int64_t cols, double* out, size_t map_end) {
    int64_t row = 0;
    size_t pos = start;
    while (pos < end) {
        const char* nl = static_cast<const char*>(memchr(d + pos, '\n', end - pos));
        size_t line_end = nl ? static_cast<size_t>(nl - d) : end;
        if (!is_blank(d, pos, line_end, sep)) {
            // field count must match exactly (genfromtxt raises on ragged)
            int64_t nsep = 0;
            for (size_t i = pos; i < line_end; ++i)
                if (d[i] == sep) ++nsep;
            if (nsep != cols - 1) return -2;
            double* dst = out + row * cols;
            size_t p = pos;
            for (int64_t c = 0; c < cols; ++c) {
                size_t field_end = line_end;
                if (c + 1 < cols) {
                    const char* s = static_cast<const char*>(
                        memchr(d + p, sep, line_end - p));
                    field_end = static_cast<size_t>(s - d);
                }
                dst[c] = parse_field(d, p, field_end, field_end == map_end);
                p = field_end + 1;
            }
            ++row;
        }
        pos = line_end + 1;
    }
    return row;
}

// Align `pos` forward to the first byte after the next newline at/after it
// (the ownership rule: a range owns lines that *start* inside it).
size_t align_to_line(const char* d, size_t pos, size_t n) {
    if (pos == 0) return 0;
    const char* nl = static_cast<const char*>(memchr(d + pos - 1, '\n', n - (pos - 1)));
    return nl ? static_cast<size_t>(nl - d) + 1 : n;
}

}  // namespace

extern "C" {

// Scan: rows (non-blank data lines after the header) and columns (from the
// first data line).  Returns 0 / negative error.
int64_t fcsv_scan(const char* path, int64_t header_lines, char sep,
                  int64_t* out_rows, int64_t* out_cols) {
    if (!path || !out_rows || !out_cols) return -3;
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    size_t start = skip_lines(m.data, m.size, header_lines);
    *out_rows = count_rows(m.data, start, m.size, sep);
    *out_cols = 0;
    // columns from the first non-blank line
    size_t pos = start;
    while (pos < m.size) {
        const char* nl = static_cast<const char*>(memchr(m.data + pos, '\n', m.size - pos));
        size_t line_end = nl ? static_cast<size_t>(nl - m.data) : m.size;
        if (!is_blank(m.data, pos, line_end, sep)) {
            int64_t cols = 1;
            for (size_t i = pos; i < line_end; ++i)
                if (m.data[i] == sep) ++cols;
            *out_cols = cols;
            break;
        }
        pos = line_end + 1;
    }
    unmap(m);
    return 0;
}

// Parse the whole file into out (rows*cols doubles), threaded over byte
// ranges.  Returns 0 / negative error.
int64_t fcsv_parse(const char* path, int64_t header_lines, char sep,
                   int64_t rows, int64_t cols, double* out, int64_t nthreads) {
    if (!path || !out || rows < 0 || cols <= 0) return -3;
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    size_t start = skip_lines(m.data, m.size, header_lines);
    size_t span = m.size - start;

    int64_t T = nthreads > 0 ? nthreads : static_cast<int64_t>(
        std::thread::hardware_concurrency());
    if (T < 1) T = 1;
    if (static_cast<size_t>(T) > span / (1 << 16) + 1)
        T = static_cast<int64_t>(span / (1 << 16)) + 1;  // >=64KiB per thread

    // range boundaries aligned to line starts (the reference's fixup rule)
    std::vector<size_t> bounds(T + 1);
    for (int64_t t = 0; t <= T; ++t) {
        size_t raw = start + span * static_cast<size_t>(t) / static_cast<size_t>(T);
        bounds[t] = (t == 0) ? start : (t == T ? m.size : align_to_line(m.data, raw, m.size));
    }

    // pass 1: rows per range -> output offsets
    std::vector<int64_t> counts(T, 0);
    {
        std::vector<std::thread> th;
        for (int64_t t = 0; t < T; ++t)
            th.emplace_back([&, t] { counts[t] = count_rows(m.data, bounds[t], bounds[t + 1], sep); });
        for (auto& x : th) x.join();
    }
    std::vector<int64_t> offs(T + 1, 0);
    for (int64_t t = 0; t < T; ++t) offs[t + 1] = offs[t] + counts[t];
    if (offs[T] != rows) { unmap(m); return -2; }

    // pass 2: parse each range into its slot
    std::vector<int64_t> status(T, 0);
    {
        std::vector<std::thread> th;
        for (int64_t t = 0; t < T; ++t)
            th.emplace_back([&, t] {
                status[t] = parse_rows(m.data, bounds[t], bounds[t + 1], sep, cols,
                                       out + offs[t] * cols, m.size);
            });
        for (auto& x : th) x.join();
    }
    unmap(m);
    for (int64_t t = 0; t < T; ++t)
        if (status[t] < 0) return status[t];
    return 0;
}

}  // extern "C"
