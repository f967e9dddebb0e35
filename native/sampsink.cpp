// Native sample-row CSV formatter for bayesrrcpp_tpu.
//
// Native equivalent of the reference's output runtime (the vendored
// moodycamel queue + Eigen CommaInitFmt consumer thread, reference:
// src/concurrentqueue.h, src/BayesRv2.cpp:72,281-290).  The host-side
// bottleneck at scale is double->ascii conversion of very wide sample rows
// (2M + N + O(1) fields each); std::to_chars emits the shortest
// round-trippable representation at ~20ns/field.  Exposed as a C ABI
// consumed via ctypes (io/native.py).
//
// Output format matches Eigen's IOFormat(StreamPrecision, DontAlignCols,
// ", ", ", ") as used by the reference writers: fields joined by ", ",
// rows by '\n'.

#include <charconv>
#include <cstdint>
#include <cstdio>

namespace {

inline int format_double(double v, char* out, char* end) {
  if (v == static_cast<int64_t>(v) && v > -1e15 && v < 1e15) {
    // integral fast path (iteration / component-label columns); emit a
    // trailing ".0" so the column parses as float like the reference output
    auto r = std::to_chars(out, end, static_cast<int64_t>(v));
    if (r.ec != std::errc() || end - r.ptr < 2) return -1;
    *r.ptr++ = '.';
    *r.ptr++ = '0';
    return static_cast<int>(r.ptr - out);
  }
  auto r = std::to_chars(out, end, v);  // shortest round-trip
  if (r.ec != std::errc()) return -1;
  return static_cast<int>(r.ptr - out);
}

}  // namespace

extern "C" {

// Formats an (n_rows, n_cols) row-major f64 matrix into CSV text.
// Returns bytes written, or -1 if the buffer would overflow.
long long format_rows_csv(const double* data, long long n_rows,
                          long long n_cols, char* out, long long out_cap) {
  char* p = out;
  char* end = out + out_cap;
  for (long long r = 0; r < n_rows; ++r) {
    const double* row = data + r * n_cols;
    for (long long c = 0; c < n_cols; ++c) {
      if (end - p < 40) return -1;
      if (c) {
        *p++ = ',';
        *p++ = ' ';
      }
      int n = format_double(row[c], p, end);
      if (n < 0) return -1;
      p += n;
    }
    if (end - p < 2) return -1;
    *p++ = '\n';
  }
  return p - out;
}

}  // extern "C"
