// Native bulk puzzle loader: newline-separated board strings -> int32 batches.
//
// The data-plane feeder for the bulk solver (ops/bulk.py).  The reference has
// no dataset path at all — each puzzle arrives as one HTTP POST body parsed
// in Python (/root/reference/DHT_Node.py:546-549); at 10^5-10^6 boards/s of
// solver throughput, Python-side string parsing (~10^5 boards/s single
// thread) would be the pipeline bottleneck, so ingestion is native and
// multithreaded here.
//
// Format, per line: the first field (up to ',', for Kaggle-style CSVs) must
// hold exactly n*n board characters: '.' or '0' = empty, digits then
// lowercase base-36 letters for values (matches utils/puzzles.py parse_line).
// Lines not matching are an error, reported by line index; empty lines and a
// leading header line (detected: first field not n*n board chars) are
// skipped.

#include <cctype>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Board-character value: '.'/'0' -> 0, '1'-'9' -> 1-9, letters -> 10-35
// (base 36 either case, matching Python's int(ch, 36) in
// utils/puzzles.py parse_line); -1 if invalid.
inline int char_value(char ch) {
  if (ch == '.' || ch == '0') return 0;
  if (ch >= '1' && ch <= '9') return ch - '0';
  if (ch >= 'a' && ch <= 'z') return ch - 'a' + 10;
  if (ch >= 'A' && ch <= 'Z') return ch - 'A' + 10;
  return -1;
}

struct LineSpan {
  const char* begin;
  int64_t len;  // excluding newline, outer whitespace trimmed
};

// First comma-separated field of the (pre-trimmed) line, with whitespace
// adjacent to the comma trimmed — byte-for-byte the Python fallback's
// raw.split(',')[0].strip().
inline int64_t field_len(const LineSpan& line) {
  int64_t end = line.len;
  for (int64_t i = 0; i < line.len; ++i) {
    if (line.begin[i] == ',') {
      end = i;
      break;
    }
  }
  while (end > 0 &&
         std::isspace(static_cast<unsigned char>(line.begin[end - 1]))) {
    --end;
  }
  return end;
}

// Parse one line's first field into out[n*n]; returns true on success.
bool parse_line(const LineSpan& line, int n, int32_t* out) {
  const int cells = n * n;
  if (field_len(line) != cells) return false;
  for (int i = 0; i < cells; ++i) {
    const int v = char_value(line.begin[i]);
    if (v < 0 || v > n) return false;
    out[i] = v;
  }
  return true;
}

void split_lines(const char* buf, int64_t len, std::vector<LineSpan>* lines) {
  int64_t start = 0;
  for (int64_t i = 0; i <= len; ++i) {
    if (i == len || buf[i] == '\n') {
      // Trim outer whitespace (editors/CSV exports pad lines; the Python
      // fallback .strip()s, and the two must agree byte-for-byte on which
      // lines exist) — whitespace-only lines count as empty.
      int64_t b = start, e = i;
      while (e > b && std::isspace(static_cast<unsigned char>(buf[e - 1]))) --e;
      while (b < e && std::isspace(static_cast<unsigned char>(buf[b]))) ++b;
      if (e > b) lines->push_back({buf + b, e - b});
      start = i + 1;
    }
  }
}

}  // namespace

extern "C" {

// Parse up to `max_boards` boards out of `buf[0:len]`.
// Returns the number of boards written to `out` (row-major int32 n*n each),
// or -(line_index+1) on the first malformed line (0-based index into the
// non-empty lines, after optional header skip).
// `allow_header` != 0 permits skipping line 0 iff it does not parse as a
// board (Kaggle-style CSV headers); with 0, every line must parse or the
// call errors — callers streaming chunk 2+ of a file use this.
// `n_threads` <= 0 means auto (hardware concurrency).
int64_t csp_parse_boards(const char* buf, int64_t len, int n, int32_t* out,
                         int64_t max_boards, int allow_header, int n_threads) {
  if (n < 1 || n > 35 || len < 0) return -1;
  std::vector<LineSpan> lines;
  split_lines(buf, len, &lines);
  if (lines.empty()) return 0;

  // Header detection: only a first line whose *field length* differs from
  // n*n can be a header (e.g. "quizzes,solutions").  A right-length line
  // with a bad character is a malformed board and errors like any other —
  // silently skipping it would shift every output line by one.
  int64_t first = 0;
  if (allow_header != 0 && field_len(lines[0]) != static_cast<int64_t>(n) * n) {
    first = 1;
  }
  const int64_t count =
      std::min<int64_t>(max_boards, static_cast<int64_t>(lines.size()) - first);
  if (count <= 0) return 0;

  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = hw > 0 ? hw : 4;
  if (n_threads > count) n_threads = static_cast<int>(count);

  std::vector<int64_t> bad(n_threads, -1);
  std::vector<std::thread> threads;
  const int cells = n * n;
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([&, t]() {
      const int64_t lo = count * t / n_threads;
      const int64_t hi = count * (t + 1) / n_threads;
      for (int64_t i = lo; i < hi; ++i) {
        if (!parse_line(lines[first + i], n, out + i * cells)) {
          bad[t] = i;
          return;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < n_threads; ++t) {
    if (bad[t] >= 0) return -(bad[t] + 1);
  }
  return count;
}

// Render boards back to text lines (inverse of csp_parse_boards; no commas).
// Each line is n*n chars + '\n'.  Returns bytes written.
int64_t csp_format_boards(const int32_t* boards, int64_t count, int n,
                          char* out) {
  static const char digits[] = "0123456789abcdefghijklmnopqrstuvwxyz";
  const int cells = n * n;
  int64_t pos = 0;
  for (int64_t b = 0; b < count; ++b) {
    const int32_t* g = boards + b * cells;
    for (int i = 0; i < cells; ++i) {
      const int32_t v = g[i];
      out[pos++] = (v >= 0 && v <= 35) ? digits[v] : '?';
    }
    out[pos++] = '\n';
  }
  return pos;
}

}  // extern "C"
