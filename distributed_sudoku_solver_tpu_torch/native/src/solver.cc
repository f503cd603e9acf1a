// Native CPU oracle: geometry-generic bitmask DFS solver + validator.
//
// Role (SURVEY.md §4): the framework's *test authority* and host-side
// reference, replacing the reference repo's only kernel — the pure-Python
// recursive `solve_sudoku` (/root/reference/utils.py:14-55,
// /root/reference/DHT_Node.py:474-538, ~185k recursions/s) — with a compiled
// implementation of the same observable search semantics:
//
//   * branch on the first empty cell in row-major order
//     (the reference's `find_next_empty`, /root/reference/utils.py:14-25),
//   * try digits in ascending order (/root/reference/DHT_Node.py:522),
//
// so the first solution found is the lexicographically-least completion —
// bit-exact with both the Python oracle (utils/oracle.py) and, on
// unique-solution boards, the TPU frontier solver.  No code or structure is
// shared with the reference: this is bitmask row/col/box state, not list
// scans.
//
// Built as a plain shared library; bound via ctypes (no pybind11 in image).

#include <cstdint>

namespace {

struct Geom {
  int n, box_h, box_w, n_hboxes;
};

// All-digits mask; `1u << 32` is UB, so n == 32 (kMaxN) is special-cased.
inline uint32_t full_mask(int n) {
  return (n >= 32) ? 0xffffffffu : ((1u << n) - 1u);
}

inline int box_of(const Geom& g, int r, int c) {
  return (r / g.box_h) * g.n_hboxes + (c / g.box_w);
}

// DFS over empty cells in row-major order, ascending digit order.
// `limit` caps the number of solutions counted; the first solution found is
// copied into `out` (if non-null).  Returns the number of solutions found
// (saturated at `limit`).  `nodes` counts cell-assignment attempts — the
// analog of the reference's `validations` counter
// (/root/reference/DHT_Node.py:512-513).
struct Searcher {
  Geom g;
  const int* empties;  // flat indices of empty cells, row-major ascending
  int n_empty;
  uint32_t* rows;
  uint32_t* cols;
  uint32_t* boxes;
  int32_t* grid;  // working copy, n*n
  int32_t* out;   // first solution, n*n (nullable)
  int limit;
  int found = 0;
  int64_t nodes = 0;

  void dfs(int depth) {
    if (found >= limit) return;
    if (depth == n_empty) {
      ++found;
      if (found == 1 && out != nullptr) {
        for (int i = 0; i < g.n * g.n; ++i) out[i] = grid[i];
      }
      return;
    }
    const int idx = empties[depth];
    const int r = idx / g.n, c = idx % g.n, b = box_of(g, r, c);
    uint32_t avail = ~(rows[r] | cols[c] | boxes[b]) & full_mask(g.n);
    while (avail != 0) {
      const uint32_t bit = avail & (~avail + 1u);  // lowest set bit: ascending
      avail &= avail - 1u;
      ++nodes;
      rows[r] |= bit;
      cols[c] |= bit;
      boxes[b] |= bit;
      grid[idx] = __builtin_ctz(bit) + 1;
      dfs(depth + 1);
      rows[r] &= ~bit;
      cols[c] &= ~bit;
      boxes[b] &= ~bit;
      grid[idx] = 0;
      if (found >= limit) return;
    }
  }
};

// Shared setup: returns 0 on success, -1 on malformed input, -2 on an
// immediate clue conflict (caller reports unsat with 0 solutions).
int setup(const int32_t* in, const Geom& g, uint32_t* rows, uint32_t* cols,
          uint32_t* boxes, int32_t* grid, int* empties, int* n_empty) {
  const int n = g.n;
  for (int i = 0; i < n; ++i) rows[i] = cols[i] = boxes[i] = 0;
  *n_empty = 0;
  for (int idx = 0; idx < n * n; ++idx) {
    const int v = in[idx];
    if (v < 0 || v > n) return -1;
    grid[idx] = v;
    if (v == 0) {
      empties[(*n_empty)++] = idx;
      continue;
    }
    const int r = idx / n, c = idx % n, b = box_of(g, r, c);
    const uint32_t bit = 1u << (v - 1);
    if ((rows[r] | cols[c] | boxes[b]) & bit) return -2;
    rows[r] |= bit;
    cols[c] |= bit;
    boxes[b] |= bit;
  }
  return 0;
}

constexpr int kMaxN = 32;

}  // namespace

extern "C" {

// Count solutions up to `limit`; fill `out` (nullable) with the first one.
// Returns: >=0 number of solutions found (saturated), -1 malformed input.
int csp_count_solutions(const int32_t* in, int n, int box_h, int box_w,
                        int limit, int32_t* out, int64_t* nodes_out) {
  if (n < 1 || n > kMaxN || box_h < 1 || box_w < 1 || box_h * box_w != n) {
    return -1;
  }
  Geom g{n, box_h, box_w, n / box_w};
  uint32_t rows[kMaxN], cols[kMaxN], boxes[kMaxN];
  int32_t grid[kMaxN * kMaxN];
  int empties[kMaxN * kMaxN];
  int n_empty = 0;
  const int rc = setup(in, g, rows, cols, boxes, grid, empties, &n_empty);
  if (rc == -1) return -1;
  if (rc == -2) {
    if (nodes_out != nullptr) *nodes_out = 0;
    return 0;
  }
  Searcher s{g, empties, n_empty, rows, cols, boxes, grid, out, limit};
  s.dfs(0);
  if (nodes_out != nullptr) *nodes_out = s.nodes;
  return s.found;
}

// Solve in place toward the lexicographically-least completion.
// Returns 1 solved (grid overwritten), 0 proven unsat, -1 malformed input.
int csp_solve(int32_t* grid, int n, int box_h, int box_w, int64_t* nodes_out) {
  int32_t out[kMaxN * kMaxN];
  const int found =
      csp_count_solutions(grid, n, box_h, box_w, 1, out, nodes_out);
  if (found < 0) return -1;
  if (found == 0) return 0;
  for (int i = 0; i < n * n; ++i) grid[i] = out[i];
  return 1;
}

// Validate a complete board: every unit contains each digit exactly once.
// Returns 1 valid, 0 invalid.  (The reference's `Sudoku.check` intends this
// but NameErrors on any valid grid — /root/reference/sudoku.py:68,
// SURVEY.md §2.5 #1; this is the corrected capability.)
int csp_is_valid_solution(const int32_t* grid, int n, int box_h, int box_w) {
  if (n < 1 || n > kMaxN || box_h < 1 || box_w < 1 || box_h * box_w != n) {
    return 0;
  }
  Geom g{n, box_h, box_w, n / box_w};
  const uint32_t full = full_mask(n);
  uint32_t rows[kMaxN] = {0}, cols[kMaxN] = {0}, boxes[kMaxN] = {0};
  for (int idx = 0; idx < n * n; ++idx) {
    const int v = grid[idx];
    if (v < 1 || v > n) return 0;
    const int r = idx / n, c = idx % n, b = box_of(g, r, c);
    const uint32_t bit = 1u << (v - 1);
    if ((rows[r] & bit) || (cols[c] & bit) || (boxes[b] & bit)) return 0;
    rows[r] |= bit;
    cols[c] |= bit;
    boxes[b] |= bit;
  }
  for (int i = 0; i < n; ++i) {
    if (rows[i] != full || cols[i] != full || boxes[i] != full) return 0;
  }
  return 1;
}

// Batch solve: `grids` is count contiguous n*n boards, solved in place.
// results[i]: 1 solved, 0 unsat, -1 malformed.  nodes[i] (nullable): per-board
// node counts.  Returns number solved.
int csp_solve_batch(int32_t* grids, int count, int n, int box_h, int box_w,
                    int32_t* results, int64_t* nodes) {
  int solved = 0;
  for (int i = 0; i < count; ++i) {
    int64_t nd = 0;
    const int r = csp_solve(grids + (int64_t)i * n * n, n, box_h, box_w, &nd);
    if (results != nullptr) results[i] = r;
    if (nodes != nullptr) nodes[i] = nd;
    if (r == 1) ++solved;
  }
  return solved;
}

}  // extern "C"

namespace {

// Generalized exact cover, counting all solutions.  Operates on the exact
// arrays models/cover.py::ExactCoverCSP carries (col_rows / row_cols /
// elim as packed uint32 words), so the native baseline and the TPU engine
// search the *identical* matrix — the benchmark contract of
// benchmarks/bench_cover.py.  MRV column choice (fewest available rows),
// ascending row order within a column: the same heuristic family as the
// device kernels, recursion instead of lane stacks.
struct CoverSearcher {
  const uint32_t* col_rows;  // [n_primary][w_rows]
  const uint32_t* row_cols;  // [n_rows][w_cols]
  const uint32_t* elim;      // [n_rows][w_rows]
  int n_rows, n_primary, w_rows, w_cols;
  int64_t limit;
  int64_t found = 0;
  int64_t nodes = 0;

  static int popcount_and(const uint32_t* a, const uint32_t* b, int w) {
    int c = 0;
    for (int i = 0; i < w; ++i) c += __builtin_popcount(a[i] & b[i]);
    return c;
  }

  void dfs(uint32_t* avail, uint32_t* covered) {
    if (limit >= 0 && found >= limit) return;
    // MRV: the uncovered primary column with the fewest available rows.
    int best_col = -1, best_cnt = INT32_MAX;
    for (int c = 0; c < n_primary; ++c) {
      if ((covered[c >> 5] >> (c & 31)) & 1u) continue;
      const int cnt = popcount_and(col_rows + c * w_rows, avail, w_rows);
      if (cnt < best_cnt) {
        best_cnt = cnt;
        best_col = c;
        if (cnt == 0) break;
      }
    }
    if (best_col == -1) {  // every primary column covered: one solution
      ++found;
      return;
    }
    if (best_cnt == 0) return;  // dead end
    const uint32_t* crow = col_rows + best_col * w_rows;
    uint32_t navail[128], ncovered[128];  // w_rows, w_cols <= 128 words each
    for (int r = 0; r < n_rows; ++r) {
      if (!((crow[r >> 5] >> (r & 31)) & (avail[r >> 5] >> (r & 31)) & 1u)) {
        continue;
      }
      ++nodes;
      const uint32_t* el = elim + r * w_rows;
      for (int i = 0; i < w_rows; ++i) navail[i] = avail[i] & ~el[i];
      navail[r >> 5] &= ~(1u << (r & 31));
      const uint32_t* rc = row_cols + r * w_cols;
      for (int i = 0; i < w_cols; ++i) ncovered[i] = covered[i] | rc[i];
      dfs(navail, ncovered);
      if (limit >= 0 && found >= limit) return;
    }
  }
};

}  // namespace

extern "C" {

// Count exact-cover solutions up to `limit` (< 0 = unlimited).
// Returns the count, or -1 on malformed sizes.
int64_t cover_count_solutions(const uint32_t* col_rows,
                              const uint32_t* row_cols, const uint32_t* elim,
                              int n_rows, int n_primary, int w_rows,
                              int w_cols, int64_t limit, int64_t* nodes_out) {
  if (n_rows < 1 || n_primary < 1 || w_rows < 1 || w_rows > 128 ||
      w_cols < 1 || w_cols > 128 || n_rows > 32 * w_rows ||
      n_primary > 32 * w_cols) {
    return -1;
  }
  CoverSearcher s{col_rows, row_cols, elim, n_rows, n_primary, w_rows,
                  w_cols, limit};
  uint32_t avail[128], covered[128];
  for (int i = 0; i < w_rows; ++i) {
    avail[i] = 0xffffffffu;
  }
  const int tail = n_rows & 31;
  if (tail) avail[w_rows - 1] = (1u << tail) - 1u;
  for (int i = 0; i < w_cols; ++i) covered[i] = 0u;
  s.dfs(avail, covered);
  if (nodes_out != nullptr) *nodes_out = s.nodes;
  return s.found;
}

}  // extern "C"
