// Shared device code of the Sudoku kernels K1 (propagate.cu) and K2
// (fused_step.cu): one warp owns one board.
//
// A board is n*n uint32 candidate masks (bit d set: digit d+1 possible),
// n <= 32.  The code is written for the H100 as follows.
//
// Geometry at compile time.  Every function is a template on a geometry
// type G: Geo<BH, BW> for each box shape the package ships
// (DSST_FOR_EACH_GEOMETRY; models/geometry.py), whose dimensions are
// constants, so index arithmetic folds into constants and the unit walks
// unroll; and Geo<0, 0>, the same source with the dimensions read at run
// time, for every other box shape with n <= 32.  Each entry point picks
// the instantiation from (box_h, box_w).
//
// Cells in registers, by row segment.  A row segment is a row's cells
// inside one box: bw consecutive cells; there are n*bh of them, segment s
// holding cells s*bw .. s*bw+bw-1 (since n = bh*bw, boxes side by side =
// bh and boxes stacked = bw).  Thread `lane` owns segments lane, lane+32,
// ... and keeps their cells in registers, x[i] for own cell i (segment
// lane + 32*(i / bw), cell i % bw in it), for the whole dispatch.  Shared
// memory holds only what other threads read: the board, stored from the
// registers once per stage for the unit walks, and the per-unit
// summaries.  Box-line's row segments are each thread's own ORs.
//
// Unit walks without divergence.  Every unit (row, column, box) is bh
// strips of bw cells, cell (i, j) at base + i*rs + j*cs with (rs, cs) =
// (bw, 1) for a row, (bw*n, n) for a column and (n, 1) for a box.  Thread
// `lane` walks units lane, lane+32, lane+64 of the 3n (rows, columns,
// boxes) with (base, rs, cs) computed once per launch, so every thread
// runs the same load, test and OR; lanes past 3n walk row 0 and store
// into summary slots that nobody reads.
//
// A sweep reproduces ops/propagate.py stage by stage, never updating a
// stage's input while that stage still reads it:
//   1. elimination: unit ORs of the cells decided BEFORE the sweep, then
//      each undecided cell drops them;
//   2. hidden singles: once/twice unit summaries of the eliminated board,
//      then each cell undecided before the sweep takes its forced digits;
//   3. (extended) box-line: rows direction from the stage input, columns
//      direction from the rows result, decided cells restored;
//   4. (subsets) naked subsets: three unit kills from the same input,
//      applied together.
// Every stage only removes candidates from a cell (or restores it), so a
// sweep changed the board iff some stage removed a candidate; the warp
// agrees on that with __any_sync, which makes convergence per board.
// After the fixpoint one walk per round (board_status) gives the status
// and, for a scored head, the unit sums its branch reads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dsst {

constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int BIG_KEY = 1 << 30;
constexpr int UNIT_WORDS = 96;  // 32 * (at most 3 units walked per lane)

// The box shapes (box_h, box_w) with a compile-time instantiation: the
// package's shipped geometries 4x4, 6x6, 9x9, 16x16 and 25x25.
#define DSST_FOR_EACH_GEOMETRY(X) X(2, 2) X(2, 3) X(3, 3) X(4, 4) X(5, 5)

template <int BH, int BW>
struct Geo {
  static constexpr int bh = BH, bw = BW, n = BH * BW, n2 = n * n, nseg = n * BH;
  static constexpr unsigned full = n >= 32 ? 0xffffffffu : ((1u << n) - 1u);
  static constexpr int MAXC = (nseg + 31) / 32 * BW;  // own cells of a lane, at most
  static constexpr int UPT = (3 * n + 31) / 32;       // units a lane walks
  __host__ __device__ Geo(int, int) {}
};

// Run-time dimensions, n <= 32: a lane owns at most 32 cells (every box
// shape with n <= 32 does; the entry points check cells_per_lane) and
// walks at most 3 units.
template <>
struct Geo<0, 0> {
  static constexpr int MAXC = 32, UPT = 3;
  int bh, bw, n, n2, nseg;
  unsigned full;
  __host__ __device__ Geo(int h, int w)
      : bh(h), bw(w), n(h * w), n2(h * w * h * w), nseg(h * w * h),
        full(h * w >= 32 ? 0xffffffffu : ((1u << (h * w)) - 1u)) {}
};

// Own cells of the lane with most: ceil(n*bh / 32) segments of bw cells.
inline __host__ __device__ int cells_per_lane(int bh, int bw) {
  return (bh * bw * bh + 31) / 32 * bw;
}

// Shared words per warp: the board, a scratch area of two boards and the
// unit summaries.
template <class G>
inline __host__ __device__ int warp_smem_words(const G& g) {
  return 3 * g.n2 + UNIT_WORDS;
}

// Warps per block, and the blocks of each kernel an SM must hold for
// __launch_bounds__, which caps the registers a thread may take (65,536
// per SM): chosen per instantiation from ptxas's counts so that none
// spills.  K1 (ROUNDS false) holds 12 blocks (48 warps, 40 registers) up to
// 9x9 and 8 (32 warps, 64 registers) at 16x16; K2 (ROUNDS true) keeps the
// lane's round state and the heads' scoring besides the fixpoint: 8 blocks
// (64 registers) up to 9x9, 5 (96) at 16x16.  At 9x9, K2 capped at 48 or
// 40 registers spills and was no faster on an H100 (chip_smoke.py phase 5
// shape).  25x25 and the run-time instantiation hold up to 32 cells in
// registers: 3 blocks (168) for K1, 2 (255) for K2 and both run-time ones.
constexpr int WARPS_PER_BLOCK = 4;
template <class G, bool ROUNDS>
struct Occupancy {
  static constexpr int MIN_BLOCKS =
      G::MAXC <= 3 ? (ROUNDS ? 8 : 12) : (G::MAXC <= 8 ? (ROUNDS ? 5 : 8) : (ROUNDS ? 2 : 3));
};
template <bool ROUNDS>
struct Occupancy<Geo<0, 0>, ROUNDS> {
  static constexpr int MIN_BLOCKS = 2;
};

// Per-stage clock counters of the counter build (-DDSST_STAGE_CLOCKS, a
// library of its own name; ops/cuda_build.py).  Each warp adds the
// clock64() cycles it spends in each stage into registers; its kernel adds
// them into dsst_stage_cycles at its end (lane 0, one atomic per stage).
// ST_TOTAL is the warp's whole run, so the cycles outside the stages
// (loads, stores, loop control) are ST_TOTAL less the others.  Without the
// define the struct is empty and every call compiles away.
enum Stage { ST_ELIM, ST_HIDDEN, ST_BOXLINE, ST_SUBSETS, ST_STATUS, ST_BRANCH, ST_PUSHPOP,
             ST_TOTAL, N_STAGES };

#ifdef DSST_STAGE_CLOCKS
__device__ unsigned long long dsst_stage_cycles[N_STAGES];

struct StageClock {
  long long acc[N_STAGES], start, t0;
  __device__ StageClock() {
    for (int i = 0; i < N_STAGES; ++i) acc[i] = 0;
    start = t0 = clock64();
  }
  __device__ __forceinline__ void mark() { t0 = clock64(); }
  __device__ __forceinline__ void stop(int s) {
    const long long t = clock64();
    acc[s] += t - t0;
    t0 = t;
  }
  __device__ void flush(int lane) {
    acc[ST_TOTAL] = clock64() - start;
    if (lane == 0)
      for (int i = 0; i < N_STAGES; ++i)
        atomicAdd(&dsst_stage_cycles[i], (unsigned long long)acc[i]);
  }
};
#else
struct StageClock {
  __device__ __forceinline__ void mark() {}
  __device__ __forceinline__ void stop(int) {}
  __device__ __forceinline__ void flush(int) {}
};
#endif

// A unit walk: cell (i, j), i < bh, j < bw, at base + i*rs + j*cs.
struct Walk {
  int base, rs, cs;
};

// Unit u of the 3n: rows [0, n), columns [n, 2n), boxes [2n, 3n) (boxes
// row-major, cells row-major inside a box); u >= 3n walks row 0.
template <class G>
__device__ __forceinline__ Walk unit_walk(const G& g, int u) {
  const int t = u < 3 * g.n ? u / g.n : 0, k = u < 3 * g.n ? u % g.n : 0;
  if (t == 0) return {k * g.n, g.bw, 1};
  if (t == 1) return {k, g.bw * g.n, g.n};
  return {(k / g.bh) * g.bh * g.n + (k % g.bh) * g.bw, g.n, 1};
}

// Cell of position q (row-major) of a unit.
template <class G>
__device__ __forceinline__ int walk_cell(const G& g, const Walk& w, int q) {
  return w.base + (q / g.bw) * w.rs + (q % g.bw) * w.cs;
}

template <class G, class F>
__device__ __forceinline__ void walk(const G& g, const unsigned* b, const Walk& w, F&& f) {
#pragma unroll
  for (int i = 0; i < g.bh; ++i) {
    const unsigned* p = b + w.base + i * w.rs;
#pragma unroll
    for (int j = 0; j < g.bw; ++j) f(p[j * w.cs]);
  }
}

// Where own cell i of a lane lies: its cell index, row, column and box.
struct CellPos {
  int c, r, col, box;
};

template <class G>
__device__ __forceinline__ CellPos cell_pos(const G& g, int lane, int i) {
  const int s = lane + 32 * (i / g.bw), j = i % g.bw;
  const int r = s / g.bh, h = s % g.bh;
  return {s * g.bw + j, r, h * g.bw + j, (r / g.bh) * g.bh + h};
}

// The warp's context: geometry, lane, shared areas and unit walks.
template <class G>
struct Warp {
  G g;
  int lane, nseg_lane;
  unsigned* b;     // the board, n*n words
  unsigned* a;     // scratch, 2*n*n words
  unsigned* unit;  // UNIT_WORDS unit summaries
  Walk wk[G::UPT];

  __device__ Warp(const G& g_, int lane_, unsigned* base) : g(g_), lane(lane_) {
    nseg_lane = lane < g.nseg ? (g.nseg - lane + 31) / 32 : 0;
    b = base;
    a = base + g.n2;
    unit = base + 3 * g.n2;
#pragma unroll
    for (int m = 0; m < G::UPT; ++m) wk[m] = unit_walk(g, lane + 32 * m);
  }
  // Units a lane walks: ceil(3n / 32), the same on every lane.
  __device__ __forceinline__ bool walks(int m) const { return 32 * m < 3 * g.n; }
  __device__ __forceinline__ bool owns(int i) const {
    return i < G::MAXC && i / g.bw < nseg_lane;
  }
  __device__ __forceinline__ CellPos pos(int i) const { return cell_pos(g, lane, i); }
};

template <class G>
using Cells = unsigned[G::MAXC];

// Bit i set: own cell i holds exactly one digit.
template <class G>
__device__ __forceinline__ unsigned single_bits(const Warp<G>& w, const Cells<G>& x) {
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < G::MAXC; ++i)
    if (w.owns(i) && __popc(x[i]) == 1) bits |= 1u << i;
  return bits;
}

template <class G>
__device__ __forceinline__ void store_board(const Warp<G>& w, const Cells<G>& x) {
#pragma unroll
  for (int i = 0; i < G::MAXC; ++i)
    if (w.owns(i)) w.b[w.pos(i).c] = x[i];
}

// OR of the three unit summaries of the cell at p.
template <class G>
__device__ __forceinline__ unsigned unit_or(const Warp<G>& w, const CellPos& p) {
  return w.unit[p.r] | w.unit[w.g.n + p.col] | w.unit[2 * w.g.n + p.box];
}

// Stage 1: elimination.  pre: the cells decided at the sweep's start.
template <class G>
__device__ bool eliminate(const Warp<G>& w, Cells<G>& x, unsigned pre) {
#pragma unroll
  for (int i = 0; i < G::MAXC; ++i)
    if (w.owns(i)) w.b[w.pos(i).c] = (pre >> i) & 1u ? x[i] : 0u;
  __syncwarp();
#pragma unroll
  for (int m = 0; m < G::UPT; ++m) {
    if (!w.walks(m)) continue;
    unsigned acc = 0;
    walk(w.g, w.b, w.wk[m], [&](unsigned v) { acc |= v; });
    w.unit[w.lane + 32 * m] = acc;
  }
  __syncwarp();
  bool changed = false;
#pragma unroll
  for (int i = 0; i < G::MAXC; ++i) {
    if (!w.owns(i) || ((pre >> i) & 1u)) continue;
    const unsigned nx = x[i] & ~unit_or(w, w.pos(i));
    changed |= nx != x[i];
    x[i] = nx;
  }
  return changed;
}

// Stage 2: hidden singles.
template <class G>
__device__ bool hidden_singles(const Warp<G>& w, Cells<G>& x, unsigned pre) {
  store_board(w, x);
  __syncwarp();
#pragma unroll
  for (int m = 0; m < G::UPT; ++m) {
    if (!w.walks(m)) continue;
    unsigned once = 0, twice = 0;
    walk(w.g, w.b, w.wk[m], [&](unsigned v) {
      twice |= once & v;
      once |= v;
    });
    w.unit[w.lane + 32 * m] = once & ~twice;
  }
  __syncwarp();
  bool changed = false;
#pragma unroll
  for (int i = 0; i < G::MAXC; ++i) {
    if (!w.owns(i) || ((pre >> i) & 1u)) continue;
    const unsigned forced = x[i] & unit_or(w, w.pos(i));
    if (forced != 0u && forced != x[i]) {
      x[i] = forced;
      changed = true;
    }
  }
  return changed;
}

// once & ~twice over `len` words at p[0], p[step], ...
__device__ __forceinline__ unsigned only_once(const unsigned* p, int len, int step) {
  unsigned once = 0, twice = 0;
  for (int t = 0; t < len; ++t) {
    const unsigned v = p[t * step];
    twice |= once & v;
    once |= v;
  }
  return once & ~twice;
}

// Stage 3: box-line pointing/claiming, rows direction then columns
// direction (ops/propagate.box_line_sweep).
//
// Rows direction: a[R*bh + h] is row R's segment OR in box column h (each
// lane's own ORs).  unit[v*bh + h] holds the bits of box (v, h) confined to
// one of its rows (pointing), unit[n + R] the bits of row R confined to one
// box (claiming); a segment's kill is the same for its bw cells.
// Columns direction, on the rows result: a[c*bw + v] is column c's OR over
// box row v (bh cells), the transposed view's segments; its pointing and
// claiming masks go to unit[], each transposed segment's kill to
// a[n*bw + c*bw + v], and each lane reads the kills of its cells.
// A cell decided at the stage input keeps its mask: its register is never
// changed, and `dead` marks those whose digit the rows direction killed,
// which the columns direction must see as 0.
template <class G>
__device__ bool box_line(const Warp<G>& w, Cells<G>& x) {
  const G& g = w.g;
  const int n = g.n, bh = g.bh, bw = g.bw;
  unsigned* seg = w.a;
  const unsigned decided = single_bits(w, x);
  bool changed = false;

  unsigned acc = 0;
#pragma unroll
  for (int i = 0; i < G::MAXC; ++i) {
    if (!w.owns(i)) continue;
    acc = i % bw == 0 ? x[i] : acc | x[i];
    if (i % bw == bw - 1) seg[w.lane + 32 * (i / bw)] = acc;
  }
  __syncwarp();
  for (int e = w.lane; e < 2 * n; e += 32) {
    const int base = e < n ? (e / bh) * bh * bh + e % bh : (e - n) * bh;
    w.unit[e] = only_once(seg + base, bh, e < n ? bh : 1);
  }
  __syncwarp();
  unsigned dead = 0, kill = 0;
#pragma unroll
  for (int i = 0; i < G::MAXC; ++i) {
    if (!w.owns(i)) continue;
    if (i % bw == 0) {
      const int s = w.lane + 32 * (i / bw), r = s / bh, h = s % bh, v = r / bh, rr = r % bh;
      kill = 0;
#pragma unroll
      for (int t = 0; t < bh; ++t) {
        if (t != h) kill |= seg[r * bh + t] & w.unit[v * bh + t];
        if (t != rr) kill |= seg[(v * bh + t) * bh + h] & w.unit[n + v * bh + t];
      }
    }
    if ((decided >> i) & 1u) {
      if (x[i] & kill) dead |= 1u << i;
    } else {
      changed |= (x[i] & kill) != 0u;
      x[i] &= ~kill;
    }
  }

#pragma unroll
  for (int i = 0; i < G::MAXC; ++i)
    if (w.owns(i)) w.b[w.pos(i).c] = (dead >> i) & 1u ? 0u : x[i];
  __syncwarp();
  unsigned* kt = w.a + n * bw;
  for (int e = w.lane; e < n * bw; e += 32) {
    const int c = e / bw, v = e % bw;
    unsigned o = 0;
    for (int t = 0; t < bh; ++t) o |= w.b[(v * bh + t) * n + c];
    seg[e] = o;
  }
  __syncwarp();
  for (int e = w.lane; e < 2 * n; e += 32) {
    const int base = e < n ? (e / bw) * bw * bw + e % bw : (e - n) * bw;
    w.unit[e] = only_once(seg + base, bw, e < n ? bw : 1);
  }
  __syncwarp();
  for (int e = w.lane; e < n * bw; e += 32) {
    const int c = e / bw, h = e % bw, vt = c / bw, rr = c % bw;
    unsigned k = 0;
    for (int t = 0; t < bw; ++t) {
      if (t != h) k |= seg[c * bw + t] & w.unit[vt * bw + t];
      if (t != rr) k |= seg[(vt * bw + t) * bw + h] & w.unit[n + vt * bw + t];
    }
    kt[e] = k;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < G::MAXC; ++i) {
    if (!w.owns(i) || ((decided >> i) & 1u)) continue;
    const CellPos p = w.pos(i);
    const unsigned k = kt[p.col * bw + p.r / bh];
    changed |= (x[i] & k) != 0u;
    x[i] &= ~k;
  }
  return changed;
}

// Stage 4: naked subsets.  For each unit type t: a[u*n + q] says whether
// probe q of unit u is confined (bit 0) and overfull (bit 1); then each
// lane ORs, for each own cell, the masks of its unit's probes that hit it.
template <class G>
__device__ bool naked_subsets(const Warp<G>& w, Cells<G>& x) {
  const G& g = w.g;
  const int n = g.n;
  const unsigned decided = single_bits(w, x);
  store_board(w, x);
  unsigned kill[G::MAXC];
#pragma unroll
  for (int i = 0; i < G::MAXC; ++i) kill[i] = 0u;
#pragma unroll 1
  for (int t = 0; t < 3; ++t) {
    __syncwarp();
    for (int p = w.lane; p < g.n2; p += 32) {
      const Walk u = unit_walk(g, t * n + p / n);
      const unsigned m = w.b[walk_cell(g, u, p % n)];
      int cnt = 0;
      walk(g, w.b, u, [&](unsigned v) { cnt += (v != 0u && (v & ~m) == 0u) ? 1 : 0; });
      const int k = __popc(m);
      w.a[p] = ((m != 0u && cnt >= k) ? 1u : 0u) | ((cnt > k) ? 2u : 0u);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < G::MAXC; ++i) {
      if (!w.owns(i)) continue;
      const CellPos c = w.pos(i);
      const int ui = t == 0 ? c.r : (t == 1 ? c.col : c.box);
      const Walk u = unit_walk(g, t * n + ui);
      const unsigned xv = x[i];
      unsigned acc = 0;
#pragma unroll
      for (int q = 0; q < g.n; ++q) {
        const unsigned s = w.a[ui * n + q];
        const unsigned m = w.b[walk_cell(g, u, q)];
        const bool sub = xv != 0u && (xv & ~m) == 0u;
        acc |= ((s & 1u) && (!sub || (s & 2u))) ? m : 0u;
      }
      kill[i] |= acc;
    }
  }
  __syncwarp();
  bool changed = false;
#pragma unroll
  for (int i = 0; i < G::MAXC; ++i) {
    if (!w.owns(i) || ((decided >> i) & 1u)) continue;
    const unsigned nx = x[i] & ~kill[i];
    changed |= nx != x[i];
    x[i] = nx;
  }
  return changed;
}

// One sweep of the rule tier (0 basic, 1 extended, 2 subsets); true iff
// the board changed.  Warp-uniform.
template <class G>
__device__ bool one_sweep(const Warp<G>& w, Cells<G>& x, int rules, StageClock& clk) {
  clk.mark();
  const unsigned pre = single_bits(w, x);
  bool changed = eliminate(w, x, pre);
  clk.stop(ST_ELIM);
  changed |= hidden_singles(w, x, pre);
  clk.stop(ST_HIDDEN);
  if (rules >= 1) {
    __syncwarp();
    changed |= box_line(w, x);
    clk.stop(ST_BOXLINE);
  }
  if (rules >= 2) {
    __syncwarp();
    changed |= naked_subsets(w, x);
    clk.stop(ST_SUBSETS);
  }
  return __any_sync(FULL_WARP, changed);
}

// Sweep the board to its fixpoint: min(unroll, max_sweeps) sweeps without
// a check, then checked sweeps until one changes nothing or max_sweeps.
// Returns the sweeps run.
template <class G>
__device__ int fixpoint(const Warp<G>& w, Cells<G>& x, int max_sweeps, int rules, int unroll,
                        StageClock& clk) {
  int sweeps = 0;
  bool changed = true;
  const int pre = unroll < max_sweeps ? unroll : max_sweeps;
  for (; sweeps < pre; ++sweeps) changed = one_sweep(w, x, rules, clk);
  while (changed && sweeps < max_sweeps) {
    changed = one_sweep(w, x, rules, clk);
    ++sweeps;
  }
  return sweeps;
}

// ops/propagate.board_status with the duplicate test of the fused round
// (a decided digit seen twice in a unit), in one walk of every unit.  With
// `sums`, the walk also leaves each unit's head sums in unit[]: excess =
// sum of (pc - 1) and und = number of undecided cells, as excess << 16 |
// und (excess <= 32*31 and und <= 32 fit).  Warp-uniform results.
template <class G>
__device__ void board_status(const Warp<G>& w, const Cells<G>& x, bool sums, bool* solved,
                             bool* contra) {
  __syncwarp();
  store_board(w, x);
  __syncwarp();
  bool bad = false, all_single = true;
#pragma unroll
  for (int m = 0; m < G::UPT; ++m) {
    if (!w.walks(m)) continue;
    unsigned once = 0, twice = 0, all = 0, sum = 0;
    walk(w.g, w.b, w.wk[m], [&](unsigned v) {
      const unsigned pc = __popc(v);
      const unsigned d = pc == 1u ? v : 0u;
      twice |= once & d;
      once |= d;
      all |= v;
      sum += pc > 1u ? ((pc - 1u) << 16 | 1u) : 0u;
    });
    const int u = w.lane + 32 * m;
    if (u < 3 * w.g.n && (twice != 0u || all != w.g.full)) bad = true;
    if (sums) w.unit[u] = sum;
  }
#pragma unroll
  for (int i = 0; i < G::MAXC; ++i) {
    if (!w.owns(i)) continue;
    if (x[i] == 0u) bad = true;
    if (__popc(x[i]) != 1) all_single = false;
  }
  bad = __any_sync(FULL_WARP, bad);
  all_single = __all_sync(FULL_WARP, all_single);
  __syncwarp();
  *contra = bad;
  *solved = all_single && !bad;
}

// Branch rules: the legacy rules 0 minrem, 1 first, 2 mixed,
// 3 minrem-desc, then the scored heads of ops/ordering.py.
constexpr int RULE_HEAD_MINREM = 4;
constexpr int RULE_HEAD_CW_SLACK = 5;
constexpr int RULE_HEAD_MLP = 6;
constexpr int MLP_FEATURES = 7;
constexpr int MLP_HIDDEN = 8;

// Everything a head needs besides the board, as f32 values rounded on the
// host exactly as JAX rounds its Python floats: the MLP's weights, b2 + 8
// (summed in double, rounded once), 1/n and 1/n^2, the quant and the
// clamp bound of pack_key.
struct HeadParams {
  float w1[MLP_FEATURES][MLP_HIDDEN];
  float b1[MLP_HIDDEN];
  float w2[MLP_HIDDEN];
  float out_bias;
  float inv_n, inv_n2, quant, qmax;
};

// A head's score of one undecided cell (pc > 1) from its unit sums:
// excess = sum of (pc - 1) and und = number of undecided cells, over the
// cell's row, column and box.  Every multiply and add is rounded on its
// own (__fmul_rn / __fadd_rn never contract into an FMA), in the order of
// the heads' score_full, so the score is the plain torch version's.
__device__ __forceinline__ float head_score(const HeadParams& hp, int rule, int pc,
                                            const int* ex, const int* und) {
  if (rule == RULE_HEAD_MINREM) return (float)pc;
  const int excess = pc - 1;
  if (rule == RULE_HEAD_CW_SLACK) {
    int peer = ex[0] + ex[1] + ex[2] - 3 * excess;
    peer = peer < 2047 ? peer : 2047;
    return __fadd_rn((float)pc, __fmul_rn((float)peer, 1.0f / 2048.0f));
  }
  float f[MLP_FEATURES];
  f[0] = __fmul_rn((float)pc, hp.inv_n);
  for (int i = 0; i < 3; ++i) f[1 + i] = __fmul_rn((float)(ex[i] - excess), hp.inv_n2);
  for (int i = 0; i < 3; ++i) f[4 + i] = __fmul_rn((float)(und[i] - 1), hp.inv_n);
  float out = 0.0f;
#pragma unroll
  for (int j = 0; j < MLP_HIDDEN; ++j) {
    float acc = __fmul_rn(f[0], hp.w1[0][j]);
#pragma unroll
    for (int i = 1; i < MLP_FEATURES; ++i) acc = __fadd_rn(acc, __fmul_rn(f[i], hp.w1[i][j]));
    acc = __fadd_rn(acc, hp.b1[j]);
    const float h = acc < 0.0f ? 0.0f : acc;
    out = j == 0 ? __fmul_rn(h, hp.w2[0]) : __fadd_rn(out, __fmul_rn(h, hp.w2[j]));
  }
  return __fadd_rn(out, hp.out_bias);
}

// pack_key's quantized score: round half to even (rintf, as torch.round
// and jnp.round), clamp in float to [0, qmax], then the int cast.
__device__ __forceinline__ int head_quant(const HeadParams& hp, float score) {
  float x = rintf(__fmul_rn(score, hp.quant));
  x = x < 0.0f ? 0.0f : x;
  x = x > hp.qmax ? hp.qmax : x;
  return (int)x;
}

// Branch cell of the board under rule: the argmin of a unique per-cell
// key over undecided cells (-1 if none is undecided).  Legacy keys are
// pc*n^2 + cell (minrem) or cell (first); a head's key is q*n^2 + cell
// with q its quantized score, from the unit sums board_status left in
// unit[].  Each lane keys its own cells; one warp min picks the cell.
template <class G>
__device__ int branch_cell(const Warp<G>& w, const Cells<G>& x, int rule, const HeadParams& hp) {
  const G& g = w.g;
  bool use_minrem = rule == 0 || rule == 3;
  if (rule == 2) {
    int h = 0;
#pragma unroll
    for (int i = 0; i < G::MAXC; ++i)
      if (w.owns(i)) h += __popc(x[i]) * (w.pos(i).c + 1);
    h = (int)__reduce_add_sync(FULL_WARP, (unsigned)h);
    use_minrem = (h & 1) == 0;
  }
  const bool head = rule >= RULE_HEAD_MINREM;
  int best = BIG_KEY;
#pragma unroll
  for (int i = 0; i < G::MAXC; ++i) {
    if (!w.owns(i)) continue;
    const int pc = __popc(x[i]);
    if (pc <= 1) continue;
    const CellPos p = w.pos(i);
    int key;
    if (head) {
      const unsigned s[3] = {w.unit[p.r], w.unit[g.n + p.col], w.unit[2 * g.n + p.box]};
      int ex[3], und[3];
      for (int t = 0; t < 3; ++t) {
        ex[t] = (int)(s[t] >> 16);
        und[t] = (int)(s[t] & 0xffffu);
      }
      key = head_quant(hp, head_score(hp, rule, pc, ex, und)) * g.n2 + p.c;
    } else {
      key = use_minrem ? pc * g.n2 + p.c : p.c;
    }
    best = key < best ? key : best;
  }
  best = __reduce_min_sync(FULL_WARP, best);
  return best == BIG_KEY ? -1 : best % g.n2;
}

__device__ __forceinline__ unsigned lowest_bit(unsigned x) { return x & (~x + 1u); }

__device__ __forceinline__ unsigned highest_bit(unsigned x) {
  return x ? (1u << (31 - __clz(x))) : 0u;
}

// Own cells <-> a board in device memory (each segment a contiguous run).
template <class G>
__device__ __forceinline__ void load_cells(const Warp<G>& w, Cells<G>& x, const unsigned* src) {
#pragma unroll
  for (int i = 0; i < G::MAXC; ++i) x[i] = w.owns(i) ? src[w.pos(i).c] : 0u;
}

template <class G>
__device__ __forceinline__ void store_cells(const Warp<G>& w, const Cells<G>& x, unsigned* dst) {
#pragma unroll
  for (int i = 0; i < G::MAXC; ++i)
    if (w.owns(i)) dst[w.pos(i).c] = x[i];
}

}  // namespace dsst
