// Shared device code of the Sudoku kernels: one warp owns one board.
//
// A board is n*n uint32 candidate masks (bit d set: digit d+1 possible),
// n <= 32, held in the warp's slice of shared memory.  Each warp's slice
// holds the board, two scratch boards and 96 unit-summary words
// (warp_smem_words; a scored branch head reuses them for its unit sums).  Thread `lane` of the warp owns cells lane, lane+32,
// ...; unit-summary phases give each thread the units lane, lane+32,
// lane+64 of the 3n rows, columns and boxes.
//
// A sweep reproduces ops/propagate.py stage by stage, never updating a
// stage's input in place while that stage still reads it:
//   1. elimination: unit ORs of the cells decided BEFORE the sweep, then
//      each undecided cell drops them;
//   2. hidden singles: once/twice unit summaries of the eliminated board,
//      then each cell undecided before the sweep takes its forced digits;
//   3. (extended) box-line: rows direction from the stage input, columns
//      direction from the rows result, decided cells restored;
//   4. (subsets) naked subsets: three unit kills from the same input,
//      applied together.
// Every stage only removes candidates from a cell (or restores it), so a
// sweep changed the board iff some stage changed some cell; the warp
// agrees on that with __any_sync, which makes convergence per board.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dsst {

constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int BIG_KEY = 1 << 30;
constexpr int UNIT_WORDS = 96;  // 3 * 32 unit summaries
constexpr int WARPS_PER_BLOCK = 4;

struct Geo {
  int n, bh, bw, nv, nh, n2;
  unsigned full;
};

inline __host__ __device__ Geo make_geo(int bh, int bw) {
  Geo g;
  g.bh = bh;
  g.bw = bw;
  g.n = bh * bw;
  g.nv = g.n / bh;
  g.nh = g.n / bw;
  g.n2 = g.n * g.n;
  g.full = g.n >= 32 ? 0xffffffffu : ((1u << g.n) - 1u);
  return g;
}

inline __host__ __device__ int warp_smem_words(const Geo& g) {
  return 3 * g.n2 + UNIT_WORDS;
}

struct WarpBufs {
  unsigned* b;     // the board
  unsigned* s1;    // scratch board
  unsigned* s2;    // scratch board
  unsigned* unit;  // UNIT_WORDS unit summaries
};

__device__ __forceinline__ WarpBufs warp_bufs(unsigned* base, const Geo& g) {
  WarpBufs w;
  w.b = base;
  w.s1 = base + g.n2;
  w.s2 = base + 2 * g.n2;
  w.unit = base + 3 * g.n2;
  return w;
}

__device__ __forceinline__ int box_of(const Geo& g, int r, int c) {
  return (r / g.bh) * g.nh + c / g.bw;
}

// Cell index of the k-th cell of unit u: rows [0, n), cols [n, 2n), boxes
// [2n, 3n) with boxes numbered row-major and cells row-major inside a box.
__device__ __forceinline__ int unit_cell(const Geo& g, int u, int k) {
  if (u < g.n) return u * g.n + k;
  if (u < 2 * g.n) return k * g.n + (u - g.n);
  const int b = u - 2 * g.n;
  const int r = (b / g.nh) * g.bh + k / g.bw;
  const int c = (b % g.nh) * g.bw + k % g.bw;
  return r * g.n + c;
}

// Bit i set: the thread's i-th cell (lane + 32 i) holds exactly one digit.
__device__ __forceinline__ unsigned single_bits(const Geo& g, const unsigned* b, int lane) {
  unsigned bits = 0;
  for (int i = 0, c = lane; c < g.n2; ++i, c += 32)
    if (__popc(b[c]) == 1) bits |= 1u << i;
  return bits;
}

// Stages 1 and 2: elimination, then hidden singles.
__device__ bool sweep_basic(const Geo& g, unsigned* b, unsigned* unit, int lane) {
  const int n = g.n;
  const unsigned pre_single = single_bits(g, b, lane);
  for (int u = lane; u < 3 * n; u += 32) {
    unsigned acc = 0;
    for (int k = 0; k < n; ++k) {
      const unsigned x = b[unit_cell(g, u, k)];
      if (__popc(x) == 1) acc |= x;
    }
    unit[u] = acc;
  }
  __syncwarp();
  bool changed = false;
  for (int i = 0, c = lane; c < g.n2; ++i, c += 32) {
    if ((pre_single >> i) & 1u) continue;
    const int r = c / n, col = c % n;
    const unsigned seen = unit[r] | unit[n + col] | unit[2 * n + box_of(g, r, col)];
    const unsigned x = b[c], nx = x & ~seen;
    if (nx != x) {
      b[c] = nx;
      changed = true;
    }
  }
  __syncwarp();
  for (int u = lane; u < 3 * n; u += 32) {
    unsigned once = 0, twice = 0;
    for (int k = 0; k < n; ++k) {
      const unsigned x = b[unit_cell(g, u, k)];
      twice |= once & x;
      once |= x;
    }
    unit[u] = once & ~twice;
  }
  __syncwarp();
  for (int i = 0, c = lane; c < g.n2; ++i, c += 32) {
    if ((pre_single >> i) & 1u) continue;
    const int r = c / n, col = c % n;
    const unsigned uniq = unit[r] | unit[n + col] | unit[2 * n + box_of(g, r, col)];
    const unsigned x = b[c], forced = x & uniq;
    if (forced != 0u && forced != x) {
      b[c] = forced;
      changed = true;
    }
  }
  __syncwarp();
  return changed;
}

__device__ __forceinline__ unsigned& view_at(unsigned* b, int n, bool tr, int r, int c) {
  return tr ? b[c * n + r] : b[r * n + c];
}

// One direction of box-line on the (possibly transposed) view of b whose
// boxes are (bh_ x bw_), nv_ x nh_ of them: seg[R][h] is the OR of row R's
// cells in box column h.
__device__ void box_line_dir(const Geo& g, unsigned* b, unsigned* seg, unsigned* unit,
                             int lane, bool tr, int bh_, int nh_, int bw_) {
  const int n = g.n;
  for (int e = lane; e < n * nh_; e += 32) {
    const int r = e / nh_, h = e % nh_;
    unsigned acc = 0;
    for (int c = 0; c < bw_; ++c) acc |= view_at(b, n, tr, r, h * bw_ + c);
    seg[e] = acc;
  }
  __syncwarp();
  // unit[v*nh_ + h]: bits of box (v, h) confined to one of its rows
  // (pointing); unit[n + r]: bits of row r confined to one box (claiming).
  for (int e = lane; e < 2 * n; e += 32) {
    unsigned once = 0, twice = 0;
    if (e < n) {
      const int v = e / nh_, h = e % nh_;
      for (int r = 0; r < bh_; ++r) {
        const unsigned x = seg[(v * bh_ + r) * nh_ + h];
        twice |= once & x;
        once |= x;
      }
    } else {
      const int r = e - n;
      for (int h = 0; h < nh_; ++h) {
        const unsigned x = seg[r * nh_ + h];
        twice |= once & x;
        once |= x;
      }
    }
    unit[e] = once & ~twice;
  }
  __syncwarp();
  for (int c = lane; c < g.n2; c += 32) {
    const int r = c / n, col = c % n;
    const int v = r / bh_, rr = r % bh_, h = col / bw_;
    unsigned kill = 0;
    for (int h2 = 0; h2 < nh_; ++h2)
      if (h2 != h) kill |= seg[r * nh_ + h2] & unit[v * nh_ + h2];
    for (int r2 = 0; r2 < bh_; ++r2) {
      if (r2 == rr) continue;
      const int row2 = v * bh_ + r2;
      kill |= seg[row2 * nh_ + h] & unit[n + row2];
    }
    view_at(b, n, tr, r, col) &= ~kill;
  }
  __syncwarp();
}

// Stage 3: box-line pointing/claiming.  `orig` keeps the stage input so
// decided cells get their own masks back at the end.
__device__ bool box_line(const Geo& g, unsigned* b, unsigned* orig, unsigned* seg,
                         unsigned* unit, int lane) {
  for (int c = lane; c < g.n2; c += 32) orig[c] = b[c];
  __syncwarp();
  box_line_dir(g, b, seg, unit, lane, false, g.bh, g.nh, g.bw);
  box_line_dir(g, b, seg, unit, lane, true, g.bw, g.nv, g.bh);
  bool changed = false;
  for (int c = lane; c < g.n2; c += 32) {
    const unsigned o = orig[c];
    if (__popc(o) == 1) {
      b[c] = o;
    } else if (b[c] != o) {
      changed = true;
    }
  }
  __syncwarp();
  return changed;
}

// Stage 4: naked subsets.  For each unit type: stat[u*n+i] says whether
// probe cell i of unit u is confined (bit 0) and overfull (bit 1); then
// each cell ORs the masks of the probes that hit it into kill.
__device__ bool naked_subsets(const Geo& g, unsigned* b, unsigned* kill, unsigned* stat,
                              int lane) {
  const int n = g.n;
  for (int c = lane; c < g.n2; c += 32) kill[c] = 0u;
  for (int t = 0; t < 3; ++t) {
    __syncwarp();
    for (int p = lane; p < g.n2; p += 32) {
      const int u = t * n + p / n, i = p % n;
      const unsigned m = b[unit_cell(g, u, i)];
      int cnt = 0;
      for (int j = 0; j < n; ++j) {
        const unsigned x = b[unit_cell(g, u, j)];
        cnt += (x != 0u && (x & ~m) == 0u) ? 1 : 0;
      }
      const int k = __popc(m);
      stat[p] = ((m != 0u && cnt >= k) ? 1u : 0u) | ((cnt > k) ? 2u : 0u);
    }
    __syncwarp();
    for (int p = lane; p < g.n2; p += 32) {
      const int u = t * n + p / n, j = p % n;
      const int cj = unit_cell(g, u, j);
      const unsigned x = b[cj];
      unsigned acc = 0;
      for (int i = 0; i < n; ++i) {
        const unsigned s = stat[(p / n) * n + i];
        if (!(s & 1u)) continue;
        const unsigned m = b[unit_cell(g, u, i)];
        const bool sub = x != 0u && (x & ~m) == 0u;
        if (!sub || (s & 2u)) acc |= m;
      }
      kill[cj] |= acc;
    }
  }
  __syncwarp();
  bool changed = false;
  for (int c = lane; c < g.n2; c += 32) {
    const unsigned x = b[c];
    if (__popc(x) == 1) continue;
    const unsigned nx = x & ~kill[c];
    if (nx != x) {
      b[c] = nx;
      changed = true;
    }
  }
  __syncwarp();
  return changed;
}

// One sweep of the rule tier (0 basic, 1 extended, 2 subsets); true iff
// the board changed.  Warp-uniform.
__device__ bool one_sweep(const Geo& g, const WarpBufs& w, int rules, int lane) {
  bool changed = sweep_basic(g, w.b, w.unit, lane);
  if (rules >= 1) changed |= box_line(g, w.b, w.s1, w.s2, w.unit, lane);
  if (rules >= 2) changed |= naked_subsets(g, w.b, w.s1, w.s2, lane);
  return __any_sync(FULL_WARP, changed);
}

// Sweep the board to its fixpoint: min(unroll, max_sweeps) sweeps without
// a check, then checked sweeps until one changes nothing or max_sweeps.
// Returns the sweeps run.
__device__ int fixpoint(const Geo& g, const WarpBufs& w, int max_sweeps, int rules,
                        int unroll, int lane) {
  int sweeps = 0;
  bool changed = true;
  const int pre = unroll < max_sweeps ? unroll : max_sweeps;
  for (; sweeps < pre; ++sweeps) changed = one_sweep(g, w, rules, lane);
  while (changed && sweeps < max_sweeps) {
    changed = one_sweep(g, w, rules, lane);
    ++sweeps;
  }
  return sweeps;
}

// ops/propagate.board_status with the duplicate test of the fused round
// (a decided digit seen twice in a unit).  Warp-uniform results.
__device__ void board_status(const Geo& g, const unsigned* b, int lane, bool* solved,
                             bool* contra) {
  bool bad = false, all_single = true;
  for (int c = lane; c < g.n2; c += 32) {
    const unsigned x = b[c];
    if (x == 0u) bad = true;
    if (__popc(x) != 1) all_single = false;
  }
  for (int u = lane; u < 3 * g.n; u += 32) {
    unsigned once = 0, twice = 0, all = 0;
    for (int k = 0; k < g.n; ++k) {
      const unsigned x = b[unit_cell(g, u, k)];
      all |= x;
      if (__popc(x) == 1) {
        twice |= once & x;
        once |= x;
      }
    }
    if (twice != 0u || all != g.full) bad = true;
  }
  bad = __any_sync(FULL_WARP, bad);
  all_single = __all_sync(FULL_WARP, all_single);
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
// pc*n^2 + cell (minrem) or cell (first); a head's key is
// q*n^2 + cell with q its quantized score.  A head first writes each
// unit's sums into `unit` (excess << 16 | und: excess <= 32*31 and
// und <= 32 fit), so each thread then scores its own cells.
__device__ int branch_cell(const Geo& g, const unsigned* b, unsigned* unit, int rule,
                           const HeadParams& hp, int lane) {
  bool use_minrem = rule == 0 || rule == 3;
  if (rule == 2) {
    int h = 0;
    for (int c = lane; c < g.n2; c += 32) h += __popc(b[c]) * (c + 1);
    for (int off = 16; off > 0; off >>= 1) h += __shfl_xor_sync(FULL_WARP, h, off);
    use_minrem = (h & 1) == 0;
  }
  const bool head = rule >= RULE_HEAD_MINREM;
  if (head) {
    for (int u = lane; u < 3 * g.n; u += 32) {
      unsigned excess = 0, und = 0;
      for (int k = 0; k < g.n; ++k) {
        const unsigned pc = __popc(b[unit_cell(g, u, k)]);
        if (pc > 1) {
          excess += pc - 1;
          ++und;
        }
      }
      unit[u] = excess << 16 | und;
    }
    __syncwarp();
  }
  int best = BIG_KEY;
  for (int c = lane; c < g.n2; c += 32) {
    const int pc = __popc(b[c]);
    if (pc > 1) {
      int key;
      if (head) {
        const int r = c / g.n, col = c % g.n;
        const unsigned w[3] = {unit[r], unit[g.n + col], unit[2 * g.n + box_of(g, r, col)]};
        int ex[3], und[3];
        for (int i = 0; i < 3; ++i) {
          ex[i] = (int)(w[i] >> 16);
          und[i] = (int)(w[i] & 0xffffu);
        }
        key = head_quant(hp, head_score(hp, rule, pc, ex, und)) * g.n2 + c;
      } else {
        key = use_minrem ? pc * g.n2 + c : c;
      }
      best = key < best ? key : best;
    }
  }
  best = __reduce_min_sync(FULL_WARP, best);
  return best == BIG_KEY ? -1 : best % g.n2;
}

__device__ __forceinline__ unsigned lowest_bit(unsigned x) { return x & (~x + 1u); }

__device__ __forceinline__ unsigned highest_bit(unsigned x) {
  return x ? (1u << (31 - __clz(x))) : 0u;
}

}  // namespace dsst
