// K3: up to k_steps exact-cover rounds per lane, one warp per lane.
//
// Replaces the TPU kernel cover_fused_rounds
// (distributed_sudoku_solver_tpu/ops/pallas_cover.py: _cover_kernel).
//
// A lane's state is the packed cover state of models/cover.py: W_r words of
// available rows, then W_c words of covered primary columns.  Each round of
// a live lane:
//   1. propagate: per sweep, take the lowest available row of the lowest
//      uncovered primary column that has exactly one available row, until a
//      sweep takes nothing or max_sweeps sweeps ran;
//   2. classify: solved (no uncovered primary column) or contradiction (an
//      uncovered column with no available row);
//   3. capture the lane's first solution;
//   4. branch on the MRV column (least (cnt, col) over uncovered columns
//      with cnt >= 1): the guess takes its lowest available row, the rest
//      (pushed at the stack's next slot, or the overflow flag) only
//      excludes that row;
//   5. pop the stack's last slot on a contradiction, and on a solve in
//      count_mode.
// Taking row r clears every available row that shares a column (primary or
// secondary) with r, keeps r itself, and sets r's primary columns covered.
//
// What bounds it on an H100: the instructions that the SM issues for its
// resident warps, and each lane's serial chain of sweeps; the dispatch
// lasts as long as its longest warp (4,096 lanes are one wave on 132 SMs).
// The first design counted the available rows of every uncovered primary
// column at every sweep (W_r AND + popcount per column): its clock64()
// counters (chip_smoke.py --breakdown) put 33 % (n-queens 14), 70 %
// (pentomino 6x10) and 83 % (sudoku-cover 9x9) of the warp cycles in that
// count.  Counts kept with one shared atomic per (killed row, column), and
// forced sets kept by atomics, cost as much again in the take, so this
// design keeps the counts without atomics:
//
// * Column counts in the owner's registers.  Thread `lane` owns primary
//   columns lane, lane + 32, ... (W_c of them) and holds their counts, -1
//   for a covered column.  They are counted in full only when a state is
//   loaded (the dispatch's start and each pop, lazily at the next round).
//   A take publishes its dead words (the available rows it kills) in the
//   warp's shared memory, and each thread subtracts popc(dead & mask of its
//   column) over the nonzero dead words only: a few words a take, no
//   atomics, every thread busy alike.  The full count walks the nonzero row
//   words the same way.  Forced column, MRV key, contradiction and
//   "solved" then come from registers: one warp reduction per sweep, and
//   one MRV scan per round of a key that orders forced columns, then
//   contradiction, then the MRV order, (rank << cb) | col with rank 0 for
//   cnt 1, 1 for cnt 0, cnt otherwise and cb the bits of a column index.
//   The covered words are ballots of "count is -1" when a state is stored.
// * Compact row lists.  Each row's columns, ascending (primary first),
//   padded to K entries; staged in shared memory as 16-bit pairs.  An entry
//   maps to a column mask with min(e, n_cols_full), and mask n_cols_full is
//   all zero, so padding needs no branch.
// * Compile-time shape.  The kernel is a template on RW = ceil(W_r / 32),
//   the row words each thread owns (words lane, lane + 32, ...) and keeps in
//   registers, CW = W_c, and ST, whether the column masks and row lists are
//   staged in shared memory (1), read from device memory (0), or either,
//   chosen at run time (-1).  Every instance shape not in
//   DSST_FOR_EACH_COVER_SHAPE takes cover_kernel<0, 0, -1>: the same
//   source with run-time trip counts and the row words and counts in
//   shared memory, or in device memory when they do not fit
//   (ops/cuda_cover.py).
// * No run-time % on the chain: the stack's next slot is kept as an index
//   and stepped with a compare.
//
// The staged column masks have an odd row pitch, so that the threads of a
// warp, each on its own column, hit distinct banks.  The stack stays in
// device memory, lane-first [L, S, D], updated in place, one coalesced row
// copy per push or pop.  Lanes stop on their own; the wrapper reproduces
// the TPU tile's one visible effect (a dead lane's available-row words
// cleared while its tile runs on).

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;
constexpr int MAX_WARPS = 8;  // lanes per block, at most

// The (RW, CW, ST) shapes with a compile-time instantiation: n-queens up to
// 16 (1, 1) and 17-32 (1, 2, with sudoku-cover 4x4), sudoku-cover 9x9
// (1, 11), pentomino 3x20 (2, 3) and 6x10 (3, 3), all staged, and
// sudoku-cover 16x16 (4, 32), whose column masks do not fit in shared memory.
#define DSST_FOR_EACH_COVER_SHAPE(X) \
  X(1, 1, 1) X(1, 2, 1) X(1, 11, 1) X(2, 3, 1) X(3, 3, 1) X(4, 32, 0)

// Blocks of MAX_WARPS warps an SM must hold, for __launch_bounds__: 4 (64
// registers a thread) keep 4,096 lanes in one wave; CW = 32 (sudoku-cover
// 16x16, off the enumeration path) holds 32 counts in registers and takes
// 1 (up to 255 registers; at 128 it spilled).
template <int CW>
struct Occupancy {
  static constexpr int MIN_BLOCKS = CW > 16 ? 1 : 4;
};

// Per-stage clock counters of the counter build (-DDSST_STAGE_CLOCKS, a
// library of its own name; ops/cuda_build.py).  Each warp adds the
// clock64() cycles it spends in each stage into registers; at its end lane
// 0 adds them into dsst_cover_cycles (one atomic per stage) and raises
// dsst_cover_cycles[N_STAGES] to its own total if that is larger (the
// longest warp, which the dispatch waits for).  ST_TOTAL is the warp's
// whole run, so "other" (output stores, loop control) is ST_TOTAL less the
// others.  Without the define the struct is empty and every call compiles
// away.
enum Stage { ST_LOAD, ST_COUNT, ST_SEARCH, ST_LOWEST, ST_TAKE, ST_CLASSIFY, ST_PUSHPOP,
             ST_TOTAL, N_STAGES };
}  // namespace

#ifdef DSST_STAGE_CLOCKS
__device__ unsigned long long dsst_cover_cycles[N_STAGES + 1];

namespace {
struct StageClock {
  long long acc[N_STAGES], start, t0;
  __device__ StageClock() {
    for (int i = 0; i < N_STAGES; ++i) acc[i] = 0;
    start = t0 = clock64();
  }
  __device__ __forceinline__ void stop(int s) {
    const long long t = clock64();
    acc[s] += t - t0;
    t0 = t;
  }
  __device__ void flush(int lane) {
    acc[ST_TOTAL] = clock64() - start;
    if (lane == 0) {
      for (int i = 0; i < N_STAGES; ++i)
        atomicAdd(&dsst_cover_cycles[i], (unsigned long long)acc[i]);
      atomicMax(&dsst_cover_cycles[N_STAGES], (unsigned long long)acc[ST_TOTAL]);
    }
  }
};
#else
namespace {
struct StageClock {
  __device__ __forceinline__ void stop(int) {}
  __device__ __forceinline__ void flush(int) {}
};
#endif

// A thread's values lane + 32*i, i < N, in registers; Vals<T, 0> holds them
// in memory at a stride of 32 (the run-time instantiation).
template <class T, int N>
struct Vals {
  T v[N];
  __device__ __forceinline__ T& operator[](int i) { return v[i]; }
};
template <class T>
struct Vals<T, 0> {
  T* p;  // &values[lane]
  __device__ __forceinline__ T& operator[](int i) { return p[32 * i]; }
};

// Trip counts per thread: row words, and primary columns (= covered words).
template <int RW, int CW>
struct Per {
  static constexpr int rows = RW, cols = CW;
  __device__ Per(int, int) {}
};
template <>
struct Per<0, 0> {
  int rows, cols;
  __device__ Per(int w_rows, int w_cols) : rows((w_rows + 31) / 32), cols(w_cols) {}
};

// The instance's constants as the kernel reads them.
template <int ST>
struct Inst {
  const unsigned* cr;  // [C_full + 1][pitch]: available-row masks of each column, then 0
  const int* rl;       // [32 W_r][K] row lists in device memory (-1 padded)
  const unsigned* rs;  // [32 W_r][K / 2] staged row lists, 16-bit pairs (0xffff padded)
  int pitch, k, w_rows, w_cols, np, ncf, cb;
  bool staged;  // read when ST == -1

  __device__ __forceinline__ bool in_smem() const { return ST == 1 || (ST == -1 && staged); }
  // Entry t of row r's list (>= n_cols_full for padding).
  __device__ __forceinline__ unsigned entry(int r, int t) const {
    if (in_smem()) return (rs[r * (k >> 1) + (t >> 1)] >> ((t & 1) * 16)) & 0xffffu;
    return (unsigned)__ldg(rl + (size_t)r * k + t);
  }
  __device__ __forceinline__ unsigned mask(unsigned c, int w) const {
    if (in_smem()) return cr[c * pitch + w];
    return __ldg(cr + (size_t)c * pitch + w);
  }
};

template <int RW, int CW, int ST>
struct Lane {
  const Inst<ST> k;
  const Per<RW, CW> per;
  const int lane;
  unsigned* xw;           // W_r words of the warp: row words to count, or a take's dead words
  Vals<unsigned, RW> av;  // this thread's row words
  Vals<int, CW> cnt;      // this thread's columns' counts, -1 for covered

  // ws: the exchange words; priv (run-time shape only): the row words,
  // then the counts of own column j of thread t at 32 j + t.
  __device__ Lane(const Inst<ST>& inst, int l, unsigned* ws, unsigned* priv)
      : k(inst), per(inst.w_rows, inst.w_cols), lane(l), xw(ws) {
    if constexpr (RW == 0) {
      av.p = priv + lane;
      cnt.p = (int*)(priv + inst.w_rows) + lane;
    }
  }

  // The row words of a state; its covered words are read by full_count.
  __device__ __forceinline__ void load(const unsigned* src) {
#pragma unroll
    for (int i = 0; i < per.rows; ++i) {
      const int w = lane + 32 * i;
      if (w < k.w_rows) {
        av[i] = src[w];
      } else if constexpr (RW > 0) {
        av[i] = 0u;
      }
    }
  }

  // The state, row excl (if >= 0) excluded; covered words from the counts.
  __device__ __forceinline__ void store(unsigned* dst, int excl) {
#pragma unroll
    for (int i = 0; i < per.rows; ++i) {
      const int w = lane + 32 * i;
      if (w < k.w_rows) dst[w] = w == (excl >> 5) ? av[i] & ~(1u << (excl & 31)) : av[i];
    }
#pragma unroll
    for (int j = 0; j < per.cols; ++j) {
      const unsigned word = __ballot_sync(FULL, lane + 32 * j < k.np && cnt[j] < 0);
      if ((j & 31) == lane) dst[k.w_rows + j] = word;
    }
  }

  // Publish this thread's word i in the exchange words; the ballot of the
  // nonzero ones (warp-uniform).
  __device__ __forceinline__ unsigned publish(int i, unsigned word) {
    const int w = lane + 32 * i;
    if (w < k.w_rows) xw[w] = word;
    return __ballot_sync(FULL, w < k.w_rows && word != 0u);
  }

  // Over the exchange words v = 32 i + t of each set bit t of nz: each own
  // column's count moves by sign * popc(xw[v] & its mask), for counts of at
  // least `floor` (covered columns stay -1; a count of 0 loses no row).
  __device__ __forceinline__ void accumulate(int i, unsigned nz, int sign, int floor) {
    for (unsigned m = nz; m; m &= m - 1) {
      const int v = 32 * i + __ffs(m) - 1;
      const unsigned x = xw[v];
#pragma unroll
      for (int j = 0; j < per.cols; ++j)
        if (cnt[j] >= floor) cnt[j] += sign * __popc(x & k.mask((unsigned)(lane + 32 * j), v));
    }
  }

  // Every own column's count from scratch, for the state loaded from src:
  // -1 if covered (or past n_primary), else its available rows.
  __device__ __forceinline__ void full_count(const unsigned* src) {
#pragma unroll
    for (int j = 0; j < per.cols; ++j)
      cnt[j] = lane + 32 * j < k.np && !((src[k.w_rows + j] >> lane) & 1u) ? 0 : -1;
    if constexpr (RW > 0) {
      unsigned nz[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) nz[i] = publish(i, av[i]);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < RW; ++i) accumulate(i, nz[i], 1, 0);
    } else {
      for (int i = 0; i < per.rows; ++i) {
        const unsigned nz = publish(i, lane + 32 * i < k.w_rows ? av[i] : 0u);
        __syncwarp();
        accumulate(i, nz, 1, 0);
      }
    }
    __syncwarp();
  }

  // The lowest forced column (uncovered, one available row), or NONE.
  __device__ __forceinline__ unsigned forced() {
    unsigned best = NONE;
#pragma unroll
    for (int j = per.cols - 1; j >= 0; --j)
      if (cnt[j] == 1) best = (unsigned)(lane + 32 * j);
    return __reduce_min_sync(FULL, best);
  }

  // The least key over uncovered columns (NONE if every column is
  // covered); *contra is this thread's "an uncovered column has no row".
  __device__ __forceinline__ unsigned scan(bool* contra) {
    unsigned best = NONE;
    bool z = false;
#pragma unroll
    for (int j = 0; j < per.cols; ++j) {
      const int v = cnt[j];
      if (v < 0) continue;
      const unsigned rank = v <= 1 ? 1u - (unsigned)v : (unsigned)v;
      best = min(best, (rank << k.cb) | (unsigned)(lane + 32 * j));
      z |= v == 0;
    }
    *contra = z;
    return __reduce_min_sync(FULL, best);
  }

  // Lowest available row of column col (the column has one).
  __device__ __forceinline__ int lowest_row(unsigned col) {
    unsigned best = NONE;
#pragma unroll
    for (int i = per.rows - 1; i >= 0; --i) {
      const int w = lane + 32 * i;
      if (w >= k.w_rows) continue;
      const unsigned m = av[i] & k.mask(col, w);
      if (m) best = (unsigned)(w * 32 + __ffs(m) - 1);
    }
    return (int)__reduce_min_sync(FULL, best);
  }

  // Row word w's kill mask for a take of row r: the OR of r's column
  // masks, r itself kept.
  __device__ __forceinline__ unsigned kill_word(int r, int w) {
    const unsigned ncf = (unsigned)k.ncf;
    unsigned kill = 0;
    for (int t0 = 0; t0 < k.k; t0 += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        kill |= k.mask(t0 + u < k.k ? min(k.entry(r, t0 + u), ncf) : ncf, w);
    }
    return w == (r >> 5) ? kill & ~(1u << (r & 31)) : kill;
  }

  // Take row r: drop every available row that shares a column with it
  // (each own column's count falls by its killed rows), keep r, cover r's
  // primary columns.
  __device__ __forceinline__ void take(int r) {
    if constexpr (RW > 0) {
      unsigned nz[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int w = lane + 32 * i;
        const unsigned kill = kill_word(r, w < k.w_rows ? w : 0);
        const unsigned dead = av[i] & kill;  // 0 for padding words
        av[i] &= ~kill;
        nz[i] = publish(i, dead);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < RW; ++i) accumulate(i, nz[i], -1, 1);
    } else {
      for (int i = 0; i < per.rows; ++i) {
        const int w = lane + 32 * i;
        unsigned dead = 0;
        if (w < k.w_rows) {
          const unsigned kill = kill_word(r, w);
          dead = av[i] & kill;
          av[i] &= ~kill;
        }
        const unsigned nz = publish(i, dead);
        __syncwarp();
        accumulate(i, nz, -1, 1);
      }
    }
    // Cover r's primary columns that this thread owns.  A compiled shape
    // gathers them as a bitmask and applies it with selects: an indexed
    // store (cnt[c >> 5] = -1, or its compare chain, which the compiler
    // folds back into one) would move the counts to local memory.
    unsigned own = 0;
    for (int t = 0; t < k.k; ++t) {
      const unsigned c = k.entry(r, t);
      if (c >= (unsigned)k.np || (c & 31) != (unsigned)lane) continue;
      if constexpr (RW > 0) {
        own |= 1u << (c >> 5);  // c >> 5 < CW <= 32
      } else {
        cnt[c >> 5] = -1;
      }
    }
    if constexpr (RW > 0) {
#pragma unroll
      for (int j = 0; j < CW; ++j) cnt[j] = (own >> j) & 1u ? -1 : cnt[j];
    }
    __syncwarp();
  }
};

template <int RW, int CW, int ST>
__global__ void __launch_bounds__(MAX_WARPS * 32, Occupancy<CW>::MIN_BLOCKS)
cover_kernel(const unsigned* __restrict__ top_in, unsigned* __restrict__ stack,
             const int* __restrict__ has_in, const int* __restrict__ base_in,
             const int* __restrict__ count_in, unsigned* __restrict__ top_out,
             unsigned* __restrict__ sol_out, int* __restrict__ lane_out,
             const unsigned* __restrict__ col_rows_full, const int* __restrict__ row_list,
             int* __restrict__ scratch, int n_lanes, int S, int w_rows, int w_cols,
             int n_primary, int n_cols_full, int kl, int max_sweeps, int k_steps,
             int count_mode, int stage) {
  extern __shared__ unsigned smem[];
  const int warps = blockDim.x / 32;
  const int wib = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = w_rows + w_cols;
  // Per lane in shared memory: the exchange words (W_r) and, for the
  // run-time shape, its private block (the row words, then 32 W_c counts)
  // unless that lives in device memory.
  const int priv_words = w_rows + 32 * w_cols;
  const bool shared_priv = RW > 0 || scratch == nullptr;
  const int lane_words = w_rows + (RW == 0 && shared_priv ? priv_words : 0);

  Inst<ST> k;
  k.rl = row_list;
  k.k = kl;
  k.w_rows = w_rows;
  k.w_cols = w_cols;
  k.np = n_primary;
  k.ncf = n_cols_full;
  k.cb = 32 - __clz(n_primary - 1);  // bits of a column index (0 for one column)
  k.staged = ST == 1 || (ST == -1 && stage);
  if (k.staged) {
    // Column masks (and the zero mask after them), then the row lists as
    // 16-bit pairs.  Every thread of the block takes part before any warp
    // may leave.
    const int pitch = w_rows | 1;
    unsigned* cs = smem + warps * lane_words;
    const int total = (n_cols_full + 1) * pitch;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int c = i / pitch, w = i - c * pitch;
      cs[i] = w < w_rows ? __ldg(col_rows_full + (size_t)c * w_rows + w) : 0u;
    }
    unsigned* ls = cs + total;
    const int pairs = w_rows * 16 * kl;  // 32 W_r rows of kl entries, two a word
    for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
      const unsigned lo = (unsigned)__ldg(row_list + 2 * i) & 0xffffu;
      const unsigned hi = (unsigned)__ldg(row_list + 2 * i + 1) & 0xffffu;
      ls[i] = lo | (hi << 16);
    }
    __syncthreads();
    k.cr = cs;
    k.pitch = pitch;
    k.rs = ls;
  } else {
    k.cr = col_rows_full;
    k.pitch = w_rows;
    k.rs = nullptr;
  }

  const long long l = (long long)blockIdx.x * warps + wib;
  if (l >= n_lanes) return;  // the whole warp leaves together
  StageClock clk;
  unsigned* ws = smem + wib * lane_words;
  unsigned* priv = shared_priv ? ws + w_rows : (unsigned*)scratch + l * priv_words;
  Lane<RW, CW, ST> s(k, lane, ws, priv);
  const unsigned* loaded = top_in + l * D;  // the state last loaded
  s.load(loaded);

  unsigned* my_stack = stack + (size_t)l * S * D;
  unsigned* my_sol = sol_out + (size_t)l * D;
  bool has = has_in[l] != 0;
  int count = count_in[l];
  int slot = (base_in[l] + count) % S;  // the next push's slot, stepped below
  bool solved_f = false, over_f = false, stale = true;
  int nodes = 0, sols = 0, live = 0, sweeps = 0;
  const unsigned cmask = (1u << k.cb) - 1u;
  clk.stop(ST_LOAD);

  for (int step = 0; has && step < k_steps; ++step) {
    ++live;
    if (stale) {
      s.full_count(loaded);
      stale = false;
      clk.stop(ST_COUNT);
    }
    int sw = 0;
    while (sw < max_sweeps) {
      const unsigned f = s.forced();
      ++sw;
      clk.stop(ST_SEARCH);
      if (f == NONE) break;
      const int r = s.lowest_row(f);
      clk.stop(ST_LOWEST);
      s.take(r);
      clk.stop(ST_TAKE);
    }
    sweeps += sw;
    bool contra;
    const unsigned m = s.scan(&contra);
    // A forced column left by the cap hides a contradiction from the key.
    const bool forced_left = (m >> k.cb) == 0u;
    const bool con = forced_left ? __any_sync(FULL, contra) : (m != NONE && (m >> k.cb) == 1u);
    clk.stop(ST_SEARCH);
    const bool slv = m == NONE;
    if (slv && !solved_f) {
      s.store(my_sol, -1);
      solved_f = true;
    }
    clk.stop(ST_CLASSIFY);
    if (count_mode && slv) ++sols;
    const bool undecided = !slv && !con;
    const bool can_push = undecided && count < S;
    if (undecided) {
      const int r = s.lowest_row(m & cmask);
      clk.stop(ST_LOWEST);
      if (can_push) {
        s.store(my_stack + (size_t)slot * D, r);
        slot = slot + 1 == S ? 0 : slot + 1;
      }
      clk.stop(ST_PUSHPOP);
      s.take(r);
      clk.stop(ST_TAKE);
      if (!can_push) over_f = true;
      ++nodes;
    }
    const bool resolved = count_mode ? (slv || con) : con;
    const bool can_pop = resolved && count > 0;
    if (can_pop) {
      slot = slot == 0 ? S - 1 : slot - 1;
      loaded = my_stack + (size_t)slot * D;
      __syncwarp();
      s.load(loaded);
      stale = true;
      clk.stop(ST_PUSHPOP);
    }
    has = !(resolved && !can_pop) && (count_mode || !slv);
    count += (can_push ? 1 : 0) - (can_pop ? 1 : 0);
  }

  unsigned* dst = top_out + l * D;
  if (stale) {  // no count since the last load: the state is still in memory
    for (int w = lane; w < D; w += 32) dst[w] = loaded[w];
  } else {
    s.store(dst, -1);
  }
  if (!solved_f)
    for (int w = lane; w < D; w += 32) my_sol[w] = 0u;
  if (lane == 0) {
    // lane_out rows: has, count, solved, overflow, nodes, sols, live, sweeps
    lane_out[0 * (long long)n_lanes + l] = has ? 1 : 0;
    lane_out[1 * (long long)n_lanes + l] = count;
    lane_out[2 * (long long)n_lanes + l] = solved_f ? 1 : 0;
    lane_out[3 * (long long)n_lanes + l] = over_f ? 1 : 0;
    lane_out[4 * (long long)n_lanes + l] = nodes;
    lane_out[5 * (long long)n_lanes + l] = sols;
    lane_out[6 * (long long)n_lanes + l] = live;
    lane_out[7 * (long long)n_lanes + l] = sweeps;
  }
  clk.flush(lane);
}

template <int RW, int CW, int ST>
int launch_cover(const void* top_in, void* stack, const void* has_in, const void* base_in,
                 const void* count_in, void* top_out, void* sol_out, void* lane_out,
                 const void* col_rows_full, const void* row_list, void* scratch, int n_lanes,
                 int S, int w_rows, int w_cols, int n_primary, int n_cols_full, int kl,
                 int max_sweeps, int k_steps, int count_mode, int warps, int stage,
                 int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cover_kernel<RW, CW, ST>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (n_lanes > 0) {
    const int grid = (n_lanes + warps - 1) / warps;
    cover_kernel<RW, CW, ST><<<grid, warps * 32, smem_bytes, (cudaStream_t)stream>>>(
        (const unsigned*)top_in, (unsigned*)stack, (const int*)has_in, (const int*)base_in,
        (const int*)count_in, (unsigned*)top_out, (unsigned*)sol_out, (int*)lane_out,
        (const unsigned*)col_rows_full, (const int*)row_list, (int*)scratch, n_lanes, S,
        w_rows, w_cols, n_primary, n_cols_full, kl, max_sweeps, k_steps, count_mode, stage);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// col_rows_full: int32 [C_full + 1][W_r], the last row 0; row_list: int32
// [32 * W_r][kl], kl even, -1 padded; scratch: int32 [n_lanes][w_rows + 32 *
// w_cols], the run-time shape's row words and counts in device memory, or
// null (the only choice of a compiled shape).
extern "C" int dsst_cover_rounds(const void* top_in, void* stack, const void* has_in,
                                 const void* base_in, const void* count_in, void* top_out,
                                 void* sol_out, void* lane_out, const void* col_rows_full,
                                 const void* row_list, void* scratch, int n_lanes, int S,
                                 int w_rows, int w_cols, int n_primary, int n_cols_full, int kl,
                                 int max_sweeps, int k_steps, int count_mode, int warps,
                                 int stage, int smem_bytes, void* stream) {
  const int rw = (w_rows + 31) / 32;
#define DSST_LAUNCH(RW, CW, ST)                                                              \
  if (rw == RW && w_cols == CW && stage == ST && scratch == nullptr)                         \
    return launch_cover<RW, CW, ST>(top_in, stack, has_in, base_in, count_in, top_out,       \
                                    sol_out, lane_out, col_rows_full, row_list, scratch,    \
                                    n_lanes, S, w_rows, w_cols, n_primary, n_cols_full, kl, \
                                    max_sweeps, k_steps, count_mode, warps, stage,          \
                                    smem_bytes, stream);
  DSST_FOR_EACH_COVER_SHAPE(DSST_LAUNCH)
#undef DSST_LAUNCH
  return launch_cover<0, 0, -1>(top_in, stack, has_in, base_in, count_in, top_out, sol_out,
                                lane_out, col_rows_full, row_list, scratch, n_lanes, S,
                                w_rows, w_cols, n_primary, n_cols_full, kl, max_sweeps,
                                k_steps, count_mode, warps, stage, smem_bytes, stream);
}

#ifdef DSST_STAGE_CLOCKS
// The counter build's cycles per stage and the longest warp's total
// (N_STAGES + 1 words) into host memory, then zeroed.  Synchronous: call
// after the timed launches have finished.
extern "C" int dsst_stage_cycles_take(void* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, dsst_cover_cycles, sizeof(dsst_cover_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[N_STAGES + 1] = {};
  return (int)cudaMemcpyToSymbol(dsst_cover_cycles, zero, sizeof(zero));
}
#endif
