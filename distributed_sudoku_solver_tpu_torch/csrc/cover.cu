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
//   4. branch on the MRV column (least cnt * n_primary + col over uncovered
//      columns with cnt >= 1): the guess takes its lowest available row,
//      the rest (pushed at slot (base+count)%S, or the overflow flag) only
//      excludes that row;
//   5. pop slot (base+count-1)%S on a contradiction, and on a solve in
//      count_mode.
// Taking row r clears every available row that shares a column (primary or
// secondary) with r, keeps r itself, and sets r's primary columns covered.
//
// What bounds it on an H100: integer work and its serial chain per lane.
// Each sweep counts the available rows of every uncovered primary column
// (W_r AND + popcount per column, the columns spread over the warp's
// threads), then two warp min-reductions pick the column and the row.  The
// TPU kernel turned every dynamic gather into an f32 matmul over the
// unpacked incidence and streamed rows in 1,024-row blocks to fit VMEM;
// here a column's row mask is read directly as packed words, rows are
// found with __ffs and columns with __reduce_min_sync on int keys.  The
// lane's state stays in the warp's shared memory for the whole dispatch;
// the column masks (col_rows_full, [C_full][W_r]) are staged in shared
// memory once per block when they fit, with an odd row pitch so that the
// threads of a warp, each on its own column, hit distinct banks.  The stack
// stays in device memory, lane-first [L, S, D], updated in place, one
// coalesced row copy per push or pop.  Lanes stop on their own; the
// wrapper reproduces the TPU tile's one visible effect (a dead lane's
// available-row words cleared while its tile runs on).

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;

struct Cover {
  const unsigned* cr;     // [C_full][pitch]: available-row masks of each column
  const unsigned* inc;    // [R][w_inc]: full columns of each row
  const unsigned* rcols;  // [R][w_cols]: primary columns of each row
  int pitch, w_rows, w_cols, w_inc, n_primary;
};

struct Scan {
  unsigned forced;  // lowest uncovered column with exactly one row, or NONE
  unsigned branch;  // least cnt * n_primary + col, cnt >= 1, or NONE
  bool any_unc, contra;
};

// Counts of every uncovered primary column, reduced over the warp.
__device__ Scan scan(const Cover& k, const unsigned* av, const unsigned* cov, int lane) {
  unsigned forced = NONE, branch = NONE;
  bool unc = false, contra = false;
  for (int c = lane; c < k.n_primary; c += 32) {
    if ((cov[c >> 5] >> (c & 31)) & 1u) continue;
    const unsigned* col = k.cr + (size_t)c * k.pitch;
    unsigned cnt = 0;
    for (int w = 0; w < k.w_rows; ++w) cnt += __popc(av[w] & col[w]);
    unc = true;
    if (cnt == 0) {
      contra = true;
    } else {
      if (cnt == 1 && forced == NONE) forced = (unsigned)c;  // c ascends per thread
      branch = min(branch, cnt * (unsigned)k.n_primary + (unsigned)c);
    }
  }
  Scan s;
  s.forced = __reduce_min_sync(FULL, forced);
  s.branch = __reduce_min_sync(FULL, branch);
  s.any_unc = __any_sync(FULL, unc);
  s.contra = __any_sync(FULL, contra);
  return s;
}

// Lowest available row of column col (the column has one: cnt >= 1).
__device__ int lowest_row(const Cover& k, const unsigned* av, unsigned col, int lane) {
  const unsigned* cw = k.cr + (size_t)col * k.pitch;
  unsigned best = NONE;
  for (int w = lane; w < k.w_rows; w += 32) {
    const unsigned m = av[w] & cw[w];
    if (m) {
      best = (unsigned)(w * 32 + __ffs(m) - 1);
      break;
    }
  }
  return (int)__reduce_min_sync(FULL, best);
}

// Take row r: drop every row sharing a column with it, keep r, cover r's columns.
__device__ void take_row(const Cover& k, unsigned* av, unsigned* cov, int r, int lane) {
  __syncwarp();
  const unsigned* ri = k.inc + (size_t)r * k.w_inc;
  const int rw = r >> 5;
  const unsigned rbit = 1u << (r & 31);
  for (int w = lane; w < k.w_rows; w += 32) {
    unsigned kill = 0;
    for (int iw = 0; iw < k.w_inc; ++iw) {
      unsigned bits = ri[iw];
      while (bits) {
        const int c = iw * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        kill |= k.cr[(size_t)c * k.pitch + w];
      }
    }
    if (w == rw) kill &= ~rbit;
    av[w] &= ~kill;
  }
  const unsigned* rc = k.rcols + (size_t)r * k.w_cols;
  for (int w = lane; w < k.w_cols; w += 32) cov[w] |= rc[w];
  __syncwarp();
}

__global__ void cover_kernel(const unsigned* __restrict__ top_in, unsigned* __restrict__ stack,
                             const int* __restrict__ has_in, const int* __restrict__ base_in,
                             const int* __restrict__ count_in, unsigned* __restrict__ top_out,
                             unsigned* __restrict__ sol_out, int* __restrict__ lane_out,
                             const unsigned* __restrict__ col_rows_full,
                             const unsigned* __restrict__ row_inc,
                             const unsigned* __restrict__ row_cols, int n_lanes, int S,
                             int w_rows, int w_cols, int w_inc, int n_primary, int n_cols_full,
                             int max_sweeps, int k_steps, int count_mode, int stage) {
  extern __shared__ unsigned smem[];
  const int warps = blockDim.x / 32;
  const int wib = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = w_rows + w_cols;

  Cover k;
  k.inc = row_inc;
  k.rcols = row_cols;
  k.w_rows = w_rows;
  k.w_cols = w_cols;
  k.w_inc = w_inc;
  k.n_primary = n_primary;
  if (stage) {
    // Every thread of the block takes part before any warp may leave.
    const int pitch = w_rows | 1;
    unsigned* cs = smem + warps * D;
    const int total = n_cols_full * pitch;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int c = i / pitch, w = i - c * pitch;
      cs[i] = w < w_rows ? __ldg(col_rows_full + (size_t)c * w_rows + w) : 0u;
    }
    __syncthreads();
    k.cr = cs;
    k.pitch = pitch;
  } else {
    k.cr = col_rows_full;
    k.pitch = w_rows;
  }

  const long long l = (long long)blockIdx.x * warps + wib;
  if (l >= n_lanes) return;  // the whole warp leaves together
  unsigned* state = smem + wib * D;
  unsigned* av = state;
  unsigned* cov = state + w_rows;
  const unsigned* src = top_in + l * D;
  for (int w = lane; w < D; w += 32) state[w] = src[w];
  __syncwarp();

  unsigned* my_stack = stack + (size_t)l * S * D;
  unsigned* my_sol = sol_out + (size_t)l * D;
  bool has = has_in[l] != 0;
  const int base = base_in[l];
  int count = count_in[l];
  bool solved_f = false, over_f = false;
  int nodes = 0, sols = 0, live = 0, sweeps = 0;

  for (int step = 0; has && step < k_steps; ++step) {
    ++live;
    Scan s;
    bool fresh = false;  // s describes the current state
    int sw = 0;
    while (sw < max_sweeps) {
      s = scan(k, av, cov, lane);
      ++sw;
      if (s.forced == NONE) {
        fresh = true;
        break;
      }
      take_row(k, av, cov, lowest_row(k, av, s.forced, lane), lane);
    }
    if (!fresh) s = scan(k, av, cov, lane);
    sweeps += sw;

    const bool con = s.contra;
    const bool slv = !s.any_unc;
    if (slv && !solved_f) {
      for (int w = lane; w < D; w += 32) my_sol[w] = state[w];
      solved_f = true;
    }
    if (count_mode && slv) ++sols;
    const bool undecided = !slv && !con;
    const bool can_push = undecided && count < S;
    if (undecided) {
      const int r = lowest_row(k, av, s.branch % (unsigned)n_primary, lane);
      if (can_push) {
        unsigned* dst = my_stack + (size_t)((base + count) % S) * D;
        const int rw = r >> 5;
        const unsigned rbit = 1u << (r & 31);
        for (int w = lane; w < D; w += 32) dst[w] = w == rw ? (state[w] & ~rbit) : state[w];
      }
      take_row(k, av, cov, r, lane);
      if (!can_push) over_f = true;
      ++nodes;
    }
    const bool resolved = count_mode ? (slv || con) : con;
    const bool can_pop = resolved && count > 0;
    if (can_pop) {
      const unsigned* row = my_stack + (size_t)((base + count - 1) % S) * D;
      __syncwarp();
      for (int w = lane; w < D; w += 32) state[w] = row[w];
      __syncwarp();
    }
    has = !(resolved && !can_pop) && (count_mode || !slv);
    count += (can_push ? 1 : 0) - (can_pop ? 1 : 0);
  }

  unsigned* dst = top_out + l * D;
  for (int w = lane; w < D; w += 32) dst[w] = state[w];
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
}

}  // namespace

extern "C" int dsst_cover_rounds(const void* top_in, void* stack, const void* has_in,
                                 const void* base_in, const void* count_in, void* top_out,
                                 void* sol_out, void* lane_out, const void* col_rows_full,
                                 const void* row_inc, const void* row_cols, int n_lanes, int S,
                                 int w_rows, int w_cols, int w_inc, int n_primary,
                                 int n_cols_full, int max_sweeps, int k_steps, int count_mode,
                                 int warps, int stage, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cover_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (n_lanes > 0) {
    const int grid = (n_lanes + warps - 1) / warps;
    cover_kernel<<<grid, warps * 32, smem_bytes, (cudaStream_t)stream>>>(
        (const unsigned*)top_in, (unsigned*)stack, (const int*)has_in, (const int*)base_in,
        (const int*)count_in, (unsigned*)top_out, (unsigned*)sol_out, (int*)lane_out,
        (const unsigned*)col_rows_full, (const unsigned*)row_inc, (const unsigned*)row_cols,
        n_lanes, S, w_rows, w_cols, w_inc, n_primary, n_cols_full, max_sweeps, k_steps,
        count_mode, stage);
  }
  return (int)cudaGetLastError();
}
