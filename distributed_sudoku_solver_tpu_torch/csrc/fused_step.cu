// K2: up to k_steps whole frontier rounds per lane, one warp per lane.
//
// Replaces the TPU kernel fused_rounds
// (distributed_sudoku_solver_tpu/ops/pallas_step.py: _fused_kernel with
// status_full, branch_onehot_full, _select_slot, _write_slot and
// _branch_dispatch_full, with _head_branch_full and each head's score_full
// from ops/ordering.py for the head:* scored branch rules).
//
// Each round of a live lane: sweep the top to its fixpoint, classify it,
// capture the lane's first solution, pick the branch cell (warp argmin of
// the unique key), push the rest child at stack slot (base+count)%S and
// keep the guess as the top, or pop slot (base+count-1)%S on a
// contradiction (and on a solve in count_mode), and flag an overflow when
// the stack is full.  A head:* rule scores each undecided cell from the
// unit sums of the round's status walk (branch_cell in fixpoint.cuh) and
// packs the score into the same unique int32 key that the warp argmin
// takes; its f32 arithmetic is rounded op by op as the plain torch version
// rounds it.
//
// What bounds it on an H100: the integer and shared-memory work of the
// sweeps and the serial chain of rounds and sweeps per lane; device
// memory moves one board per push or pop.  The per-stage clock counters
// (the counter build, -DDSST_STAGE_CLOCKS; chip_smoke.py --breakdown), on
// a design that read the geometry at run time and kept the board in
// shared memory, put 86 % of the warp cycles at the bulk pass's shape in
// the sweeps (elimination 25 %, hidden singles 24 %, box-line 38 %), spent
// on index arithmetic with run-time divisions, three divergent unit-type
// paths and shared-memory round trips.  This design (fixpoint.cuh)
// instantiates the code per box shape, keeps each lane's row segments in
// registers for the whole dispatch and walks every unit with the same
// strided loop: 12x fewer warp cycles at that shape, of which the sweeps
// take 74 % (box-line 42 %: two directions of dependent phases, each
// ending in __syncwarp), the status walk 6 %, branch 6 % and push and pop
// 6 %.  The top never leaves registers across rounds; the stack stays in
// device memory, lane-first [L, S, n, n], updated in place, each segment a
// contiguous run, so a push or pop is one coalesced row copy across the
// warp.  Lanes converge and stop on their own: the TPU kernel's
// cell-uniform [n, n, T] counters, static-S slot trees and boards-last
// layout were workarounds for the TPU's vector compiler.  The wrapper
// reproduces the one observable effect of the TPU's 128-lane tiles (a
// dead lane's top is cleared while its tile runs on).

#include "fixpoint.cuh"

using namespace dsst;

template <int BH, int BW>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32, Occupancy<Geo<BH, BW>, true>::MIN_BLOCKS)
fused_kernel(const unsigned* __restrict__ top_in, unsigned* __restrict__ stack,
             const int* __restrict__ has_in, const int* __restrict__ base_in,
             const int* __restrict__ count_in, unsigned* __restrict__ top_out,
             unsigned* __restrict__ sol_out, int* __restrict__ lane_out, int n_lanes, int S,
             int box_h, int box_w, int rules, int rule, int max_sweeps, int k_steps,
             int count_mode, int unroll, const __grid_constant__ HeadParams hp) {
  using G = Geo<BH, BW>;
  extern __shared__ unsigned smem[];
  const G g(box_h, box_w);
  const int wib = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long l = (long long)blockIdx.x * WARPS_PER_BLOCK + wib;
  if (l >= n_lanes) return;  // the whole warp leaves together
  StageClock clk;
  const Warp<G> w(g, lane, smem + wib * warp_smem_words(g));
  const int n2 = g.n2;
  Cells<G> x;
  load_cells(w, x, top_in + l * n2);

  unsigned* my_stack = stack + (size_t)l * S * n2;
  unsigned* my_sol = sol_out + (size_t)l * n2;
  bool has = has_in[l] != 0;
  const int base = base_in[l];
  int count = count_in[l];
  bool solved_f = false, over_f = false;
  int nodes = 0, sols = 0, live = 0, sweeps = 0;
  const bool pick_low = rule != 3;
  const bool head = rule >= RULE_HEAD_MINREM;

  for (int step = 0; has && step < k_steps; ++step) {
    ++live;
    sweeps += fixpoint(w, x, max_sweeps, rules, unroll, clk);
    bool slv, con;
    clk.mark();
    board_status(w, x, head, &slv, &con);
    clk.stop(ST_STATUS);
    if (slv && !solved_f) {
      store_cells(w, x, my_sol);
      solved_f = true;
    }
    clk.stop(ST_PUSHPOP);
    if (count_mode && slv) ++sols;
    const bool undecided = !slv && !con;
    const bool can_push = undecided && count < S;
    if (undecided) {
      const int cell = branch_cell(w, x, rule, hp);
      unsigned xv = 0;
#pragma unroll
      for (int i = 0; i < G::MAXC; ++i)
        if (w.owns(i) && w.pos(i).c == cell) xv = x[i];
      xv = __reduce_or_sync(FULL_WARP, xv);
      const unsigned pick = pick_low ? lowest_bit(xv) : highest_bit(xv);
      clk.stop(ST_BRANCH);
      unsigned* dst = my_stack + (size_t)((base + count) % S) * n2;
#pragma unroll
      for (int i = 0; i < G::MAXC; ++i) {
        if (!w.owns(i)) continue;
        const int c = w.pos(i).c;
        if (can_push) dst[c] = c == cell ? (x[i] & ~pick) : x[i];
        if (c == cell) x[i] = pick;
      }
      if (!can_push) over_f = true;
      ++nodes;
      clk.stop(ST_PUSHPOP);
    }
    const bool resolved = count_mode ? (slv || con) : con;
    const bool can_pop = resolved && count > 0;
    if (can_pop) {
      load_cells(w, x, my_stack + (size_t)((base + count - 1) % S) * n2);
      clk.stop(ST_PUSHPOP);
    }
    has = !(resolved && !can_pop) && (count_mode || !slv);
    count += (can_push ? 1 : 0) - (can_pop ? 1 : 0);
  }

  store_cells(w, x, top_out + l * n2);
  if (!solved_f) {
    Cells<G> zero;
#pragma unroll
    for (int i = 0; i < G::MAXC; ++i) zero[i] = 0u;
    store_cells(w, zero, my_sol);
  }
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

// -- host side -------------------------------------------------------------------

template <int BH, int BW>
static int launch_fused(const void* top_in, void* stack, const void* has_in,
                        const void* base_in, const void* count_in, void* top_out,
                        void* sol_out, void* lane_out, int n_lanes, int S, int box_h,
                        int box_w, int rules, int rule, int max_sweeps, int k_steps,
                        int count_mode, int unroll, const HeadParams& hp, void* stream) {
  const int smem = WARPS_PER_BLOCK * warp_smem_words(Geo<BH, BW>(box_h, box_w)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<BH, BW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_lanes > 0) {
    const int grid = (n_lanes + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    fused_kernel<BH, BW><<<grid, WARPS_PER_BLOCK * 32, smem, (cudaStream_t)stream>>>(
        (const unsigned*)top_in, (unsigned*)stack, (const int*)has_in, (const int*)base_in,
        (const int*)count_in, (unsigned*)top_out, (unsigned*)sol_out, (int*)lane_out,
        n_lanes, S, box_h, box_w, rules, rule, max_sweeps, k_steps, count_mode, unroll, hp);
  }
  return (int)cudaGetLastError();
}

extern "C" int dsst_fused_rounds(const void* top_in, void* stack, const void* has_in,
                                 const void* base_in, const void* count_in, void* top_out,
                                 void* sol_out, void* lane_out, int n_lanes, int S,
                                 int box_h, int box_w, int rules, int rule, int max_sweeps,
                                 int k_steps, int count_mode, int unroll, const void* head,
                                 void* stream) {
  if (box_h * box_w > 32 || cells_per_lane(box_h, box_w) > Geo<0, 0>::MAXC)
    return (int)cudaErrorInvalidValue;
  // head: a HeadParams image for the head:* rules, NULL for the legacy ones.
  HeadParams hp = {};
  if (head != nullptr) hp = *(const HeadParams*)head;
#define DSST_LAUNCH(BH, BW)                                                                  \
  if (box_h == BH && box_w == BW)                                                            \
    return launch_fused<BH, BW>(top_in, stack, has_in, base_in, count_in, top_out, sol_out, \
                                lane_out, n_lanes, S, box_h, box_w, rules, rule, max_sweeps, \
                                k_steps, count_mode, unroll, hp, stream);
  DSST_FOR_EACH_GEOMETRY(DSST_LAUNCH)
#undef DSST_LAUNCH
  return launch_fused<0, 0>(top_in, stack, has_in, base_in, count_in, top_out, sol_out,
                            lane_out, n_lanes, S, box_h, box_w, rules, rule, max_sweeps,
                            k_steps, count_mode, unroll, hp, stream);
}

#ifdef DSST_STAGE_CLOCKS
// The counter build's cycles per stage (N_STAGES words) into host memory,
// then zeroed.  Synchronous: call after the timed launches have finished.
extern "C" int dsst_stage_cycles_take(void* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, dsst_stage_cycles, sizeof(dsst_stage_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[N_STAGES] = {};
  return (int)cudaMemcpyToSymbol(dsst_stage_cycles, zero, sizeof(zero));
}
#endif
