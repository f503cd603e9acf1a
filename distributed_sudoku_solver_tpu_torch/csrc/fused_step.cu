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
// the stack is full.  A head:* rule scores each undecided cell from its
// unit sums (branch_cell in fixpoint.cuh) and packs the score into the
// same unique int32 key that the warp argmin takes; its f32 arithmetic is
// rounded op by op as the plain torch version rounds it.
//
// What bounds it on an H100: the fixpoint's shared-memory and integer
// work, and the serial chain of rounds and sweeps per lane; the device
// memory traffic is one board per push or pop.  The design keeps the top
// in the warp's shared memory across all rounds of a dispatch and the
// per-lane counters in registers; the stack stays in device memory,
// lane-first [L, S, n, n], and is updated in place, one coalesced row
// copy across the warp per push or pop, so a dispatch moves rows only
// where the search does.  Lanes converge and stop on their own: the TPU
// kernel's cell-uniform [n, n, T] counters, static-S slot trees and
// boards-last layout were workarounds for the TPU's vector compiler.
// The wrapper reproduces the one observable effect of the TPU's 128-lane
// tiles (a dead lane's top is cleared while its tile runs on).

#include "fixpoint.cuh"

using namespace dsst;

__global__ void fused_kernel(const unsigned* __restrict__ top_in, unsigned* __restrict__ stack,
                             const int* __restrict__ has_in, const int* __restrict__ base_in,
                             const int* __restrict__ count_in, unsigned* __restrict__ top_out,
                             unsigned* __restrict__ sol_out, int* __restrict__ lane_out,
                             int n_lanes, int S, Geo g, int rules, int rule,
                             int max_sweeps, int k_steps, int count_mode, int unroll,
                             const __grid_constant__ HeadParams hp) {
  extern __shared__ unsigned smem[];
  const int wib = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long l = (long long)blockIdx.x * WARPS_PER_BLOCK + wib;
  if (l >= n_lanes) return;  // the whole warp leaves together
  const WarpBufs w = warp_bufs(smem + wib * warp_smem_words(g), g);
  const int n2 = g.n2;
  const unsigned* src = top_in + l * n2;
  for (int c = lane; c < n2; c += 32) w.b[c] = src[c];
  __syncwarp();

  unsigned* my_stack = stack + (size_t)l * S * n2;
  unsigned* my_sol = sol_out + (size_t)l * n2;
  bool has = has_in[l] != 0;
  const int base = base_in[l];
  int count = count_in[l];
  bool solved_f = false, over_f = false;
  int nodes = 0, sols = 0, live = 0, sweeps = 0;
  const bool pick_low = rule != 3;

  for (int step = 0; has && step < k_steps; ++step) {
    ++live;
    sweeps += fixpoint(g, w, max_sweeps, rules, unroll, lane);
    bool slv, con;
    board_status(g, w.b, lane, &slv, &con);
    if (slv && !solved_f) {
      for (int c = lane; c < n2; c += 32) my_sol[c] = w.b[c];
      solved_f = true;
    }
    if (count_mode && slv) ++sols;
    const bool undecided = !slv && !con;
    const bool can_push = undecided && count < S;
    if (undecided) {
      const int cell = branch_cell(g, w.b, w.unit, rule, hp, lane);
      const unsigned x = cell >= 0 ? w.b[cell] : 0u;
      const unsigned pick = pick_low ? lowest_bit(x) : highest_bit(x);
      if (can_push) {
        unsigned* dst = my_stack + (size_t)((base + count) % S) * n2;
        for (int c = lane; c < n2; c += 32) dst[c] = c == cell ? (x & ~pick) : w.b[c];
      }
      __syncwarp();
      if (lane == 0 && cell >= 0) w.b[cell] = pick;
      __syncwarp();
      if (!can_push) over_f = true;
      ++nodes;
    }
    const bool resolved = count_mode ? (slv || con) : con;
    const bool can_pop = resolved && count > 0;
    if (can_pop) {
      const unsigned* row = my_stack + (size_t)((base + count - 1) % S) * n2;
      for (int c = lane; c < n2; c += 32) w.b[c] = row[c];
      __syncwarp();
    }
    has = !(resolved && !can_pop) && (count_mode || !slv);
    count += (can_push ? 1 : 0) - (can_pop ? 1 : 0);
  }

  unsigned* dst = top_out + l * n2;
  for (int c = lane; c < n2; c += 32) dst[c] = w.b[c];
  if (!solved_f)
    for (int c = lane; c < n2; c += 32) my_sol[c] = 0u;
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

extern "C" int dsst_fused_rounds(const void* top_in, void* stack, const void* has_in,
                                 const void* base_in, const void* count_in, void* top_out,
                                 void* sol_out, void* lane_out, int n_lanes, int S,
                                 int box_h, int box_w, int rules, int rule, int max_sweeps,
                                 int k_steps, int count_mode, int unroll, const void* head,
                                 void* stream) {
  const Geo g = make_geo(box_h, box_w);
  // head: a HeadParams image for the head:* rules, NULL for the legacy ones.
  HeadParams hp = {};
  if (head != nullptr) hp = *(const HeadParams*)head;
  const int smem = WARPS_PER_BLOCK * warp_smem_words(g) * (int)sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_lanes > 0) {
    const int grid = (n_lanes + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    fused_kernel<<<grid, WARPS_PER_BLOCK * 32, smem, (cudaStream_t)stream>>>(
        (const unsigned*)top_in, (unsigned*)stack, (const int*)has_in, (const int*)base_in,
        (const int*)count_in, (unsigned*)top_out, (unsigned*)sol_out, (int*)lane_out,
        n_lanes, S, g, rules, rule, max_sweeps, k_steps, count_mode, unroll, hp);
  }
  return (int)cudaGetLastError();
}
