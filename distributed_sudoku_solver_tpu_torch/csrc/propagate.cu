// K1: constraint propagation to a fixpoint, one warp per board.
//
// Replaces the TPU kernel propagate_fixpoint_pallas
// (distributed_sudoku_solver_tpu/ops/pallas_propagate.py: _fixpoint_kernel,
// body _fixpoint_boards_last, sweeps sweep_mosaic / box_line_mosaic /
// naked_subsets_mosaic).
//
// What bounds it on an H100: not device memory (each board is read once
// and written once, 324 bytes each way at 9x9) but the integer and
// shared-memory work of the sweeps, and the serial dependence between a
// board's sweeps: a batch of a few thousand boards is one wave of warps,
// so the kernel lasts about as long as its longest board.  The sweeps are
// K2's (fixpoint.cuh), where the stage counters of K2's counter build
// showed index arithmetic with run-time divisions, divergent unit-type
// paths and shared-memory round trips taking most of a design that read
// the geometry at run time; the code is instantiated per box shape, each
// lane's row segments stay in registers for the whole fixpoint, and every
// unit walk is the same strided loop over the board in shared memory.
// Device memory is touched once per board each way, and every board stops
// at its own fixpoint (the TPU kernel stopped per 256-board tile).
// Per-board convergence changes no mask, since a sweep of a fixpoint is
// the identity; each warp writes its own sweep count and the caller takes
// the maximum, which is the TPU kernel's max over tiles.  Boards stay
// lane-first [B, n, n]: a contiguous board per warp is the natural layout
// here (the boards-last transposes existed for the TPU's vector layout).

#include "fixpoint.cuh"

using namespace dsst;

template <int BH, int BW>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32, Occupancy<Geo<BH, BW>, false>::MIN_BLOCKS)
propagate_kernel(const unsigned* __restrict__ in, unsigned* __restrict__ out,
                 int* __restrict__ sweeps, int n_boards, int box_h, int box_w, int max_sweeps,
                 int rules) {
  using G = Geo<BH, BW>;
  extern __shared__ unsigned smem[];
  const G g(box_h, box_w);
  const int wib = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long board = (long long)blockIdx.x * WARPS_PER_BLOCK + wib;
  if (board >= n_boards) return;  // the whole warp leaves together
  StageClock clk;
  const Warp<G> w(g, lane, smem + wib * warp_smem_words(g));
  Cells<G> x;
  load_cells(w, x, in + board * g.n2);
  const int s = fixpoint(w, x, max_sweeps, rules, 0, clk);
  store_cells(w, x, out + board * g.n2);
  if (lane == 0) sweeps[board] = s;
}

// -- host side -------------------------------------------------------------------

template <int BH, int BW>
static int launch_propagate(const void* in, void* out, void* sweeps, int n_boards, int box_h,
                            int box_w, int max_sweeps, int rules, void* stream) {
  const int smem = WARPS_PER_BLOCK * warp_smem_words(Geo<BH, BW>(box_h, box_w)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      propagate_kernel<BH, BW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_boards > 0) {
    const int grid = (n_boards + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    propagate_kernel<BH, BW><<<grid, WARPS_PER_BLOCK * 32, smem, (cudaStream_t)stream>>>(
        (const unsigned*)in, (unsigned*)out, (int*)sweeps, n_boards, box_h, box_w,
        max_sweeps, rules);
  }
  return (int)cudaGetLastError();
}

extern "C" int dsst_propagate(const void* in, void* out, void* sweeps, int n_boards,
                              int box_h, int box_w, int max_sweeps, int rules,
                              void* stream) {
  if (box_h * box_w > 32 || cells_per_lane(box_h, box_w) > Geo<0, 0>::MAXC)
    return (int)cudaErrorInvalidValue;
#define DSST_LAUNCH(BH, BW)                                                              \
  if (box_h == BH && box_w == BW)                                                        \
    return launch_propagate<BH, BW>(in, out, sweeps, n_boards, box_h, box_w, max_sweeps, \
                                    rules, stream);
  DSST_FOR_EACH_GEOMETRY(DSST_LAUNCH)
#undef DSST_LAUNCH
  return launch_propagate<0, 0>(in, out, sweeps, n_boards, box_h, box_w, max_sweeps, rules,
                                stream);
}
