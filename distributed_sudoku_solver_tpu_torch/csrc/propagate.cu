// K1: constraint propagation to a fixpoint, one warp per board.
//
// Replaces the TPU kernel propagate_fixpoint_pallas
// (distributed_sudoku_solver_tpu/ops/pallas_propagate.py: _fixpoint_kernel,
// body _fixpoint_boards_last, sweeps sweep_mosaic / box_line_mosaic /
// naked_subsets_mosaic).
//
// What bounds it on an H100: not device memory (each board is read once
// and written once, 324 bytes each way at 9x9) but the shared-memory
// traffic and integer work of the sweeps, and the serial dependence
// between a board's sweeps.  The design keeps each board in its warp's
// shared memory for the whole fixpoint, so device memory is touched once
// per board, and lets every board stop at its own fixpoint (the TPU kernel
// stopped per 256-board tile).  Per-board convergence changes no mask,
// since a sweep of a fixpoint is the identity; each warp writes its own
// sweep count and the caller takes the maximum, which is the TPU kernel's
// max over tiles.  Boards stay lane-first [B, n, n]: a contiguous board
// per warp is the natural layout here (the boards-last transposes existed
// for the TPU's vector layout).

#include "fixpoint.cuh"

using namespace dsst;

__global__ void propagate_kernel(const unsigned* __restrict__ in, unsigned* __restrict__ out,
                                 int* __restrict__ sweeps, int n_boards, Geo g,
                                 int max_sweeps, int rules) {
  extern __shared__ unsigned smem[];
  const int wib = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long board = (long long)blockIdx.x * WARPS_PER_BLOCK + wib;
  if (board >= n_boards) return;  // the whole warp leaves together
  const WarpBufs w = warp_bufs(smem + wib * warp_smem_words(g), g);
  const unsigned* src = in + board * g.n2;
  for (int c = lane; c < g.n2; c += 32) w.b[c] = src[c];
  __syncwarp();
  const int s = fixpoint(g, w, max_sweeps, rules, 0, lane);
  unsigned* dst = out + board * g.n2;
  for (int c = lane; c < g.n2; c += 32) dst[c] = w.b[c];
  if (lane == 0) sweeps[board] = s;
}

extern "C" int dsst_propagate(const void* in, void* out, void* sweeps, int n_boards,
                              int box_h, int box_w, int max_sweeps, int rules,
                              void* stream) {
  const Geo g = make_geo(box_h, box_w);
  const int smem = WARPS_PER_BLOCK * warp_smem_words(g) * (int)sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      propagate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_boards > 0) {
    const int grid = (n_boards + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    propagate_kernel<<<grid, WARPS_PER_BLOCK * 32, smem, (cudaStream_t)stream>>>(
        (const unsigned*)in, (unsigned*)out, (int*)sweeps, n_boards, g, max_sweeps, rules);
  }
  return (int)cudaGetLastError();
}
