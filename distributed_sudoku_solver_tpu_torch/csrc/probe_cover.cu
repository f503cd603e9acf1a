// PCV: the cover-primitive probe, three steps of "take the lowest available
// row" on packed row words, one thread per lane.
//
// Replaces the TPU probe benchmarks/probe_cover_kernel.py: run() -> kernel
// (pl.pallas_call).  Per lane t and step:
//   * the lowest available row r of the lane's packed words (the probe's P4,
//     a sublane min re-broadcast by a ones-matmul);
//   * if there is one: every row that shares a column with r is cleared, r
//     itself is kept, and all 8 meta rows of the lane gain 1;
//   * the lane's words from before the step go into stack slot
//     meta[0] mod S (after the increment), whether a row was taken or not.
// After the steps: the column counts cnt[c] = popcount of the available rows
// of column c (the probe's P1, inc^T . bits).
//
// Where the MXU route and the card's route part.  The TPU has no dynamic
// gather and no bit scan in its vector unit, so the probe unpacks the words
// into one 0/1 float per row with a select-matmul (P2), finds the conflict
// rows and the counts with f32 matmuls over the incidence (P1), and packs
// the rows back with weight matmuls (P3).  A thread on the card has __ffs,
// __popc and indexed shared memory: the packed words are the working form,
// P2 and P3 are the identity, and the incidence is staged in shared memory
// twice, as a column mask per row (C <= 32: one word) and as a row mask per
// (column, row word).  The conflict set of row r is the OR of the row masks
// of r's columns; the counts are popcounts of the row masks ANDed with the
// available words.  No product of any kind is computed.
//
// What bounds it on an H100: the launch.  The probe's shape (R = 224 rows,
// W = 7 words, C = 28 columns, T = 128 lanes, S = 8 slots) moves ~0.1 MB and
// does ~10^5 integer operations: microseconds of work for one block.
//
// The incidence must be 0/1 (the wrapper checks it); rows are R = 32 * W,
// so every bit of a word is a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_W = 8;
constexpr int NO_ROW = 1 << 22;  // the probe's key for "no row available"

template <int W>
__global__ void __launch_bounds__(THREADS)
probe_cover_kernel(const float* __restrict__ inc, const uint32_t* __restrict__ packed_in,
                   const int* __restrict__ meta_in, const uint32_t* __restrict__ stack_in,
                   int* __restrict__ cnt_out, uint32_t* __restrict__ packed_out,
                   int* __restrict__ meta_out, uint32_t* __restrict__ stack_out, int C, int T,
                   int S, int steps) {
  constexpr int R = 32 * W;
  __shared__ uint32_t row_cols[R];           // columns of row r, one bit each
  __shared__ uint32_t col_rows[32 * MAX_W];  // [c][w]: rows of word w in column c
  for (int r = threadIdx.x; r < R; r += THREADS) {
    uint32_t m = 0u;
    for (int c = 0; c < C; ++c) m |= (inc[r * C + c] != 0.0f ? 1u : 0u) << c;
    row_cols[r] = m;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < C * W; e += THREADS) {
    const int c = e / W, w = e % W;
    uint32_t m = 0u;
    for (int b = 0; b < 32; ++b) m |= ((row_cols[32 * w + b] >> c) & 1u) << b;
    col_rows[e] = m;
  }
  __syncthreads();
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= T) return;

  uint32_t bits[W];
#pragma unroll
  for (int w = 0; w < W; ++w) bits[w] = packed_in[w * T + t];
  int meta[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) meta[i] = meta_in[i * T + t];
  for (int i = 0; i < S * W; ++i) stack_out[(long long)i * T + t] = stack_in[(long long)i * T + t];

  for (int k = 0; k < steps; ++k) {
    int r = NO_ROW;
#pragma unroll
    for (int w = W - 1; w >= 0; --w) {
      if (bits[w]) r = 32 * w + __ffs(bits[w]) - 1;
    }
    uint32_t next[W];
#pragma unroll
    for (int w = 0; w < W; ++w) next[w] = bits[w];
    if (r != NO_ROW) {
      uint32_t conflict[W];
#pragma unroll
      for (int w = 0; w < W; ++w) conflict[w] = 0u;
      for (uint32_t cols = row_cols[r]; cols; cols &= cols - 1) {
        const int c = __ffs(cols) - 1;
#pragma unroll
        for (int w = 0; w < W; ++w) conflict[w] |= col_rows[c * W + w];
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t keep = (r >> 5) == w ? 1u << (r & 31) : 0u;
        next[w] = bits[w] & ~(conflict[w] & ~keep);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) meta[i] += 1;
    }
    const int slot = ((meta[0] % S) + S) % S;  // floor modulo, as jnp's %
#pragma unroll
    for (int w = 0; w < W; ++w) {
      stack_out[((long long)slot * W + w) * T + t] = bits[w];
      bits[w] = next[w];
    }
  }

  for (int c = 0; c < C; ++c) {
    int n = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) n += __popc(col_rows[c * W + w] & bits[w]);
    cnt_out[c * T + t] = n;
  }
#pragma unroll
  for (int w = 0; w < W; ++w) packed_out[w * T + t] = bits[w];
#pragma unroll
  for (int i = 0; i < 8; ++i) meta_out[i * T + t] = meta[i];
}

template <int W>
int launch(const void* inc, const void* packed_in, const void* meta_in, const void* stack_in,
           void* cnt, void* packed_out, void* meta_out, void* stack_out, int C, int T, int S,
           int steps, void* stream) {
  if (T > 0) {
    const int grid = (T + THREADS - 1) / THREADS;
    probe_cover_kernel<W><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)inc, (const uint32_t*)packed_in, (const int*)meta_in,
        (const uint32_t*)stack_in, (int*)cnt, (uint32_t*)packed_out, (int*)meta_out,
        (uint32_t*)stack_out, C, T, S, steps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// inc f32 [32 W, C] (0/1), packed [W, T], meta int32 [8, T], stack [S, W, T]
// in; cnt int32 [C, T], packed, meta and stack out (each its own buffer).
extern "C" int dsst_probe_cover(const void* inc, const void* packed_in, const void* meta_in,
                                const void* stack_in, void* cnt, void* packed_out,
                                void* meta_out, void* stack_out, int W, int C, int T, int S,
                                int steps, void* stream) {
  if (C < 1 || C > 32 || T < 0 || S < 1 || steps < 0) return (int)cudaErrorInvalidValue;
#define DSST_LAUNCH(WORDS)                                                                  \
  if (W == WORDS)                                                                           \
    return launch<WORDS>(inc, packed_in, meta_in, stack_in, cnt, packed_out, meta_out,      \
                         stack_out, C, T, S, steps, stream);
  DSST_LAUNCH(1) DSST_LAUNCH(2) DSST_LAUNCH(3) DSST_LAUNCH(4)
  DSST_LAUNCH(5) DSST_LAUNCH(6) DSST_LAUNCH(7) DSST_LAUNCH(8)
#undef DSST_LAUNCH
  return (int)cudaErrorInvalidValue;
}
