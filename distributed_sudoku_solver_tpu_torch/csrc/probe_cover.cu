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
// What bounds it on an H100: the launch and one thread's chain of
// dependent waits.  The probe's shape (R = 224 rows, W = 7 words, C = 28
// columns, T = 128 lanes, S = 8 slots) moves ~0.1 MB and does ~10^5
// integer operations: microseconds of work, in which every memory wait,
// every dependent instruction and every instruction fetched cold (the
// kernel runs once) adds to the time.  So:
//   * every global load is issued before any is used, one memory round
//     trip: lane b of a warp reads row 32 w + b of the incidence whole, in
//     16-byte pieces, and builds the row's column mask; the lane's packed
//     words and meta; the stack, copied to the output as 16-byte pieces,
//     a pass's loads all issued before its stores, then one barrier before
//     the steps write their slots;
//   * each row word's 32 x 32 bit matrix is transposed across the warp by
//     five shuffle rounds, which gives the row masks per column with no
//     serial transpose;
//   * a block serves 32 lanes with 4 warps (T = 128 spreads over 4 SMs),
//     each warp a quarter of the counts; and the code stays small (loops,
//     not unrolled copies).
//
// The incidence must be 0/1 (the wrapper checks it); rows are R = 32 * W,
// so every bit of a word is a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 32;        // probe lanes a block: one warp's worth
constexpr int NO_ROW = 1 << 22;  // the probe's key for "no row available"
constexpr int STACK_PIECES = 4;  // 16-byte stack pieces a thread has in flight at once
constexpr uint32_t FULL = 0xFFFFFFFFu;

// A block serves 32 probe lanes with 4 warps.  Each warp stages a share of
// the incidence and of the lanes' stack, runs the lanes' steps (every warp
// the same 32 lanes: the steps are short, and each warp needs the final
// words), and writes a quarter of the column counts; warp 0 writes the
// stack slots, the words and meta.
template <int W>
__global__ void __launch_bounds__(THREADS, 1)
probe_cover_kernel(const float* __restrict__ inc, const uint32_t* __restrict__ packed_in,
                   const int* __restrict__ meta_in, const uint32_t* __restrict__ stack_in,
                   int* __restrict__ cnt_out, uint32_t* __restrict__ packed_out,
                   int* __restrict__ meta_out, uint32_t* __restrict__ stack_out, int C, int T,
                   int S, int steps, int vec) {
  constexpr int R = 32 * W;
  constexpr int PER_WARP = (W + WARPS - 1) / WARPS;  // row words a warp stages
  __shared__ uint32_t row_cols[R];       // columns of row r, one bit each
  __shared__ uint32_t col_rows[32 * W];  // [c][w]: rows of word w in column c
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x * LANES + lane;
  const bool live = t < T;

  // Every global load before any is used, one memory round trip.  The
  // incidence: lane b of warp w' reads row 32 w + b of its words w = w' +
  // 4 q, whole (16-byte pieces when vec: C % 4 == 0).
  float4 rowv[PER_WARP][8];
#pragma unroll
  for (int q = 0; q < PER_WARP; ++q) {
    const int w = warp + WARPS * q;
    const float* row = inc + (32 * w + lane) * C;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      rowv[q][k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (w < W && 4 * k < C) {
        if (vec) {
          rowv[q][k] = reinterpret_cast<const float4*>(row)[k];
        } else {
          rowv[q][k].x = row[4 * k];
          if (4 * k + 1 < C) rowv[q][k].y = row[4 * k + 1];
          if (4 * k + 2 < C) rowv[q][k].z = row[4 * k + 2];
          if (4 * k + 3 < C) rowv[q][k].w = row[4 * k + 3];
        }
      }
    }
  }
  uint32_t bits[W];
  int meta[8];
#pragma unroll
  for (int w = 0; w < W; ++w) bits[w] = live ? packed_in[w * T + t] : 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) meta[i] = live ? meta_in[i * T + t] : 0;
  // The lanes' stack, S * W rows of (up to) 32 words: in 16-byte pieces
  // where vec (T % 4 == 0), 8 a row; each pass loads its pieces, then
  // stores them.
  {
    const int lanes = min(LANES, T - blockIdx.x * LANES);
    const int per = vec ? 4 : 1;
    const int row_pieces = (lanes + per - 1) / per;
    const int total = S * W * row_pieces;
    for (int p0 = 0; p0 < total; p0 += STACK_PIECES * THREADS) {
      uint4 piece[STACK_PIECES];
      long long at[STACK_PIECES];
#pragma unroll
      for (int k = 0; k < STACK_PIECES; ++k) {
        const int p = p0 + k * THREADS + threadIdx.x;
        const int r = row_pieces == 8 ? p >> 3 : p / row_pieces;
        at[k] = p < total ? (long long)r * T + blockIdx.x * LANES + (p - r * row_pieces) * per : -1;
        if (at[k] >= 0) {
          if (vec) {
            piece[k] = *reinterpret_cast<const uint4*>(stack_in + at[k]);
          } else {
            piece[k].x = stack_in[at[k]];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < STACK_PIECES; ++k) {
        if (at[k] >= 0) {
          if (vec) {
            *reinterpret_cast<uint4*>(stack_out + at[k]) = piece[k];
          } else {
            stack_out[at[k]] = piece[k].x;
          }
        }
      }
    }
  }

  // Row masks from the loaded rows; then each word's 32 x 32 bit matrix
  // (lane b: row 32 w + b's columns) transposed across the warp by five
  // shuffle rounds, so lane c holds the rows of word w in column c.
#pragma unroll
  for (int q = 0; q < PER_WARP; ++q) {
    const int w = warp + WARPS * q;
    if (w < W) {  // warp-uniform
      uint32_t v = 0u;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v |= (rowv[q][k].x != 0.f ? 1u : 0u) << (4 * k);
        v |= (rowv[q][k].y != 0.f ? 2u : 0u) << (4 * k);
        v |= (rowv[q][k].z != 0.f ? 4u : 0u) << (4 * k);
        v |= (rowv[q][k].w != 0.f ? 8u : 0u) << (4 * k);
      }
      row_cols[32 * w + lane] = v;
      uint32_t m = 0x0000FFFFu;  // the columns with bit j of their index clear
#pragma unroll
      for (int j = 16; j >= 1; j >>= 1, m ^= m << j) {
        const uint32_t other = __shfl_xor_sync(FULL, v, j);
        v = (lane & j) ? (v & ~m) | ((other & ~m) >> j) : (v & m) | ((other & m) << j);
      }
      if (lane < C) col_rows[lane * W + w] = v;
    }
  }
  __syncthreads();  // the masks, and the stack copy's stores before the slots' stores
  if (!live) return;

  const bool pow2 = (S & (S - 1)) == 0;
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
      // Four of r's columns at a time, their row masks loaded together.
      for (uint32_t cols = row_cols[r]; cols;) {
        int cs[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          cs[k] = cols ? __ffs(cols) - 1 : -1;
          cols &= cols - 1;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (cs[k] >= 0) {
#pragma unroll
            for (int w = 0; w < W; ++w) conflict[w] |= col_rows[cs[k] * W + w];
          }
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t keep = (r >> 5) == w ? 1u << (r & 31) : 0u;
        next[w] = bits[w] & ~(conflict[w] & ~keep);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) meta[i] += 1;
    }
    // floor modulo, as jnp's %
    const int slot = pow2 ? meta[0] & (S - 1) : ((meta[0] % S) + S) % S;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (warp == 0) stack_out[((long long)slot * W + w) * T + t] = bits[w];
      bits[w] = next[w];
    }
  }

  // Warp w' counts columns w', w' + 4, ... (at most 8 of them).
#pragma unroll
  for (int k = 0; k < 32 / WARPS; ++k) {
    const int c = warp + WARPS * k;
    if (c < C) {
      int n = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) n += __popc(col_rows[c * W + w] & bits[w]);
      cnt_out[c * T + t] = n;
    }
  }
  if (warp == 0) {
#pragma unroll
    for (int w = 0; w < W; ++w) packed_out[w * T + t] = bits[w];
#pragma unroll
    for (int i = 0; i < 8; ++i) meta_out[i * T + t] = meta[i];
  }
}

template <int W>
int launch(const void* inc, const void* packed_in, const void* meta_in, const void* stack_in,
           void* cnt, void* packed_out, void* meta_out, void* stack_out, int C, int T, int S,
           int steps, void* stream) {
  if (T > 0) {
    const int grid = (T + LANES - 1) / LANES;
    const uintptr_t a = (uintptr_t)inc | (uintptr_t)stack_in | (uintptr_t)stack_out;
    const int vec = C % 4 == 0 && T % 4 == 0 && a % 16 == 0;
    probe_cover_kernel<W><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)inc, (const uint32_t*)packed_in, (const int*)meta_in,
        (const uint32_t*)stack_in, (int*)cnt, (uint32_t*)packed_out, (int*)meta_out,
        (uint32_t*)stack_out, C, T, S, steps, vec);
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
