// P16: the 9x9 propagation fixpoint on 32-bit and on 16-bit candidate masks.
//
// Replaces the TPU probe benchmarks/probe_uint16.py: build() -> fixpoint
// (pl.pallas_call), kernel and sweep.  One sweep: naked singles (each
// undecided cell loses the values decided anywhere in its row, column and
// box), then hidden singles (a cell that holds a value seen exactly once in
// one of its units is set to those values).  The fixpoint repeats sweeps
// until nothing changes or max_sweeps sweeps ran.  Boards are boards-last,
// [9, 9, T], the probe's own layout: cell i of board t at i * T + t.
//
// The probe asks whether 16-bit masks pay.  On the card:
// * BITS = 32: one board per thread, each of its 81 cells in a register.
//   Neighbouring threads read neighbouring words, so every cell's load and
//   store is one coalesced access of the warp.
// * BITS = 16: two boards per thread, packed in one 32-bit word per cell
//   (board 2j in the low half, 2j + 1 in the high half), and every sweep
//   runs on both at once as SWAR.  AND, OR and ANDNOT are lane-wise as they
//   are; "exactly one bit" per half is x != 0 and x & (x - 1) == 0, from
//   __vsub2 / __vcmpeq2 / __vcmpne2, which never borrow across the halves.
//   This halves the bytes and the integer instructions per board, which is
//   both halves of the probe's question (bytes and ALU work).
//
// What bounds it on an H100: integer instructions.  A board is 324 bytes
// (162 at 16 bits) each way, and a sweep does ~1,800 integer operations on
// it, with a dozen sweeps to a fixpoint on carved 24-clue boards.
//
// Registers: the 81 cells, 27 unit masks and a few temporaries (~120);
// every array index is a compile-time constant after unrolling, so nothing
// goes to local memory.  One simplification of the probe's algebra: the
// probe keeps a decided cell out of the hidden-single step
// (where(~single & forced != 0, forced, cand)).  A cell decided at the
// sweep's start keeps its one value through the naked step, so its forced
// set is that value or nothing, and where(forced != 0, forced, cand) gives
// the same cell: the kernel needs no per-cell flag after the naked step.
//
// Each board (pair of boards) loops to its own fixpoint, capped at
// max_sweeps.  The TPU loop ran per tile of boards until no board of the
// tile changed; a sweep of a board at its fixpoint is the identity, so the
// extra sweeps a tile gave its converged boards changed nothing, and a
// board that had not converged got max_sweeps sweeps either way: the
// output is the same.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int N = 9;
constexpr int CELLS = N * N;
constexpr int THREADS = 128;

// All ones in each half (or the whole word) where x holds exactly one bit.
template <int BITS>
__device__ __forceinline__ uint32_t one_bit(uint32_t x) {
  if constexpr (BITS == 16) {
    return __vcmpeq2(x & __vsub2(x, 0x00010001u), 0u) & __vcmpne2(x, 0u);
  } else {
    return __popc(x) == 1 ? 0xFFFFFFFFu : 0u;
  }
}

template <int BITS>
__device__ __forceinline__ uint32_t nonzero(uint32_t x) {
  if constexpr (BITS == 16) {
    return __vcmpne2(x, 0u);
  } else {
    return x != 0u ? 0xFFFFFFFFu : 0u;
  }
}

constexpr __host__ __device__ int box_of(int i) { return (i / 27) * 3 + (i % 9) / 3; }

// One sweep in place; returns the bits it removed (nonzero iff a cell of
// either board changed: both steps only ever clear bits).
template <int BITS>
__device__ __forceinline__ uint32_t sweep(uint32_t (&c)[CELLS]) {
  uint32_t row[N], col[N], box[N];
#pragma unroll
  for (int u = 0; u < N; ++u) row[u] = col[u] = box[u] = 0u;
  // Naked singles: the OR of the decided values over each unit.
#pragma unroll
  for (int i = 0; i < CELLS; ++i) {
    const uint32_t d = c[i] & one_bit<BITS>(c[i]);
    row[i / N] |= d;
    col[i % N] |= d;
    box[box_of(i)] |= d;
  }
  uint32_t removed = 0u;
#pragma unroll
  for (int i = 0; i < CELLS; ++i) {
    const uint32_t seen = row[i / N] | col[i % N] | box[box_of(i)];
    const uint32_t next = c[i] & (one_bit<BITS>(c[i]) | ~seen);
    removed |= c[i] ^ next;
    c[i] = next;
  }
  // Hidden singles: per unit, the values seen exactly once (once & ~twice).
#pragma unroll
  for (int u = 0; u < N; ++u) {
    uint32_t once_r = 0u, twice_r = 0u, once_c = 0u, twice_c = 0u, once_b = 0u, twice_b = 0u;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const uint32_t r = c[u * N + k];
      const uint32_t q = c[k * N + u];
      const uint32_t b = c[(u / 3) * 27 + (u % 3) * 3 + (k / 3) * N + k % 3];
      twice_r |= once_r & r;
      once_r |= r;
      twice_c |= once_c & q;
      once_c |= q;
      twice_b |= once_b & b;
      once_b |= b;
    }
    row[u] = once_r & ~twice_r;
    col[u] = once_c & ~twice_c;
    box[u] = once_b & ~twice_b;
  }
#pragma unroll
  for (int i = 0; i < CELLS; ++i) {
    const uint32_t forced = c[i] & (row[i / N] | col[i % N] | box[box_of(i)]);
    const uint32_t take = nonzero<BITS>(forced);
    const uint32_t next = (forced & take) | (c[i] & ~take);
    removed |= c[i] ^ next;
    c[i] = next;
  }
  return removed;
}

// BITS = 32: word w of a cell is board w.  BITS = 16: word w holds boards
// 2w and 2w + 1 (the high half is zero past an odd T: an empty board, which
// no sweep changes).
template <int BITS>
__global__ void __launch_bounds__(THREADS)
probe_fixpoint_kernel(const void* __restrict__ in, void* __restrict__ out, int T,
                      int max_sweeps) {
  const int words = BITS == 16 ? (T + 1) / 2 : T;
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= words) return;
  uint32_t c[CELLS];
  if constexpr (BITS == 32) {
    const uint32_t* src = static_cast<const uint32_t*>(in);
#pragma unroll
    for (int i = 0; i < CELLS; ++i) c[i] = src[(long long)i * T + w];
  } else {
    const uint16_t* src = static_cast<const uint16_t*>(in);
    const bool pair_word = (T % 2) == 0;  // cell rows start on a 4-byte boundary
    const bool has_hi = 2 * w + 1 < T;
#pragma unroll
    for (int i = 0; i < CELLS; ++i) {
      const long long at = (long long)i * T + 2 * w;
      if (pair_word) {
        c[i] = *reinterpret_cast<const uint32_t*>(src + at);
      } else {
        c[i] = (uint32_t)src[at] | (has_hi ? (uint32_t)src[at + 1] << 16 : 0u);
      }
    }
  }
  for (int k = 0; k < max_sweeps; ++k) {
    if (sweep<BITS>(c) == 0u) break;
  }
  if constexpr (BITS == 32) {
    uint32_t* dst = static_cast<uint32_t*>(out);
#pragma unroll
    for (int i = 0; i < CELLS; ++i) dst[(long long)i * T + w] = c[i];
  } else {
    uint16_t* dst = static_cast<uint16_t*>(out);
    const bool pair_word = (T % 2) == 0;
    const bool has_hi = 2 * w + 1 < T;
#pragma unroll
    for (int i = 0; i < CELLS; ++i) {
      const long long at = (long long)i * T + 2 * w;
      if (pair_word) {
        *reinterpret_cast<uint32_t*>(dst + at) = c[i];
      } else {
        dst[at] = (uint16_t)(c[i] & 0xFFFFu);
        if (has_hi) dst[at + 1] = (uint16_t)(c[i] >> 16);
      }
    }
  }
}

template <int BITS>
int launch(const void* in, void* out, int T, int max_sweeps, void* stream) {
  const int words = BITS == 16 ? (T + 1) / 2 : T;
  if (words > 0) {
    const int grid = (words + THREADS - 1) / THREADS;
    probe_fixpoint_kernel<BITS><<<grid, THREADS, 0, (cudaStream_t)stream>>>(in, out, T,
                                                                            max_sweeps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// bits: 32 (int32 masks read as uint32) or 16 (int16 masks read as uint16).
extern "C" int dsst_probe_fixpoint(const void* in, void* out, int T, int max_sweeps, int bits,
                                   void* stream) {
  if (T < 0 || max_sweeps < 0) return (int)cudaErrorInvalidValue;
  if (bits == 32) return launch<32>(in, out, T, max_sweeps, stream);
  if (bits == 16) return launch<16>(in, out, T, max_sweeps, stream);
  return (int)cudaErrorInvalidValue;
}
