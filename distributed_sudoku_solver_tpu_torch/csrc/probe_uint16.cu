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
// The probe asks whether 16-bit masks pay.  One template serves both
// widths, so the two compare like with like:
// * BITS = 32: a lane holds one board, its 81 cells in registers.
// * BITS = 16: a lane holds two boards, one in each 16-bit half of its 81
//   words, and every sweep runs on both at once as SWAR.  The per-half
//   algebra (Lanes<16>) is carry-free on plain 32-bit instructions (LOP3,
//   IADD3, one PRMT): no carry or borrow ever crosses from one half into
//   the other, for any 16-bit values, not only 9-bit masks.
//   probes/uint16.py holds a numpy model of these identities, which the
//   CPU tests check on every 16-bit value.
//
// What bounds it on an H100: integer operations, about 1,800 a board-sweep
// (a board is 324 bytes, 162 at 16 bits, each way), issued at the integer
// pipe's rate, and the sweeps a warp runs for boards that have already
// converged.  The probe's 65,536 boards need 9.22 sweeps on average, 3 to
// 19; a warp that loops a fixed 32 (or 64) of them to their own fixpoints
// runs its slowest one's count, 1.79x (1.90x at 64 boards a warp) the
// sweeps the boards need (chip_smoke.py phase 15).
//
// The design against that: persistent blocks of 4 warps (one a scheduler:
// the sweep's 81 independent cells give each warp the parallelism it needs)
// walk tiles of boards, one tile of about T / (number of SMs) boards a
// block at the probe's size.  A tile, board-major in dynamic shared memory,
// is staged by cp.async in chunks of 32 slots, each chunk with an mbarrier
// that the copies arrive on.  A lane takes a board (at 16 bits, a board
// for each half) from a shared counter, waits for its chunk, loads it into
// registers and sweeps; when the board reaches its fixpoint or max_sweeps
// the lane writes it back into the tile and takes the next unstarted board.
// A warp sweeps converged boards only once the tile has no board left to
// start; the queue's model (chip_smoke.py queue_model) puts what is left
// at 1.22x (1.52x at 16 bits: 256 board slots an SM for about 496 boards)
// against 1.79x (1.90x).  What remains is the end of the tile, where lanes
// wait for its last boards: no lane can know which boards run long, and
// each SM has only its tile to draw from.
// Chunks go back to device memory in coalesced stores as soon as their
// boards are done, by warps with nothing left to sweep.

// Each board loops to its own fixpoint, capped at max_sweeps: a lane
// counts the sweeps of its board (of each half's board) and stops it after
// the first sweep that changes nothing or after max_sweeps.  The TPU loop
// ran per tile of boards until no board of the tile changed; a sweep of a
// board at its fixpoint is the identity, so the extra sweeps a tile gave
// its converged boards changed nothing, and a board that had not converged
// got max_sweeps sweeps either way: the output is the same.
//
// One simplification of the probe's algebra: the probe keeps a decided
// cell out of the hidden-single step (where(~single & forced != 0, forced,
// cand)).  A cell decided at the sweep's start keeps its one value through
// the naked step, so its forced set is that value or nothing, and
// where(forced != 0, forced, cand) gives the same cell.  The naked step is
// c & (one(c) | ~seen) at 32 bits and c & ~(seen & multi(c)) at 16 (the
// same cell: a decided cell keeps its value, any other loses what its
// units decided); the first lets the compiler keep one popcount a cell
// for both uses, the second costs the SWAR algebra least.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int N = 9;
constexpr int CELLS = N * N;
constexpr int THREADS = 128;  // 4 warps: one for each scheduler of an SM
constexpr int ALIGN = 8;      // tile widths are multiples of 8 boards
constexpr uint32_t FULL = 0xFFFFFFFFu;

// Lane-wise mask algebra.  decided(c): c where it holds exactly one value
// (a decided cell), else 0; naked(c, seen): the naked step, c less the
// values its units decided unless c is decided itself; nonzero(x): all
// ones where x is not 0.  BITS = 16 answers per half.
template <int BITS>
struct Lanes;

template <>
struct Lanes<32> {
  static __device__ __forceinline__ uint32_t one(uint32_t x) {
    return __popc(x) == 1 ? FULL : 0u;
  }
  static __device__ __forceinline__ uint32_t decided(uint32_t c) { return c & one(c); }
  static __device__ __forceinline__ uint32_t naked(uint32_t c, uint32_t seen) {
    return c & (one(c) | ~seen);
  }
  static __device__ __forceinline__ uint32_t nonzero(uint32_t x) { return x != 0u ? FULL : 0u; }
};

template <>
struct Lanes<16> {
  static constexpr uint32_t H = 0x80008000u;  // bit 15 of each half
  static constexpr uint32_t L = 0x7FFF7FFFu;  // bits 0-14 of each half
  // Each half minus 1, mod 2^16: a half with bit 15 forced on never borrows
  // out of itself, and the XOR restores bit 15.
  static __device__ __forceinline__ uint32_t dec(uint32_t x) {
    return ((x | H) - 0x00010001u) ^ (~x & H);
  }
  // Bit 15 of each half set where that half is not 0: bits 0-14 plus
  // 0x7FFF carry into bit 15 (never beyond it) where any of them is set.
  static __device__ __forceinline__ uint32_t nonzero_flags(uint32_t x) {
    return (((x & L) + L) | x) & H;
  }
  // Bit 15 of each half spread over the half: PRMT replicates the sign of
  // byte 1 into bytes 0-1 and that of byte 3 into bytes 2-3.
  static __device__ __forceinline__ uint32_t widen(uint32_t f) {
    uint32_t m;
    asm("prmt.b32 %0, %1, 0, 0xBB99;" : "=r"(m) : "r"(f));
    return m;
  }
  // All ones in each half that holds two bits or more (x & dec(x) != 0).
  static __device__ __forceinline__ uint32_t multi(uint32_t x) {
    return widen(nonzero_flags(x & dec(x)));
  }
  static __device__ __forceinline__ uint32_t decided(uint32_t c) { return c & ~multi(c); }
  // A decided half holds its own value in seen, so seen only clears the
  // halves that hold more than one.
  static __device__ __forceinline__ uint32_t naked(uint32_t c, uint32_t seen) {
    return c & ~(seen & multi(c));
  }
  static __device__ __forceinline__ uint32_t nonzero(uint32_t x) { return widen(nonzero_flags(x)); }
};

constexpr __host__ __device__ int box_of(int i) { return (i / 27) * 3 + (i % 9) / 3; }

// One sweep in place; returns the bits it removed (nonzero in a half iff
// that half's board changed: both steps only ever clear bits).
template <int BITS>
__device__ __forceinline__ uint32_t sweep(uint32_t (&c)[CELLS]) {
  using A = Lanes<BITS>;
  uint32_t row[N], col[N], box[N];
#pragma unroll
  for (int u = 0; u < N; ++u) row[u] = col[u] = box[u] = 0u;
  // Naked singles: the OR of the decided values over each unit.
#pragma unroll
  for (int i = 0; i < CELLS; ++i) {
    const uint32_t d = A::decided(c[i]);
    row[i / N] |= d;
    col[i % N] |= d;
    box[box_of(i)] |= d;
  }
  uint32_t removed = 0u;
#pragma unroll
  for (int i = 0; i < CELLS; ++i) {
    const uint32_t seen = row[i / N] | col[i % N] | box[box_of(i)];
    const uint32_t next = A::naked(c[i], seen);
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
    const uint32_t take = A::nonzero(forced);
    const uint32_t next = (forced & take) | (c[i] & ~take);
    removed |= c[i] ^ next;
    c[i] = next;
  }
  return removed;
}

// -- shared-memory barriers and asynchronous copies ------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrives once this thread's earlier cp.async copies have landed (the
// arrival is one of the count the barrier was initialised with).
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0u;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.b32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// -- the tile in shared memory ----------------------------------------------------
//
// Board-major, STRIDE words a slot, so a lane moves a board between its
// registers and the tile in 16-byte accesses: BITS = 32, slot b holds board
// b; BITS = 16, slot p holds boards 2p (low halves) and 2p + 1 (high
// halves), as device memory holds them (a 4-byte word per cell and pair).
// A chunk is a warp's worth of slots (32), staged by cp.async (4-byte
// pieces, one per cell and slot: a warp copies a cell's 32 slots from one
// coalesced row segment) and tracked by an mbarrier; at 16 bits and an odd
// T the rows start on 2-byte boundaries, and plain element loads and stores
// move the tile instead.  A chunk's done counter counts its finished
// boards; a warp with nothing left to sweep writes finished chunks back
// while the others finish theirs.
constexpr int STRIDE = 84;  // 81 cells and 3 pad words: 21 16-byte pieces a slot
enum CopyMode { COPY4 = 0, COPY_PLAIN = 1 };

template <int BITS>
constexpr __host__ __device__ int per_slot() { return BITS == 16 ? 2 : 1; }  // boards a slot

template <int BITS>
using Elem = std::conditional_t<BITS == 16, uint16_t, uint32_t>;

struct Tile {
  uint32_t* words;  // [slots][STRIDE]
  uint64_t* bars;   // one a chunk
  int* done;        // finished boards, one counter a chunk
  int* claimed;     // written back, one flag a chunk
  int T, t0, n, mode;
};

// Issue the copies of the tile's boards, chunk by chunk, every thread
// arriving once on each chunk's barrier.  Warp w copies cells w, w + 4, ...
// of the chunk's slots, lane l slot l.
template <int BITS>
__device__ __forceinline__ void stage(const Elem<BITS>* __restrict__ src, const Tile& tile) {
  constexpr int PER = per_slot<BITS>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j * 32 * PER < tile.n; ++j) {
    const int b = j * 32 * PER + lane * PER;  // the slot's first board
    if (tile.mode == COPY4) {
      if (b < tile.n) {
        const Elem<BITS>* g = src + (long long)warp * tile.T + tile.t0 + b;
        uint32_t* s = tile.words + (j * 32 + lane) * STRIDE + warp;
        for (int i = warp; i < CELLS; i += 4, g += 4LL * tile.T, s += 4) copy4(s, g);
      }
      bar_arrive_copies(&tile.bars[j]);
    } else {
      Elem<BITS>* half = reinterpret_cast<Elem<BITS>*>(tile.words);
      for (int k = 0; k < PER; ++k) {
        if (b + k >= tile.n) break;
        for (int i = warp; i < CELLS; i += 4) {
          half[((j * 32 + lane) * STRIDE + i) * PER + k] =
              src[(long long)i * tile.T + tile.t0 + b + k];
        }
      }
      bar_arrive(&tile.bars[j]);
    }
  }
}

// The warp writes chunk j back to device memory: cell by cell, lane l its
// slot's board (or pair), coalesced.
template <int BITS>
__device__ __forceinline__ void write_chunk(Elem<BITS>* __restrict__ dst, const Tile& tile, int j) {
  constexpr int PER = per_slot<BITS>();
  const int lane = threadIdx.x & 31;
  const int b = j * 32 * PER + lane * PER;
  if (b >= tile.n) return;
  const uint32_t* s = tile.words + (j * 32 + lane) * STRIDE;
  Elem<BITS>* g = dst + tile.t0 + b;
  if (tile.mode == COPY4) {
    for (int i = 0; i < CELLS; ++i, g += tile.T) *reinterpret_cast<uint32_t*>(g) = s[i];
  } else {
    const Elem<BITS>* half = reinterpret_cast<const Elem<BITS>*>(s);
    for (int i = 0; i < CELLS; ++i, g += tile.T) {
      g[0] = half[i * PER];
      if (PER == 2 && b + 1 < tile.n) g[1] = half[i * PER + 1];
    }
  }
}

// Write back every chunk whose boards are all done (all of them, once the
// block has finished the tile) that no warp has claimed yet.
template <int BITS>
__device__ __forceinline__ void drain(Elem<BITS>* __restrict__ dst, const Tile& tile, bool all) {
  constexpr int PER = per_slot<BITS>();
  const int lane = threadIdx.x & 31;
  const int chunks = (tile.n + 32 * PER - 1) / (32 * PER);
  for (int j = 0; j < chunks; ++j) {
    const int boards = min(32 * PER, tile.n - j * 32 * PER);
    int mine = 0;
    if (lane == 0 && (all || *(volatile int*)&tile.done[j] == boards) &&
        *(volatile int*)&tile.claimed[j] == 0) {
      mine = atomicCAS(&tile.claimed[j], 0, 1) == 0;
    }
    if (__shfl_sync(FULL, mine, 0)) {
      __threadfence_block();  // the boards' stores before their readers
      write_chunk<BITS>(dst, tile, j);
    }
  }
}

// The next unstarted board of the tile (the compiler aggregates the
// atomics of the warp's callers into one, and ranks them by lane).
__device__ __forceinline__ int take_board(int* next) { return atomicAdd(next, 1); }

// A lane's board in one slot of its registers: the whole word (BITS = 32)
// or half S of it.
struct Slot {
  int board;    // index in the tile; -1 before the first
  int sweeps;   // sweeps run on it
  bool active;  // holds a board of the tile that is not done
  bool need;    // takes the tile's next board before the next sweep
};

// A register slot that needs a board: put its done board back into the
// tile (and count it done), take the tile's next unstarted board and load
// it, once its chunk has landed.
template <int BITS, int S>
__device__ __forceinline__ void refill(uint32_t (&c)[CELLS], Slot& slot, const Tile& tile,
                                       uint32_t parity, int* next) {
  constexpr int PER = per_slot<BITS>();
  if (!slot.need) return;
  if (slot.board >= 0) {
    const int at = (slot.board / PER) * STRIDE;
    if constexpr (BITS == 32) {
      uint4* dst = reinterpret_cast<uint4*>(tile.words + at);
#pragma unroll
      for (int q = 0; q < STRIDE / 4; ++q) {
        dst[q] = make_uint4(c[4 * q], 4 * q + 1 < CELLS ? c[4 * q + 1] : 0u,
                            4 * q + 2 < CELLS ? c[4 * q + 2] : 0u,
                            4 * q + 3 < CELLS ? c[4 * q + 3] : 0u);
      }
    } else {
      uint16_t* dst = reinterpret_cast<uint16_t*>(tile.words + at) + (slot.board & 1);
#pragma unroll
      for (int i = 0; i < CELLS; ++i) dst[2 * i] = (uint16_t)(c[i] >> (16 * S));
    }
    __threadfence_block();  // the board's stores before the count that publishes them
    atomicAdd(&tile.done[slot.board / (32 * PER)], 1);
  }
  slot.need = false;
  slot.board = take_board(next);
  slot.sweeps = 0;
  slot.active = slot.board < tile.n;
  if (!slot.active) return;
  bar_wait(&tile.bars[(unsigned)slot.board / (32 * PER)], parity);
  const uint4* src = reinterpret_cast<const uint4*>(tile.words + (slot.board / PER) * STRIDE);
  // BITS = 16: the board's half of each word into half S of the cell.
  const uint32_t sel = (slot.board & 1) ? (S == 0 ? 0x3276u : 0x7610u)
                                        : (S == 0 ? 0x3254u : 0x5410u);
#pragma unroll
  for (int q = 0; q < STRIDE / 4; ++q) {
    const uint4 v = src[q];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * q + k < CELLS) {
        c[4 * q + k] = BITS == 32 ? w[k] : __byte_perm(c[4 * q + k], w[k], sel);
      }
    }
  }
}

// After a sweep that removed `removed`: a slot whose board reached its
// fixpoint or max_sweeps needs the next one.
template <int BITS, int S>
__device__ __forceinline__ void mark_done(Slot& slot, uint32_t removed, int max_sweeps) {
  const uint32_t changed = BITS == 16 ? (removed >> (16 * S)) & 0xFFFFu : removed;
  if (slot.active && (changed == 0u || ++slot.sweeps >= max_sweeps)) slot.need = true;
}

// One lane's queue over the tile: BITS = 32, one board a lane; BITS = 16,
// one board in each half, each half with its own board, sweep count and
// refill.  Returns when the tile has no unstarted board and every board
// the warp holds is done and back in the tile.
template <int BITS>
__device__ __forceinline__ void solve_tile(const Tile& tile, int max_sweeps, uint32_t parity,
                                           int* next) {
  uint32_t c[CELLS];
#pragma unroll
  for (int i = 0; i < CELLS; ++i) c[i] = 0u;
  Slot lo{-1, 0, false, true};
  Slot hi{-1, 0, false, BITS == 16};
  for (;;) {
    refill<BITS, 0>(c, lo, tile, parity, next);
    if constexpr (BITS == 16) refill<BITS, 1>(c, hi, tile, parity, next);
    if (!__any_sync(FULL, lo.active || hi.active)) break;
    const uint32_t removed = sweep<BITS>(c);
    mark_done<BITS, 0>(lo, removed, max_sweeps);
    if constexpr (BITS == 16) mark_done<BITS, 1>(hi, removed, max_sweeps);
  }
}

// BITS = 32: uint32 masks; BITS = 16: uint16 masks.  Dynamic shared
// memory: the tile's slots, then a barrier, a done counter and a claim
// flag a chunk.
template <int BITS>
__global__ void __launch_bounds__(THREADS, 1)
probe_fixpoint_kernel(const void* __restrict__ in, void* __restrict__ out, int T, int max_sweeps,
                      int tile_boards, int mode) {
  constexpr int PER = per_slot<BITS>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int next_board;
  const int slots = tile_boards / PER;
  const int chunks = (slots + 31) / 32;
  Tile tile;
  tile.words = reinterpret_cast<uint32_t*>(smem);
  tile.bars = reinterpret_cast<uint64_t*>(smem + (size_t)slots * STRIDE * 4);
  tile.done = reinterpret_cast<int*>(tile.bars + chunks);
  tile.claimed = tile.done + chunks;
  tile.T = T;
  tile.mode = mode;
  if (threadIdx.x == 0) {
    for (int j = 0; j < chunks; ++j) bar_init(&tile.bars[j], THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int j = threadIdx.x; j < chunks; j += THREADS) tile.done[j] = tile.claimed[j] = 0;
  if (threadIdx.x == 0) next_board = 0;
  __syncthreads();
  const int tiles = (T + tile_boards - 1) / tile_boards;
  uint32_t parity = 0u;  // each tile completes one phase of every barrier it uses
  for (int tt = blockIdx.x; tt < tiles; tt += gridDim.x, parity ^= 1u) {
    tile.t0 = tt * tile_boards;
    tile.n = min(tile_boards, T - tile.t0);
    stage<BITS>(static_cast<const Elem<BITS>*>(in), tile);
    if (max_sweeps > 0) {
      solve_tile<BITS>(tile, max_sweeps, parity, &next_board);
      drain<BITS>(static_cast<Elem<BITS>*>(out), tile, false);
    } else {
      for (int j = 0; j * 32 * PER < tile.n; ++j) bar_wait(&tile.bars[j], parity);
    }
    __syncthreads();
    drain<BITS>(static_cast<Elem<BITS>*>(out), tile, true);
    __syncthreads();
    for (int j = threadIdx.x; j < chunks; j += THREADS) tile.done[j] = tile.claimed[j] = 0;
    if (threadIdx.x == 0) next_board = 0;
    __syncthreads();
  }
}

struct Shape {
  int tile, grid, mode;
  size_t smem;
};

// The tile: about T / (number of SMs) boards, a multiple of 8, at most what
// shared memory holds; the grid: one block for each tile, at most the
// blocks the card holds at once (persistent blocks walk the rest).
template <int BITS>
int plan(const void* in, const void* out, int T, Shape* shape) {
  constexpr int PER = per_slot<BITS>();
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // A slot's words, and a chunk's barrier, counter and flag spread over it.
  const int per_slot_bytes = STRIDE * 4 + 1;
  const int max_slots = (optin - 1024) / per_slot_bytes / 32 * 32;
  const int want = ((T + sms - 1) / sms + ALIGN - 1) / ALIGN * ALIGN;
  shape->tile = want < max_slots * PER ? want : max_slots * PER;
  const int slots = shape->tile / PER, chunks = (slots + 31) / 32;
  shape->smem = (size_t)slots * STRIDE * 4 + chunks * (sizeof(uint64_t) + 2 * sizeof(int));
  const uintptr_t a = (uintptr_t)in | (uintptr_t)out;
  shape->mode = T % PER == 0 && a % 4 == 0 ? COPY4 : COPY_PLAIN;
  err = cudaFuncSetAttribute(probe_fixpoint_kernel<BITS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shape->smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_fixpoint_kernel<BITS>,
                                                      THREADS, shape->smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (T + shape->tile - 1) / shape->tile;
  shape->grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  return 0;
}

template <int BITS>
int launch(const void* in, void* out, int T, int max_sweeps, void* stream) {
  if (T > 0) {
    Shape shape;
    const int err = plan<BITS>(in, out, T, &shape);
    if (err != 0) return err;
    probe_fixpoint_kernel<BITS><<<shape.grid, THREADS, shape.smem, (cudaStream_t)stream>>>(
        in, out, T, max_sweeps, shape.tile, shape.mode);
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
