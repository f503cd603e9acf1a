// The fused loop's job bookkeeping between two round-kernel dispatches, for
// K2 and K3 alike, in three launches.
//
// Replaces the XLA ops that the JAX package runs after each pallas_call of
// its fused loop (distributed_sudoku_solver_tpu/ops/pallas_step.py:
// _fused_round's harvest, purge and counters, _steal_t, and _run_fused's
// loop condition), which the port ran as a chain of small torch ops
// (ops/cuda_step.py: _kernel_outputs, _fused_bookkeeping, _fused_go; still
// the plain version, the CPU's path and the tests' reference).
//
// What bounds it on an H100: latency, not bytes or operations.  A dispatch
// reads the round kernel's eight lane_out rows and the lanes' job, base and
// count (a few bytes a lane), and moves only the rows that change: a dead
// lane's cleared words, a thief's stolen stack row, a newly solved job's
// solution row.  The chain of torch ops it replaces made dozens of passes
// over [L] and [L, D], and its scatters sent every lane of one job to one
// address (the count cell, J = 1: L atomics on one word a scatter).  This
// design:
//   * H (harvest): the tile clear, and every per-job reduction aggregated in
//     the warp (__match_any_sync on the job id, one atomic per distinct job
//     per warp: L/32 atomics at J = 1, what a scatter costs at J = L) into
//     per-job accumulators of the scratch; the scalar sums one atomic a block.
//   * P (purge and rank): each lane's job is live once H's first-solution
//     minima are complete; ballots of the idle and donor lanes a warp, counts
//     a block, and the last block to finish scans the block counts (a
//     block-level prefix scan of L/256 values) and writes the loop flag.
//   * S (steal and fold): the r-th idle lane of a segment (the whole frontier,
//     or a steal_gang block) finds the r-th donor from P's prefix counts and
//     ballots (a binary search and a popcount walk), and copies the donor's
//     bottom stack row as one warp; its own thread then bumps the donor's base
//     and cuts its count, so no lane's base is read after another thread
//     wrote it.  Each job folds its accumulators into the frontier (solution
//     rows copied by warps) and resets them for the next dispatch.
// The wrapper (ops/cuda_bookkeep.py) checks shapes, types and devices; the
// graph of the fused loop (ops/cuda_step._RoundGraph) captures the three
// launches.  The round kernel writes its tops into the buffer the frontier
// does not hold, and the two swap each dispatch, so no top is copied.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;  // lanes (or jobs) per block
constexpr int WARPS = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_LANE = INT_MAX;

// Scalars of the scratch, after the four per-job accumulators.
enum { SC_STEPS, SC_SWEEPS, SC_EXPANSIONS, SC_LIVE, SC_DONE, N_SCALARS };

struct Args {
  // The frontier, updated in place (its top is the round kernel's output).
  unsigned char* has_top;
  int* base;
  int* count;
  int* job;
  unsigned char* solved;
  int* solution;
  unsigned char* overflowed;
  int* nodes;
  int* sol_count;
  int* steps;
  int* sweeps;
  int* expansions;
  int* steals;
  int* lane_rounds;
  const int* stack;
  int* top;
  // The round kernel's other outputs.
  const int* lane_sol;
  const int* lane_out;  // [8, L]: has, count, solved, overflow, nodes, sols, live, sweeps
  const long long* limit;
  unsigned char* go;
  int* work;
  int lanes, jobs, slots, words, clear_words, tile, count_all, steal, gang;
};

struct Work {
  int* first;      // [J] lowest eligible lane of each job (NO_LANE: none)
  int* sols;       // [J]
  int* nodes;      // [J]
  int* over;       // [J]
  int* scalar;     // [N_SCALARS]
  int* idle_n;     // [nb] idle lanes a block
  int* donor_n;    // [nb]
  int* idle_pre;   // [nb + 1] exclusive prefix of idle_n
  int* donor_pre;  // [nb + 1]
  unsigned* idle_mask;   // [nb * WARPS] ballots
  unsigned* donor_mask;  // [nb * WARPS]
};

__host__ __device__ inline int blocks_of(int n) { return (n + BLOCK - 1) / BLOCK; }

__host__ __device__ inline long long work_words(int lanes, int jobs) {
  const long long nb = blocks_of(lanes);
  return 4LL * jobs + N_SCALARS + 4 * nb + 2 + 2 * nb * WARPS;
}

__device__ inline Work work_of(const Args& a) {
  const int nb = blocks_of(a.lanes);
  Work w;
  w.first = a.work;
  w.sols = w.first + a.jobs;
  w.nodes = w.sols + a.jobs;
  w.over = w.nodes + a.jobs;
  w.scalar = w.over + a.jobs;
  w.idle_n = w.scalar + N_SCALARS;
  w.donor_n = w.idle_n + nb;
  w.idle_pre = w.donor_n + nb;
  w.donor_pre = w.idle_pre + nb + 1;
  w.idle_mask = (unsigned*)(w.donor_pre + nb + 1);
  w.donor_mask = w.idle_mask + nb * WARPS;
  return w;
}

__device__ inline int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

__device__ inline int clamp_job(int j, int jobs) { return j < 0 ? 0 : (j >= jobs ? jobs - 1 : j); }

// The sum of v over the lanes of ``peers`` (a __match_any_sync group); every
// lane of the warp calls it.
__device__ inline unsigned group_sum(unsigned peers, unsigned v) {
  if (__all_sync(FULL, peers == FULL)) return __reduce_add_sync(FULL, v);
  const int lane = threadIdx.x % 32;
  if (__all_sync(FULL, peers == 1u << lane)) return v;
  unsigned s = 0;
  for (int i = 0; i < 32; ++i) {
    const unsigned x = __shfl_sync(FULL, v, i);
    if (peers >> i & 1u) s += x;
  }
  return s;
}

// Warp-cooperative copy of ``n`` words for each lane whose bit is set in
// ``todo``: src[lane] -> dst[lane] as that lane gave them.  Two rows at a
// time, each lane's words of both loaded before any is stored, so a row
// of up to 256 words costs about one load latency and not eight (the
// source rows are never written while this runs).
__device__ inline void warp_copy_rows(unsigned todo, const int* src, int* dst, int n) {
  constexpr int PER_LANE = 8;
  const int lane = threadIdx.x % 32;
  while (todo) {
    const int a = __ffs(todo) - 1;
    todo &= todo - 1;
    const int b = todo ? __ffs(todo) - 1 : a;
    todo &= todo - 1;
    const int* sa = (const int*)__shfl_sync(FULL, (unsigned long long)src, a);
    const int* sb = (const int*)__shfl_sync(FULL, (unsigned long long)src, b);
    int* da = (int*)__shfl_sync(FULL, (unsigned long long)dst, a);
    int* db = (int*)__shfl_sync(FULL, (unsigned long long)dst, b);
    for (int base = lane; base < n; base += 32 * PER_LANE) {
      int va[PER_LANE], vb[PER_LANE];
#pragma unroll
      for (int r = 0; r < PER_LANE; ++r) {
        const int k = base + 32 * r;
        if (k < n) {
          va[r] = __ldg(sa + k);
          vb[r] = __ldg(sb + k);
        }
      }
#pragma unroll
      for (int r = 0; r < PER_LANE; ++r) {
        const int k = base + 32 * r;
        if (k < n) {
          da[k] = va[r];
          db[k] = vb[r];
        }
      }
    }
  }
}

// Flagged lanes below lane x: the block prefix, then the ballots up to x.
__device__ inline int rank_below(const unsigned* mask, const int* pre, int x) {
  const int b = x / BLOCK, wx = x >> 5;
  int r = pre[b];
  for (int w = b * WARPS; w < wx; ++w) r += __popc(mask[w]);
  if (x & 31) r += __popc(mask[wx] & ((1u << (x & 31)) - 1u));
  return r;
}

// The lane of the r-th flagged lane (r below the total).
__device__ inline int lane_of_rank(const unsigned* mask, const int* pre, int nb, int r) {
  int lo = 0, hi = nb - 1;  // the last block whose prefix is <= r holds it
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (pre[mid] <= r) lo = mid; else hi = mid - 1;
  }
  r -= pre[lo];
  for (int w = lo * WARPS;; ++w) {
    unsigned m = mask[w];
    const int c = __popc(m);
    if (r < c) {
      for (; r > 0; --r) m &= m - 1;
      return w * 32 + __ffs(m) - 1;
    }
    r -= c;
  }
}

// -- H: tile clear, harvest, counters -----------------------------------------

__global__ void __launch_bounds__(BLOCK) harvest_kernel(Args a) {
  __shared__ int tile_max[BLOCK];
  __shared__ unsigned block_sum[3];
  const Work w = work_of(a);
  const int L = a.lanes, lane = threadIdx.x % 32;
  const int first_lane = blockIdx.x * BLOCK;
  const int l = first_lane + threadIdx.x;
  const bool valid = l < L;
  const int live = valid ? a.lane_out[6LL * L + l] : 0;
  tile_max[threadIdx.x] = 0;
  if (threadIdx.x < 3) block_sum[threadIdx.x] = 0;
  __syncthreads();
  // A block holds whole tiles: the tile divides the block, or one block
  // holds every lane (dsst_bookkeep refuses anything else).
  if (valid) atomicMax(&tile_max[(l - first_lane) / a.tile], live);
  __syncthreads();
  const bool dead = valid && live < tile_max[(l - first_lane) / a.tile];
  // The dead lanes' first clear_words words, one warp a row.
  for (unsigned todo = __ballot_sync(FULL, dead); todo; todo &= todo - 1) {
    int* row = a.top + (long long)(l - lane + __ffs(todo) - 1) * a.words;
    for (int k = lane; k < a.clear_words; k += 32) row[k] = 0;
  }

  int j = -1;
  unsigned nodes_d = 0, sols_d = 0, sweeps_d = 0;
  bool eligible = false, over = false;
  if (valid) {
    j = a.job[l];
    const int js = clamp_job(j, a.jobs);
    const bool had = a.count_all ? a.sol_count[js] > 0 : a.solved[js] != 0;
    eligible = j >= 0 && a.lane_out[2LL * L + l] > 0 && !had;
    over = j >= 0 && a.lane_out[3LL * L + l] > 0;
    nodes_d = (unsigned)a.lane_out[4LL * L + l];
    sols_d = (unsigned)a.lane_out[5LL * L + l];
    sweeps_d = (unsigned)a.lane_out[7LL * L + l];
    a.lane_rounds[l] = (int)((unsigned)a.lane_rounds[l] + (unsigned)live);
  }
  // Per job: the warp's lanes of one job reduce together, and the group's
  // lowest lane makes the atomics.
  const bool keyed = valid && j >= 0 && j < a.jobs;
  const unsigned peers = __match_any_sync(FULL, keyed ? (unsigned)j : (0x80000000u | lane));
  const unsigned first_bits = peers & __ballot_sync(FULL, eligible);
  const bool any_over = (peers & __ballot_sync(FULL, over)) != 0u;
  const unsigned nodes_j = group_sum(peers, keyed ? nodes_d : 0u);
  const unsigned sols_j = a.count_all ? group_sum(peers, keyed ? sols_d : 0u) : 0u;
  if (keyed && lane == __ffs(peers) - 1) {
    if (first_bits) atomicMin(&w.first[j], l - lane + __ffs(first_bits) - 1);
    if (nodes_j) atomicAdd((unsigned*)&w.nodes[j], nodes_j);
    if (sols_j) atomicAdd((unsigned*)&w.sols[j], sols_j);
    if (any_over) w.over[j] = 1;
  }
  // Every lane's sweeps, node expansions and rounds, whatever its job.
  const unsigned sweeps_w = __reduce_add_sync(FULL, sweeps_d);
  const unsigned nodes_w = __reduce_add_sync(FULL, nodes_d);
  const unsigned live_w = __reduce_max_sync(FULL, (unsigned)live);
  if (lane == 0) {
    atomicAdd(&block_sum[0], sweeps_w);
    atomicAdd(&block_sum[1], nodes_w);
    atomicMax(&block_sum[2], live_w);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (block_sum[0]) atomicAdd((unsigned*)&w.scalar[SC_SWEEPS], block_sum[0]);
    if (block_sum[1]) atomicAdd((unsigned*)&w.scalar[SC_EXPANSIONS], block_sum[1]);
    if (block_sum[2]) atomicMax((unsigned*)&w.scalar[SC_STEPS], block_sum[2]);
  }
}

// -- P: purge, idle and donor ranks, the loop flag ---------------------------

__device__ inline void block_exclusive_scan(const int* counts, int* pre, int n, int* carry_smem,
                                            int* warp_smem) {
  // One block scans n counts (read from L2: other blocks wrote them).
  const int lane = threadIdx.x % 32, wib = threadIdx.x / 32;
  if (threadIdx.x == 0) *carry_smem = 0;
  __syncthreads();
  for (int start = 0; start < n; start += BLOCK) {
    const int i = start + threadIdx.x;
    const int v = i < n ? __ldcg(counts + i) : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_smem[wib] = x;
    __syncthreads();
    int before = *carry_smem;
    for (int k = 0; k < wib; ++k) before += warp_smem[k];
    if (i < n) pre[i] = before + x - v;
    __syncthreads();
    if (threadIdx.x == BLOCK - 1) *carry_smem = before + x;
    __syncthreads();
  }
  if (threadIdx.x == 0) pre[n] = *carry_smem;
}

__global__ void __launch_bounds__(BLOCK) purge_kernel(Args a) {
  __shared__ int idle_w[WARPS], donor_w[WARPS];
  __shared__ int carry, scan_w[WARPS];
  __shared__ bool last;
  const Work w = work_of(a);
  const int L = a.lanes, lane = threadIdx.x % 32, wib = threadIdx.x / 32;
  const int l = blockIdx.x * BLOCK + threadIdx.x;
  bool has = false, donor = false;
  const bool valid = l < L;
  if (valid) {
    const int j = a.job[l];
    const int js = clamp_job(j, a.jobs);
    const bool solved = a.solved[js] != 0 || (!a.count_all && w.first[js] != NO_LANE);
    const bool job_live = j >= 0 && !solved;
    has = job_live && a.lane_out[l] > 0;
    const int cnt = job_live ? a.lane_out[(long long)L + l] : 0;
    a.has_top[l] = has;
    a.count[l] = cnt;
    donor = has && cnt >= 1;
  }
  const bool any_live = __syncthreads_or(has);
  if (a.steal) {
    const unsigned im = __ballot_sync(FULL, valid && !has), dm = __ballot_sync(FULL, donor);
    if (lane == 0) {
      w.idle_mask[blockIdx.x * WARPS + wib] = im;
      w.donor_mask[blockIdx.x * WARPS + wib] = dm;
      idle_w[wib] = __popc(im);
      donor_w[wib] = __popc(dm);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int ni = 0, nd = 0;
      for (int k = 0; k < WARPS; ++k) ni += idle_w[k], nd += donor_w[k];
      w.idle_n[blockIdx.x] = ni;
      w.donor_n[blockIdx.x] = nd;
    }
  }
  if (threadIdx.x == 0) {
    if (any_live) w.scalar[SC_LIVE] = 1;
    __threadfence();
    last = atomicAdd(&w.scalar[SC_DONE], 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (a.steal) {
    block_exclusive_scan(w.idle_n, w.idle_pre, gridDim.x, &carry, scan_w);
    block_exclusive_scan(w.donor_n, w.donor_pre, gridDim.x, &carry, scan_w);
  }
  if (threadIdx.x == 0) {
    volatile int* sc = w.scalar;
    const int steps = (int)((unsigned)*a.steps + (unsigned)sc[SC_STEPS]);
    *a.steps = steps;
    *a.sweeps = (int)((unsigned)*a.sweeps + (unsigned)sc[SC_SWEEPS]);
    *a.expansions = (int)((unsigned)*a.expansions + (unsigned)sc[SC_EXPANSIONS]);
    *a.go = sc[SC_LIVE] != 0 && (long long)steps < *a.limit;
    sc[SC_STEPS] = 0;
    sc[SC_SWEEPS] = 0;
    sc[SC_EXPANSIONS] = 0;
    sc[SC_LIVE] = 0;
    sc[SC_DONE] = 0;
  }
}

// -- S: steals, and each job's fold ------------------------------------------

__global__ void __launch_bounds__(BLOCK) steal_fold_kernel(Args a) {
  __shared__ int pairs_w[WARPS];
  const Work w = work_of(a);
  const int L = a.lanes, lane = threadIdx.x % 32, wib = threadIdx.x / 32;
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const int nb = blocks_of(L);

  if (a.steal && blockIdx.x < nb) {  // a block of lanes: thieves
    const int t = i;
    bool thief = false;
    const int* src = nullptr;
    int* dst = nullptr;
    int d = 0;
    if (t < L && (w.idle_mask[t >> 5] >> (t & 31) & 1u)) {
      const int g0 = a.gang > 0 ? t / a.gang * a.gang : 0;
      const int g1 = a.gang > 0 ? g0 + a.gang : L;
      const int rank = rank_below(w.idle_mask, w.idle_pre, t) -
                       rank_below(w.idle_mask, w.idle_pre, g0);
      const int donors_below = rank_below(w.donor_mask, w.donor_pre, g0);
      if (rank < rank_below(w.donor_mask, w.donor_pre, g1) - donors_below) {
        d = lane_of_rank(w.donor_mask, w.donor_pre, nb, donors_below + rank);
        thief = true;
        const int slot = floor_mod(a.base[d], a.slots);
        src = a.stack + ((long long)d * a.slots + slot) * a.words;
        dst = a.top + (long long)t * a.words;
      }
    }
    const unsigned pairs = __ballot_sync(FULL, thief);
    warp_copy_rows(pairs, src, dst, a.words);
    if (thief) {
      a.has_top[t] = 1;
      a.job[t] = a.job[d];
      a.base[d] = floor_mod(a.base[d] + 1, a.slots);
      a.count[d] -= 1;
    }
    if (lane == 0) pairs_w[wib] = __popc(pairs);
    __syncthreads();
    if (threadIdx.x == 0) {
      int n = 0;
      for (int k = 0; k < WARPS; ++k) n += pairs_w[k];
      if (n) atomicAdd((unsigned*)a.steals, (unsigned)n);
    }
  }

  // A job: fold its accumulators, copy a newly found solution, reset.
  const int j = i;
  bool newly = false;
  const int* src = nullptr;
  int* dst = nullptr;
  if (j < a.jobs) {
    const int f = w.first[j];
    newly = f != NO_LANE;
    if (newly) {
      src = a.lane_sol + (long long)f * a.words;
      dst = a.solution + (long long)j * a.words;
    }
    if (a.count_all) {
      a.sol_count[j] = (int)((unsigned)a.sol_count[j] + (unsigned)w.sols[j]);
    } else {
      const bool s = a.solved[j] != 0 || newly;
      a.solved[j] = s;
      a.sol_count[j] = s;
    }
    if (w.over[j]) a.overflowed[j] = 1;
    a.nodes[j] = (int)((unsigned)a.nodes[j] + (unsigned)w.nodes[j]);
    w.first[j] = NO_LANE;
    w.sols[j] = 0;
    w.nodes[j] = 0;
    w.over[j] = 0;
  }
  warp_copy_rows(__ballot_sync(FULL, newly), src, dst, a.words);
}

}  // namespace

// -- host side -------------------------------------------------------------------

extern "C" long long dsst_bookkeep_work_words(int lanes, int jobs) {
  return work_words(lanes, jobs);
}

// Loads the three kernels (lazy module loading would otherwise load them at
// their first launch, which may be inside a graph capture).
extern "C" int dsst_bookkeep_prepare() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, harvest_kernel);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, purge_kernel);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, steal_fold_kernel);
  return (int)err;
}

extern "C" int dsst_bookkeep(void* has_top, void* base, void* count, void* job, void* solved,
                             void* solution, void* overflowed, void* nodes, void* sol_count,
                             void* steps, void* sweeps, void* expansions, void* steals,
                             void* lane_rounds, const void* stack, void* top,
                             const void* lane_sol, const void* lane_out, const void* limit,
                             void* go, void* work, long long work_len, int lanes, int jobs,
                             int slots, int words, int clear_words, int tile, int count_all,
                             int steal, int gang, void* stream) {
  if (lanes < 1 || jobs < 1 || slots < 1 || words < 1 || clear_words < 0 ||
      clear_words > words || tile < 1 || lanes % tile != 0 ||
      (lanes > BLOCK && BLOCK % tile != 0) || gang < 0 ||
      (gang > 0 && lanes % gang != 0) || work_len < work_words(lanes, jobs))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.has_top = (unsigned char*)has_top;
  a.base = (int*)base;
  a.count = (int*)count;
  a.job = (int*)job;
  a.solved = (unsigned char*)solved;
  a.solution = (int*)solution;
  a.overflowed = (unsigned char*)overflowed;
  a.nodes = (int*)nodes;
  a.sol_count = (int*)sol_count;
  a.steps = (int*)steps;
  a.sweeps = (int*)sweeps;
  a.expansions = (int*)expansions;
  a.steals = (int*)steals;
  a.lane_rounds = (int*)lane_rounds;
  a.stack = (const int*)stack;
  a.top = (int*)top;
  a.lane_sol = (const int*)lane_sol;
  a.lane_out = (const int*)lane_out;
  a.limit = (const long long*)limit;
  a.go = (unsigned char*)go;
  a.work = (int*)work;
  a.lanes = lanes;
  a.jobs = jobs;
  a.slots = slots;
  a.words = words;
  a.clear_words = clear_words;
  a.tile = tile;
  a.count_all = count_all;
  a.steal = steal;
  a.gang = gang;
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = blocks_of(lanes);
  harvest_kernel<<<nb, BLOCK, 0, s>>>(a);
  purge_kernel<<<nb, BLOCK, 0, s>>>(a);
  steal_fold_kernel<<<blocks_of(lanes > jobs ? lanes : jobs), BLOCK, 0, s>>>(a);
  return (int)cudaGetLastError();
}
