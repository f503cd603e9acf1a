/* Sudoku puzzles with a unique solution, for portbench's corpus.
 *
 *   corpus BOX_H BOX_W CLUES COUNT SEED > out.bin
 *
 * Writes COUNT records of n*n puzzle bytes (0 = empty) then n*n solution
 * bytes, n = BOX_H * BOX_W <= 25.  Each solution grid is filled by a
 * randomised backtracking search from an empty board (the digit order of
 * every branch drawn from SEED); the puzzle is carved from it one cell at a
 * time in a random order, a cell staying empty only where no other digit
 * there leads to a solution, until CLUES givens are left.  A grid whose
 * carve stops above CLUES (every given left is needed) is dropped and a new
 * one filled.  The search propagates naked and hidden singles and branches
 * on a cell with the fewest candidates.  Stderr gets the count of grids
 * dropped.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define MAXN 25
#define MAXC (MAXN * MAXN)

static int N, BH, BW, NC;
static uint32_t FULL;
static int unit_cells[3 * MAXN][MAXN];
static int cell_row[MAXC], cell_col[MAXC], cell_box[MAXC];

typedef struct {
    uint8_t g[MAXC];
    uint32_t row[MAXN], col[MAXN], box[MAXN];
} State;

static uint64_t rng_s;
static uint64_t next_u64(void) {
    uint64_t z = (rng_s += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
}
static uint32_t below(uint32_t k) { return (uint32_t)(next_u64() % k); }

static int ban_cell = -1;
static uint32_t ban_mask = 0;

static inline uint32_t cand(const State *s, int c) {
    uint32_t m = FULL & ~(s->row[cell_row[c]] | s->col[cell_col[c]] | s->box[cell_box[c]]);
    return c == ban_cell ? m & ~ban_mask : m;
}

static inline void place(State *s, int c, int d) {
    uint32_t b = 1u << (d - 1);
    s->g[c] = (uint8_t)d;
    s->row[cell_row[c]] |= b;
    s->col[cell_col[c]] |= b;
    s->box[cell_box[c]] |= b;
}

static void init_state(State *s, const uint8_t *grid) {
    memset(s, 0, sizeof *s);
    for (int c = 0; c < NC; c++)
        if (grid[c]) place(s, c, grid[c]);
}

/* Naked and hidden singles to a fixpoint.  Returns -1 on a contradiction,
 * NC when the board is full, else the empty cell with fewest candidates. */
static int propagate(State *s) {
    for (;;) {
        int changed = 0, best = NC, bestk = 99;
        for (int c = 0; c < NC; c++) {
            if (s->g[c]) continue;
            uint32_t m = cand(s, c);
            if (!m) return -1;
            if (!(m & (m - 1))) {
                place(s, c, __builtin_ctz(m) + 1);
                changed = 1;
            } else if (!changed) {
                int k = __builtin_popcount(m);
                if (k < bestk) { bestk = k; best = c; }
            }
        }
        if (changed) continue;
        for (int u = 0; u < 3 * N; u++) {
            uint32_t once = 0, twice = 0, have = 0;
            for (int i = 0; i < N; i++) {
                int c = unit_cells[u][i];
                if (s->g[c]) { have |= 1u << (s->g[c] - 1); continue; }
                uint32_t m = cand(s, c);
                twice |= once & m;
                once |= m;
            }
            uint32_t need = FULL & ~have;
            if ((once & need) != need) return -1;
            uint32_t hid = once & ~twice & need;
            while (hid) {
                uint32_t b = hid & -hid;
                hid ^= b;
                for (int i = 0; i < N; i++) {
                    int c = unit_cells[u][i];
                    if (!s->g[c] && (cand(s, c) & b)) { place(s, c, __builtin_ctz(b) + 1); break; }
                }
                changed = 1;
            }
        }
        if (!changed) return best;
    }
}

/* Depth-first search; counts solutions up to *left (decremented), copying
 * the first into out when out is not NULL.  With shuffle the digits of a
 * branch are tried in a random order. */
static void search(State *s, int *left, uint8_t *out, int shuffle) {
    int c = propagate(s);
    if (c < 0) return;
    if (c == NC) {
        if (out) memcpy(out, s->g, NC);
        (*left)--;
        return;
    }
    uint32_t m = cand(s, c);
    int digits[MAXN], k = 0;
    while (m) { digits[k++] = __builtin_ctz(m) + 1; m &= m - 1; }
    if (shuffle)
        for (int i = k - 1; i > 0; i--) {
            int j = (int)below((uint32_t)i + 1), t = digits[i];
            digits[i] = digits[j];
            digits[j] = t;
        }
    for (int i = 0; i < k && *left > 0; i++) {
        State t = *s;
        place(&t, c, digits[i]);
        search(&t, left, out, shuffle);
    }
}

int main(int argc, char **argv) {
    if (argc != 6) {
        fprintf(stderr, "usage: corpus BOX_H BOX_W CLUES COUNT SEED\n");
        return 2;
    }
    BH = atoi(argv[1]);
    BW = atoi(argv[2]);
    int clues = atoi(argv[3]);
    long count = atol(argv[4]);
    rng_s = strtoull(argv[5], NULL, 10);
    N = BH * BW;
    NC = N * N;
    if (N < 4 || N > MAXN || clues < 1 || clues > NC) return 2;
    FULL = (1u << N) - 1;
    for (int r = 0; r < N; r++)
        for (int c = 0; c < N; c++) {
            int cell = r * N + c, b = (r / BH) * (N / BW) + c / BW;
            cell_row[cell] = r;
            cell_col[cell] = c;
            cell_box[cell] = b;
            unit_cells[r][c] = cell;
            unit_cells[N + c][r] = cell;
        }
    int fill[MAXN] = {0};
    for (int cell = 0; cell < NC; cell++) {
        int b = cell_box[cell];
        unit_cells[2 * N + b][fill[b]++] = cell;
    }
    long dropped = 0;
    uint8_t sol[MAXC], puz[MAXC];
    int order[MAXC];
    for (long made = 0; made < count;) {
        State s;
        uint8_t empty[MAXC] = {0};
        init_state(&s, empty);
        int left = 1;
        search(&s, &left, sol, 1);
        if (left) return 3;
        memcpy(puz, sol, NC);
        for (int i = 0; i < NC; i++) order[i] = i;
        for (int i = NC - 1; i > 0; i--) {
            int j = (int)below((uint32_t)i + 1), t = order[i];
            order[i] = order[j];
            order[j] = t;
        }
        int have = NC;
        for (int i = 0; i < NC && have > clues; i++) {
            int c = order[i], d = puz[c];
            puz[c] = 0;
            /* Removable iff no solution has another digit at c. */
            ban_cell = c;
            ban_mask = 1u << (d - 1);
            init_state(&s, puz);
            int one = 1;
            search(&s, &one, NULL, 0);
            ban_cell = -1;
            ban_mask = 0;
            if (one == 0) puz[c] = (uint8_t)d;
            else have--;
        }
        if (have != clues) { dropped++; continue; }
        fwrite(puz, 1, NC, stdout);
        fwrite(sol, 1, NC, stdout);
        made++;
    }
    fprintf(stderr, "dropped %ld\n", dropped);
    return 0;
}
