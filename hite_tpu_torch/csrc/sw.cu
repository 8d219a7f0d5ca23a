// Batched Smith-Waterman local alignment for Hopper (sm_90a).
//
// Replaces the TPU kernel hite_tpu/ops/terminal_pallas.py:_sw_kernel
// (batched_local_align_pallas, dispatched by ops/terminal.py:
// batched_local_align_auto).  It computes exactly what the plain version
// hite_tpu_torch/ops/terminal.py:_local_align_core computes:
//   * linear-gap SW, h = max(0, diag + sub, up - gap, left - gap), where
//     sub = match if both codes are < invalid_code and equal, else mismatch;
//   * the choice is the FIRST argmax of [fresh, diag, up, left] (a zero
//     score starts fresh; diag beats up beats left);
//   * every cell carries its start (si, sj), match count m and length l;
//     a fresh cell starts at its own (i, j) with m = l = 0; row 0 and
//     column 0 are fresh zero-score cells;
//   * the answer is the cell with the largest score, the first row among
//     ties and the first column within that row (the plain version's
//     per-row strict-> running best followed by a first-row argmax).
// Output int32 out[7][B] = score (>= 0), qs = si, qe = row, ss = sj,
// se = column, matches, alen.  Any La, Lb and B.
//
// Protein mode (TAB) replaces the nucleotide substitution with a table:
// sub = table[x][y] where both codes are valid, else mismatch (the plain
// version's `submatrix` mode, which the domain engine calls with
// BLOSUM62, mismatch -4, gap 8, invalid code 20 = X).  The host passes a
// 32 x 32 int32 table (ops/terminal.py:sw_table: the caller's entries for
// codes below the invalid code, mismatch everywhere else, every entry an
// int8); an invalid a code is recoded to 30 and an invalid b code to 31,
// so an invalid pair reads a mismatch entry and `im = x == y` stays the
// match test.  Instantiated for packed fields only, R 4 and 8, one band
// and banded.  Two things differ from the nucleotide mode:
//   * Extents.  The domain confirm pads every row of a batch with X to
//     the batch's largest power of two, and adds all-X rows.  Each group
//     finds its alignment's extents on the device (La_r, Lb_r: the index
//     after the last code below the invalid code in a and in b; 0 when
//     there is none) and computes only the La_r x Lb_r region.  Only a
//     trailing run of invalid codes is cut.  This is exact when
//     mismatch < 0 and gap > 0 (otherwise the extents are the full
//     widths): a cell in a cut row or column has an invalid code on its
//     row or column, so it scores max(0, pred - c) with c > 0 for each
//     predecessor; by induction every cut cell scores
//     0 or strictly less than the region's best M.  So no cut cell can be
//     the best (when M = 0 the best is cell (1, 1), which is in the
//     region), and the region's cells depend only on cells above and to
//     the left of them, none of which is cut.  An empty region (La_r or
//     Lb_r 0 with La, Lb > 0) returns what the plain version returns for
//     an all-invalid row: score 0 at cell (1, 1), a fresh start there,
//     no matches, length 0.  A warp steps to the last column of its
//     groups' last active lanes; a band past its alignment's La_r takes
//     its ticket, does nothing, and reports a "no cell" best (it is never
//     waited on: the band below it is past La_r too).
//   * A query profile in shared memory in place of a table lookup a cell.
//     Each lane writes, once, the R int8 scores of its R rows against
//     each b code 0-31 into its own slot (R bytes a code: lane g's word
//     of code c is c * 32 + g words, or two words at R = 8), so a
//     step reads all R scores of its column's b code in one
//     bank-conflict-free load (two halves for R = 8) whatever b code each
//     lane holds; a lane reads only its own slots, so no barrier.

// Design.  The unit of work is a GROUP of G lanes of one warp that owns a
// band of G * R DP rows of one alignment, R consecutive rows per lane
// whose previous-column cells live in registers.  Lane g works on column
// j = s - g + 1 at step s (Lb + G - 1 steps), so the lanes form a
// wavefront; the cell above a lane's first row is lane g-1's last row
// from the step before, passed by one __shfl_sync per word: no shared
// memory between lanes and no __syncthreads in the step loop.
//   * Short alignments (G * R >= La): one band, and 32 / G groups (so
//     32 / G alignments) per warp.
//   * Long alignments: G = 32 and nb bands of 32 * R rows, one warp per
//     (alignment, band), so B * nb warps fill the SMs however small B is.
//     Band k's last lane writes its bottom row to global memory and
//     publishes it every CHUNK columns with a release store of a progress
//     count; band k+1 acquires that count, stages the chunk in shared
//     memory AHEAD steps before it needs it, and its last lane feeds the
//     cell above the band's first row into the same rotating shuffle.
//     Warps take (band, alignment) from an atomic ticket in band-major
//     order, so a band only ever waits on a band that has already started:
//     no launch order or residency can deadlock.  Each band keeps its own
//     best; the last band of an alignment to finish (an atomic count)
//     reduces them in band order under the same total order.
//   * A cell is three words: h, (si, sj) and (m, d) packed as two 16-bit
//     halves of a 32-bit word (W = uint32, when La and Lb < 65536) or two
//     32-bit halves of a 64-bit word (W = uint64, any width): three
//     shuffles per step instead of five.  d counts diagonal moves, so the
//     diagonal move is ml += 1 + (im << S), an up or left move copies ml,
//     and the length is (i - si) + (j - sj) - d at the end.  The best
//     cell's (row, column) key has the same packing, so its tie rule is
//     one unsigned compare.
//
// What bounds it.  Integer ALU issue: there is no tensor-core path for
// this recurrence (chip_smoke.py prints the step loop's SASS instructions
// per cell of each instantiation).  With a warp or less a scheduler (few,
// long alignments) a warp's own issue of its step bounds it, so the cell
// keeps its chain short (one DPX add-max-relu on the score, one select on
// each packed field) and the one-band loop carries no hand-off code.
// Each band also starts at least CHUNK + 31 lanes of skew + AHEAD steps
// after the band above it, which bounds how far B * nb bands can overlap.
// R (rows a lane) is 4 or 8; ops/terminal.py:sw_rows chooses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;       // warps per block; each warp is independent
constexpr int CHUNK = 32;      // hand-off columns per published progress:
                               // one column a lane
constexpr int AHEAD = 4;       // steps a chunk is fetched before its use
constexpr int NEG = -1000000000;
constexpr unsigned FULL = 0xffffffffu;

template <typename W>
struct Cell {
  int h;
  W st;  // (si << S) | sj
  W ml;  // (m << S) | d, d = diagonal moves
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

constexpr int TAB_W = 32;      // protein table row width (codes 0-31)
constexpr int TAB_INV_A = 30;  // an invalid a code in protein mode
constexpr int TAB_INV_B = 31;  // an invalid b code in protein mode

// Protein profile words a warp: TAB_W codes x 32 lanes x a slot of R
// int8 scores
template <int R>
constexpr int PROF_WORDS = TAB_W * 32 * R / 4;

// The nucleotide substitution term of one cell: a code x against a b
// code y, both recoded so that an invalid code equals nothing.
__device__ __forceinline__ int sub_score(int x, int y, int match,
                                         int mismatch, int& im) {
  im = x == y;
  return im ? match : mismatch;
}

__device__ __forceinline__ int sbyte(unsigned w, int k) {
  return (int)(signed char)(w >> (8 * k));
}

// The extent of a row of n codes (the index after its last code below
// `inv`, 0 when there is none), found by the G lanes of group `grp` from
// the row's end backwards, G codes a round; every lane of the warp takes
// part in every round.
__device__ __forceinline__ int row_extent(const uint8_t* row, int n, int inv,
                                          bool live, int g, int G, int grp) {
  const unsigned bits =
      (G == 32 ? FULL : ((1u << G) - 1) << (grp * G));
  int end = live ? n : 0;  // codes at [0, end) not yet ruled out
  int ext = 0;
  bool done = end <= 0;
  while (__any_sync(FULL, !done)) {
    const int p = end - G + g;
    const bool v = !done && p >= 0 && row[p] < inv;
    const unsigned m = __ballot_sync(FULL, v) & bits;
    if (!done) {
      if (m) {
        ext = end - G + (31 - __clz(m)) - grp * G + 1;
        done = true;
      } else {
        end -= G;
        done = end <= 0;
      }
    }
  }
  return ext;
}

template <typename W>
__device__ __forceinline__ Cell<W> shfl_cell(const Cell<W>& c, int src) {
  return {__shfl_sync(FULL, c.h, src), __shfl_sync(FULL, c.st, src),
          __shfl_sync(FULL, c.ml, src)};
}

template <typename W>
__device__ __forceinline__ bool better(int h, W key, int bh, W bkey) {
  return h > bh || (h == bh && key < bkey);
}

// BANDED: nb > 1 bands of G = 32 lanes, one warp each, with the hand-off;
// otherwise one band a group, and the step loop carries no hand-off code.
// TAB: protein mode, scores from the 32 x 32 `table`.
template <int R, typename W, bool BANDED, bool TAB>
__global__ void __launch_bounds__(WARPS * 32)
sw_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
          int B, int La, int Lb, int match, int mismatch, int gap, int inv,
          int G, int nb, int* __restrict__ out, int* __restrict__ sync,
          W* __restrict__ ho_st, W* __restrict__ ho_ml,
          int* __restrict__ ho_h, W* __restrict__ bests,
          const int* __restrict__ table) {
  constexpr int S = 4 * sizeof(W);  // bits per packed half
  __shared__ __align__(16) unsigned s_prof[TAB ? WARPS * PROF_WORDS<R> : 1];
  constexpr W LOW = (W(1) << S) - 1;
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  if (BANDED) G = 32;  // what the host passes; a constant for the compiler
  const int gpw = 32 / G;
  const int grp = lane / G;
  const int g = lane - grp * G;

  __shared__ int s_h[WARPS][2 * CHUNK];  // two chunks of the band above
  __shared__ W s_st[WARPS][2 * CHUNK];
  __shared__ W s_ml[WARPS][2 * CHUNK];

  int aln, band;
  if (!BANDED) {
    aln = (blockIdx.x * WARPS + wib) * gpw + grp;
    band = 0;
    if (grp >= gpw) aln = B;  // lanes past the warp's last group idle
  } else {
    int u = 0;
    if (lane == 0) u = atomicAdd(sync, 1);
    u = __shfl_sync(FULL, u, 0);
    band = u / B;
    aln = u - band * B;
    if (band >= nb) aln = B;
  }
  const bool live = aln < B;
  if (__ballot_sync(FULL, live) == 0) return;  // warp-uniform

  const int top = band * G * R + g * R + 1;  // first DP row of the lane
  int nrows = live ? La - top + 1 : 0;
  nrows = nrows < 0 ? 0 : (nrows > R ? R : nrows);
  const uint8_t* arow = a + (size_t)(live ? aln : 0) * La;
  const uint8_t* brow = b + (size_t)(live ? aln : 0) * Lb;
  // the region computed: La_r x Lb_r (protein mode, when the cut is
  // exact), else La x Lb
  int La_r = La, Lb_r = Lb;
  if (TAB && mismatch < 0 && gap > 0) {
    La_r = row_extent(arow, La, inv, live, g, G, grp);
    Lb_r = row_extent(brow, Lb, inv, live && La_r > 0, g, G, grp);
    if (La_r == 0 || Lb_r == 0) La_r = Lb_r = 0;
    nrows = live ? La_r - top + 1 : 0;
    nrows = nrows < 0 ? 0 : (nrows > R ? R : nrows);
  }

  int aq[R];
  Cell<W> col[R];  // cells of the previous column
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int x = q < nrows ? (int)arow[top - 1 + q] : inv;
    aq[q] = x < inv ? x : (TAB ? TAB_INV_A : 0x100);
    col[q] = {0, (W)(top + q) << S, 0};  // column 0: fresh (i, 0)
  }
  // protein mode: this lane's profile slots, code c's scores at word
  // c * 32 + lane (R = 4) or words 2 (c * 32 + lane) + {0, 1} (R = 8)
  unsigned* const prof = s_prof + (TAB ? wib * PROF_WORDS<R> : 0);
  if (TAB) {
#pragma unroll 4
    for (int c = 0; c < TAB_W; ++c) {
      unsigned w[R / 4] = {};
#pragma unroll
      for (int q = 0; q < R; ++q)
        w[q / 4] |= (unsigned)(table[aq[q] * TAB_W + c] & 0xff)
                    << (8 * (q % 4));
      if constexpr (R == 8) {
        prof[2 * (c * 32 + lane)] = w[0];
        prof[2 * (c * 32 + lane) + 1] = w[1];
      } else {
        prof[c * 32 + lane] = w[0];
      }
    }
  }
  Cell<W> above_prev = {0, (W)(top - 1) << S, 0};  // cell (top - 1, 0)
  Cell<W> out_cell = {0, 0, 0};  // the lane's last row, last column
  int bh = NEG;
  W bkey = 0, bst = 0, bml = 0;

  // band hand-off (nb > 1; G == 32, one group per warp)
  // (protein mode: only bands with rows; a band past La_r waits on none)
  const int nb_r = TAB ? (La_r + 32 * R - 1) / (32 * R) : nb;
  const bool produce = BANDED && live && band < nb_r - 1;
  const bool consume = BANDED && live && band > 0 && (!TAB || band < nb_r);
  // this band's hand-off row (column j at j - 1) and the band above's
  const size_t my_row = ((size_t)aln * (nb - 1) + band) * Lb;
  const size_t up_row = my_row - Lb;
  int* const out_h = produce ? ho_h + my_row : nullptr;
  W* const out_st = produce ? ho_st + my_row : nullptr;
  W* const out_ml = produce ? ho_ml + my_row : nullptr;
  int* prog = sync + 1 + B + (size_t)aln * nb;  // progress of each band
  int pre_h = 0;
  W pre_st = 0, pre_ml = 0;
  auto fetch = [&](int c) {  // wait for chunk c of band - 1, load it
    const int need = min((c + 1) * CHUNK, Lb_r);
    while (ld_acquire(prog + band - 1) < need) __nanosleep(32);
    const int j = c * CHUNK + lane + 1;
    if (j <= Lb_r) {
      pre_h = __ldcg(ho_h + up_row + j - 1);
      pre_st = __ldcg(ho_st + up_row + j - 1);
      pre_ml = __ldcg(ho_ml + up_row + j - 1);
    }
  };
  if (consume) fetch(0);

  // lane g takes the cell above from lane g-1; the group's first lane
  // from its last lane, which sends row 0 or the band above
  const int src = g > 0 ? lane - 1 : lane + G - 1;
  const bool last = g == G - 1;
  // protein mode: to the last column of the last lane with rows
  const int steps =
      TAB ? __reduce_max_sync(FULL, nrows > 0 ? Lb_r + g : 0) : Lb + G - 1;
  // b code of the lane's column, loaded one step ahead at a clamped index
  int bnext = Lb > 0 ? (int)brow[0] : inv;
  for (int s = 0; s < steps; ++s) {
    const int j = s - g + 1;
    const bool on = j >= 1 && j <= Lb_r && nrows > 0;
    const int bc = bnext < inv ? bnext : (TAB ? TAB_INV_B : 0x200);
    if (Lb > 0) bnext = brow[min(max(j, 0), Lb - 1)];
    Cell<W> hand = {0, (W)(s + 1), 0};  // row 0: fresh (0, s + 1)
    if (consume) {  // warp-uniform
      const int k = s & (2 * CHUNK - 1);
      if (s < Lb_r && (s & (CHUNK - 1)) == 0) {
        s_h[wib][k + lane] = pre_h;
        s_st[wib][k + lane] = pre_st;
        s_ml[wib][k + lane] = pre_ml;
        __syncwarp();
      }
      if (s + AHEAD < Lb_r && ((s + AHEAD) & (CHUNK - 1)) == 0)
        fetch((s + AHEAD) / CHUNK);
      hand = {s_h[wib][k], s_st[wib][k], s_ml[wib][k]};  // past Lb: unused
    }
    const Cell<W> above = shfl_cell(last ? hand : out_cell, src);
    // protein mode: the R scores of this column's b code, one load
    unsigned pw0 = 0, pw1 = 0;
    if (TAB && on) {
      if constexpr (R == 8) {
        const uint2 w2 = reinterpret_cast<const uint2*>(prof)[bc * 32 + lane];
        pw0 = w2.x;
        pw1 = w2.y;
      } else {
        pw0 = prof[bc * 32 + lane];
      }
    }
    if (on) {
      Cell<W> diag = above_prev;
      Cell<W> up = above;
      const W jw = (W)j;
      // every row of the strip is computed (rows past La hold junk that
      // no lane reads and the best never takes), so the cell is straight
      // selects with no branch; of the cell above only h feeds the
      // score (one DPX instruction) and its packed fields one select each
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const Cell<W> left = col[q];
        int im;
        int sub;
        if (TAB) {
          im = aq[q] == bc;
          sub = sbyte(q < 4 ? pw0 : pw1, q % 4);
        } else {
          sub = sub_score(aq[q], bc, match, mismatch, im);
        }
        const int cd = diag.h + sub;
        // max(0, cd, left - gap, up - gap)
        const int h = __viaddmax_s32_relu(up.h, -gap, max(cd, left.h - gap));
        const W key = ((W)(top + q) << S) | jw;
        // first argmax of [fresh, diag, up, left]
        const bool fresh = h == 0;
        const bool take_d = cd == h;
        const bool take_u = !fresh && !take_d && up.h - gap == h;
        W st = take_d ? diag.st : left.st;
        W ml = take_d ? diag.ml + (((W)im << S) | 1) : left.ml;
        st = fresh ? key : st;
        ml = fresh ? (W)0 : ml;
        const Cell<W> c = {h, take_u ? up.st : st, take_u ? up.ml : ml};
        const bool bt = q < nrows && better(h, key, bh, bkey);
        bh = bt ? h : bh;
        bkey = bt ? key : bkey;
        bst = bt ? c.st : bst;
        bml = bt ? c.ml : bml;
        diag = left;
        up = c;
        col[q] = c;
      }
      above_prev = above;
      out_cell = up;
      if (produce && last) {
        __stcg(out_h + j - 1, up.h);
        __stcg(out_st + j - 1, up.st);
        __stcg(out_ml + j - 1, up.ml);
        if (j % CHUNK == 0 || j == Lb_r) st_release(prog + band, j);
      }
    }
  }

  // the group's best: lane g merges lane g + off while it is in the group
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int oh = __shfl_down_sync(FULL, bh, off);
    const W okey = __shfl_down_sync(FULL, bkey, off);
    const W ost = __shfl_down_sync(FULL, bst, off);
    const W oml = __shfl_down_sync(FULL, bml, off);
    if (g + off < G && better(oh, okey, bh, bkey)) {
      bh = oh;
      bkey = okey;
      bst = ost;
      bml = oml;
    }
  }
  if (!live || g != 0) return;
  if (BANDED) {
    W* mine = bests + ((size_t)aln * nb + band) * 4;
    mine[0] = (W)(unsigned)bh;
    mine[1] = bkey;
    mine[2] = bst;
    mine[3] = bml;
    __threadfence();
    if (atomicAdd(sync + 1 + aln, 1) != nb - 1) return;
    __threadfence();  // every other band's best is visible now
    const W* all = bests + (size_t)aln * nb * 4;
    bh = NEG;
    for (int k = 0; k < nb; ++k) {
      const int h = (int)(unsigned)__ldcg(all + 4 * k);
      const W key = __ldcg(all + 4 * k + 1);
      if (better(h, key, bh, bkey)) {
        bh = h;
        bkey = key;
        bst = __ldcg(all + 4 * k + 2);
        bml = __ldcg(all + 4 * k + 3);
      }
    }
  }
  if (TAB && bh == NEG && La > 0 && Lb > 0) {
    // an empty region: the plain version's all-invalid answer, score 0
    // at cell (1, 1) with a fresh start there
    bkey = bst = ((W)1 << S) | 1;
    bml = 0;
  }
  const int si = (int)(bst >> S), sj = (int)(bst & LOW);
  const int i = (int)(bkey >> S), j = (int)(bkey & LOW);
  out[0 * B + aln] = bh > 0 ? bh : 0;
  out[1 * B + aln] = si;
  out[2 * B + aln] = i;
  out[3 * B + aln] = sj;
  out[4 * B + aln] = j;
  out[5 * B + aln] = (int)(bml >> S);
  // a path of d diagonal moves from (si, sj) to (i, j) has this length
  out[6 * B + aln] = (i - si) + (j - sj) - (int)(bml & LOW);
}

// Byte offsets of the hand-off planes and per-band bests in the scratch
// (st plane, ml plane, bests, then the h plane).
struct Layout {
  size_t st, ml, bests, h, total;
};

Layout layout(long long B, long long Lb, long long nb, int wbytes) {
  const size_t n = (size_t)(B * (nb - 1) * Lb);
  Layout L;
  L.st = 0;
  L.ml = n * wbytes;
  L.bests = 2 * n * wbytes;
  L.h = L.bests + (size_t)(B * nb * 4) * wbytes;
  L.total = L.h + n * 4;
  return L;
}

template <int R, typename W, bool BANDED, bool TAB>
cudaError_t launch(const uint8_t* a, const uint8_t* b, int B, int La, int Lb,
                   int match, int mismatch, int gap, int inv, int G, int nb,
                   int* out, int* sync, char* scratch, const int* table,
                   cudaStream_t stream) {
  const long long warps =
      nb > 1 ? (long long)B * nb : ((long long)B + 32 / G - 1) / (32 / G);
  const long long blocks = (warps + WARPS - 1) / WARPS;
  W* st = nullptr;
  W* ml = nullptr;
  W* bests = nullptr;
  int* h = nullptr;
  if (BANDED) {
    const Layout L = layout(B, Lb, nb, sizeof(W));
    st = (W*)(scratch + L.st);
    ml = (W*)(scratch + L.ml);
    bests = (W*)(scratch + L.bests);
    h = (int*)(scratch + L.h);
  }
  sw_kernel<R, W, BANDED, TAB><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
      a, b, B, La, Lb, match, mismatch, gap, inv, G, nb, out, sync, st, ml, h,
      bests, table);
  return cudaGetLastError();
}

template <int R, typename W, bool TAB>
cudaError_t launch_r(const uint8_t* a, const uint8_t* b, int B, int La,
                     int Lb, int match, int mismatch, int gap, int inv, int G,
                     int nb, int* out, int* sync, char* scratch,
                     const int* table, cudaStream_t st) {
  if (nb > 1)
    return launch<R, W, true, TAB>(a, b, B, La, Lb, match, mismatch, gap, inv,
                                   G, nb, out, sync, scratch, table, st);
  return launch<R, W, false, TAB>(a, b, B, La, Lb, match, mismatch, gap, inv,
                                  G, nb, out, sync, scratch, table, st);
}

template <typename W, bool TAB>
cudaError_t dispatch(int R, const uint8_t* a, const uint8_t* b, int B,
                     int La, int Lb, int match, int mismatch, int gap,
                     int inv, int G, int nb, int* out, int* sync,
                     char* scratch, const int* table, cudaStream_t st) {
  switch (R) {
    case 4: return launch_r<4, W, TAB>(a, b, B, La, Lb, match, mismatch, gap,
                                       inv, G, nb, out, sync, scratch, table,
                                       st);
    case 8: return launch_r<8, W, TAB>(a, b, B, La, Lb, match, mismatch, gap,
                                       inv, G, nb, out, sync, scratch, table,
                                       st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Bytes of scratch (hand-off rows, per-band bests) and int32 words of
// zeroed sync state (ticket, per-alignment done counts, per-band
// progress) a launch with nb > 1 bands needs; both 0 for nb == 1.
extern "C" long long sw_scratch_bytes(int B, int Lb, int nb, int packed) {
  if (nb <= 1) return 0;
  return (long long)layout(B, Lb, nb, packed ? 4 : 8).total;
}

extern "C" long long sw_sync_ints(int B, int nb) {
  return nb <= 1 ? 0 : 1 + (long long)B + (long long)B * nb;
}

// Launch on `stream` with the plan (R rows a lane, G lanes a group, nb
// bands, packed 16-bit fields or not) that ops/terminal.py:sw_plan chose;
// `table` (32 x 32 int32 on the device, or null) selects protein mode,
// which computes only each alignment's extents when mismatch < 0 and
// gap > 0.  Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a plan that does not cover the shape, or a
// table with unpacked fields or an invalid code past the table's codes.
extern "C" int sw_launch(const void* a, const void* b, int B, int La, int Lb,
                         int match, int mismatch, int gap, int invalid_code,
                         int R, int G, int nb, int packed, void* out,
                         void* sync, void* scratch, const void* table,
                         void* stream) {
  if (B <= 0) return 0;
  const bool ok =
      G >= 1 && G <= 32 && nb >= 1 &&
      (nb == 1 ? (long long)G * R >= La
               : G == 32 && (long long)nb * 32 * R >= La &&
                     (long long)(nb - 1) * 32 * R < La && sync && scratch) &&
      (!packed || (La < 65536 && Lb < 65536)) &&
      (!table || (packed && invalid_code >= 0 && invalid_code <= TAB_INV_A));
  if (!ok) return (int)cudaErrorInvalidValue;
  const auto* a8 = (const uint8_t*)a;
  const auto* b8 = (const uint8_t*)b;
  const auto* tab = (const int*)table;
  auto st = (cudaStream_t)stream;
  if (table)
    return (int)dispatch<unsigned, true>(
        R, a8, b8, B, La, Lb, match, mismatch, gap, invalid_code, G, nb,
        (int*)out, (int*)sync, (char*)scratch, tab, st);
  if (packed)
    return (int)dispatch<unsigned, false>(
        R, a8, b8, B, La, Lb, match, mismatch, gap, invalid_code, G, nb,
        (int*)out, (int*)sync, (char*)scratch, nullptr, st);
  return (int)dispatch<unsigned long long, false>(
      R, a8, b8, B, La, Lb, match, mismatch, gap, invalid_code, G, nb,
      (int*)out, (int*)sync, (char*)scratch, nullptr, st);
}

extern "C" const char* sw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
