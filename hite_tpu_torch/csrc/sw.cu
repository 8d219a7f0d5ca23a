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
// Design.  One thread block per alignment; each thread owns a strip of R
// consecutive DP rows whose previous-column cells live in registers.
// Thread t works on column j = s - t at step s, so the strips form a
// wavefront: the cell above a strip's first row comes from thread t-1's
// last row, computed one step earlier, passed by __shfl_up_sync inside a
// warp and through a double-buffered shared-memory slot between warps,
// with one __syncthreads() per step.  A block covers MAX_T * R rows per
// band; taller problems run several bands, the last row of one band
// handed to the next through a per-alignment global scratch row.  Each
// thread keeps its own best cell; one block reduction writes the outputs.
//
// What bounds it.  About 30 integer ALU operations per cell over B*La*Lb
// cells (no tensor-core path exists for this recurrence), and for a single
// alignment the wavefront is latency-bound: Lb + T dependent steps per
// band.  The strip of R rows per thread amortises the per-step shuffle and
// barrier over R cells; many alignments in flight (one block each, up to
// 32 resident blocks per SM) hide the step latency at the TIR gate shape.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int R = 8;          // DP rows per thread
constexpr int MAX_T = 512;    // threads per block
constexpr int NEG = -1000000000;
constexpr unsigned FULL = 0xffffffffu;

struct Cell {
  int h, si, sj, m, l;
};

struct Best {
  int h, i, j, si, sj, m, l;
};

__device__ __forceinline__ bool better(const Best& x, const Best& y) {
  if (x.h != y.h) return x.h > y.h;
  if (x.i != y.i) return x.i < y.i;
  return x.j < y.j;
}

__device__ __forceinline__ Cell shfl_up_cell(const Cell& c) {
  Cell r;
  r.h = __shfl_up_sync(FULL, c.h, 1);
  r.si = __shfl_up_sync(FULL, c.si, 1);
  r.sj = __shfl_up_sync(FULL, c.sj, 1);
  r.m = __shfl_up_sync(FULL, c.m, 1);
  r.l = __shfl_up_sync(FULL, c.l, 1);
  return r;
}

__device__ __forceinline__ Best shfl_down_best(const Best& b, int off) {
  Best r;
  r.h = __shfl_down_sync(FULL, b.h, off);
  r.i = __shfl_down_sync(FULL, b.i, off);
  r.j = __shfl_down_sync(FULL, b.j, off);
  r.si = __shfl_down_sync(FULL, b.si, off);
  r.sj = __shfl_down_sync(FULL, b.sj, off);
  r.m = __shfl_down_sync(FULL, b.m, off);
  r.l = __shfl_down_sync(FULL, b.l, off);
  return r;
}

__global__ void __launch_bounds__(MAX_T)
sw_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
          int B, int La, int Lb, int match, int mismatch, int gap, int inv,
          int* __restrict__ out, int* __restrict__ scratch) {
  const int bi = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const uint8_t* arow = a + (size_t)bi * La;
  const uint8_t* brow = b + (size_t)bi * Lb;
  // scratch row of this alignment: 5 planes of Lb + 1 ints (band hand-off)
  int* sc = scratch ? scratch + (size_t)bi * 5 * (Lb + 1) : nullptr;

  __shared__ Cell xfer[2][MAX_T / 32];
  __shared__ Best wbest[MAX_T / 32];

  Best best = {NEG, 0, 0, 0, 0, 0, 0};
  const int band_rows = T * R;

  for (int r0 = 0; r0 < La; r0 += band_rows) {
    const int top = r0 + t * R + 1;           // first DP row of the strip
    int nrows = La - top + 1;
    nrows = nrows < 0 ? 0 : (nrows > R ? R : nrows);
    const bool has_next = r0 + band_rows < La;

    int asym[R];
    Cell col[R];                              // cells of the previous column
#pragma unroll
    for (int q = 0; q < R; ++q) {
      asym[q] = q < nrows ? (int)arow[top - 1 + q] : inv;
      col[q] = {0, top + q, 0, 0, 0};          // column 0: fresh (i, 0)
    }
    Cell above_prev = {0, top - 1, 0, 0, 0};  // cell (top - 1, 0)
    Cell out_cell = {0, 0, 0, 0, 0};          // strip's last row, last column

    // thread t covers columns j = 1..Lb at steps s = t+1..t+Lb
    const int steps = Lb + T;
    for (int s = 0; s < steps; ++s) {
      Cell up_in = shfl_up_cell(out_cell);
      if (lane == 0 && warp > 0) up_in = xfer[(s + 1) & 1][warp - 1];
      const int j = s - t;
      if (j >= 1 && j <= Lb && nrows > 0) {
        Cell above;
        if (t > 0) {
          above = up_in;
        } else if (r0 == 0) {
          above = {0, 0, j, 0, 0};            // row 0: fresh (0, j)
        } else {
          above = {sc[j], sc[(Lb + 1) + j], sc[2 * (Lb + 1) + j],
                   sc[3 * (Lb + 1) + j], sc[4 * (Lb + 1) + j]};
        }
        const int bs = (int)brow[j - 1];
        const bool b_ok = bs < inv;
        Cell diag = above_prev;
        Cell up = above;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          if (q < nrows) {
            const int i = top + q;
            const Cell left = col[q];
            const int im = (b_ok && asym[q] < inv && asym[q] == bs) ? 1 : 0;
            const int cd = diag.h + (im ? match : mismatch);
            const int cu = up.h - gap;
            const int cl = left.h - gap;
            const int h = max(max(cd, 0), max(cu, cl));
            Cell c;
            if (h == 0) {
              c = {0, i, j, 0, 0};
            } else if (cd == h) {
              c = {h, diag.si, diag.sj, diag.m + im, diag.l + 1};
            } else if (cu == h) {
              c = {h, up.si, up.sj, up.m, up.l + 1};
            } else {
              c = {h, left.si, left.sj, left.m, left.l + 1};
            }
            if (h > best.h ||
                (h == best.h && (i < best.i || (i == best.i && j < best.j)))) {
              best = {h, i, j, c.si, c.sj, c.m, c.l};
            }
            diag = left;
            up = c;
            col[q] = c;
          }
        }
        above_prev = above;
        out_cell = up;
        if (has_next && t == T - 1) {
          sc[j] = up.h;
          sc[(Lb + 1) + j] = up.si;
          sc[2 * (Lb + 1) + j] = up.sj;
          sc[3 * (Lb + 1) + j] = up.m;
          sc[4 * (Lb + 1) + j] = up.l;
        }
      }
      if (lane == 31) xfer[s & 1][warp] = out_cell;
      __syncthreads();
    }
  }

  // block reduction of the per-thread best cells
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Best o = shfl_down_best(best, off);
    if (better(o, best)) best = o;
  }
  if (lane == 0) wbest[warp] = best;
  __syncthreads();
  if (t == 0) {
    Best r = wbest[0];
    for (int w = 1; w < T / 32; ++w)
      if (better(wbest[w], r)) r = wbest[w];
    out[0 * B + bi] = r.h > 0 ? r.h : 0;
    out[1 * B + bi] = r.si;
    out[2 * B + bi] = r.i;
    out[3 * B + bi] = r.sj;
    out[4 * B + bi] = r.j;
    out[5 * B + bi] = r.m;
    out[6 * B + bi] = r.l;
  }
}

int threads_for(int La) {
  int need = (La + R - 1) / R;
  int T = ((need + 31) / 32) * 32;
  if (T < 32) T = 32;
  if (T > MAX_T) T = MAX_T;
  return T;
}

}  // namespace

// Scratch ints per alignment the caller must provide (0 = none needed).
extern "C" long long sw_scratch_ints(int La, int Lb) {
  return La > MAX_T * R ? 5LL * (Lb + 1) : 0LL;
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int sw_launch(const void* a, const void* b, int B, int La, int Lb,
                         int match, int mismatch, int gap, int invalid_code,
                         void* out, void* scratch, void* stream) {
  if (B <= 0) return 0;
  const int T = threads_for(La);
  sw_kernel<<<B, T, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, B, La, Lb, match, mismatch, gap,
      invalid_code, (int*)out, (int*)scratch);
  return (int)cudaGetLastError();
}

extern "C" const char* sw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
