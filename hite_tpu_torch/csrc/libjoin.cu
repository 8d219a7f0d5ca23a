// The chunked copy join's pairing for Hopper (sm_90a): the forward fills
// and compactions of ops/libjoin.py:libjoin_pairs in two passes over the
// jointly sorted k-mer stream.
//
// Replaces no Pallas kernel.  It replaces the XLA `lax.cummax` chain of
// hite_tpu/ops/libjoin.py:libjoin_pairs (there, and in the plain version
// hite_tpu_torch/ops/libjoin.py:libjoin_fill_plain, `fill_w` chained
// cummax fills over the whole [K, S] stream, then for each fill a
// cumsum compaction and four gathers), and computes exactly what the plain
// version computes.
//
// Input: the sorted unique keys (code << 32) | (tag << 31) | pos of one
// chunk (n of them, int64), cut into K slices of S; tag 0 marks a
// candidate k-mer (pos indexes `cid`, its candidate id), tag 1 a genome
// k-mer (pos is its two-strand position); code INT32_MAX is a k-mer with
// an N.  Past n the slice reads as padding (code INT32_MAX).  Within one
// code run the candidate entries come first, so for a genome entry i of
// slice k whose last candidate at or before it (within the slice) is p:
//   fill w pairs i with j = p - w  iff  i is a genome entry with a valid
//   code, i - p <= max_occ, p - w >= 0 and code[p - w] == code[i]
// (every entry of [p - w, p] is then a candidate of i's run).  So fill w
// holds the genome entries with m(i) > w, where m(i) in 0..fill_w counts
// the run's candidates at or before i within the slice, capped; a run's
// candidates cut off by the slice's start are absent, as in the per-row
// fills.  For slice k and fill w the kernel writes the first q_w such
// entries in index order as (cid[pos_j], pos_j, pos_i) at columns
// qoff_w .. qoff_w + q_w of row k, INT32_MAX / INT32_MAX / 0 past the
// count, and the counts cw[w][k] (uncapped) and ew[w][k] = min(cw, q_w).
//
// Design.  A block owns a tile of TILE = 2048 entries of one slice: each
// warp 8 rows of 32 consecutive entries (coalesced 8-byte loads; 16 rows
// read 7% slower at the copy join's chunk, 32 rows of 4 warps 70%).
//   * Last candidate: one ballot a row gives each lane the last candidate
//     at or before it in the row (highest set bit at or below the lane),
//     the warp carries it from row to row, and the block carries it from
//     warp to warp in shared memory.  Before the tile the block looks
//     back over the max_occ entries before it, LOOK loads a thread in
//     flight at once; a candidate further back pairs with no entry of the
//     tile.
//   * m(i): at most fill_w loads of code[p - w], stopping at the first
//     other code, mostly the same lines for the lanes of a run (L1).  m and
//     p are kept packed in one register an entry, and the write pass
//     reloads an entry's own key only where it pairs, so it keeps ROWS
//     registers of state.
//   * Ranks: fill w's entries of a row are the lanes with m > w, so one
//     ballot a (row, fill) gives each lane its rank within the row and
//     the row's count; warps add their counts in shared memory.
//   * Writes: a fill's survivors of one tile are a run of consecutive
//     columns, so the write pass stages each fill's (pos_j, pos_i) in
//     shared memory at their ranks and the block writes the run whole:
//     coalesced stores (each warp storing its few pairing lanes of a row
//     in place made the write pass 3x slower at the copy join's chunk).
// Pass 1 (libjoin_fill_count) writes each tile's count per fill.  Pass 2
// (libjoin_fill_write) recomputes m, adds the counts of the slice's
// earlier tiles to get each tile's first rank, writes the entries whose
// rank is below q_w, writes its share (1 / tiles) of the slice's padding
// columns, and tile 0 writes the counts.  No [K, S] intermediate, no
// host synchronisation.
//
// What bounds it.  Device memory: the keys read once (8 bytes an entry)
// and the [K, sum q] x 3 int32 outputs written once.  At the copy join's
// chunk (2^25 + Pk keys, K = 33, S = 2^20, fill_w 8, slice quota 2^19:
// sum q = 524,287) that is 277 MB + 208 MB, 0.142 ms at 3.35 TB/s; the
// two passes take about 0.72 ms there on an H100 (PERF.md).  The kernel
// reads the keys twice (once a pass), the look-back ranges and the
// candidates' keys again (mostly L2 and L1); the plain version's cummax
// scans, cumsum compactions and gathers move about 16 bytes an entry a
// fill.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 8;                   // rows of 32 entries a warp
constexpr int WARP_SPAN = 32 * ROWS;      // entries a warp
constexpr int TILE = THREADS * ROWS;      // entries a block
constexpr int MAXW = 8;                   // fills the kernel takes
constexpr int LOOK = 4;                   // look-back loads a thread a round
constexpr int BIG = 0x7fffffff;           // INT32_MAX: no code, padding
constexpr unsigned FULL = 0xffffffffu;
constexpr long long PAD_KEY =
    ((long long)BIG << 32) | (1ll << 31);  // padding: code BIG, tag 1

struct Params {
  const long long* key;  // [n] sorted keys
  const int* cid;        // candidate id of each candidate k-mer
  int n, K, S, fill_w, max_occ, ntiles, qt;
  int q[MAXW];           // quota of each fill
  int qoff[MAXW];        // first column of each fill in a row
  int* tile_counts;      // [K][ntiles][MAXW]
  int* out_cand;         // [K][qt]
  int* out_qpos;
  int* out_spos;
  int* cw;               // [fill_w][K]
  int* ew;
};

__device__ __forceinline__ int code_of(long long k) { return (int)(k >> 32); }
__device__ __forceinline__ int tag_of(long long k) {
  return (int)((k >> 31) & 1);
}
__device__ __forceinline__ int pos_of(long long k) {
  return (int)(k & 0x7fffffff);
}
__device__ __forceinline__ bool is_cand(long long k) {
  return tag_of(k) == 0 && code_of(k) != BIG;
}

// Entry j (slice-local) of slice k, padding past the slice or the stream.
__device__ __forceinline__ long long load_key(const Params& P, int k, int j) {
  const long long g = (long long)k * P.S + j;
  return (j < P.S && g < P.n) ? __ldg(P.key + g) : PAD_KEY;
}

// For each of the thread's ROWS entries of the tile (warp-striped: warp
// w, row r, lane l is entry t0 + w * WARP_SPAN + r * 32 + l of slice k):
// pm[r] = the fills that pair it, m in 0 .. fill_w, and its last candidate
// p (slice-local) packed as p | m << P_BITS (0 when m = 0).
constexpr int P_BITS = 27;                // slices of at most 2^27 entries
constexpr int P_MASK = (1 << P_BITS) - 1;

__device__ __forceinline__ void tile_fills(const Params& P, int k, int t0,
                                           int* pm, int* sh_carry,
                                           int* sh_last) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) *sh_carry = -1;
  // the last candidate before the tile within max_occ of its start: the
  // window's loads all at once, LOOK a thread a round
  const int lo = max(0, t0 - P.max_occ);
  int best = -1;
  for (int base = t0 - 1 - (int)threadIdx.x; base >= lo;
       base -= LOOK * THREADS) {
    long long kk[LOOK];
#pragma unroll
    for (int u = 0; u < LOOK; ++u) {
      const int j = base - u * THREADS;
      kk[u] = j >= lo ? load_key(P, k, j) : PAD_KEY;
    }
#pragma unroll
    for (int u = 0; u < LOOK; ++u)
      if (is_cand(kk[u])) best = max(best, base - u * THREADS);
  }
  best = __reduce_max_sync(FULL, best);
  __syncthreads();                        // sh_carry's reset before the max
  if (lane == 0 && best >= 0) atomicMax(sh_carry, best);

  const int wbase = t0 + warp * WARP_SPAN;
  int code[ROWS], p[ROWS];
  int run = -1;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long kk = load_key(P, k, wbase + r * 32 + lane);
    code[r] = (tag_of(kk) == 1) ? code_of(kk) : BIG;  // genome entries pair
    const unsigned b = __ballot_sync(FULL, is_cand(kk));
    const unsigned le = b & (FULL >> (31 - lane));     // lanes <= this one
    p[r] = le ? wbase + r * 32 + 31 - __clz(le) : run;
    if (b) run = wbase + r * 32 + 31 - __clz(b);
  }
  if (lane == 0) sh_last[warp] = run;
  __syncthreads();
  int carry = *sh_carry;
  for (int w = 0; w < warp; ++w) carry = max(carry, sh_last[w]);

  // m: the run's candidates at or before p, up to fill_w of them
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int j = wbase + r * 32 + lane;
    const int pp = max(p[r], carry);
    int mm = 0;
    if (code[r] != BIG && pp >= 0 && j - pp <= P.max_occ) {
      for (int w = 0; w < P.fill_w && pp - w >= 0; ++w) {
        if (code_of(load_key(P, k, pp - w)) != code[r]) break;
        ++mm;
      }
    }
    pm[r] = mm ? pp | mm << P_BITS : 0;
  }
}

// Each fill's count over the warp's entries (warp-uniform).
__device__ __forceinline__ void warp_counts(const int* pm, int* cnt) {
#pragma unroll
  for (int w = 0; w < MAXW; ++w) cnt[w] = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int m = pm[r] >> P_BITS;
    if (!__ballot_sync(FULL, m > 0)) continue;
#pragma unroll
    for (int w = 0; w < MAXW; ++w)
      cnt[w] += __popc(__ballot_sync(FULL, m > w));
  }
}

__global__ void __launch_bounds__(THREADS)
    libjoin_fill_count(Params P) {
  __shared__ int sh_carry, sh_last[WARPS], sh_cnt[WARPS][MAXW];
  const int k = blockIdx.y, tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int pm[ROWS], cnt[MAXW];
  tile_fills(P, k, tile * TILE, pm, &sh_carry, sh_last);
  warp_counts(pm, cnt);
  if (lane == 0) {
#pragma unroll
    for (int w = 0; w < MAXW; ++w) sh_cnt[warp][w] = cnt[w];
  }
  __syncthreads();
  if (threadIdx.x < MAXW) {
    int s = 0;
    for (int v = 0; v < WARPS; ++v) s += sh_cnt[v][threadIdx.x];
    P.tile_counts[((long long)k * P.ntiles + tile) * MAXW + threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
    libjoin_fill_write(Params P) {
  __shared__ int sh_carry, sh_last[WARPS], sh_cnt[WARPS][MAXW];
  __shared__ int sh_off[MAXW], sh_tot[MAXW];
  __shared__ int sh_qp[TILE], sh_spos[TILE];  // one fill's survivors
  const int k = blockIdx.y, tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < MAXW) sh_off[threadIdx.x] = sh_tot[threadIdx.x] = 0;
  int pm[ROWS], cnt[MAXW];
  tile_fills(P, k, tile * TILE, pm, &sh_carry, sh_last);
  warp_counts(pm, cnt);
  if (lane == 0) {
#pragma unroll
    for (int w = 0; w < MAXW; ++w) sh_cnt[warp][w] = cnt[w];
  }
  // the slice's earlier tiles (this tile's first rank) and all its tiles
  int off[MAXW], tot[MAXW];
#pragma unroll
  for (int w = 0; w < MAXW; ++w) off[w] = tot[w] = 0;
  const int* tc = P.tile_counts + (long long)k * P.ntiles * MAXW;
  for (int t = threadIdx.x; t < P.ntiles; t += THREADS) {
    const int4 a = reinterpret_cast<const int4*>(tc + t * MAXW)[0];
    const int4 b = reinterpret_cast<const int4*>(tc + t * MAXW)[1];
    const int v[MAXW] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
      tot[w] += v[w];
      if (t < tile) off[w] += v[w];
    }
  }
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    tot[w] = __reduce_add_sync(FULL, tot[w]);
    off[w] = __reduce_add_sync(FULL, off[w]);
  }
  if (lane == 0) {
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
      if (tot[w]) atomicAdd(&sh_tot[w], tot[w]);
      if (off[w]) atomicAdd(&sh_off[w], off[w]);
    }
  }
  __syncthreads();

  // survivors, one fill at a time: each entry's rank within the tile
  // (earlier warps', rows' and lanes' counts) places its (pos_j, pos_i) in
  // shared memory, and the block then writes the fill's run of columns
  // [first, first + kept) whole, so the stores are coalesced
  int wofs[MAXW], tcnt[MAXW];
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    wofs[w] = tcnt[w] = 0;
    for (int v = 0; v < WARPS; ++v) {
      if (v < warp) wofs[w] += sh_cnt[v][w];
      tcnt[w] += sh_cnt[v][w];
    }
  }
  const unsigned lt = (1u << lane) - 1u;
  const long long row0 = (long long)k * P.qt;
  const int wbase = tile * TILE + warp * WARP_SPAN;
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    const int first = sh_off[w];
    const int kept = min(tcnt[w], P.q[w] - first);
    if (kept <= 0) continue;                // the same in every thread
    int rank = wofs[w];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int m = pm[r] >> P_BITS;
      const unsigned b = __ballot_sync(FULL, m > w);
      const int t = rank + __popc(b & lt);
      if (m > w && t < kept) {
        sh_qp[t] = pos_of(load_key(P, k, (pm[r] & P_MASK) - w));
        sh_spos[t] = pos_of(load_key(P, k, wbase + r * 32 + lane));
      }
      rank += __popc(b);
    }
    __syncthreads();
    const long long o = row0 + P.qoff[w] + first;
    for (int i = threadIdx.x; i < kept; i += THREADS) {
      const int qp = sh_qp[i];
      P.out_cand[o + i] = __ldg(P.cid + qp);
      P.out_qpos[o + i] = qp;
      P.out_spos[o + i] = sh_spos[i];
    }
    __syncthreads();
  }

  // this tile's share of the padding columns [min(cw, q), q) of each fill
  for (int w = 0; w < P.fill_w; ++w) {
    const long long lo = min(sh_tot[w], P.q[w]);
    const long long len = P.q[w] - lo;
    const long long a = lo + len * tile / P.ntiles;
    const long long e = lo + len * (tile + 1) / P.ntiles;
    for (long long i = a + threadIdx.x; i < e; i += THREADS) {
      const long long o = row0 + P.qoff[w] + i;
      P.out_cand[o] = BIG;
      P.out_qpos[o] = BIG;
      P.out_spos[o] = 0;
    }
  }
  if (tile == 0 && threadIdx.x < P.fill_w) {
    const int w = threadIdx.x;
    P.cw[w * P.K + k] = sh_tot[w];
    P.ew[w * P.K + k] = min(sh_tot[w], P.q[w]);
  }
}

}  // namespace

// Tiles a slice of S entries is cut into; the wrapper allocates
// K * tiles * 8 int32 of scratch for the tiles' counts.
extern "C" int libjoin_fill_tiles(int S) { return (S + TILE - 1) / TILE; }

// Launch both passes on `stream`.  key: n sorted int64 keys; cid: the
// candidates' ids (int32, indexed by a candidate key's pos); quotas:
// fill_w host ints; tile_counts: K * libjoin_fill_tiles(S) * 8 int32;
// out_cand / out_qpos / out_spos: K x sum(quotas) int32; cw / ew:
// fill_w x K int32.  Returns cudaGetLastError() after each launch (0 =
// both launched), or cudaErrorInvalidValue for arguments out of range.
extern "C" int libjoin_fill_launch(const void* key, const void* cid, int n,
                                   int K, int S, int fill_w, int max_occ,
                                   const int* quotas, void* tile_counts,
                                   void* out_cand, void* out_qpos,
                                   void* out_spos, void* cw, void* ew,
                                   void* stream) {
  if (fill_w < 1 || fill_w > MAXW || K < 1 || K > 65535 || S < 1 ||
      S > (1 << P_BITS) || n < 1 || (long long)K * S < n || max_occ < 0)
    return (int)cudaErrorInvalidValue;
  Params P;
  P.key = (const long long*)key;
  P.cid = (const int*)cid;
  P.n = n;
  P.K = K;
  P.S = S;
  P.fill_w = fill_w;
  P.max_occ = max_occ;
  P.ntiles = libjoin_fill_tiles(S);
  long long qt = 0;
  for (int w = 0; w < MAXW; ++w) {
    P.q[w] = w < fill_w ? quotas[w] : 0;
    if (P.q[w] < 0) return (int)cudaErrorInvalidValue;
    P.qoff[w] = (int)qt;
    qt += P.q[w];
  }
  if (qt > BIG) return (int)cudaErrorInvalidValue;
  P.qt = (int)qt;
  P.tile_counts = (int*)tile_counts;
  P.out_cand = (int*)out_cand;
  P.out_qpos = (int*)out_qpos;
  P.out_spos = (int*)out_spos;
  P.cw = (int*)cw;
  P.ew = (int*)ew;
  auto st = (cudaStream_t)stream;
  const dim3 grid((unsigned)P.ntiles, (unsigned)K);
  libjoin_fill_count<<<grid, THREADS, 0, st>>>(P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  libjoin_fill_write<<<grid, THREADS, 0, st>>>(P);
  return (int)cudaGetLastError();
}

extern "C" const char* libjoin_fill_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
