// Native host runtime: exact FMEA greedy chaining.
//
// The self-join discovery path chains its compacted HSP list on the host
// (`ops/chain.py:chain_hsps_host`); the pure-Python loop is O(n * open)
// with per-element list surgery and becomes the host bottleneck at
// GB-scale HSP counts.  Same semantics as the Python implementation
// (which stays as the oracle/fallback): walk HSPs in query order, merge
// each into the FIRST open chain whose query gap and subject gap are
// both within the extend threshold (reference `Util.py:4176-4313`),
// closing chains that fall behind.
//
// C ABI (consumed via ctypes, hite_tpu_torch/native/runtime.py):
//   fmea_chain(qs, qe, ss, se, n, T, min_len, out) -> n_chains
//     inputs int64[n] (any order; sorted internally), out int64[n*4].

#include <cstdint>
#include <algorithm>
#include <numeric>
#include <vector>

// fmea_chain2 adds diag_tol: when > 0, an HSP merges into a chain only if
// its diagonal offset (ss - qs) stays within diag_tol of the chain's —
// copy-retrieval semantics, where a neighboring genomic copy (query
// restarting at 0 while the subject continues) must START A NEW CHAIN
// instead of being absorbed and then dropped by the length-ratio filter.
extern "C" int64_t fmea_chain2(const int64_t* qs, const int64_t* qe,
                               const int64_t* ss, const int64_t* se,
                               int64_t n, int64_t T, int64_t diag_tol,
                               int64_t min_len, int64_t* out) {
  if (n <= 0) return 0;
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return qs[a] < qs[b]; });

  struct Chain { int64_t qs, qe, ss, se; };
  std::vector<Chain> open;
  open.reserve(64);
  int64_t n_out = 0;
  auto emit = [&](const Chain& c) {
    if (c.qe - c.qs >= min_len) {
      out[n_out * 4 + 0] = c.qs;
      out[n_out * 4 + 1] = c.qe;
      out[n_out * 4 + 2] = c.ss;
      out[n_out * 4 + 3] = c.se;
      ++n_out;
    }
  };

  for (int64_t k = 0; k < n; ++k) {
    const int64_t i = order[k];
    const int64_t x_qs = qs[i], x_qe = qe[i], x_ss = ss[i], x_se = se[i];
    bool merged = false;
    for (size_t j = 0; j < open.size();) {
      if (x_qs - open[j].qe > T) {  // too far behind: close it
        emit(open[j]);
        open.erase(open.begin() + j);
        continue;
      }
      const bool diag_ok =
          diag_tol <= 0 ||
          std::llabs((long long)((x_ss - x_qs) -
                                 (open[j].se - open[j].qe))) <= diag_tol;
      if (!merged && diag_ok &&
          std::llabs((long long)(x_ss - open[j].se)) <= T &&
          x_se >= open[j].ss) {
        open[j].qe = std::max(open[j].qe, x_qe);
        open[j].ss = std::min(open[j].ss, x_ss);
        open[j].se = std::max(open[j].se, x_se);
        merged = true;
      }
      ++j;
    }
    if (!merged) open.push_back({x_qs, x_qe, x_ss, x_se});
  }
  for (const Chain& c : open) emit(c);
  return n_out;
}

extern "C" int64_t fmea_chain(const int64_t* qs, const int64_t* qe,
                              const int64_t* ss, const int64_t* se,
                              int64_t n, int64_t T, int64_t min_len,
                              int64_t* out) {
  return fmea_chain2(qs, qe, ss, se, n, T, /*diag_tol=*/0, min_len, out);
}
