"""Host FMEA chain merging of HSPs.

Counterpart of the JAX package's `ops/chain.py:chain_hsps_host` /
`chain_hsps_host_py` (reference `get_longest_repeats_v4`,
`Util.py:4122-4400`): HSPs walked in query order merge into ANY open chain
whose query and subject gaps are both within `extend_threshold`.  The
native C++ (`native/chain.cc`) runs it; the Python loop is the oracle.
"""

from __future__ import annotations

import numpy as np


def chain_hsps_host(qs: np.ndarray, qe: np.ndarray, ss: np.ndarray,
                    se: np.ndarray, *, extend_threshold: int,
                    min_len: int = 80, diag_tol: int = 0) -> np.ndarray:
    """Exact FMEA greedy chaining; int64 [C, 4] chains (qs, qe, ss, se)."""
    if len(qs) == 0:
        return np.zeros((0, 4), dtype=np.int64)
    from hite_tpu_torch.native import runtime

    out = runtime.fmea_chain(qs, qe, ss, se, extend_threshold, min_len,
                             diag_tol=diag_tol)
    if out is not None:
        return out
    return chain_hsps_host_py(qs, qe, ss, se,
                              extend_threshold=extend_threshold,
                              min_len=min_len, diag_tol=diag_tol)


def chain_hsps_host_py(qs: np.ndarray, qe: np.ndarray, ss: np.ndarray,
                       se: np.ndarray, *, extend_threshold: int,
                       min_len: int = 80, diag_tol: int = 0) -> np.ndarray:
    """Pure-Python FMEA chaining (the oracle for native/chain.cc)."""
    if len(qs) == 0:
        return np.zeros((0, 4), dtype=np.int64)
    order = np.argsort(qs, kind="stable")
    qs, qe, ss, se = (np.asarray(a, dtype=np.int64)[order]
                      for a in (qs, qe, ss, se))
    T = int(extend_threshold)
    closed: list = []
    o_qs: list = []
    o_qe: list = []
    o_ss: list = []
    o_se: list = []
    for i in range(len(qs)):
        x_qs, x_qe, x_ss, x_se = qs[i], qe[i], ss[i], se[i]
        merged = False
        j = 0
        while j < len(o_qs):
            if x_qs - o_qe[j] > T:           # too far behind: close it
                closed.append((o_qs[j], o_qe[j], o_ss[j], o_se[j]))
                o_qs.pop(j); o_qe.pop(j); o_ss.pop(j); o_se.pop(j)
                continue
            diag_ok = (diag_tol <= 0
                       or abs((x_ss - x_qs) - (o_se[j] - o_qe[j]))
                       <= diag_tol)
            if (not merged and diag_ok and abs(x_ss - o_se[j]) <= T
                    and x_se >= o_ss[j]):
                o_qe[j] = max(o_qe[j], x_qe)
                o_ss[j] = min(o_ss[j], x_ss)
                o_se[j] = max(o_se[j], x_se)
                merged = True
            j += 1
        if not merged:
            o_qs.append(x_qs); o_qe.append(x_qe)
            o_ss.append(x_ss); o_se.append(x_se)
    closed.extend(zip(o_qs, o_qe, o_ss, o_se))
    out = np.array(closed, dtype=np.int64).reshape(-1, 4)
    return out[(out[:, 1] - out[:, 0]) >= min_len]
