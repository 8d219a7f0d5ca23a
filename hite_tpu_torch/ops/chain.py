"""FMEA chain merging of HSPs, on the device and on the host.

Counterpart of the JAX package's `ops/chain.py` (reference
`get_longest_repeats_v4`, `Util.py:4122-4400`):
* `chain_hsps` (device): HSPs sorted by (group, query start) are merged
  greedily into ONE running chain per row, tolerating gaps up to
  `extend_threshold` on query and subject; the scan runs over the HSP
  axis, vectorised over all rows at once.
* `chain_hsps_host`: HSPs walked in query order merge into ANY open chain
  whose query and subject gaps are both within `extend_threshold`.  The
  native C++ (`native/chain.cc`) runs it; the Python loop is the oracle.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hite_tpu_torch.ops.selfjoin import compact, pack2
from hite_tpu_torch.ops.seedext import HSPs

INT32_MAX = 2**31 - 1


class Chains(NamedTuple):
    qs: torch.Tensor      # int32 [..., C]
    qe: torch.Tensor
    ss: torch.Tensor
    se: torch.Tensor
    nseeds: torch.Tensor
    valid: torch.Tensor   # bool [..., C]


def chain_hsps(hsps: HSPs, *, extend_threshold: int, max_chains: int = 512,
               min_len: int = 80,
               group: Optional[torch.Tensor] = None) -> Chains:
    """Greedy-merge each row's HSPs [N, M] into chains (one subject, one
    strand); `group` int32 [N, M] (e.g. the library entry an HSP lands in)
    keeps chains from crossing groups.  Returns the first `max_chains`
    chains of at least `min_len` query bases per row, in emission order."""
    N, n = hsps.qs.shape
    dev = hsps.qs.device
    valid = hsps.valid
    g = group if group is not None else torch.zeros_like(hsps.qs)
    g = torch.where(valid, g, INT32_MAX)
    qkey = torch.where(valid, hsps.qs, INT32_MAX)
    order = torch.sort(pack2(g, qkey), dim=1, stable=True).indices
    x = [torch.gather(a, 1, order)
         for a in (qkey, hsps.qe, hsps.ss, hsps.se, hsps.nseeds, g)]
    xvalid_all = torch.gather(valid, 1, order)

    T = extend_threshold
    z = torch.zeros(N, dtype=torch.int32, device=dev)
    cqs, cqe, css, cse, cn, cg = z, z, z, z, z, z
    active = torch.zeros(N, dtype=torch.bool, device=dev)
    emitted = []
    # invalid HSPs sort last and leave the carry alone: scan the valid
    # prefix only (the skipped steps would emit nothing)
    n_steps = int(valid.sum(1).max()) if N and n else 0
    for t in range(n_steps):
        xqs, xqe, xss, xse, xn, xg = (a[:, t] for a in x)
        xvalid = xvalid_all[:, t]
        q_ok = (xqs - cqe) <= T
        s_ok = ((xss - cse).abs() <= T) & (xse >= css)
        merge = active & xvalid & q_ok & s_ok & (xg == cg)
        emitted.append((cqs, cqe, css, cse, cn, active & xvalid & ~merge))
        fresh = xvalid & ~merge
        cqe = torch.where(merge, torch.maximum(cqe, xqe),
                          torch.where(fresh, xqe, cqe))
        css = torch.where(merge, torch.minimum(css, xss),
                          torch.where(fresh, xss, css))
        cse = torch.where(merge, torch.maximum(cse, xse),
                          torch.where(fresh, xse, cse))
        cn = torch.where(merge, cn + xn, torch.where(fresh, xn, cn))
        cqs = torch.where(fresh, xqs, cqs)
        cg = torch.where(fresh, xg, cg)
        active = active | xvalid

    # the emission of every step, the skipped steps' as nothing, then the
    # final open chain
    def column(i: int, final: torch.Tensor) -> torch.Tensor:
        cols = [e[i] for e in emitted]
        cols += [torch.zeros_like(final)] * (n - n_steps) + [final]
        return torch.stack(cols, dim=1)

    e_qs, e_qe, e_ss, e_se, e_n, e_valid = (
        column(i, f) for i, f in enumerate((cqs, cqe, css, cse, cn, active)))
    good = e_valid & ((e_qe - e_qs) >= min_len)
    sel = compact(good, max_chains, n)
    out_valid = (torch.arange(max_chains, device=dev)[None]
                 < good.sum(1, keepdim=True))

    def take(a: torch.Tensor) -> torch.Tensor:
        return torch.where(out_valid, torch.gather(a, 1, sel), 0)

    return Chains(qs=take(e_qs), qe=take(e_qe), ss=take(e_ss),
                  se=take(e_se), nseeds=take(e_n), valid=out_valid)


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
