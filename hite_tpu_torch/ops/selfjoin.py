"""Whole-genome k-mer self-join (counterpart of JAX `ops/selfjoin.py`).

Every k-mer of the genome (forward and, at virtual offset L, reverse
complement) is stably sorted by code; seed pairs are entries up to
`window` apart inside a run of equal codes (qpos < spos: the strict upper
triangle of the dot plot, rc-rc mirror pairs masked).  A second stable
sort by (diagonal band, qpos) groups co-diagonal seeds; runs with bounded
qpos gaps become HSPs (`selfjoin_scan`), chained exactly on the host.

Sorts are `torch.sort(stable=True)`, two keys packed into one int64, so
ties keep input order exactly as `jax.lax.sort` does.  Invalid entries
carry INT32_MAX keys and sort to the tail, so a fixed-size prefix holds
the first `max_seed_pairs` real pairs; `n_pairs` is the pre-cut count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hite_tpu_torch.ops.encode import kmer_codes, revcomp

INT32_MAX = 2**31 - 1


class JoinHSPs(NamedTuple):
    """HSPs in virtual flat coordinates (subject >= L means rc strand)."""

    qs: torch.Tensor      # int32 [M]
    qe: torch.Tensor
    ss: torch.Tensor
    se: torch.Tensor
    nseeds: torch.Tensor
    valid: torch.Tensor   # bool [M]
    n_pairs: torch.Tensor  # int32 [] seed pairs before the budget cut


def pack2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 key ordering (hi, lo) lexicographically for int32 hi, lo."""
    return hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) + (1 << 31))


def stable_order(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting lexicographically by `keys` (first = major),
    stable: equal keys keep input order."""
    order = None
    for key in reversed(keys):
        k = key if order is None else key[order]
        o = torch.sort(k, stable=True).indices
        order = o if order is None else order[o]
    return order


def two_strand_codes(flat: torch.Tensor, k: int) -> torch.Tensor:
    """fwd k-mers ++ (k-1 pad) ++ rc k-mers ++ (k-1 pad): int32 [2L],
    invalid windows as INT32_MAX."""
    pad = torch.full((k - 1,), -1, dtype=torch.int32, device=flat.device)
    codes = torch.cat([kmer_codes(flat, k), pad,
                       kmer_codes(revcomp(flat), k), pad])
    return torch.where(codes < 0, INT32_MAX, codes)


def selfjoin_sorted(flat: torch.Tensor, *, k: int, window: int = 4,
                    diag_band: int = 32):
    """Stage 1: k-mer sort + (diag band, qpos)-sorted seed stream + count.

    Returns (s_dbin, s_qpos, s_spos, n_pairs) int32 tensors."""
    L = flat.shape[-1]
    codes = two_strand_codes(flat, k)
    n = codes.shape[0]
    codes_s, perm = torch.sort(codes, stable=True)
    pos_s = perm.to(torch.int32)

    qv_parts, sv_parts, ok_parts = [], [], []
    for d in range(1, window + 1):
        eq = (codes_s[:-d] == codes_s[d:]) & (codes_s[:-d] != INT32_MAX)
        qv = pos_s[:-d]
        sv = pos_s[d:]
        ok = eq & (qv < L) & ((sv >= L) | (sv - qv >= k))
        qv_parts.append(torch.nn.functional.pad(qv, (0, d)))
        sv_parts.append(torch.nn.functional.pad(sv, (0, d)))
        ok_parts.append(torch.nn.functional.pad(ok, (0, d)))
    qv = torch.cat(qv_parts)                                # [W*2L]
    sv = torch.cat(sv_parts)
    ok = torch.cat(ok_parts)
    n_pairs = ok.sum(dtype=torch.int32)

    dbin = torch.div(sv - qv, diag_band, rounding_mode="floor")
    key_d = torch.where(ok, dbin, INT32_MAX)
    key_q = torch.where(ok, qv, INT32_MAX)
    order = torch.sort(pack2(key_d, key_q), stable=True).indices
    return key_d[order], key_q[order], sv[order], n_pairs


def compact(good: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Row-wise `jnp.nonzero(size=size, fill_value=fill)` of bool [K, S]:
    the first `size` True indices of each row in index order, padded."""
    K, S = good.shape
    rank = torch.cumsum(good, dim=1) - 1
    take = good & (rank < size)
    sel = torch.full((K, size), fill, dtype=torch.int64, device=good.device)
    rows = torch.arange(K, device=good.device)[:, None].expand(K, S)
    cols = torch.arange(S, device=good.device).expand(K, S)
    sel[rows[take], rank[take]] = cols[take]
    return sel


def slices(a: torch.Tensor, K: int, S: int, padv: int) -> torch.Tensor:
    """First K*S entries of `a` as [K, S], tail-padded with `padv`."""
    total = min(K * S, a.shape[0])
    a = a[:total]
    if K * S > total:
        a = torch.cat([a, torch.full((K * S - total,), padv, dtype=a.dtype,
                                     device=a.device)])
    return a.reshape(K, S)


def shift1(a: torch.Tensor) -> torch.Tensor:
    """a[:, i-1] along the last axis with -1 entering at column 0."""
    return torch.nn.functional.pad(a[:, :-1], (1, 0), value=-1)


def selfjoin_scan(s_dbin, s_qpos, s_spos, n_pairs, *, k: int,
                  run_gap: int = 96, min_seeds: int = 4,
                  min_hsp_len: int = 30, max_hsps: int = 16_384,
                  max_seed_pairs: int = 1 << 20,
                  budget_slices: int = 1) -> JoinHSPs:
    """Stage 2: run detection + HSP compaction over `budget_slices`
    consecutive budget-sized slices of the sorted stream (a batch axis;
    a run crossing a slice boundary splits, chaining re-merges it)."""
    K = budget_slices
    S = min(max_seed_pairs, s_qpos.shape[0])
    quota = max(1, max_hsps // K)
    d = slices(s_dbin, K, S, INT32_MAX)
    q = slices(s_qpos, K, S, INT32_MAX)
    sp = slices(s_spos, K, S, INT32_MAX)

    valid = d != INT32_MAX
    brk = (d != shift1(d)) | (q - shift1(q) > run_gap)
    idx = torch.arange(S, dtype=torch.int32, device=d.device).expand(K, S)
    run_start = torch.cummax(torch.where(brk, idx, -1), dim=1).values
    rs = run_start.long()
    start_q = torch.gather(q, 1, rs)
    start_s = torch.gather(sp, 1, rs)
    nseeds = idx - run_start + 1
    qs, qe = start_q, q + k
    ss = torch.minimum(start_s, sp)
    se = torch.maximum(start_s, sp) + k

    nxt_brk = torch.nn.functional.pad(brk[:, 1:], (0, 1), value=True)
    good = valid & nxt_brk & (nseeds >= min_seeds) & (qe - qs >= min_hsp_len)
    sel = compact(good, quota, S - 1)
    count = good.sum(1, keepdim=True)
    out_valid = torch.arange(quota, device=d.device)[None] < count

    def take(a):
        return torch.where(out_valid, torch.gather(a, 1, sel), 0).reshape(-1)

    return JoinHSPs(qs=take(qs), qe=take(qe), ss=take(ss), se=take(se),
                    nseeds=take(nseeds), valid=out_valid.reshape(-1),
                    n_pairs=n_pairs)


def selfjoin_scan_packed(s_dbin, s_qpos, s_spos, n_pairs, **kw
                         ) -> torch.Tensor:
    """`selfjoin_scan` packed into ONE int32 [6, M] tensor: rows qs, qe,
    ss, se, valid, n_pairs (broadcast)."""
    hs = selfjoin_scan(s_dbin, s_qpos, s_spos, n_pairs, **kw)
    return torch.stack([hs.qs, hs.qe, hs.ss, hs.se,
                        hs.valid.to(torch.int32),
                        hs.n_pairs.to(hs.qs.dtype).expand_as(hs.qs)])
