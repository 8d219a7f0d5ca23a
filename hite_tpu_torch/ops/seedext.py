"""Seed matching + HSP extraction (counterpart of the JAX `ops/seedext.py`).

HSPs are dense runs of co-diagonal seed matches: the (qpos, spos) seed
pairs of a query against a sorted k-mer index are sorted by (diagonal
band, qpos) per tile of `tile_entries` slots, and maximal runs with
bounded qpos gaps become HSPs (the reference's blastn shard-pair HSPs,
`Util.py:4740-4748`).  A leading batch axis of queries maps (the JAX
package vmaps one query row); sorts are stable, so ties keep input order
as `jax.lax.sort` does, and the fixed-size compactions go through
`selfjoin.compact`.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from hite_tpu_torch.ops.kmer import KmerIndex, bucket_shift_for, lookup
from hite_tpu_torch.ops.selfjoin import compact, pack2, shift1

INT32_MAX = 2**31 - 1


class HSPs(NamedTuple):
    """A static-size batch of HSPs per query row (half-open coordinates
    in the searched index's coordinate system: revcomp coordinates for a
    minus-strand search, converted by `rc_to_forward`)."""

    qs: torch.Tensor      # int32 [..., M]
    qe: torch.Tensor
    ss: torch.Tensor
    se: torch.Tensor
    nseeds: torch.Tensor
    valid: torch.Tensor   # bool [..., M]


def pair_hsps(
    q_kmers: torch.Tensor,
    subj_index: KmerIndex,
    *,
    k: int,
    stride: int = 2,
    max_hits: int = 8,
    diag_band: int = 32,
    run_gap: int = 96,
    min_seeds: int = 4,
    min_hsp_len: int = 30,
    max_hsps: int = 2048,
    exclude_self: Union[torch.Tensor, bool] = False,
    tile_entries: int = 32_768,
) -> HSPs:
    """HSPs of each query row q_kmers int32 [N, Qk] (-1 invalid) against
    one sorted subject index [n] (any alphabet), or row by row against an
    index [N, n].  An index with prefix buckets is searched as the JAX
    package searches it.  `exclude_self` (a bool, or bool [N] a row)
    drops qpos == spos seed matches."""
    N, Qk = q_kmers.shape
    dev = q_kmers.device
    i32 = torch.int32
    Q = Qk // stride
    qpos = torch.arange(Q, dtype=i32, device=dev) * stride
    qk = q_kmers[:, qpos.long()]

    spos, valid = lookup(subj_index, qk, max_hits,
                         bucket_shift=bucket_shift_for(k))  # [N, Q, H]
    qpos_b = qpos[:, None].expand(Q, max_hits)
    excl = torch.as_tensor(exclude_self, dtype=torch.bool, device=dev)
    if excl.dim() == 1:
        excl = excl[:, None, None]
    valid = valid & ~(excl & (qpos_b == spos))

    n_subj = subj_index.codes.shape[-1]
    dbin = torch.div(qpos_b - spos + n_subj, diag_band, rounding_mode="floor")
    n_dbins = (Qk + n_subj) // diag_band + 2
    packed_ok = n_dbins * Q < 2**31
    qidx = torch.arange(Q, dtype=i32, device=dev)[:, None].expand(Q, max_hits)

    # per-row tiles of T seed slots (query-major), each sorted on its own
    n_total = Q * max_hits
    T = min(tile_entries, n_total)
    n_tiles = -(-n_total // T) if T else 0
    pad = n_tiles * T - n_total

    def tiled(a: torch.Tensor, fill: int) -> torch.Tensor:
        flat = a.expand(N, Q, max_hits).reshape(N, n_total)
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad), value=fill)
        return flat.reshape(N * n_tiles, T)

    if packed_ok:
        key = dbin * Q + qidx
        t_key = tiled(torch.where(valid, key, INT32_MAX), INT32_MAX)
        t_spos = tiled(spos, 0)
        s_key, order = torch.sort(t_key, dim=1, stable=True)
        s_spos = torch.gather(t_spos, 1, order)
        s_valid = s_key != INT32_MAX
        safe_key = torch.where(s_valid, s_key, 0)
        s_dbin = torch.div(safe_key, Q, rounding_mode="floor")
        s_qpos = torch.where(s_valid, (safe_key % Q) * stride, INT32_MAX)
    else:
        t_dbin = tiled(torch.where(valid, dbin, INT32_MAX), INT32_MAX)
        t_qpos = tiled(torch.where(valid, qpos_b, INT32_MAX), INT32_MAX)
        order = torch.sort(pack2(t_dbin, t_qpos), dim=1, stable=True).indices
        s_dbin = torch.gather(t_dbin, 1, order)
        s_qpos = torch.gather(t_qpos, 1, order)
        s_spos = torch.gather(tiled(spos, 0), 1, order)
        s_valid = torch.gather(tiled(valid.to(i32), 0), 1, order).bool()

    # runs within each tile: a new run on a band change or a qpos gap
    brk = (s_dbin != shift1(s_dbin)) | (s_qpos - shift1(s_qpos) > run_gap)
    idx = torch.arange(T, dtype=i32, device=dev).expand(N * n_tiles, T)
    run_start = torch.cummax(torch.where(brk, idx, -1), dim=1).values
    nxt_brk = torch.nn.functional.pad(brk[:, 1:], (0, 1), value=True)
    is_end = s_valid & nxt_brk
    # column 0 always breaks, so every run start is >= 0: the segmented
    # forward fill of the JAX package is a gather at the run start
    rs = run_start.long()
    start_q = torch.gather(s_qpos, 1, rs)
    start_s = torch.gather(s_spos, 1, rs)
    nseeds = idx - run_start + 1
    qs, qe = start_q, s_qpos + k
    ss = torch.minimum(start_s, s_spos)
    se = torch.maximum(start_s, s_spos) + k
    good = is_end & (nseeds >= min_seeds) & (qe - qs >= min_hsp_len)

    # two-stage compaction: the first per_tile survivors of each tile,
    # then the first max_hsps of the row's n_tiles * per_tile slots
    per_tile = min(max(32, max_hsps // max(n_tiles, 1)), 256)
    sel_t = compact(good, per_tile, T - 1)                # [N*tiles, pt]
    valid_t = (torch.arange(per_tile, device=dev)[None]
               < good.sum(1, keepdim=True))

    def take_t(a: torch.Tensor) -> torch.Tensor:
        return torch.gather(a, 1, sel_t).reshape(N, n_tiles * per_tile)

    gf = valid_t.reshape(N, n_tiles * per_tile)
    n2 = gf.shape[1]
    sel = compact(gf, max_hsps, n2 - 1)
    out_valid = torch.arange(max_hsps, device=dev)[None] < gf.sum(1, keepdim=True)

    def take(a: torch.Tensor) -> torch.Tensor:
        return torch.where(out_valid, torch.gather(take_t(a), 1, sel), 0)

    return HSPs(qs=take(qs), qe=take(qe), ss=take(ss), se=take(se),
                nseeds=take(nseeds), valid=out_valid)


def rc_to_forward(ss: torch.Tensor, se: torch.Tensor, subj_len: int):
    """Convert half-open subject spans from revcomp to forward coordinates."""
    return subj_len - se, subj_len - ss
