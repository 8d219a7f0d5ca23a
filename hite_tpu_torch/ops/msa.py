"""Anchor-projection batched MSA (counterpart of JAX `ops/msa.py`).

Replaces the reference's per-family mafft runs: every copy is projected
onto the center sequence's coordinates —
  1. exact k-mer matches (copy, center) -> anchors via the center index;
  2. the dominant diagonal band per copy (mode over quantized diagonals);
  3. per-position offsets forward/backward filled between anchors, after
     a lonely-anchor veto;
  4. each copy base written into its center column; unwritten columns are
     gaps (5).  When two copy positions land in one column, the LAST copy
     position wins, the rule the JAX package's CPU scatter follows; here
     it is applied deterministically (a max-reduce of the position index
     per column, then a gather), on every device.

The family axis is an explicit leading batch dimension (the JAX package
vmaps `project_to_center` over families).
"""

from __future__ import annotations

import math

import torch

from hite_tpu_torch.ops.encode import kmer_codes
from hite_tpu_torch.ops.kmer import build_index, lookup

GAP = 5
INT32_MAX = 2**31 - 1


def _mode_of_valid(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Most frequent valid value along the last axis (smallest on ties)."""
    v = torch.where(valid, vals, INT32_MAX)
    s = torch.sort(v, dim=-1).values
    N = s.shape[-1]
    idx = torch.arange(N, dtype=torch.int32, device=s.device)
    prev = torch.nn.functional.pad(s[..., :-1], (1, 0), value=-(2**31))
    run_start = torch.cummax(torch.where(s != prev, idx, -1), dim=-1).values
    run_len = torch.where(s == INT32_MAX, 0, idx - run_start + 1)
    best = torch.argmax(run_len, dim=-1, keepdim=True)
    return torch.gather(s, -1, best)[..., 0]


def _forward_fill(vals: torch.Tensor, valid: torch.Tensor):
    """Forward fill of valid entries along the last axis; (filled, had)."""
    N = vals.shape[-1]
    idx = torch.arange(N, dtype=torch.int32, device=vals.device)
    last_valid = torch.cummax(torch.where(valid, idx, -1), dim=-1).values
    filled = torch.gather(vals, -1, last_valid.clamp(0, N - 1).long())
    return filled, last_valid >= 0


def _shifted_fill(o: torch.Tensor, ok: torch.Tensor):
    return _forward_fill(torch.nn.functional.pad(o[..., :-1], (1, 0)),
                         torch.nn.functional.pad(ok[..., :-1], (1, 0)))


def project_to_center(
    center: torch.Tensor,
    copies: torch.Tensor,
    lens: torch.Tensor,
    *,
    k: int = 8,
    max_hits: int = 4,
    diag_band: int = 16,
    diag_tol: int = 64,
) -> torch.Tensor:
    """Project copies [..., R, Lc] onto center [..., Lq] coordinates.

    lens int32 [..., R]: true copy lengths (rows padded with N).  Leading
    dims are family batch dims.  Returns uint8 [..., R, Lq] (0-3 base,
    4 N, 5 gap)."""
    lead = center.shape[:-1]
    Lq = center.shape[-1]
    R, Lc = copies.shape[-2:]
    F = math.prod(lead)
    dev = center.device
    center = center.reshape(F, Lq)
    copies = copies.reshape(F, R, Lc)
    lens = lens.reshape(F, R)
    A = Lc - k + 1

    idx = build_index(center, k)                              # [F, n]
    km = kmer_codes(copies, k)                                # [F, R, A]
    spos, valid = lookup(idx, km.reshape(F, R * A), max_hits)
    spos = spos.reshape(F, R, A, max_hits)
    valid = valid.reshape(F, R, A, max_hits)

    qpos = torch.arange(A, dtype=torch.int32, device=dev)
    diag = spos - qpos[:, None]                               # [F, R, A, H]
    db = torch.where(valid, torch.div(diag + Lc, diag_band,
                                      rounding_mode="floor"), INT32_MAX)
    mode_db = _mode_of_valid(db.reshape(F, R, -1), valid.reshape(F, R, -1))
    target = mode_db * diag_band - Lc + diag_band // 2        # [F, R]

    dist = (diag - target[..., None, None]).abs()
    dist = torch.where(valid, dist, INT32_MAX)
    best_h = torch.argmin(dist, dim=-1, keepdim=True)         # [F, R, A, 1]
    anchor_ok = torch.gather(dist, -1, best_h)[..., 0] <= diag_tol
    off = torch.gather(spos, -1, best_h)[..., 0] - qpos       # [F, R, A]

    # lonely-anchor veto: keep an anchor only if it agrees (within a small
    # jitter) with its previous OR next valid anchor
    jitter = 8
    prev_off, had_prev0 = _shifted_fill(off, anchor_ok)
    nxt, had_nxt = _shifted_fill(off.flip(-1), anchor_ok.flip(-1))
    next_off, had_next0 = nxt.flip(-1), had_nxt.flip(-1)
    agree_prev = had_prev0 & ((off - prev_off).abs() <= jitter)
    agree_next = had_next0 & ((off - next_off).abs() <= jitter)
    lonely = anchor_ok & ~(agree_prev | agree_next) & (had_prev0 | had_next0)
    anchor_ok = anchor_ok & ~lonely

    off_ff, had_prev = _forward_fill(off, anchor_ok)
    off_bf, _ = _forward_fill(off.flip(-1), anchor_ok.flip(-1))
    off_q = torch.where(had_prev, off_ff, off_bf.flip(-1))    # [F, R, A]
    off_all = torch.cat([off_q, off_q[..., -1:].expand(F, R, Lc - A)], -1)

    q_all = torch.arange(Lc, dtype=torch.int32, device=dev)
    col = q_all + off_all
    in_range = (col >= 0) & (col < Lq) & (q_all < lens[..., None])
    col = torch.where(in_range, col, Lq).long()               # Lq: dropped

    # last copy position per (row, column) wins
    winner = torch.full((F, R, Lq + 1), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(-1, col, q_all.long().expand(F, R, Lc),
                           reduce="amax", include_self=True)
    M = torch.where(winner >= 0,
                    torch.gather(copies, -1, winner.clamp(min=0)),
                    torch.tensor(GAP, dtype=torch.uint8, device=dev))
    any_anchor = anchor_ok.any(-1)
    M = torch.where(any_anchor[..., None], M,
                    torch.tensor(GAP, dtype=torch.uint8, device=dev))
    return M[..., :Lq].reshape(lead + (R, Lq))
