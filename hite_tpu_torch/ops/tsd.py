"""Target-site-duplication search (counterpart of JAX `ops/tsd.py`).

Replaces the reference's `TSDsearch_v1-v5` / `search_confident_tir_v4`
k-mer pairing: for each TSD size, every left-flank window is compared with
every right-flank window at once through a one-hot inner product (a float32
batched matmul, exact: 0/1 products summed to at most 44), then size 2
must be TA and size 4 TTAA (plants), both windows N-free, and the pair
nearest the raw boundaries wins (first index on ties).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from hite_tpu_torch.ops.encode import one_hot

TA = (3, 0)
TTAA = (3, 3, 0, 0)


class TSDHit(NamedTuple):
    """Best TSD per candidate per size ([B, S] each; `sizes` static)."""

    left_pos: torch.Tensor
    right_pos: torch.Tensor
    mismatches: torch.Tensor
    dist: torch.Tensor
    found: torch.Tensor
    sizes: Tuple[int, ...]


def tsd_search(
    left_flank: torch.Tensor,
    right_flank: torch.Tensor,
    *,
    sizes: Sequence[int] = (2, 3, 4, 5, 6, 8, 9, 10, 11),
    mismatch_min_len: int = 8,
    plant: bool = True,
    boundary_l: Optional[int] = None,
    boundary_r: int = 0,
) -> TSDHit:
    """Search for TSDs of each size in paired flank windows uint8 [B, R];
    the element begins at `boundary_l` (default R) in the left window and
    ends at `boundary_r` in the right one."""
    B, R = left_flank.shape
    dev = left_flank.device
    if boundary_l is None:
        boundary_l = R
    oh_l = one_hot(left_flank, dtype=torch.float32)   # [B, R, 4]; N -> zeros
    oh_r = one_hot(right_flank, dtype=torch.float32)
    big = 10**6

    lp_out, rp_out, mm_out, d_out, f_out = [], [], [], [], []
    for s in sizes:
        I = R - s + 1
        wl = torch.stack([oh_l[:, t : t + I] for t in range(s)], 2).reshape(
            B, I, s * 4)
        wr = torch.stack([oh_r[:, t : t + I] for t in range(s)], 2).reshape(
            B, I, s * 4)
        match = torch.bmm(wl, wr.transpose(1, 2))           # [B, I, I]
        mm = s - match.to(torch.int32)

        allowed = mm <= (1 if s >= mismatch_min_len else 0)
        if s == 2 or (s == 4 and plant):
            motif = TA if s == 2 else TTAA
            is_motif = torch.ones((B, I), dtype=torch.bool, device=dev)
            for t, c in enumerate(motif):
                is_motif &= left_flank[:, t : t + I] == c
            allowed &= is_motif[:, :, None]
        ok_l = torch.ones((B, I), dtype=torch.bool, device=dev)
        ok_r = torch.ones((B, I), dtype=torch.bool, device=dev)
        for t in range(s):
            ok_l &= left_flank[:, t : t + I] < 4
            ok_r &= right_flank[:, t : t + I] < 4
        allowed &= ok_l[:, :, None] & ok_r[:, None, :]

        ii = torch.arange(I, dtype=torch.int32, device=dev)
        dist = ((ii[:, None] + s - boundary_l).abs()
                + (ii[None, :] - boundary_r).abs())
        cost = torch.where(allowed, dist[None], big).reshape(B, I * I)
        best = torch.argmin(cost, dim=1)
        best_cost = torch.gather(cost, 1, best[:, None])[:, 0]
        found = best_cost < big
        lp_out.append(best // I)
        rp_out.append(best % I)
        mm_out.append(
            torch.gather(mm.reshape(B, I * I), 1, best[:, None])[:, 0])
        d_out.append(torch.where(found, best_cost, big))
        f_out.append(found)

    return TSDHit(
        left_pos=torch.stack(lp_out, 1),
        right_pos=torch.stack(rp_out, 1),
        mismatches=torch.stack(mm_out, 1),
        dist=torch.stack(d_out, 1),
        found=torch.stack(f_out, 1),
        sizes=tuple(sizes),
    )
