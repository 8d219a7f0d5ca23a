"""Candidate clustering via shared genome-copy overlap (host side).

A copy of the JAX package's `pipeline/cluster.py` (cd-hit-est
replacement): two candidates share a family when their genomic copy sets
reciprocally overlap.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hite_tpu_torch.pipeline.copies import CopyHit


class UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def cluster_by_copies(copy_sets: Sequence[Sequence[CopyHit]],
                      min_overlap: float = 0.7) -> np.ndarray:
    """Group labels [N]: candidates whose copies RECIPROCALLY overlap >=
    min_overlap share a family."""
    n = len(copy_sets)
    uf = UnionFind(n)
    events: List[Tuple[int, int, int]] = []
    for i, hits in enumerate(copy_sets):
        for h in hits:
            events.append((h.start, h.end, i))
    events.sort()
    active: List[Tuple[int, int, int]] = []
    for s, e, i in events:
        active = [a for a in active if a[0] > s]
        for ae, as_, j in active:
            if j == i:
                continue
            ov = min(ae, e) - max(as_, s)
            if ov >= min_overlap * (e - s) and ov >= min_overlap * (ae - as_):
                uf.union(i, j)
        active.append((e, s, i))
    return np.array([uf.find(i) for i in range(n)])


def representatives(groups: np.ndarray, lengths: np.ndarray,
                    copy_counts: Optional[Sequence[int]] = None
                    ) -> Dict[int, int]:
    """Each group's representative (most copies, then longest)."""
    best: Dict[int, int] = {}

    def score(i: int):
        c = copy_counts[i] if copy_counts is not None else 0
        return (c, lengths[i])

    for i, g in enumerate(groups):
        if g not in best or score(i) > score(best[int(g)]):
            best[int(g)] = i
    return best
