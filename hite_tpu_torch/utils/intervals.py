"""Vectorized interval algebra (host side, numpy).

The reference scatters interval logic across ad-hoc loops (coordinate dedup
`Util.py:4344-4390`, >=95%-overlap merging `process_all_seqs:4551`,
full-length copy filters `generate_full_length_out_v1:6288`).  hite_tpu
centralizes it: intervals are int64 [N, 2] arrays of half-open [start, end).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def as_intervals(arr) -> np.ndarray:
    a = np.asarray(arr, dtype=np.int64).reshape(-1, 2)
    return a


def merge(intervals: np.ndarray, gap: int = 0) -> np.ndarray:
    """Union of intervals, joining pairs separated by <= gap."""
    iv = as_intervals(intervals)
    if len(iv) == 0:
        return iv
    order = np.lexsort((iv[:, 1], iv[:, 0]))
    iv = iv[order]
    # running max of ends; a new group starts where start > prev_max_end + gap
    max_end = np.maximum.accumulate(iv[:, 1])
    new_group = np.ones(len(iv), dtype=bool)
    new_group[1:] = iv[1:, 0] > max_end[:-1] + gap
    group = np.cumsum(new_group) - 1
    n = group[-1] + 1
    starts = np.full(n, np.iinfo(np.int64).max)
    ends = np.zeros(n, dtype=np.int64)
    np.minimum.at(starts, group, iv[:, 0])
    np.maximum.at(ends, group, iv[:, 1])
    return np.stack([starts, ends], axis=1)


def total_length(intervals: np.ndarray) -> int:
    m = merge(intervals)
    return int((m[:, 1] - m[:, 0]).sum()) if len(m) else 0


def overlap_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise overlap lengths: int64 [len(a), len(b)]."""
    a = as_intervals(a)
    b = as_intervals(b)
    lo = np.maximum(a[:, None, 0], b[None, :, 0])
    hi = np.minimum(a[:, None, 1], b[None, :, 1])
    return np.maximum(hi - lo, 0)


def coverage_fraction(targets: np.ndarray, by: np.ndarray) -> np.ndarray:
    """Fraction of each target interval covered by the union of `by`.

    Vectorized via prefix sums over the merged cover — O((N+M) log)."""
    targets = as_intervals(targets)
    cover = merge(by)
    if len(targets) == 0:
        return np.zeros(0)
    if len(cover) == 0:
        return np.zeros(len(targets))
    # cumulative covered length before each cover interval start
    seg_len = cover[:, 1] - cover[:, 0]
    cum = np.concatenate([[0], np.cumsum(seg_len)])

    def covered_upto(x: np.ndarray) -> np.ndarray:
        """Total covered bp in (-inf, x)."""
        idx = np.searchsorted(cover[:, 0], x, side="right")  # covers starting before x
        base = cum[idx]
        # subtract the part of the last overlapping interval beyond x
        last = idx - 1
        adj = np.where(
            last >= 0,
            np.maximum(cover[np.maximum(last, 0), 1] - x, 0),
            0,
        )
        # only subtract when x is inside that interval
        inside = (last >= 0) & (x < cover[np.maximum(last, 0), 1])
        return base - np.where(inside, adj, 0)

    cov_bp = covered_upto(targets[:, 1]) - covered_upto(targets[:, 0])
    length = np.maximum(targets[:, 1] - targets[:, 0], 1)
    return cov_bp / length


def round_coords(intervals: np.ndarray, q: int = 10) -> np.ndarray:
    """Round coordinates to multiples of q (reference get_integer_pos,
    `Util.py:4566` — dedup slack for near-identical candidates)."""
    iv = as_intervals(intervals)
    return (iv + q // 2) // q * q


def dedup(intervals: np.ndarray, q: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """Drop intervals identical after rounding; returns (kept, keep_index)."""
    iv = as_intervals(intervals)
    if len(iv) == 0:
        return iv, np.zeros(0, dtype=np.int64)
    r = round_coords(iv, q)
    _, keep = np.unique(r, axis=0, return_index=True)
    keep = np.sort(keep)
    return iv[keep], keep


def mutual_overlap_groups(intervals: np.ndarray, frac: float = 0.95) -> np.ndarray:
    """Group labels for intervals that reciprocally overlap >= frac.

    Mirrors the reference's >=95% overlap candidate merging
    (`process_all_seqs`, `Util.py:4551`).  Union-find over sorted pairs.
    """
    iv = as_intervals(intervals)
    n = len(iv)
    parent = np.arange(n)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    order = np.argsort(iv[:, 0], kind="stable")
    siv = iv[order]
    for i in range(n):
        for j in range(i + 1, n):
            if siv[j, 0] >= siv[i, 1]:
                break
            ov = min(siv[i, 1], siv[j, 1]) - max(siv[i, 0], siv[j, 0])
            li = siv[i, 1] - siv[i, 0]
            lj = siv[j, 1] - siv[j, 0]
            if ov >= frac * li and ov >= frac * lj:
                ri, rj = find(order[i]), find(order[j])
                if ri != rj:
                    parent[rj] = ri
    return np.array([find(i) for i in range(n)])
