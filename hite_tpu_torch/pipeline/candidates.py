"""Candidate set container + padding/bucketing utilities (host side).

A copy of the JAX package's `pipeline/candidates.py`: a candidate set is a
host table of flat genome intervals; padded code matrices are bucketed by
length so device calls see few distinct shapes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from hite_tpu_torch.genome import Genome
from hite_tpu_torch.io.fasta import CODE_N

BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


def bucket_for(length: int, buckets: Sequence[int] = BUCKETS) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


@dataclass
class CandidateSet:
    """Flat-coordinate candidate intervals with optional metadata columns."""

    intervals: np.ndarray                    # int64 [N, 2]
    strand: Optional[np.ndarray] = None      # int8 [N] 0=+, 1=-
    meta: Dict[str, np.ndarray] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.intervals)

    @property
    def lengths(self) -> np.ndarray:
        return self.intervals[:, 1] - self.intervals[:, 0]

    def subset(self, mask_or_idx) -> "CandidateSet":
        idx = np.asarray(mask_or_idx)
        return CandidateSet(
            intervals=self.intervals[idx],
            strand=None if self.strand is None else self.strand[idx],
            meta={k: v[idx] for k, v in self.meta.items()},
        )

    def seqs(self, genome: Genome, flank: int = 0) -> List[np.ndarray]:
        return [genome.extract(s, e, flank) for s, e in self.intervals]


def pad_rows(n: int, min_rows: int = 4) -> int:
    """Round a batch size up to a power of two."""
    n = max(n, min_rows)
    return 1 << (n - 1).bit_length()


def pad_seqs(seqs: Sequence[np.ndarray], width: Optional[int] = None,
             n_rows: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Pad variable-length code arrays into [N, W] (N-filled) + lengths;
    `n_rows` pads the batch dimension too (all-N rows of length 0)."""
    if width is None:
        width = bucket_for(max((len(s) for s in seqs), default=1))
    rows = n_rows if n_rows is not None else len(seqs)
    mat = np.full((rows, width), CODE_N, dtype=np.uint8)
    lens = np.zeros(rows, dtype=np.int32)
    for i, s in enumerate(seqs):
        L = min(len(s), width)
        mat[i, :L] = s[:L]
        lens[i] = L
    return mat, lens


def bucket_iter(
    items: Sequence[int],
    lengths: np.ndarray,
    buckets: Sequence[int] = BUCKETS,
    max_batch: int = 64,
) -> Iterator[Tuple[int, List[int]]]:
    """Yield (bucket_width, item_indices) groups, batches capped at max_batch."""
    by_bucket: Dict[int, List[int]] = {}
    for i in items:
        by_bucket.setdefault(bucket_for(int(lengths[i]), buckets), []).append(i)
    for width in sorted(by_bucket):
        group = by_bucket[width]
        for b0 in range(0, len(group), max_batch):
            yield width, group[b0 : b0 + max_batch]
