"""Sorted k-mer index + lookup (counterpart of JAX `ops/kmer.py`).

A stable code sort of a sequence's k-mers and a lookup returning up to
`max_hits` index positions per query k-mer.  Leading batch dimensions
map: the index of [F, L] sequences is [F, n], and queries [F, Q] look up
their own row.  With prefix buckets (the segment mappers' indexes) the
lookup is the JAX package's bounded binary search inside the query's
bucket; without them, a `searchsorted`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hite_tpu_torch.ops.encode import kmer_codes

INVALID_CODE = 2**31 - 1

BUCKET_BASES = 8          # first-level direct-address prefix (4^8 buckets)
BUCKET_SEARCH_ITERS = 12  # exact for buckets up to 4095 entries; larger
                          # buckets (extreme low-complexity prefixes) may
                          # miss seeds, as in the JAX package


class KmerIndex(NamedTuple):
    """codes int32 [..., n] ascending (masked k-mers last as INVALID_CODE);
    pos int32 [..., n] position of each code; buckets: optional int32
    [..., 4^BUCKET_BASES + 1] prefix-bucket start offsets."""

    codes: torch.Tensor
    pos: torch.Tensor
    buckets: Optional[torch.Tensor] = None


def bucket_shift_for(k: int) -> Optional[int]:
    """Shift from a k-mer code to its BUCKET_BASES prefix (None: k too
    short for buckets)."""
    return 2 * (k - BUCKET_BASES) if k > BUCKET_BASES else None


def _gather_last(a: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """a[..., j] row by row: a [n] with any j, or a [..., n] with j
    [..., *] of the same leading dims."""
    if a.dim() == 1:
        return a[j]
    flat = j.reshape(j.shape[: a.dim() - 1] + (-1,))
    return torch.gather(a, -1, flat).reshape(j.shape)


def build_index_from_kmers(km: torch.Tensor,
                           bucket_shift: Optional[int] = None) -> KmerIndex:
    """Sorted index of precomputed int32 [..., n] k-mer codes of any
    alphabet (-1 = invalid), by a stable sort; with `bucket_shift`, the
    4^BUCKET_BASES prefix-bucket starts (bounds b << shift in int32, as
    the JAX package computes them, wrapping past 2^31)."""
    km = torch.where(km < 0, INVALID_CODE, km)
    sort_codes, perm = torch.sort(km, dim=-1, stable=True)
    buckets = None
    if bucket_shift is not None:
        nb = 4**BUCKET_BASES
        b = torch.arange(nb + 1, dtype=torch.int64, device=km.device)
        bounds = ((b << bucket_shift) & 0xFFFFFFFF)
        bounds = torch.where(bounds >= 2**31, bounds - 2**32, bounds)
        bounds = torch.where(bounds < 0, INVALID_CODE, bounds).to(torch.int32)
        lead = sort_codes.shape[:-1]
        buckets = torch.searchsorted(
            sort_codes.contiguous(),
            bounds.expand(lead + (nb + 1,)).contiguous(),
            right=False).to(torch.int32)
    return KmerIndex(codes=sort_codes, pos=perm.to(torch.int32),
                     buckets=buckets)


def build_index(seg_codes: torch.Tensor, k: int,
                buckets: bool = False) -> KmerIndex:
    """Sorted k-mer index of uint8 [..., S] code arrays (stable sort).
    `buckets=True` adds the prefix buckets when k > BUCKET_BASES, as the
    JAX package's `build_index` always does; its lookups agree with the
    plain search wherever a bucket holds under 4096 entries."""
    shift = bucket_shift_for(k) if buckets else None
    return build_index_from_kmers(kmer_codes(seg_codes, k),
                                  bucket_shift=shift)


def lookup(index: KmerIndex, query_codes: torch.Tensor, max_hits: int,
           bucket_shift: Optional[int] = None):
    """Up to `max_hits` index positions matching each query k-mer.

    query_codes int32 [..., Q] (-1 invalid), leading dims = the index's,
    or any leading dims against a one-row index [n].  With the index's
    buckets and `bucket_shift`, the start is BUCKET_SEARCH_ITERS halvings
    inside the query's bucket (the JAX package's search).
    Returns (spos int32 [..., Q, max_hits] (-1 where invalid),
    valid bool [..., Q, max_hits])."""
    codes = index.codes
    n = codes.shape[-1]
    query_codes = query_codes.contiguous()
    if index.buckets is not None and bucket_shift is not None:
        nb = index.buckets.shape[-1] - 1
        b = (torch.where(query_codes >= 0, query_codes, 0)
             >> bucket_shift).clamp(0, nb - 1).long()
        lo = _gather_last(index.buckets, b).long()
        hi = _gather_last(index.buckets, b + 1).long()
        for _ in range(BUCKET_SEARCH_ITERS):
            mid = torch.div(lo + hi, 2, rounding_mode="floor")
            go_right = _gather_last(codes, mid.clamp(0, n - 1)) < query_codes
            lo = torch.where(go_right, mid + 1, lo)
            hi = torch.where(go_right, hi, mid)
        start = lo
    else:
        start = torch.searchsorted(codes, query_codes, right=False)
    raw = start[..., None] + torch.arange(max_hits, device=codes.device)
    j = raw.clamp(0, n - 1)
    if codes.dim() == 1:
        codes_j, pos_j = codes[j], index.pos[j]
    else:
        codes_j, pos_j = _gather_last(codes, j), _gather_last(index.pos, j)
    valid = (codes_j == query_codes[..., None]) & (query_codes[..., None] >= 0)
    valid &= raw < n
    return torch.where(valid, pos_j, -1), valid
