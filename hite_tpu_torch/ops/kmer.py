"""Sorted k-mer index + lookup (counterpart of JAX `ops/kmer.py`).

A stable code sort of a sequence's k-mers and a `searchsorted` lookup
returning up to `max_hits` index positions per query k-mer.  Leading batch
dimensions map: the index of [F, L] sequences is [F, n], and queries
[F, Q] look up their own row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hite_tpu_torch.ops.encode import kmer_codes

INVALID_CODE = 2**31 - 1


class KmerIndex(NamedTuple):
    """codes int32 [..., n] ascending (masked k-mers last as INVALID_CODE);
    pos int32 [..., n] position of each code.  The JAX package's optional
    prefix buckets serve only its segment-grid mappers, not ported."""

    codes: torch.Tensor
    pos: torch.Tensor


def build_index_from_kmers(km: torch.Tensor) -> KmerIndex:
    """Sorted index of precomputed int32 [..., n] k-mer codes of any
    alphabet (-1 = invalid), by a stable sort.  No prefix buckets: the
    amino-acid index (k = 4) never had them."""
    km = torch.where(km < 0, INVALID_CODE, km)
    sort_codes, perm = torch.sort(km, dim=-1, stable=True)
    return KmerIndex(codes=sort_codes, pos=perm.to(torch.int32))


def build_index(seg_codes: torch.Tensor, k: int) -> KmerIndex:
    """Sorted k-mer index of uint8 [..., S] code arrays (stable sort)."""
    return build_index_from_kmers(kmer_codes(seg_codes, k))


def lookup(index: KmerIndex, query_codes: torch.Tensor, max_hits: int):
    """Up to `max_hits` index positions matching each query k-mer.

    query_codes int32 [..., Q] (-1 invalid), leading dims = the index's,
    or any leading dims against a one-row index [n].
    Returns (spos int32 [..., Q, max_hits] (-1 where invalid),
    valid bool [..., Q, max_hits])."""
    codes = index.codes
    n = codes.shape[-1]
    start = torch.searchsorted(codes, query_codes.contiguous(), right=False)
    raw = start[..., None] + torch.arange(max_hits, device=codes.device)
    j = raw.clamp(0, n - 1)
    if codes.dim() == 1:
        codes_j, pos_j = codes[j], index.pos[j]
    else:
        flat_j = j.reshape(j.shape[:-2] + (-1,))
        codes_j = torch.gather(codes, -1, flat_j).reshape(j.shape)
        pos_j = torch.gather(index.pos, -1, flat_j).reshape(j.shape)
    valid = (codes_j == query_codes[..., None]) & (query_codes[..., None] >= 0)
    valid &= raw < n
    return torch.where(valid, pos_j, -1), valid
