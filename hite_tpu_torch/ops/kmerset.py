"""k-mer sets of many short sequences in one batched pass on the device.

Two host steps of the modules built a distinct k-mer set one sequence at
a time in NumPy: the boundary engines' flank scores (how many of a
copy's flank 8-mers belong to its candidate) and the min-hash sketches
that group candidates (`pipeline/copies.py:_kmer_sketch_groups`).  Here a
ragged batch is N-padded [rows, width] uint8 rows on the caller's device
(the genome's), every window coded at once by `ops.encode.kmer_codes`
(a window holding an N or padding is invalid), in row chunks whose
largest intermediate stays under `CHUNK_BYTES`.  The same torch code is
the plain version the CPU tests run; `kmer_code_set` is the NumPy
per-sequence rule both callers had, kept as their oracle.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from hite_tpu_torch.ops.encode import kmer_codes
from hite_tpu_torch.utils.log import count

CHUNK_BYTES = 1 << 28        # the largest intermediate of one chunk
MIX = 0xC2B2AE3D27D4EB4F     # the sketches' uint64 multiplier
_MIX_BITS = MIX - (1 << 64)  # the same bits as an int64
_SIGN = -(1 << 63)           # int64 sign bit: unsigned order as signed
_INT64_MAX = (1 << 63) - 1


def kmer_code_set(v: np.ndarray, k: int = 8) -> np.ndarray:
    """Sorted distinct codes of the windows of `v` with no N (NumPy, one
    sequence)."""
    v = np.asarray(v, np.int64)
    if len(v) < k:
        return np.zeros(0, np.int64)
    m = len(v) - k + 1
    ok = np.ones(m, bool)
    code = np.zeros(m, np.int64)
    for j in range(k):
        w = v[j : m + j]
        ok &= w < 4
        code = code * 4 + np.where(w < 4, w, 0)
    return np.unique(code[ok])


def row_chunks(n: int, row_bytes: int):
    """[a, b) row ranges of n rows, each at most CHUNK_BYTES of
    `row_bytes` a row (one row at least)."""
    step = max(1, CHUNK_BYTES // max(row_bytes, 1))
    for r0 in range(0, n, step):
        yield r0, min(n, r0 + step)


def _set_keys(stream: torch.Tensor, owner: torch.Tensor, n_owners: int,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted distinct (owner, code) keys of every valid window of an
    N-separated stream, valid windows an owner); `owner` int64 [L] is the
    owning set of each position."""
    keys = [torch.zeros(0, dtype=torch.int64, device=stream.device)]
    set_n = torch.zeros(n_owners, dtype=torch.int64, device=stream.device)
    for a, b in row_chunks(stream.shape[0] - k + 1, 32):
        code = kmer_codes(stream[a : b + k - 1], k)
        ok = code >= 0
        own = owner[a:b][ok]
        set_n += torch.bincount(own, minlength=n_owners)
        keys.append(torch.unique(own * 4 ** k + code[ok]))
    return torch.unique(torch.cat(keys)), set_n


def in_set_counts(rows: torch.Tensor, row_owner: torch.Tensor,
                  stream: torch.Tensor, stream_owner: torch.Tensor,
                  n_owners: int, k: int = 8
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each row's distinct valid k-mers, and how many of them lie in its
    owner's set.

    rows uint8 [n, W] (N-padded), row_owner int64 [n]; the owners' sets
    are the valid windows of `stream` (uint8 [L], the sets' sequences
    joined by N) with `stream_owner` int64 [L].  Returns host int64
    (distinct [n], in_set [n], set windows [n_owners]): each row sorted,
    its first occurrences counted and looked up in the sorted (owner,
    code) keys of the sets."""
    n, W = rows.shape
    keys, set_n = _set_keys(stream, stream_owner, n_owners, k)
    distinct = torch.zeros(n, dtype=torch.int64, device=rows.device)
    in_set = torch.zeros_like(distinct)
    for a, b in row_chunks(n if W >= k else 0, 48 * W):
        s = torch.sort(kmer_codes(rows[a:b], k), dim=1).values
        first = torch.ones_like(s, dtype=torch.bool)
        first[:, 1:] = s[:, 1:] != s[:, :-1]
        first &= s >= 0
        distinct[a:b] = first.sum(1)
        if len(keys):
            key = row_owner[a:b, None] * 4 ** k + s
            at = torch.searchsorted(keys, key).clamp_(max=len(keys) - 1)
            in_set[a:b] = (first & (keys[at] == key)).sum(1)
    return distinct.cpu().numpy(), in_set.cpu().numpy(), set_n.cpu().numpy()


def minhash_sketches(seqs: Sequence[np.ndarray], k: int, salts: np.ndarray,
                     device) -> Tuple[np.ndarray, np.ndarray]:
    """Min-hash sketches of every sequence's valid k-mers: for each salt,
    min over codes of (code ^ salt) * MIX in uint64 arithmetic and order.

    Returns (uint64 [n, S], has [n]); a sequence with no valid window keeps
    an all-ones row and has False.  The sequences are joined once on the
    host, uploaded, and cut on the device into rows padded to a power of
    two of their length, shortest first; the product runs in int64 (the
    same bits) with its sign bit flipped so that a signed min is the
    unsigned one.  Duplicate codes cannot change a minimum, so no set is
    built."""
    if k > 15:
        raise ValueError(f"k={k}: int32 window codes hold k <= 15")
    n, S = len(seqs), len(salts)
    sk = np.full((n, S), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    has = np.zeros(n, bool)
    lens = np.fromiter(map(len, seqs), np.int64, n)
    rows = np.flatnonzero(lens >= k)
    if not len(rows):
        return sk, has
    count("kmer.sketch_items", len(rows))
    dev = torch.device(device)
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    flat = torch.from_numpy(
        np.concatenate(seqs).astype(np.uint8, copy=False)).to(dev)
    rows = rows[np.argsort(lens[rows], kind="stable")]
    width = 1 << np.frexp(lens[rows] - 1)[1]          # power of two >= len
    salt = torch.from_numpy(np.asarray(salts, np.uint64).view(np.int64)
                            ).to(dev)
    meta = torch.from_numpy(np.stack([starts[rows], lens[rows]])).to(dev)
    outs, oks = [], []
    for W in np.unique(width):
        sel = np.flatnonzero(width == W)
        j = torch.arange(int(W), device=dev)
        for a, b in row_chunks(len(sel), 8 * S * int(W)):
            st, ln = meta[:, sel[a]:sel[b - 1] + 1]
            pos = (st[:, None] + j).clamp_(max=flat.shape[0] - 1)
            x = torch.where(j < ln[:, None], flat[pos], 4)
            code = kmer_codes(x, k)
            h = (code.to(torch.int64)[..., None] ^ salt).mul_(_MIX_BITS)
            h.bitwise_xor_(_SIGN).masked_fill_((code < 0)[..., None],
                                               _INT64_MAX)
            outs.append(h.amin(dim=1))
            oks.append((code >= 0).any(1))
    got = (torch.cat(outs) ^ _SIGN).cpu().numpy().view(np.uint64)
    sk[rows] = got
    has[rows] = torch.cat(oks).cpu().numpy()
    return sk, has
