"""Nucleotide code tensor ops (counterpart of the JAX `ops/encode.py`).

Codes: A=0 C=1 G=2 T=3 N/masked=4 (gap 5 in MSA matrices).  N propagates
so masked regions never seed or extend alignments.
"""

from __future__ import annotations

import torch

CODE_N = 4


def complement(codes: torch.Tensor) -> torch.Tensor:
    """Complement; codes >= 4 (N, gap) pass through unchanged.  `3 - codes`
    wraps in uint8 for those codes, but the `where` never selects it."""
    return torch.where(codes < 4, 3 - codes, codes)


def revcomp(codes: torch.Tensor) -> torch.Tensor:
    """Reverse complement along the last axis; N stays N."""
    return torch.flip(complement(codes), dims=(-1,))


def one_hot(codes: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """[..., L] codes -> [..., L, 4] one-hot; N rows are all-zero."""
    eye = torch.cat([torch.eye(4, dtype=dtype, device=codes.device),
                     torch.zeros((1, 4), dtype=dtype, device=codes.device)])
    return eye[codes.clamp(0, 4).long()]


def kmer_codes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Rolling base-4 big-endian k-mer codes along the last axis.

    int32 [..., L - k + 1]; a window containing an N/masked base is -1."""
    L = codes.shape[-1]
    n_kmers = L - k + 1
    c32 = codes.to(torch.int32)
    acc = torch.zeros(codes.shape[:-1] + (n_kmers,), dtype=torch.int32,
                      device=codes.device)
    bad = torch.zeros(acc.shape, dtype=torch.bool, device=codes.device)
    for j in range(k):
        window = c32[..., j : j + n_kmers]
        big = window >= 4
        acc = acc * 4 + torch.where(big, 0, window)
        bad |= big
    return torch.where(bad, -1, acc)


def n_mask(codes: torch.Tensor) -> torch.Tensor:
    """Boolean mask of valid (non-N) positions."""
    return codes < 4
