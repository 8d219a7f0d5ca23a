"""Tandem-repeat detection and masking (counterpart of JAX `ops/tandem.py`).

Replaces TRF (reference `run_TRF`, `trf 2 7 7 80 10 50 500 -m`):
* short periods (p <= `max_period`): positionwise self-match
  `seq[i] == seq[i-p]`, box-filtered; a position is tandem when any
  period's local match density reaches the threshold;
* long periods (`long_tandem_mask`): one stable code sort of all k-mers —
  a position is periodic when its k-mer's nearest other occurrence lies
  within `max_period` bp, and a dense run of periodic positions is an array.

Window sums are exact integer counts divided in float32, as the JAX
package's float32 `reduce_window` sums of 0/1 values are.
"""

from __future__ import annotations

import torch

from hite_tpu_torch.ops.encode import kmer_codes

_INT32_MAX = 2**31 - 1


def _box_density(x: torch.Tensor, window: int) -> torch.Tensor:
    """Centered moving average along the last axis (same length), float32:
    mean of x[max(0, i - window//2) : min(L, i + (window+1)//2)]."""
    L = x.shape[-1]
    w_lo = window // 2
    w_hi = (window + 1) // 2
    c = torch.nn.functional.pad(
        torch.cumsum(x.to(torch.int32), dim=-1, dtype=torch.int32), (1, 0))
    idx = torch.arange(L, device=x.device)
    hi = (idx + w_hi).clamp(max=L)
    lo = (idx - w_lo).clamp(min=0)
    sums = (c[..., hi] - c[..., lo]).to(torch.float32)
    count = (hi - lo).to(torch.float32)
    return sums / count.clamp(min=1.0)


def tandem_mask(seqs: torch.Tensor, *, max_period: int = 16,
                density: float = 0.8, window: int = 24) -> torch.Tensor:
    """Boolean tandem mask over [..., L] code arrays (one fixed 24 bp
    window for every period, as in the JAX package)."""
    out = torch.zeros(seqs.shape, dtype=torch.bool, device=seqs.device)
    for p in range(1, max_period + 1):
        eq = (seqs[..., p:] == seqs[..., :-p]) & (seqs[..., p:] < 4)
        eq = torch.nn.functional.pad(eq, (p, 0))
        out |= _box_density(eq, window) >= density
    return out


def long_tandem_mask(seqs: torch.Tensor, *, k: int = 12,
                     max_period: int = 500, density: float = 0.5,
                     window: int = 64) -> torch.Tensor:
    """Boolean long-period tandem mask over [..., L] code arrays."""
    shape = seqs.shape
    flat = seqs.reshape(-1, shape[-1])
    L = flat.shape[-1]
    codes = kmer_codes(flat, k)                            # [N, L - k + 1]
    codes = torch.where(codes < 0, _INT32_MAX, codes)
    nk = codes.shape[-1]
    # stable sort: equal codes keep ascending positions, so the adjacent
    # sorted pair is each position's nearest other occurrence
    codes_s, pos_s = torch.sort(codes, dim=-1, stable=True)
    eq = (codes_s[:, :-1] == codes_s[:, 1:]) & (codes_s[:, :-1] != _INT32_MAX)
    pair = (eq & (pos_s[:, 1:] - pos_s[:, :-1] <= max_period)).to(torch.int32)
    per_entry = torch.maximum(torch.nn.functional.pad(pair, (0, 1)),
                              torch.nn.functional.pad(pair, (1, 0)))
    # back to genome order: positions are a permutation (unique targets)
    ind = torch.empty_like(per_entry).scatter_(1, pos_s, per_entry)
    mask = _box_density(ind, window) >= density           # k-mer starts
    full = torch.nn.functional.pad(mask, (0, L - nk))
    out = full.clone()
    for s in range(1, k):
        out |= torch.nn.functional.pad(full[:, : L - s], (s, 0))
    return out.reshape(shape)


def tandem_fraction(seqs: torch.Tensor, lens: torch.Tensor, *,
                    max_period: int = 16, density: float = 0.8,
                    window: int = 24) -> torch.Tensor:
    """Fraction of each (padded) candidate covered by tandem repeats [B]
    (float32, count / length as in the JAX package)."""
    mask = tandem_mask(seqs, max_period=max_period, density=density,
                       window=window)
    idx = torch.arange(seqs.shape[-1], device=seqs.device)
    valid = idx < lens[..., None]
    n = (mask & valid).sum(-1).to(torch.float32)
    return n / lens.clamp(min=1).to(torch.float32)
