"""Feature extraction for the neural TE classifiers (counterpart of the
JAX package's `models/features.py`).

The NeuralTE feature vector: internal 5-mer frequencies (4^5), 3-/4-mer
frequencies of the located 5' and 3' termini, a TSD one-hot block and a
protein-domain one-hot block; and the HybridLTR frame image.  Every
feature is an exact count or a float32 ratio of exact counts, so the
port's features equal the JAX package's bit for bit.  Functions run on
their inputs' device; `locate_termini` launches the SW kernel on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from hite_tpu_torch.ops.encode import kmer_codes
from hite_tpu_torch.ops.terminal import find_terminal_repeat

TSD_MAX = 16
N_DOMAIN_CLASSES = 29   # 28 Wicker superfamilies + "absent"
FEATURE_DIM = 4**5 + 2 * (4**3 + 4**4) + 5 * TSD_MAX + N_DOMAIN_CLASSES


def kmer_frequencies(seqs: torch.Tensor, lens: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Normalized k-mer frequency vectors float32 [B, 4^k] of uint8 [B, L]
    codes; k-mers past each row's length or holding an N do not count."""
    B = seqs.shape[0]
    codes = kmer_codes(seqs, k)                          # [B, L-k+1]
    idx = torch.arange(codes.shape[1], device=seqs.device)[None]
    valid = (codes >= 0) & (idx < (lens.to(torch.int64)[:, None] - k + 1))
    target = torch.where(valid, codes, 4**k).long()      # invalid -> trash
    hist = torch.zeros((B, 4**k + 1), dtype=torch.float32,
                       device=seqs.device)
    hist.scatter_add_(1, target, torch.ones(target.shape,
                                            dtype=torch.float32,
                                            device=seqs.device))
    hist = hist[:, : 4**k]
    return hist / hist.sum(1, keepdim=True).clamp(min=1.0)


def terminal_kmer_features(
    seqs: torch.Tensor, lens: torch.Tensor,
    *, window: int = 50, ks: Sequence[int] = (3, 4),
    term_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """k-mer frequencies of the 5' and 3' terminal windows, concatenated
    [B, 2 * sum(4^k)]: each row's window is its located terminal length
    `term_lens` clipped to [7, window] (or `window` bp), and at most the
    row's length."""
    B, L = seqs.shape
    dev = seqs.device
    lens = lens.to(torch.int64)
    head = seqs[:, :window]
    offs = torch.arange(window, device=dev)[None]
    if term_lens is not None:
        win_lens = term_lens.to(torch.int64).clamp(min=7).clamp(max=window)
    else:
        win_lens = torch.full((B,), window, dtype=torch.int64, device=dev)
    win_lens = torch.minimum(win_lens, lens)
    # 3' window: the last win_lens bases, right-aligned, then rolled left
    # so the terminal starts at column 0 (kmer_frequencies masks a prefix)
    ridx = (lens[:, None] - window + offs).clamp(0, L - 1)
    tail = torch.gather(seqs, 1, ridx)
    mask = offs >= (window - win_lens[:, None])
    tail = torch.where(mask, tail, torch.full_like(tail, 4))
    rolled = (offs + (window - win_lens)[:, None]).clamp(0, window - 1)
    tail = torch.gather(tail, 1, rolled)
    feats = []
    for k in ks:
        feats.append(kmer_frequencies(head, win_lens, k))
        feats.append(kmer_frequencies(tail, win_lens, k))
    return torch.cat(feats, dim=1)


def locate_termini(seqs: torch.Tensor, lens: torch.Tensor,
                   *, ltr_window: int = 100, itr_window: int = 40,
                   ) -> torch.Tensor:
    """Terminal lengths int32 [B] from the ltrsearch/itrsearch-equivalent
    scans (NeuralTE `identify_terminals`, data_util.py:671-733): one SW
    scan of the 100 bp end windows for a direct repeat (>= 0.85 identity,
    >= 50 bp), one of the 40 bp windows for an inverted repeat (>= 0.7,
    >= 7 bp); 50 bp where neither finds one."""
    ltr = find_terminal_repeat(seqs, lens, inverted=False, window=ltr_window,
                               min_identity=0.85, min_len=50)
    itr = find_terminal_repeat(seqs, lens, inverted=True, window=itr_window,
                               min_identity=0.7, min_len=7)
    fifty = torch.full_like(ltr.length, 50)
    return torch.where(ltr.found, ltr.length,
                       torch.where(itr.found, itr.length, fifty)
                       ).to(torch.int32)


def one_hot_float(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of integer codes; codes outside [0, n) give zeros
    (as `jax.nn.one_hot`)."""
    return (idx.to(torch.int64)[..., None]
            == torch.arange(n, device=idx.device)).float()


def tsd_feature(tsd_codes: torch.Tensor, tsd_lens: torch.Tensor,
                max_len: int = TSD_MAX) -> torch.Tensor:
    """TSD one-hot block float32 [B, max_len * 5] (base or absent per
    position)."""
    B, L = tsd_codes.shape
    pos = torch.arange(max_len, device=tsd_codes.device)[None]
    padded = F.pad(tsd_codes.to(torch.int64), (0, max(0, max_len - L)),
                   value=4)[:, :max_len]
    n = torch.minimum(tsd_lens.to(torch.int64),
                      torch.tensor(max_len, device=tsd_codes.device))
    codes = torch.where(pos < n[:, None], padded, torch.full_like(padded, 4))
    return one_hot_float(codes, 5).reshape(B, max_len * 5)


def classifier_features(
    seqs: torch.Tensor,
    lens: torch.Tensor,
    *,
    internal_k: int = 5,
    terminal_ks: Sequence[int] = (3, 4),
    term_lens: Optional[torch.Tensor] = None,      # [B] located terminals
    tsd_onehot: Optional[torch.Tensor] = None,     # [B, 16 * 5]
    domain_onehot: Optional[torch.Tensor] = None,  # [B, 29]
) -> torch.Tensor:
    """The NeuralTE-equivalent feature vector float32 [B, FEATURE_DIM].

    The TSD and domain blocks are always present (one checkpoint, one
    feature width): absent inputs encode as the all-"absent" rows."""
    B = seqs.shape[0]
    dev = seqs.device
    if tsd_onehot is None:
        tsd_onehot = tsd_feature(
            torch.full((B, 1), 4, dtype=torch.int32, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev))
    if domain_onehot is None:
        domain_onehot = one_hot_float(
            torch.full((B,), N_DOMAIN_CLASSES - 1, device=dev),
            N_DOMAIN_CLASSES)
    return torch.cat([
        kmer_frequencies(seqs, lens, internal_k),
        terminal_kmer_features(seqs, lens, ks=terminal_ks,
                               term_lens=term_lens),
        tsd_onehot.float(),
        domain_onehot.float(),
    ], dim=1)


def frame_image(M: torch.Tensor, n_rows: int = 100) -> torch.Tensor:
    """Render an [R, L] MSA matrix as HybridLTR-style image channels
    float32 [n_rows, L, 3] (rows cut or zero-padded): 0 gap/absence,
    1 agreement with the column majority (ties: the lowest code), 2 the
    base scaled to (0, 1]."""
    R, L = M.shape
    Mi = M.to(torch.int64)
    gap = (Mi >= 4).float()
    counts = one_hot_float(Mi, 4).sum(0)                 # [L, 4]
    majority = counts.argmax(1)
    support = ((Mi == majority[None]) & (Mi < 4)).float()
    base = torch.where(Mi < 4, (Mi + 1).float() / 4.0,
                       torch.zeros((), device=M.device))
    img = torch.stack([gap, support, base], dim=-1)
    if R < n_rows:
        return F.pad(img, (0, 0, 0, 0, 0, n_rows - R))
    return img[:n_rows]
