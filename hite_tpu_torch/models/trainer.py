"""Inference half of the JAX package's `models/trainer.py`: label mapping,
the shared feature assembly and batched CNN inference.

`build_features` assembles the NeuralTE-equivalent feature matrix for
every inference site (located termini, TSD block, domain block) in row
batches padded to a power of two, as the JAX package does;
`predict_logits` is one `eval()` forward under `torch.no_grad()`.
Training (`train_classifier`, `cross_validate`, `make_dataset`, ...)
stays in the JAX package (ROADMAP item 16.6).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from hite_tpu_torch.device import resolve_device
from hite_tpu_torch.models.classifier import WICKER_CLASSES, WICKER_TO_RM
from hite_tpu_torch.models.features import (
    N_DOMAIN_CLASSES, classifier_features, locate_termini, one_hot_float,
    tsd_feature,
)
from hite_tpu_torch.pipeline.candidates import pad_rows, pad_seqs

RM_TO_WICKER = {v: k for k, v in WICKER_TO_RM.items()}
# common RepeatMasker aliases seen in Repbase-style libraries
RM_TO_WICKER.update({
    "DNA/CMC": "CACTA", "DNA/EnSpm": "CACTA", "DNA/CACTA": "CACTA",
    "DNA/hAT-Ac": "hAT", "DNA/hAT-Tip100": "hAT", "DNA/hAT-Charlie": "hAT",
    "DNA/TcMar-Tc1": "Tc1-Mariner", "DNA/TcMar-Mariner": "Tc1-Mariner",
    "DNA/MULE-MuDR": "Mutator", "DNA/MuDR": "Mutator",
    "DNA/PIF": "PIF-Harbinger", "DNA/Harbinger": "PIF-Harbinger",
    "LTR/ERV1": "Retrovirus", "LTR/ERVK": "Retrovirus",
    "LINE/CR1": "Jockey", "LINE/RTE-BovB": "RTE", "SINE/MIR": "tRNA",
    "RC/Helitron": "Helitron", "DNA/Helitron": "Helitron",
})


def label_to_class(label: str) -> Optional[int]:
    """`Class/Subclass` or Wicker name -> class index (None if unmapped)."""
    if label in WICKER_CLASSES:
        return WICKER_CLASSES.index(label)
    if label in RM_TO_WICKER:
        return WICKER_CLASSES.index(RM_TO_WICKER[label])
    head = label.split("-")[0]
    if head in RM_TO_WICKER:
        return WICKER_CLASSES.index(RM_TO_WICKER[head])
    return None


def build_features(
    seqs: Sequence[np.ndarray],
    *,
    tsd_seqs: Optional[Sequence[Optional[np.ndarray]]] = None,
    domain_classes: Optional[Sequence[Optional[int]]] = None,
    locate: bool = True,
    term_lens: Optional[np.ndarray] = None,   # [N] known terminal lengths
    batch: int = 256,
    device=None,
) -> np.ndarray:
    """The feature matrix float32 [N, FEATURE_DIM], computed on `device`
    (None = the card).

    Terminal lengths are `term_lens` when given ("given"), else located
    by the SW scans ("locate") or a fixed window (`locate=False`);
    `tsd_seqs`: per-row TSD codes or None; `domain_classes`: Wicker class
    index or None (= absent)."""
    dev = resolve_device(device)
    n = len(seqs)
    out: List[np.ndarray] = []
    for b0 in range(0, n, batch):
        sub = list(seqs[b0 : b0 + batch])
        mat, lens = pad_seqs(sub, n_rows=pad_rows(len(sub), min_rows=8))
        B = mat.shape[0]
        tmat = np.full((B, 16), 4, np.int32)
        tlens = np.zeros(B, np.int32)
        dom_idx = np.full(B, N_DOMAIN_CLASSES - 1, np.int32)
        for i in range(len(sub)):
            r = tsd_seqs[b0 + i] if tsd_seqs is not None else None
            if r is not None:
                r = np.asarray(r)
                tmat[i, : min(len(r), 16)] = r[:16]
                tlens[i] = min(len(r), 16)
            c = domain_classes[b0 + i] if domain_classes is not None else None
            if c is not None:
                dom_idx[i] = c
        mat_d = torch.from_numpy(mat).to(dev)
        lens_d = torch.from_numpy(lens).to(dev)
        if term_lens is not None:
            tl = np.zeros(B, np.int32)
            tl[: len(sub)] = np.asarray(term_lens[b0 : b0 + batch], np.int32)
            term = torch.from_numpy(tl).to(dev)
        elif locate:
            term = locate_termini(mat_d, lens_d)
        else:
            term = None
        dom = torch.from_numpy(dom_idx).to(dev)
        X = classifier_features(
            mat_d, lens_d, term_lens=term,
            tsd_onehot=tsd_feature(torch.from_numpy(tmat).to(dev),
                                   torch.from_numpy(tlens).to(dev)),
            domain_onehot=one_hot_float(dom, N_DOMAIN_CLASSES))
        out.append(X.cpu().numpy()[: len(sub)])
    return (np.concatenate(out) if out
            else np.zeros((0, 1), np.float32))


@torch.no_grad()
def predict_logits(model: nn.Module, X: np.ndarray) -> np.ndarray:
    """Logits float32 [N, classes] of `model` (in eval mode, on its own
    device) for the feature rows X."""
    if len(X) == 0:
        return np.zeros((0, len(WICKER_CLASSES)), np.float32)
    dev = next(model.parameters()).device
    return model.eval()(torch.from_numpy(np.asarray(X, np.float32)).to(dev)
                        ).cpu().numpy()
