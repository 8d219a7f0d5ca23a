"""TE superfamily classifier (NeuralTE-equivalent) in PyTorch.

Counterpart of the JAX package's `models/classifier.py`: the same 1-D CNN
over the NeuralTE feature vector (3 x Conv(32, k=7) + ReLU + max-pool 2,
dropout in training, Dense 256, Dense 28), with flax's bf16 arithmetic
(`models.convert`), filled from the JAX package's parameter tree or
trained (`models.trainer`); the 28 Wicker superfamilies and their
RepeatMasker names; `predict_labels`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hite_tpu_torch.models.convert import BF16, Conv, Dense
from hite_tpu_torch.models.features import FEATURE_DIM

# 28 Wicker superfamily labels (bin/NeuralTE/configs/config.py:58-63) and
# their RepeatMasker equivalents (data/TEClasses.tsv via getRMToWicker).
WICKER_CLASSES = (
    "Copia", "Gypsy", "Bel-Pao", "Retrovirus", "DIRS", "Ngaro", "VIPER",
    "Penelope", "R2", "RTE", "Jockey", "L1", "I", "tRNA", "7SL", "5S",
    "Tc1-Mariner", "hAT", "Mutator", "Merlin", "Transib", "P", "PiggyBac",
    "PIF-Harbinger", "CACTA", "Crypton", "Helitron", "Maverick",
)

WICKER_TO_RM = {
    "Copia": "LTR/Copia", "Gypsy": "LTR/Gypsy", "Bel-Pao": "LTR/Pao",
    "Retrovirus": "LTR/ERV", "DIRS": "LTR/DIRS", "Ngaro": "LTR/Ngaro",
    "VIPER": "LTR/Viper", "Penelope": "LINE/Penelope", "R2": "LINE/R2",
    "RTE": "LINE/RTE", "Jockey": "LINE/Jockey", "L1": "LINE/L1",
    "I": "LINE/I", "tRNA": "SINE/tRNA", "7SL": "SINE/7SL", "5S": "SINE/5S",
    "Tc1-Mariner": "DNA/TcMar", "hAT": "DNA/hAT", "Mutator": "DNA/MULE",
    "Merlin": "DNA/Merlin", "Transib": "DNA/CMC-Transib", "P": "DNA/P",
    "PiggyBac": "DNA/PiggyBac", "PIF-Harbinger": "DNA/PIF-Harbinger",
    "CACTA": "DNA/CMC-EnSpm", "Crypton": "DNA/Crypton",
    "Helitron": "RC/Helitron", "Maverick": "DNA/Maverick",
}


class SuperfamilyCNN(nn.Module):
    """1-D CNN over the feature vector [B, F] (treated as a length axis)
    -> float32 logits [B, num_classes].

    `dropout` (flax's default 0.5) applies to the flattened features in
    training mode only, as flax's `nn.Dropout`: keep with probability
    1 - rate, scaled by 1 / (1 - rate), in bf16; the mask draws from the
    `generator` handed to `forward` (on the input's device)."""

    def __init__(self, n_features: int = FEATURE_DIM, num_classes: int = 28,
                 channels: Sequence[int] = (32, 32, 32), kernel: int = 7,
                 hidden: int = 256, dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        cin, width = 1, n_features
        for i, ch in enumerate(channels):
            self.add_module(f"Conv_{i}", Conv(cin, ch, (kernel,)))
            cin, width = ch, width // 2
        self.n_convs = len(channels)
        self.Dense_0 = Dense(width * cin, hidden)
        self.Dense_1 = Dense(hidden, num_classes, torch.float32)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x.to(BF16)[:, None, :]                       # [B, 1, F]
        for i in range(self.n_convs):
            h = F.relu(getattr(self, f"Conv_{i}")(h))
            # VALID max-pool 2; a tie sends the gradient to the first, as
            # XLA's select-and-scatter does
            h = F.max_pool1d(h, 2)
        # flax flattens [B, W, C]: channels fastest
        h = h.permute(0, 2, 1).reshape(h.shape[0], -1)
        if self.training and self.dropout > 0:
            keep = 1.0 - self.dropout
            mask = torch.rand(h.shape, generator=generator,
                              device=h.device) < keep
            h = torch.where(mask, h / keep, torch.zeros_like(h))
        h = F.relu(self.Dense_0(h))
        return self.Dense_1(h)


def predict_labels(logits, is_wicker: bool = True, restrict=None):
    """argmax logits -> label strings (Wicker or RepeatMasker vocabulary);
    ties take the first class.

    restrict: optional iterable of Wicker class names — classes outside it
    are masked before the argmax (e.g. intact LTR elements may only take
    LTR superfamilies, as NeuralTE's LTR mode does by construction)."""
    scores = np.asarray(logits, np.float32)
    if restrict is not None:
        allowed = set(restrict)
        mask = np.array([c in allowed for c in WICKER_CLASSES])
        scores = np.where(mask[None, :], scores, -np.inf)
    idx = scores.argmax(axis=-1)
    if is_wicker:
        return [WICKER_CLASSES[i] for i in idx]
    return [WICKER_TO_RM[WICKER_CLASSES[i]] for i in idx]


LTR_SUPERFAMILIES = ("Copia", "Gypsy", "Bel-Pao", "Retrovirus", "DIRS",
                     "Ngaro", "VIPER")
# cut-and-paste DNA transposons (Wicker class II subclass 1/2, minus RC)
DNA_SUPERFAMILIES = ("Tc1-Mariner", "hAT", "Mutator", "Merlin", "Transib",
                     "P", "PiggyBac", "PIF-Harbinger", "CACTA", "Crypton",
                     "Maverick")
# non-LTR retrotransposons (LINE + SINE superfamilies)
NONLTR_SUPERFAMILIES = ("Penelope", "R2", "RTE", "Jockey", "L1", "I",
                        "tRNA", "7SL", "5S")
