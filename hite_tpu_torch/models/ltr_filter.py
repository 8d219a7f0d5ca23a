"""LTR true/false deep filter (HybridLTR/FiLTR-equivalent), inference in
PyTorch.

Counterpart of the JAX package's `models/ltr_filter.py`: an image branch
over the 100 x 400 both-ends frame rendered as 3 channels and a k-mer
branch over 3-/4-mer frequency planes, each three ResNet-style blocks of
32, 64 and 128 channels (the second and third at stride 2) and a global
average pool, then Dense 64 -> 16 -> 2, with flax's bf16 arithmetic
(`models.convert`).  Inputs keep the JAX package's NHWC layout.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hite_tpu_torch.models.convert import BF16, Conv, Dense, GroupNorm


class ResBlock(nn.Module):
    """conv 3x3 (stride) -> GroupNorm(8) -> ReLU -> conv 3x3 -> GroupNorm(8),
    plus the input (through a 1x1 conv of the same stride when the width or
    stride changes), then ReLU; bf16 NCHW in and out."""

    def __init__(self, cin: int, channels: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(cin, channels, (3, 3), stride)
        self.GroupNorm_0 = GroupNorm(8, channels)
        self.Conv_1 = Conv(channels, channels, (3, 3))
        self.GroupNorm_1 = GroupNorm(8, channels)
        if cin != channels or stride != 1:
            self.Conv_2 = Conv(cin, channels, (1, 1), stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        h = self.GroupNorm_1(self.Conv_1(h))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return F.relu(h + x)


class Branch(nn.Module):
    """Three ResBlocks and a global average pool: NHWC float -> bf16 [B, C]."""

    def __init__(self, cin: int, widths: Sequence[int] = (32, 64, 128)):
        super().__init__()
        for i, w in enumerate(widths):
            self.add_module(f"ResBlock_{i}",
                            ResBlock(cin, w, stride=1 if i == 0 else 2))
            cin = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2).to(BF16)
        for block in self.children():
            h = block(h)
        # jnp.mean of bf16: a float32 sum, rounded back to bf16
        return h.float().mean(dim=(2, 3)).to(BF16)


class LTRFilterCNN(nn.Module):
    """Dual-branch CNN: img [B, 100, W, 3] + kmer [B, 16, 16, 2] -> float32
    logits [B, 2] (class 1 = a real LTR element)."""

    def __init__(self, img_channels: int = 3, kmer_channels: int = 2):
        super().__init__()
        self.image_branch = Branch(img_channels)
        self.kmer_branch = Branch(kmer_channels)
        self.Dense_0 = Dense(256, 64)
        self.Dense_1 = Dense(64, 16)
        self.Dense_2 = Dense(16, 2, torch.float32)

    def forward(self, img: torch.Tensor, kmer: torch.Tensor) -> torch.Tensor:
        h = torch.cat([self.image_branch(img), self.kmer_branch(kmer)], -1)
        h = F.relu(self.Dense_0(h))
        h = F.relu(self.Dense_1(h))
        return self.Dense_2(h)


def kmer_channels(seq_freqs_3: torch.Tensor, seq_freqs_4: torch.Tensor,
                  height: int = 16) -> torch.Tensor:
    """Arrange 3-/4-mer frequency vectors [B, 64], [B, 256] into a 2-channel
    map float32 [B, height, 16, 2] (zero-padded / cut to height x 16)."""
    B = seq_freqs_3.shape[0]
    n = height * 16
    f3 = F.pad(seq_freqs_3, (0, n - 64))
    f4 = F.pad(seq_freqs_4, (0, max(0, n - 256)))[:, :n]
    return torch.stack([f3.reshape(B, height, 16), f4.reshape(B, height, 16)],
                       dim=-1).float()
