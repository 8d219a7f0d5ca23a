"""The training step of the neural classifiers, on one device.

Counterpart of the JAX package's `models/train.py`: the cross-entropy loss
and an AdamW step with optax's `adamw(lr)` settings (b1 0.9, b2 0.999, eps
1e-8, weight decay 1e-4 on every parameter, biases included; PyTorch's
own default decay is 1e-2).  The model holds its parameters and the
optimizer its moments, so a step updates both in place.  The mesh-sharded
step (`shard_train`) waits for the multi-GPU port.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hite_tpu_torch.device import resolve_device
from hite_tpu_torch.models.convert import (
    Tree, load_flax_params, reset_parameters,
)
from hite_tpu_torch.utils.log import count

# optax.adamw's defaults
BETAS = (0.9, 0.999)
EPS = 1e-8
WEIGHT_DECAY = 1e-4


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of int64 `labels` [B] under float32
    `logits` [B, C]."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None].long()).mean()


def adamw(model: nn.Module, lr: float = 1e-3) -> torch.optim.AdamW:
    """`optax.adamw(lr)` over every parameter of `model`."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=BETAS, eps=EPS,
                             weight_decay=WEIGHT_DECAY)


def create_state(model: nn.Module, seed: int = 0, lr: float = 1e-3,
                 device=None, init: Optional[Tree] = None
                 ) -> Tuple[nn.Module, torch.optim.AdamW]:
    """(model, optimizer): `model` from flax's default init drawn from a CPU
    generator seeded with `seed` (the same draw on every device), or from
    the flax parameter tree `init` where one is given, moved to `device`
    (None = the card), and its AdamW."""
    dev = resolve_device(device)
    if init is None:
        reset_parameters(model, torch.Generator().manual_seed(seed))
    else:
        load_flax_params(model, init)
    model = model.to(dev)
    return model, adamw(model, lr)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    generator: Optional[torch.Generator] = None
                    ) -> Callable[[Dict], torch.Tensor]:
    """train_step(batch) -> the batch's loss (a detached 0-d tensor), after
    one optimizer step on it.

    batch: 'inputs', a tuple of tensors on the model's device with a
    leading batch axis, and 'labels', int [B].  The model runs in
    training mode; a model with dropout draws its mask from `generator`.
    Each step adds one to the `train.steps` counter.
    (The JAX step applies the flax model without `train=True`, so its
    SuperfamilyCNN never drops; `SuperfamilyCNN(dropout=0.0)` is that.)"""
    kw = {} if generator is None else {"generator": generator}

    def train_step(batch: Dict) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = cross_entropy(model(*batch["inputs"], **kw), batch["labels"])
        loss.backward()
        optimizer.step()
        count("train.steps")
        return loss.detach()

    return train_step
