"""The training step of the neural classifiers, on one device or a mesh.

Counterpart of the JAX package's `models/train.py`: the cross-entropy loss
and an AdamW step with optax's `adamw(lr)` settings (b1 0.9, b2 0.999, eps
1e-8, weight decay 1e-4 on every parameter, biases included; PyTorch's
own default decay is 1e-2).  The model holds its parameters and the
optimizer its moments, so a step updates both in place.

`shard_train(mesh, model, optimizer)` is the JAX package's jitted step
over a (dp, tp) mesh, done by hand: the batch splits over "dp"; each
parameter that `parallel.mesh.param_sharding` cuts over "tp" lives, with
its two AdamW moments, as tp slices along its output axis, one a tp
device (the rest once, on the mesh's first device).  A step gathers a
replica of the parameters on each dp row, runs forward and backward on
that row's batch shard with the loss weighted by the shard's share of
the batch, sums the gradients, hands each slice its part and steps AdamW
on the slices (elementwise, so slicing changes nothing).  The summation
order of the gradients is the only difference from the unsharded step.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hite_tpu_torch.device import resolve_device
from hite_tpu_torch.models.convert import (
    Tree, load_flax_params, reset_parameters,
)
from hite_tpu_torch.parallel.mesh import (
    Mesh, batch_sharding, device_guard, param_sharding, replicated,
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


class ShardedTrain:
    """The state of `shard_train`: the parameter slices (`slices[name]`,
    a list of tp tensors, or one replicated tensor), their AdamW
    (`optimizer`, moments placed like the slices) and one model replica
    a dp row.  Calling it runs one step on a batch (`make_train_step`'s
    dict) and returns the loss on the mesh's first device."""

    def __init__(self, mesh: Mesh, model: nn.Module,
                 optimizer: torch.optim.Optimizer):
        self.dims = param_sharding(mesh, model)
        self.home = mesh.devices[0, 0]
        tp_devs = list(mesh.devices[0, :])
        self.slices: Dict[str, List[nn.Parameter]] = {}
        for name, p in model.named_parameters():
            d = self.dims[name]
            if d is None:
                parts = [p.detach().to(self.home)]
            else:
                parts = [c.to(dev) for c, dev in
                         zip(p.detach().chunk(len(tp_devs), d), tp_devs)]
            self.slices[name] = [nn.Parameter(t.clone()) for t in parts]
        self.optimizer = _opt_sharding(optimizer, model, self.slices,
                                       self.dims)
        self.replicas = [copy.deepcopy(model).to(dev).train()
                         for dev in mesh.shard_devices(("dp",))]
        self._split = batch_sharding(mesh)
        self._replicate = replicated(mesh)

    def full(self, name: str) -> torch.Tensor:
        """Parameter `name` gathered whole on the mesh's first device."""
        parts = self.slices[name]
        if self.dims[name] is None:
            return parts[0].detach()
        return torch.cat([t.detach().to(self.home) for t in parts],
                         self.dims[name])

    def unshard(self, model: nn.Module) -> nn.Module:
        """Copy the trained parameters into `model` (in place)."""
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(self.full(name))
        return model

    def __call__(self, batch: Dict) -> torch.Tensor:
        with torch.no_grad():
            for name in self.slices:
                full = self.full(name)
                for rep, t in zip(self.replicas, self._replicate(full)):
                    rep.get_parameter(name).copy_(t)
        inputs = [self._split(x) for x in batch["inputs"]]
        labels = self._split(batch["labels"])
        n = batch["labels"].shape[0]
        losses = []
        for r, rep in enumerate(self.replicas):
            if labels[r].shape[0] == 0:
                continue
            with device_guard(labels[r].device):
                rep.zero_grad(set_to_none=True)
                loss = cross_entropy(rep(*(x[r] for x in inputs)),
                                     labels[r]) * (labels[r].shape[0] / n)
                loss.backward()
                losses.append(loss.detach())
        for name, parts in self.slices.items():
            grad = sum(rep.get_parameter(name).grad.to(self.home)
                       for rep in self.replicas
                       if rep.get_parameter(name).grad is not None)
            d = self.dims[name]
            pieces = [grad] if d is None else grad.chunk(len(parts), d)
            for t, g in zip(parts, pieces):
                t.grad = g.to(t.device)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        count("train.steps")
        return sum(loss.to(self.home) for loss in losses)


def _opt_sharding(optimizer: torch.optim.Optimizer, model: nn.Module,
                  slices: Dict[str, List[nn.Parameter]],
                  dims: Dict[str, Optional[int]]) -> torch.optim.AdamW:
    """An AdamW over the slices with `optimizer`'s settings; moments the
    optimizer already holds are cut like their parameters (the step
    count is a scalar, replicated)."""
    group = optimizer.param_groups[0]
    opt = torch.optim.AdamW(
        [t for parts in slices.values() for t in parts], lr=group["lr"],
        betas=group["betas"], eps=group["eps"],
        weight_decay=group["weight_decay"])
    for name, p in model.named_parameters():
        st = optimizer.state.get(p)
        if not st:
            continue
        parts, d = slices[name], dims[name]
        for i, t in enumerate(parts):
            new = {}
            for k, v in st.items():
                if torch.is_tensor(v) and v.shape == p.shape:
                    v = v if d is None else v.chunk(len(parts), d)[i]
                    new[k] = v.to(t.device).clone()
                else:
                    new[k] = v.clone() if torch.is_tensor(v) else v
            opt.state[t] = new
    return opt


def shard_train(mesh: Mesh, model: nn.Module,
                optimizer: torch.optim.Optimizer) -> ShardedTrain:
    """The training step of `model` over `mesh` (module doc), starting
    from the model's parameters and the optimizer's settings and moments;
    `unshard(model)` writes the trained parameters back."""
    return ShardedTrain(mesh, model, optimizer)
