"""Flax-layout layers and the flax -> PyTorch parameter converter.

The JAX package's CNNs are flax modules declared with `dtype=bfloat16` and
bundled as pickles of their parameter trees (float16 numpy arrays).  The
layers here reproduce flax's arithmetic cast for cast:

* `Conv` / `Dense` (bf16): inputs, kernel and bias are cast to bf16 (the
  float16 or float32 parameters round to bf16, as `promote_dtype` does);
  the product is accumulated in float32 and rounded to bf16; the bias is
  added in bf16.  Products of bf16 values are exact in TF32 as in float32,
  so these layers do not depend on the caller's TF32 flags on the card.
* `Dense(dtype=float32)` (the last layer of both CNNs): float32 operands,
  computed as a sum of products that never goes through TF32.
* `GroupNorm`: flax's statistics in float32 (mean and E[x^2] - mean^2,
  clipped at 0), epsilon 1e-6 (flax's default, not PyTorch's 1e-5), scale
  and bias in float32, the result cast to bf16.
* padding is flax's "SAME": for stride s, kernel k and width n, the total
  pad is max((ceil(n / s) - 1) s + k - n, 0), low half rounded down, so a
  stride-2 3x3 convolution of an even width pads 0 low and 1 high.

Parameters are float32 and trainable; every cast above is differentiable,
so a parameter's gradient arrives rounded to bf16 as in flax.  A layer
is built with zeros; `reset_parameters` (which `models.train.create_state`
calls) gives it flax's default init: `lecun_normal` kernels, zero biases,
GroupNorm scale 1.

Tensors are NC(H)W inside the modules; each layer's `load_flax` maps its
flax leaves: conv kernels HWIO -> OIHW (WIO -> OIW), `Dense.kernel`
(in, out) -> `weight` (out, in), `GroupNorm.scale` -> `weight`, and its
`to_flax` maps them back.  `load_flax_params` walks a module and a flax
tree together by name (the modules carry flax's submodule names:
`Conv_0`, `ResBlock_1`, ...); `to_flax_params` builds the tree.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hite_tpu_torch.device import resolve_device

BF16 = torch.bfloat16


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding (low, high) of one spatial axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


# flax's lecun_normal: a normal truncated at +-2 sigma, sigma
# sqrt(1 / fan_in) over the truncated normal's own standard deviation
TRUNC_STD = 0.87962566103423978


def _param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


@torch.no_grad()
def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    std = (1.0 / fan_in) ** 0.5 / TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv(nn.Module):
    """flax `nn.Conv(cout, kernel, strides=stride, dtype=bfloat16)`, SAME
    padding, on bf16 [B, C, *spatial] tensors (1-D or 2-D)."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, ...],
                 stride: int = 1):
        super().__init__()
        self.kernel = tuple(kernel)
        self.stride = stride
        self.weight = _param(cout, cin, *self.kernel)
        self.bias = _param(cout)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        _lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads: list = []
        for n, k in reversed(list(zip(x.shape[2:], self.kernel))):
            pads += same_pads(n, k, self.stride)
        xp = F.pad(x.float(), pads)
        conv = F.conv2d if len(self.kernel) == 2 else F.conv1d
        y = conv(xp, self.weight.to(BF16).float(), stride=self.stride)
        shape = (1, -1) + (1,) * len(self.kernel)
        return y.to(BF16) + self.bias.to(BF16).view(shape)

    def load_flax(self, leaves: Dict[str, np.ndarray]) -> None:
        k = _f32(leaves["kernel"])                  # [*spatial, I, O]
        nd = k.dim()
        self.weight.copy_(k.permute(nd - 1, nd - 2, *range(nd - 2)))
        self.bias.copy_(_f32(leaves["bias"]))

    def to_flax(self) -> Dict[str, np.ndarray]:
        w = self.weight
        return {"kernel": _np(w.permute(*range(2, w.dim()), 1, 0)),
                "bias": _np(self.bias)}


class Dense(nn.Module):
    """flax `nn.Dense(dout, dtype=dtype)` on [B, din] tensors."""

    def __init__(self, din: int, dout: int, dtype: torch.dtype = BF16):
        super().__init__()
        self.dtype = dtype
        self.weight = _param(dout, din)
        self.bias = _param(dout)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        _lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            # a sum of products: no TF32 whatever the caller's flags
            return ((x.float()[:, :, None] * self.weight.t()[None]).sum(1)
                    + self.bias)
        y = x.to(BF16).float() @ self.weight.to(BF16).float().t()
        return y.to(BF16) + self.bias.to(BF16)

    def load_flax(self, leaves: Dict[str, np.ndarray]) -> None:
        self.weight.copy_(_f32(leaves["kernel"]).t())
        self.bias.copy_(_f32(leaves["bias"]))

    def to_flax(self) -> Dict[str, np.ndarray]:
        return {"kernel": _np(self.weight.t()), "bias": _np(self.bias)}


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm(num_groups, dtype=bfloat16)` (epsilon 1e-6) on
    bf16 [B, C, H, W] tensors; contiguous channels form a group."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = _param(channels)
        self.bias = _param(channels)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        x32 = x.float()
        g = x32.reshape(B, self.groups, -1)
        mean = g.mean(-1)
        var = ((g * g).mean(-1) - mean * mean).clamp(min=0.0)
        per = C // self.groups
        shape = (B, C) + (1,) * (x.dim() - 2)
        mean_c = mean.repeat_interleave(per, dim=1).view(shape)
        var_c = var.repeat_interleave(per, dim=1).view(shape)
        cshape = (1, C) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var_c + self.eps) * self.weight.view(cshape)
        return ((x32 - mean_c) * mul + self.bias.view(cshape)).to(BF16)

    def load_flax(self, leaves: Dict[str, np.ndarray]) -> None:
        self.weight.copy_(_f32(leaves["scale"]))
        self.bias.copy_(_f32(leaves["bias"]))

    def to_flax(self) -> Dict[str, np.ndarray]:
        return {"scale": _np(self.weight), "bias": _np(self.bias)}


Tree = Dict[str, Union["Tree", np.ndarray]]


@torch.no_grad()
def load_flax_params(module: nn.Module, tree: Tree) -> nn.Module:
    """Fill `module` from a flax parameter tree of numpy arrays (with or
    without the top-level "params" key); every leaf and every parameter
    must be matched, and shapes must agree.  Returns the module."""
    if set(tree) == {"params"}:
        tree = tree["params"]

    def walk(mod: nn.Module, sub: Tree, path: str) -> None:
        if hasattr(mod, "load_flax"):
            mod.load_flax(sub)
            return
        children = dict(mod.named_children())
        if set(children) != set(sub):
            raise KeyError(f"{path or 'root'}: module has {sorted(children)},"
                           f" parameter tree has {sorted(sub)}")
        for name, child in children.items():
            walk(child, sub[name], f"{path}/{name}")

    walk(module, tree, "")
    return module


def to_flax_params(module: nn.Module) -> Tree:
    """The flax parameter tree of `module`, the inverse of
    `load_flax_params`: {"params": nested dicts of float32 numpy arrays},
    as the JAX package's `save_params` writes it."""

    def walk(mod: nn.Module) -> Tree:
        if hasattr(mod, "to_flax"):
            return mod.to_flax()
        return {name: walk(child) for name, child in mod.named_children()}

    return {"params": walk(module)}


def reset_parameters(module: nn.Module,
                     generator: Optional[torch.Generator] = None
                     ) -> nn.Module:
    """Every layer of `module` back to flax's default init, drawn from
    `generator` (a CPU generator; None = torch's global one), in module
    order.  Returns the module."""
    for mod in module.modules():
        if hasattr(mod, "to_flax"):
            mod.reset_parameters(generator)
    return module


def load_params(path: str) -> Tree:
    """The flax parameter tree of a bundled checkpoint: a pickle of nested
    dicts of numpy arrays, written by the JAX package's `save_params`."""
    with open(path, "rb") as fh:
        return pickle.load(fh)


_MODEL_CACHE: Dict[Tuple, nn.Module] = {}


def load_model(cls, path: str, device=None) -> nn.Module:
    """`cls()` filled from the checkpoint at `path`, frozen (no parameter
    requires a gradient) and in eval mode on `device` (None = the card);
    process-cached per (class, file, device)."""
    dev = resolve_device(device)
    key = (cls, os.path.abspath(path), os.path.getmtime(path), str(dev))
    model = _MODEL_CACHE.get(key)
    if model is None:
        model = load_flax_params(cls(), load_params(path))
        model = _MODEL_CACHE[key] = model.requires_grad_(False).to(dev).eval()
    return model
