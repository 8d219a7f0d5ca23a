"""Device mesh and sharding helpers (counterpart of the JAX package's
`parallel/mesh.py`).

The JAX package runs one process over a `jax.sharding.Mesh`: batch axes
are sharded by `NamedSharding(mesh, P(("dp", "tp")))` and XLA's GSPMD
partitions the jitted programs.  The port keeps that single-controller
shape with a plain object and no `torch.distributed`: a `Mesh` is a
(dp, tp) grid of `torch.device`s, and a sharded call cuts its batch axis
into contiguous shards in the grid's row-major order (`P(("dp", "tp"))`'s
layout), runs the per-shard function on each shard's device, launching
every shard before reading any back, and concatenates the results on the
caller's device.  Only row-independent work is sharded this way, so a
sharded call equals the unsharded one bit for bit.

A mesh names its devices.  `make_mesh()` takes every visible card and
raises without one; several shards on one device (the counterpart of
JAX's virtual CPU devices) are asked for by passing the list, e.g.
`make_mesh(devices=[torch.device("cpu")] * 8)`.
"""

from __future__ import annotations

import contextlib
import os
from typing import (
    Any, Callable, Dict, List, Optional, Sequence, Tuple, Union,
)

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

Axes = Tuple[str, ...]
ALL: Axes = ("dp", "tp")


class Mesh:
    """A (dp, tp) grid of devices: `devices` is a numpy object array of
    `torch.device`; `shape` is a dict as in JAX (`mesh.shape["dp"]`)."""

    axis_names: Axes = ALL

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"mesh devices must be 2-D (dp, tp), got "
                             f"{devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def distinct(self) -> bool:
        """Whether every shard has a device of its own."""
        return len(set(self.devices.reshape(-1))) == self.size

    def shard_devices(self, axes: Axes = ALL) -> List[torch.device]:
        """The device of each shard of a batch sharded over `axes`:
        ("dp", "tp") = every device in row-major order; ("dp",) = the
        first device of each dp row (a dp-sharded batch is replicated
        over tp, and one replica computes it)."""
        if tuple(axes) == ALL:
            return list(self.devices.reshape(-1))
        if tuple(axes) == ("dp",):
            return list(self.devices[:, 0])
        raise ValueError(f"unsupported shard axes {axes!r}")


def factor_devices(n: int) -> Tuple[int, int]:
    """Split n devices into (dp, tp): largest dp with tp in {1, 2, 4}."""
    for tp in (4, 2, 1):
        if n % tp == 0 and n // tp >= 1:
            return n // tp, tp
    return n, 1


def _checked(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {dev} requested but CUDA is "
                           "unavailable")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"mesh device {dev}: only "
                           f"{torch.cuda.device_count()} cards are visible")
    return dev


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    tp: Optional[int] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Mesh:
    """A (dp, tp) mesh over `devices` (None = every visible card; raises
    without a GPU), cut to the first `n_devices`.  Asking for more devices
    than there are raises; nothing falls back to the CPU or to a smaller
    mesh.  (dp, tp) default to `factor_devices`."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no GPU is available; pass devices=[...] "
                "explicitly (e.g. [torch.device('cpu')] * 8)")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [_checked(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise RuntimeError(f"make_mesh: {n_devices} devices asked for, "
                               f"{len(devs)} available")
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0:
        raise ValueError("make_mesh: no devices")
    if dp is None or tp is None:
        dp, tp = factor_devices(n)
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} devices")
    arr = np.empty((dp, tp), dtype=object)
    for i, d in enumerate(devs):
        arr[i // tp, i % tp] = d
    return Mesh(arr)


# ---------------------------------------------------------------- sharding

def device_guard(dev: torch.device):
    """`torch.cuda.device(dev)` for a card (so tensors made without an
    explicit device and hand-written launches land there), else a no-op."""
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def _to(a, dev: torch.device):
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if isinstance(a, torch.Tensor):
        return a.to(dev, non_blocking=True)
    if isinstance(a, tuple):
        parts = [_to(x, dev) for x in a]
        return type(a)(*parts) if hasattr(a, "_fields") else tuple(parts)
    raise TypeError(f"cannot place {type(a)} on {dev}")


def replicate(x, devices: Sequence[torch.device]) -> Dict[torch.device, Any]:
    """{device: x on that device} for each distinct device (a tensor, an
    array or a (named) tuple of them); a device x already lies on gets x
    itself."""
    out: Dict[torch.device, Any] = {}
    for d in devices:
        if d not in out:
            out[d] = _to(x, d)
    return out


def _pad_rows(a, n: int):
    """`a` with its last row repeated up to n rows."""
    extra = n - a.shape[0]
    if extra == 0:
        return a
    if isinstance(a, np.ndarray):
        return np.concatenate([a, np.repeat(a[-1:], extra, axis=0)])
    return torch.cat([a, a[-1:].expand(extra, *a.shape[1:])])


def shard_rows(mesh: Mesh, *arrays, axes: Axes = ALL
               ) -> List[Tuple[torch.device, tuple]]:
    """Cut the leading axis of `arrays` (numpy arrays or tensors, one row
    count) into one contiguous shard a device of `axes`, the row count
    first padded to a multiple of the shard count by repeating the last
    row; each shard moved to its device.  Returns [(device, shard
    arrays)] in shard order."""
    n = arrays[0].shape[0]
    if n == 0:
        raise ValueError("shard_rows: empty batch")
    if any(a.shape[0] != n for a in arrays):
        raise ValueError("shard_rows: arrays differ in row count")
    devs = mesh.shard_devices(axes)
    per = -(-n // len(devs))
    padded = [_pad_rows(a, per * len(devs)) for a in arrays]
    return [(d, tuple(_to(a[k * per : (k + 1) * per], d) for a in padded))
            for k, d in enumerate(devs)]


def _gather(parts: List[Any], n: int, device: torch.device):
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])[:n]
    if isinstance(first, tuple):
        fields = [_gather([p[i] for p in parts], n, device)
                  for i in range(len(first))]
        return type(first)(*fields) if hasattr(first, "_fields") \
            else tuple(fields)
    raise TypeError(f"cannot gather {type(first)}")


def run_sharded(mesh: Mesh, fn: Callable, *arrays, axes: Axes = ALL,
                device: Optional[torch.device] = None):
    """fn over the batch axis of `arrays`, sharded over `axes`: every
    shard's fn is launched (under its device's guard) before any result
    is read back, then the results (a tensor or a (named) tuple of
    tensors with the batch axis first) are concatenated on `device` and
    cut to the unpadded row count.  fn must be row-independent and must
    not synchronise with the host, or the shards run one after another."""
    n = arrays[0].shape[0]
    outs = []
    for dev, shard in shard_rows(mesh, *arrays, axes=axes):
        with device_guard(dev):
            outs.append(fn(*shard))
    if device is None:
        device = (arrays[0].device if isinstance(arrays[0], torch.Tensor)
                  else torch.device("cpu"))
    return _gather(outs, n, device)


# ------------------------------------------------------ training placement

def _flax_leaves(mod: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """{torch parameter name: its flax leaf's shape} of one layer."""
    leaves = mod.to_flax()
    names = {"weight": ("kernel", "scale"), "bias": ("bias",)}
    out = {}
    for pname, _p in mod.named_parameters(recurse=False):
        (leaf,) = [k for k in names[pname] if k in leaves]
        out[pname] = tuple(leaves[leaf].shape)
    return out


def param_sharding(mesh: Mesh, model: nn.Module, min_shard: int = 2
                   ) -> Dict[str, Optional[int]]:
    """{parameter name: the torch dim cut over "tp", or None = replicated}.

    The JAX rule: shard a leaf's last axis over "tp" when it divides and
    is at least `min_shard * tp` (column parallelism).  The rule is taken
    on the FLAX shape (`to_flax`): there the last axis is the output axis
    of a Conv kernel [*k, in, out] or Dense kernel [in, out] and the only
    axis of a bias or GroupNorm scale; in the port's layout
    (`models/convert.py`: Conv weight [out, in, *k], Dense [out, in]) that
    is torch's dim 0."""
    tp = mesh.shape["tp"]
    out: Dict[str, Optional[int]] = {}
    for prefix, mod in model.named_modules():
        if not hasattr(mod, "to_flax"):
            continue
        for pname, fshape in _flax_leaves(mod).items():
            p = getattr(mod, pname)
            if fshape[-1] != p.shape[0]:
                raise ValueError(f"{prefix}.{pname}: flax last axis "
                                 f"{fshape[-1]} is not torch dim 0 "
                                 f"{p.shape[0]}")
            name = f"{prefix}.{pname}" if prefix else pname
            ok = (tp > 1 and fshape[-1] % tp == 0
                  and fshape[-1] >= min_shard * tp)
            out[name] = 0 if ok else None
    missing = {n for n, _ in model.named_parameters()} - set(out)
    if missing:
        raise ValueError(f"parameters of no flax layer: {sorted(missing)}")
    return out


def batch_sharding(mesh: Mesh) -> Callable[[torch.Tensor], List[torch.Tensor]]:
    """A tensor's leading (batch) axis cut over "dp": one contiguous
    shard a dp row (`torch.tensor_split`, so no padding row enters a
    loss), each on its row's first device."""
    devs = mesh.shard_devices(("dp",))

    def rule(x: torch.Tensor) -> List[torch.Tensor]:
        return [s.to(d, non_blocking=True)
                for s, d in zip(torch.tensor_split(x, len(devs)), devs)]

    return rule


def replicated(mesh: Mesh) -> Callable[[torch.Tensor], List[torch.Tensor]]:
    """A tensor copied to each dp row's first device (one replica a row;
    the tp devices of a row hold slices, not replicas)."""
    devs = mesh.shard_devices(("dp",))
    return lambda x: [x.to(d, non_blocking=True) for d in devs]


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> None:
    """Join the `torch.distributed` process group of a multi-process run
    (the JAX package calls `jax.distributed.initialize`): NCCL after
    `torch.cuda.set_device(LOCAL_RANK)` when `device` is None or cuda,
    gloo for the CPU.  `coordinator` is "host:port" (None = torchrun's
    environment: MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK).
    `parallel/multihost.py` then partitions whole genomes over the
    ranks."""
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
