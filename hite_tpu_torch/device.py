"""Device selection for the port's public entry points.

`device=None` means the card.  Without a GPU an entry point raises instead
of carrying on quietly on the CPU; tests and CPU users ask for
`device="cpu"` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` -> cuda (raises when no GPU is present); else `device`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hite_tpu_torch runs on the GPU by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev
