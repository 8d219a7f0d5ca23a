"""ctypes binding of the native host FMEA chaining (`native/chain.cc`).

Built with the kernels (`hite_tpu_torch.kernels`, into `_build/`).  When
the host compiler is missing, `fmea_chain` returns None and callers take
the pure-Python oracle (`ops.chain.chain_hsps_host_py`).  `CALLS` counts
native calls so a run can show the native path was used.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np

CALLS: Dict[str, int] = {"fmea_chain": 0}
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    from hite_tpu_torch import kernels

    try:
        lib = kernels.load("chain")
    except (OSError, RuntimeError):
        return None
    lib.fmea_chain2.argtypes = [ctypes.POINTER(ctypes.c_int64)] * 4 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.fmea_chain2.restype = ctypes.c_int64
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def fmea_chain(qs: np.ndarray, qe: np.ndarray, ss: np.ndarray,
               se: np.ndarray, extend_threshold: int,
               min_len: int = 80, diag_tol: int = 0) -> Optional[np.ndarray]:
    """Native FMEA greedy chaining; None when the library is unavailable.

    diag_tol > 0 enables copy-retrieval semantics (fmea_chain2): HSPs
    only merge into diagonal-consistent chains."""
    lib = _load()
    if lib is None:
        return None
    n = len(qs)
    if n == 0:
        return np.zeros((0, 4), dtype=np.int64)
    arrs = [np.ascontiguousarray(a, dtype=np.int64) for a in (qs, qe, ss, se)]
    out = np.empty((n, 4), dtype=np.int64)
    m = lib.fmea_chain2(
        *(a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)) for a in arrs),
        n, int(extend_threshold), int(diag_tol), int(min_len),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    CALLS["fmea_chain"] += 1
    return out[:m].copy()
