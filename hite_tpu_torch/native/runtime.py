"""ctypes bindings of the native host libraries.

`native/chain.cc` (FMEA chaining) and `native/fasta.cc` (the mmap FASTA
reader and the interval helpers) are built with the kernels
(`hite_tpu_torch.kernels`, into `_build/`).  When the host compiler is
missing, `fmea_chain` returns None and callers take the pure-Python
oracle (`ops.chain.chain_hsps_host_py`), and `io.fasta.read_fasta` takes
its Python reader.  `CALLS` counts native calls so a run can show which
path ran:
  read_fasta(path) -> {name: uint8 codes}   (mmap + one-pass encode)
  merge_intervals(iv, gap) -> merged int64 [M, 2]
  covered_bp(targets, cover) -> bp of sorted targets under merged cover
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional

import numpy as np

CALLS: Dict[str, int] = {"fmea_chain": 0, "read_fasta": 0}
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}
_I64P = ctypes.POINTER(ctypes.c_int64)


class _FastaResult(ctypes.Structure):
    _fields_ = [
        ("codes", ctypes.POINTER(ctypes.c_uint8)),
        ("seq_offsets", _I64P),
        ("names", ctypes.POINTER(ctypes.c_char)),
        ("name_offsets", _I64P),
        ("n_seqs", ctypes.c_int64),
        ("total_len", ctypes.c_int64),
        ("names_len", ctypes.c_int64),
    ]


def _bind(name: str, lib: ctypes.CDLL) -> None:
    if name == "chain":
        lib.fmea_chain2.argtypes = [_I64P] * 4 + [ctypes.c_int64] * 4 + [
            _I64P]
        lib.fmea_chain2.restype = ctypes.c_int64
        return
    lib.fasta_read.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.POINTER(_FastaResult))]
    lib.fasta_read.restype = ctypes.c_int
    lib.fasta_free.argtypes = [ctypes.POINTER(_FastaResult)]
    lib.intervals_merge.argtypes = [_I64P, _I64P, ctypes.c_int64,
                                    ctypes.c_int64]
    lib.intervals_merge.restype = ctypes.c_int64
    lib.intervals_covered_bp.argtypes = [_I64P, _I64P, ctypes.c_int64,
                                         _I64P, _I64P, ctypes.c_int64]
    lib.intervals_covered_bp.restype = ctypes.c_int64


def _load(name: str = "chain") -> Optional[ctypes.CDLL]:
    """The host library `name` ("chain" or "fasta"), built at first use;
    None when it cannot be built (tried once a process)."""
    if name not in _LIBS:
        from hite_tpu_torch import kernels

        try:
            lib = kernels.load(name)
            _bind(name, lib)
        except (OSError, RuntimeError):
            lib = None
        _LIBS[name] = lib
    return _LIBS[name]


def available(name: str = "chain") -> bool:
    return _load(name) is not None


def fmea_chain(qs: np.ndarray, qe: np.ndarray, ss: np.ndarray,
               se: np.ndarray, extend_threshold: int,
               min_len: int = 80, diag_tol: int = 0) -> Optional[np.ndarray]:
    """Native FMEA greedy chaining; None when the library is unavailable.

    diag_tol > 0 enables copy-retrieval semantics (fmea_chain2): HSPs
    only merge into diagonal-consistent chains."""
    lib = _load("chain")
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


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _fasta_lib() -> ctypes.CDLL:
    lib = _load("fasta")
    if lib is None:
        raise RuntimeError("the native FASTA library did not build")
    return lib


def read_fasta(path: str) -> Dict[str, np.ndarray]:
    """{name: uint8 codes} of a FASTA file by the native reader (name =
    the header's first token; A0 C1 G2 T3, anything else 4)."""
    lib = _fasta_lib()
    out = ctypes.POINTER(_FastaResult)()
    rc = lib.fasta_read(os.fsencode(path), ctypes.byref(out))
    if rc != 0:
        raise OSError(f"fasta_read({path}) failed with {rc}")
    try:
        r = out.contents
        n = int(r.n_seqs)
        codes = np.ctypeslib.as_array(r.codes,
                                      shape=(max(int(r.total_len), 1),))
        seq_off = np.ctypeslib.as_array(r.seq_offsets, shape=(n + 1,))
        names_raw = ctypes.string_at(r.names, int(r.names_len))
        name_off = np.ctypeslib.as_array(r.name_offsets, shape=(n + 1,))
        result: Dict[str, np.ndarray] = {}
        for i in range(n):
            name = names_raw[int(name_off[i]): int(name_off[i + 1]) - 1]
            result[name.decode()] = codes[int(seq_off[i]):
                                          int(seq_off[i + 1])].copy()
    finally:
        lib.fasta_free(out)
    CALLS["read_fasta"] += 1
    return result


def merge_intervals(iv: np.ndarray, gap: int = 0) -> np.ndarray:
    """Half-open intervals [N, 2] merged where they overlap or lie within
    `gap` bp: int64 [M, 2] sorted by start."""
    lib = _fasta_lib()
    iv = np.ascontiguousarray(iv, dtype=np.int64).reshape(-1, 2)
    if len(iv) == 0:
        return iv
    starts = np.ascontiguousarray(iv[:, 0])
    ends = np.ascontiguousarray(iv[:, 1])
    m = lib.intervals_merge(_ptr(starts), _ptr(ends), len(iv), int(gap))
    return np.stack([starts[:m], ends[:m]], axis=1)


def covered_bp(targets: np.ndarray, cover: np.ndarray) -> int:
    """bp of the half-open `targets` [N, 2] that lie under `cover` [M, 2]
    (both sorted by start, `cover` merged)."""
    lib = _fasta_lib()
    t = np.ascontiguousarray(targets, dtype=np.int64).reshape(-1, 2)
    c = np.ascontiguousarray(cover, dtype=np.int64).reshape(-1, 2)
    ts, te = (np.ascontiguousarray(t[:, i]) for i in (0, 1))
    cs, ce = (np.ascontiguousarray(c[:, i]) for i in (0, 1))
    return int(lib.intervals_covered_bp(_ptr(ts), _ptr(te), len(t),
                                        _ptr(cs), _ptr(ce), len(c)))
