"""2-bit genome packing: the host codec and the device unpack.

Counterpart of the JAX package's `ops/pack2.py`.  A genome past
`genome.HOST_PACK_THRESHOLD` keeps its host arrays as ACGT in 2 bits plus
an N bitmask (3 bits/bp, 0.375 bytes/bp against 1), the reference's
>= 2 GB tier (`main.py:328-329`); the device unpacks the packed bytes
with elementwise torch ops, so an upload ships 3/8 of the bytes.

Codes: A0 C1 G2 T3, N/masked 4 (io.fasta.CODE_N).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def pack_codes(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """uint8 codes [L] -> (packed uint8 [ceil(L/4)], nmask uint8
    [ceil(L/8)], L).  N (code >= 4) packs as base 0 + an N-mask bit."""
    codes = np.asarray(codes, np.uint8)
    L = len(codes)
    n = codes >= 4
    base = np.where(n, 0, codes).astype(np.uint8)
    Lp4 = -(-L // 4) * 4
    b = np.zeros(Lp4, np.uint8)
    b[:L] = base
    b = b.reshape(-1, 4)
    packed = (b[:, 0] | (b[:, 1] << 2) | (b[:, 2] << 4)
              | (b[:, 3] << 6)).astype(np.uint8)
    nmask = np.packbits(n, bitorder="little")
    return packed, nmask, L


def unpack_codes(packed: np.ndarray, nmask: np.ndarray,
                 L: int) -> np.ndarray:
    """Host-side inverse of pack_codes (the oracle for the device path)."""
    b = np.asarray(packed, np.uint8)
    out = np.stack([b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3],
                   axis=1).reshape(-1)[:L].astype(np.uint8)
    n = np.unpackbits(np.asarray(nmask, np.uint8), bitorder="little")[:L]
    out[n == 1] = 4
    return out


class PackedFlat:
    """Host-resident 2-bit + N-bitmask genome array (3 bits/bp).

    Stands in for the uint8 ``Genome.flat`` / ``masked`` arrays: ``len``,
    step-1 slice and int reads (unpacked on demand), and the two masking
    writes the pipeline makes (``a[s:e] = N`` and ``a[positions] = N``).
    Writes only ever SET N bits; any other write raises.
    """

    __slots__ = ("packed", "nmask", "L")

    def __init__(self, packed: np.ndarray, nmask: np.ndarray, L: int):
        self.packed = packed
        self.nmask = nmask
        self.L = L

    @classmethod
    def from_uint8(cls, codes: np.ndarray) -> "PackedFlat":
        packed, nmask, L = pack_codes(codes)
        return cls(packed, nmask, L)

    def __len__(self) -> int:
        return self.L

    @property
    def nbytes(self) -> int:
        return self.packed.nbytes + self.nmask.nbytes

    def copy(self) -> "PackedFlat":
        return PackedFlat(self.packed.copy(), self.nmask.copy(), self.L)

    def unpack_all(self) -> np.ndarray:
        return unpack_codes(self.packed, self.nmask, self.L)

    def _range(self, s: int, e: int) -> np.ndarray:
        s = max(0, min(s, self.L))
        e = max(s, min(e, self.L))
        if e == s:
            return np.zeros(0, np.uint8)
        b0, b1 = s // 4, -(-e // 4)
        b = self.packed[b0:b1]
        out = np.stack([b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3],
                       axis=1).reshape(-1)[s - 4 * b0 : e - 4 * b0]
        out = out.astype(np.uint8)
        m0, m1 = s // 8, -(-e // 8)
        n = np.unpackbits(self.nmask[m0:m1],
                          bitorder="little")[s - 8 * m0 : e - 8 * m0]
        out[n == 1] = 4
        return out

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            s, e, step = idx.indices(self.L)
            if step != 1:
                raise IndexError("PackedFlat supports step-1 slices only")
            return self._range(s, e)
        if isinstance(idx, (int, np.integer)):
            i = int(idx) + (self.L if idx < 0 else 0)
            return self._range(i, i + 1)[0]
        raise IndexError(f"unsupported PackedFlat index {type(idx)}")

    def __setitem__(self, idx, value) -> None:
        if not (np.isscalar(value) and int(value) >= 4):
            raise ValueError("PackedFlat writes are masking-only "
                             "(scalar code >= 4)")
        if isinstance(idx, slice):
            s, e, step = idx.indices(self.L)
            if step != 1:
                raise IndexError("PackedFlat supports step-1 slices only")
            if e <= s:
                return
            # whole bytes -> 0xFF, the partial edge bytes by OR masks
            fb0, fb1 = -(-s // 8), e // 8
            if fb1 > fb0:
                self.nmask[fb0:fb1] = 0xFF
            lmask = 0
            for p in range(s, min(e, fb0 * 8)):
                lmask |= 1 << (p & 7)
            if lmask:
                self.nmask[s >> 3] |= np.uint8(lmask)
            rmask = 0
            for p in range(max(s, fb1 * 8), e):
                rmask |= 1 << (p & 7)
            if rmask:
                self.nmask[e - 1 >> 3] |= np.uint8(rmask)
            return
        pos = np.asarray(idx)
        if pos.dtype == bool:
            # a boolean mask cast to int64 would silently become
            # positions 0/1: take the selected positions
            if pos.shape != (self.L,):
                raise IndexError("PackedFlat boolean mask must cover "
                                 "the full array")
            pos = np.nonzero(pos)[0]
        pos = pos.astype(np.int64).reshape(-1)
        if pos.size and (pos.min() < 0 or pos.max() >= self.L):
            raise IndexError("PackedFlat mask position out of range")
        np.bitwise_or.at(self.nmask, pos >> 3,
                         np.left_shift(np.uint8(1),
                                       (pos & 7).astype(np.uint8)))


def unpack_device(packed: torch.Tensor, nmask: torch.Tensor) -> torch.Tensor:
    """packed uint8 [P] + nmask uint8 [P // 2] on one device -> uint8
    codes [4P] there (elementwise; the caller slices to the true
    length)."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    base = ((packed[:, None] >> shifts) & 3).reshape(-1)
    bits = torch.arange(8, dtype=torch.uint8, device=nmask.device)
    n = ((nmask[:, None] >> bits) & 1).reshape(-1)[: base.shape[0]]
    return torch.where(n == 1, torch.full_like(base, 4), base)


def unpack_device_chunked(packed: np.ndarray, nmask: np.ndarray,
                          device, chunk_out: int = 1 << 27) -> torch.Tensor:
    """Upload host `packed` / `nmask` to `device` and unpack them there in
    `chunk_out`-byte output chunks (the JAX package's chunk, which bounds
    each step's temporaries) into one uint8 [4 * len(packed)] tensor."""
    P4 = len(packed) * 4
    out = torch.empty(P4, dtype=torch.uint8, device=device)
    for o in range(0, P4, chunk_out):
        p = torch.from_numpy(packed[o // 4 : (o + chunk_out) // 4])
        m = torch.from_numpy(nmask[o // 8 : (o + chunk_out) // 8])
        part = unpack_device(p.to(device), m.to(device))
        out[o : o + part.shape[0]] = part
    return out
