"""Host-side FASTA I/O and nucleotide <-> code conversion.

Sequences are numpy ``uint8`` code arrays (A=0, C=1, G=2, T=3, N/other=4)
ready to be placed on the device.  A copy of the JAX package's
`io/fasta.py`: `read_fasta` takes the native mmap reader
(`native/fasta.cc`) when it builds, as the JAX package does, and the
pure-Python reader (`read_fasta_py`, the oracle) otherwise.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

# Code table: A=0 C=1 G=2 T=3, anything else (N, IUPAC ambiguity) = 4.
CODE_A, CODE_C, CODE_G, CODE_T, CODE_N = 0, 1, 2, 3, 4

_ENCODE_LUT = np.full(256, CODE_N, dtype=np.uint8)
for ch, code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _ENCODE_LUT[ord(ch)] = code
    _ENCODE_LUT[ord(ch.lower())] = code

_DECODE_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)

_COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def encode_seq(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 codes (A0 C1 G2 T3 N4), case-insensitive."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _ENCODE_LUT[raw]


def decode_seq(codes: np.ndarray) -> str:
    """uint8 codes -> ASCII string (masked/ambiguous -> 'N')."""
    codes = np.asarray(codes, dtype=np.uint8)
    return _DECODE_LUT[np.minimum(codes, CODE_N)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (N maps to N)."""
    return _COMPLEMENT[np.asarray(codes, dtype=np.uint8)][::-1]


def read_fasta(path: str) -> Dict[str, np.ndarray]:
    """Read a FASTA file into an ordered {name: uint8 code array} dict
    (name = first whitespace-separated token of the header)."""
    from hite_tpu_torch.native import runtime

    if runtime.available("fasta"):
        return runtime.read_fasta(path)
    return read_fasta_py(path)


def read_fasta_py(path: str) -> Dict[str, np.ndarray]:
    """The pure-Python reader (line by line, trailing whitespace
    stripped, blank lines skipped)."""
    seqs: Dict[str, np.ndarray] = {}
    name = None
    parts: List[bytes] = []
    with open(path, "rb") as fh:
        for line in fh:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    seqs[name] = encode_seq(b"".join(parts))
                name = line[1:].split()[0].decode("ascii")
                parts = []
            else:
                parts.append(line)
        if name is not None:
            seqs[name] = encode_seq(b"".join(parts))
    return seqs


def write_fasta(path: str, seqs: Dict[str, np.ndarray | str],
                width: int = 70) -> None:
    """Write {name: codes-or-string} to FASTA with fixed line width."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        for name, seq in seqs.items():
            if not isinstance(seq, str):
                seq = decode_seq(seq)
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width])
                fh.write("\n")
