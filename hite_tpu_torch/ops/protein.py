"""Protein ops: 6-frame translation, BLOSUM62, amino-acid k-mers.

Counterpart of the JAX package's `ops/protein.py`, the substrate of the
blastx-replacement domain engine (`pipeline/domain.py`; reference
`get_domain_info` `Util.py:4571-4612`, low-copy rescue
`Util.py:8215-8281`).

Amino-acid codes 0-19 (ARNDCQEGHILKMFPSTWYV order), 20 = X/stop/unknown.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from hite_tpu_torch.ops.encode import revcomp

AA_ORDER = "ARNDCQEGHILKMFPSTWYV"
AA_X = 20
AA_TO_CODE: Dict[str, int] = {c: i for i, c in enumerate(AA_ORDER)}

# standard codon table, indexed by b0*16 + b1*4 + b2 (A0 C1 G2 T3)
_CODONS = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}

_B = {"A": 0, "C": 1, "G": 2, "T": 3}
CODON_TABLE = np.full(64, AA_X, np.int32)
for codon, aa in _CODONS.items():
    idx = _B[codon[0]] * 16 + _B[codon[1]] * 4 + _B[codon[2]]
    CODON_TABLE[idx] = AA_TO_CODE.get(aa, AA_X)

# BLOSUM62 over AA_ORDER (+X row/col of -1)
_B62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4
"""
BLOSUM62 = np.full((21, 21), -1, np.int32)
for i, line in enumerate(l for l in _B62.strip().split("\n")):
    BLOSUM62[i, :20] = [int(v) for v in line.split()]


def encode_protein(seq: str) -> np.ndarray:
    return np.array([AA_TO_CODE.get(c.upper(), AA_X) for c in seq], np.uint8)


def decode_protein(codes: np.ndarray) -> str:
    alpha = AA_ORDER + "X"
    return "".join(alpha[min(int(c), AA_X)] for c in codes)


def translate_frames(seqs: torch.Tensor) -> torch.Tensor:
    """uint8 [B, L] nucleotide codes -> uint8 [B, 6, L//3 - 1] amino acids.

    Frames 0-2: forward at offsets 0-2; frames 3-5: the reverse complement
    of the whole (padded) row at offsets 0-2, as the JAX package does: for
    a row padded past its length the reverse frames start in the padding.
    Codons containing N translate to X (code 20); stop codons are X too.
    """
    table = torch.as_tensor(CODON_TABLE, device=seqs.device)
    B, L = seqs.shape
    n_cod = max(L // 3 - 1, 0)

    def frame(s: torch.Tensor, off: int) -> torch.Tensor:
        c = s[:, off : off + 3 * n_cod].to(torch.int32).reshape(B, n_cod, 3)
        c0, c1, c2 = c.unbind(-1)
        bad = (c0 >= 4) | (c1 >= 4) | (c2 >= 4)
        idx = (c0.clamp(0, 3) * 16 + c1.clamp(0, 3) * 4 + c2.clamp(0, 3))
        return torch.where(bad, AA_X, table[idx.long()])

    rc = revcomp(seqs)
    frames = [frame(seqs, 0), frame(seqs, 1), frame(seqs, 2),
              frame(rc, 0), frame(rc, 1), frame(rc, 2)]
    return torch.stack(frames, dim=1).to(torch.uint8)


def aa_kmer_codes(codes: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Rolling amino-acid k-mer codes (base 21) along the last axis;
    int32, windows with an X are -1."""
    n = codes.shape[-1] - k + 1
    c32 = codes.to(torch.int32)
    acc = torch.zeros(codes.shape[:-1] + (n,), dtype=torch.int32,
                      device=codes.device)
    bad = torch.zeros(acc.shape, dtype=torch.bool, device=codes.device)
    for j in range(k):
        w = c32[..., j : j + n]
        acc = acc * 21 + w.clamp(0, 20)
        bad |= w >= AA_X
    return torch.where(bad, -1, acc)
