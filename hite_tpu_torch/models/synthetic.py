"""Synthetic labeled TE libraries for default-checkpoint training (the
port's own copy of the JAX package's `models/synthetic.py`: numpy only,
the same draws for every seed).

The reference ships pretrained model blobs (`bin/NeuralTE/models/*.h5`,
`bin/FiLTR-main/models/production_model.pth`) whose training data (Repbase)
is not redistributable — and the blobs themselves are missing from the
reference checkout (`.MISSING_LARGE_BLOBS`).  To still ship a usable
default checkpoint, this module generates labeled TEs from first
principles, per Wicker superfamily (`configs/config.py:58-63` class list):

* **structural terminals** — the genuinely class-identifying signal the
  NeuralTE feature set reads (terminal 3/4-mer frequencies): TG..CA direct
  LTR pairs for the LTR order, superfamily-specific inverted terminal
  repeats + characteristic TSD/terminal motifs for DNA superfamilies
  (CACTA `CACT[AG]`, PiggyBac `TTAA` context, Mutator long TIRs, ...),
  polyA tails for LINE/SINE, `ATC`..`CTRR[T]` for Helitron
  (motif sources: `Util.py:7297-7334`, `:9414-9472`, `:10915-11006`).
* **real protein internals** — internal regions reverse-translated from
  the vendored superfamily-tagged transposase libraries
  (`data/protein/TIRPeps.lib`, `HelitronPeps.lib`), so internal 5-mer
  composition carries real coding signal for the 12 covered DNA classes.

Classes sharing a structural group and lacking vendored proteins (e.g.
Copia vs Gypsy) are *not* given fake compositional bias — the default
model is honest about what nucleotide structure alone can separate; users
with Repbase-class data retrain via `models.trainer` for full resolution.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from hite_tpu_torch.io.fasta import encode_seq

DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")

# one representative codon set per amino acid (standard code)
_CODONS = {
    "A": ("GCT", "GCC", "GCA", "GCG"), "R": ("CGT", "CGC", "AGA", "AGG"),
    "N": ("AAT", "AAC"), "D": ("GAT", "GAC"), "C": ("TGT", "TGC"),
    "Q": ("CAA", "CAG"), "E": ("GAA", "GAG"), "G": ("GGT", "GGC", "GGA"),
    "H": ("CAT", "CAC"), "I": ("ATT", "ATC", "ATA"),
    "L": ("TTA", "TTG", "CTT", "CTC", "CTA", "CTG"), "K": ("AAA", "AAG"),
    "M": ("ATG",), "F": ("TTT", "TTC"), "P": ("CCT", "CCC", "CCA", "CCG"),
    "S": ("TCT", "TCC", "TCA", "AGT", "AGC"), "T": ("ACT", "ACC", "ACA"),
    "W": ("TGG",), "Y": ("TAT", "TAC"), "V": ("GTT", "GTC", "GTA", "GTG"),
}

# Wicker class -> (group, RepeatMasker prefix used to pull real proteins)
CLASS_SPECS: Dict[str, Tuple[str, Optional[str]]] = {
    "Copia": ("ltr", None), "Gypsy": ("ltr", None), "Bel-Pao": ("ltr", None),
    "Retrovirus": ("ltr", None), "DIRS": ("ltr", None),
    "Ngaro": ("ltr", None), "VIPER": ("ltr", None),
    "Penelope": ("line", None), "R2": ("line", None), "RTE": ("line", None),
    "Jockey": ("line", None), "L1": ("line", None), "I": ("line", None),
    "tRNA": ("sine", None), "7SL": ("sine", None), "5S": ("sine", None),
    "Tc1-Mariner": ("tir", "DNA/TcMar"), "hAT": ("tir", "DNA/hAT"),
    "Mutator": ("tir", "DNA/MULE"), "Merlin": ("tir", "DNA/Merlin"),
    "Transib": ("tir", "DNA/CMC-Transib"), "P": ("tir", "DNA/P"),
    "PiggyBac": ("tir", "DNA/PiggyBac"),
    "PIF-Harbinger": ("tir", "DNA/PIF"),
    "CACTA": ("tir", "DNA/CMC-EnSpm"), "Crypton": ("none", "DNA/Crypton"),
    "Helitron": ("helitron", "RC/Helitron"),
    "Maverick": ("tir", "DNA/Maverick"),
}

# TIR geometry per superfamily: (tir_min, tir_max, 5' motif or None)
TIR_GEOM = {
    "Tc1-Mariner": (20, 32, None), "hAT": (5, 27, None),
    "Mutator": (80, 200, None), "Merlin": (8, 20, None),
    "Transib": (10, 40, None), "P": (25, 31, None),
    "PiggyBac": (13, 17, "TTAA"), "PIF-Harbinger": (12, 25, None),
    "CACTA": (10, 28, "CACTA"), "Maverick": (100, 400, None),
}


def load_protein_pools() -> Dict[str, List[str]]:
    """RM label prefix -> list of protein strings from the vendored libs."""
    pools: Dict[str, List[str]] = {}
    for fn in ("TIRPeps.lib", "HelitronPeps.lib"):
        path = os.path.join(DATA_DIR, "protein", fn)
        if not os.path.exists(path):
            continue
        name, buf = None, []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line.startswith(">"):
                    if name and buf:
                        pools.setdefault(name, []).append("".join(buf))
                    name = line.rpartition("#")[2]
                    buf = []
                elif line:
                    buf.append(line)
        if name and buf:
            pools.setdefault(name, []).append("".join(buf))
    return pools


def _pool_for(pools: Dict[str, List[str]], prefix: str) -> List[str]:
    out: List[str] = []
    for label, seqs in pools.items():
        if label == prefix or label.startswith(prefix + "-"):
            out.extend(seqs)
    return out


def reverse_translate(protein: str, rng: np.random.Generator) -> str:
    parts = []
    for aa in protein:
        codons = _CODONS.get(aa)
        if codons is None:
            continue
        parts.append(codons[rng.integers(len(codons))])
    return "".join(parts)


def _rand_seq(rng: np.random.Generator, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _mutate(seq: str, rng: np.random.Generator, rate: float = 0.05) -> str:
    arr = list(seq)
    for i in np.nonzero(rng.random(len(arr)) < rate)[0]:
        arr[i] = "ACGT"[rng.integers(4)]
    return "".join(arr)


def _internal(cls: str, rng: np.random.Generator, n: int,
              pools: Dict[str, List[str]]) -> str:
    prefix = CLASS_SPECS[cls][1]
    pool = _pool_for(pools, prefix) if prefix else []
    if pool:
        parts = []
        while sum(len(p) for p in parts) < n:
            prot = pool[rng.integers(len(pool))]
            parts.append(_mutate(reverse_translate(prot, rng), rng))
        return "".join(parts)[:n]
    return _rand_seq(rng, n)


def _revcomp_str(seq: str) -> str:
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(comp.get(b, "N") for b in reversed(seq))


# class-characteristic TSD generator: (fixed motif | (min_len, max_len) |
# None).  The TSD block is genuinely class-identifying signal the
# reference's use_TSD-1 NeuralTE model exploits
# (`get_nonRedundant_lib.py:66-79`); sources: Wicker 2007 superfamily
# table + the reference's TSD gates (`Util.py:7297-7334`, `:7801-7804`).
TSD_GEOM: Dict[str, object] = {
    "Tc1-Mariner": "TA", "hAT": (8, 8), "Mutator": (9, 11),
    "Merlin": (8, 9), "Transib": (5, 5), "P": (7, 8),
    "PiggyBac": "TTAA", "PIF-Harbinger": (3, 3), "CACTA": (2, 3),
    "Maverick": (5, 6), "Crypton": None,
    "Copia": (4, 6), "Gypsy": (4, 6), "Bel-Pao": (4, 6),
    "Retrovirus": (4, 6), "DIRS": None, "Ngaro": None, "VIPER": None,
    "Penelope": (10, 14), "R2": None, "RTE": (8, 14), "Jockey": (8, 14),
    "L1": (8, 20), "I": (8, 14), "tRNA": (8, 16), "7SL": (8, 16),
    "5S": (8, 16), "Helitron": None,
}


def synthesize_tsd(cls: str, rng: np.random.Generator) -> str:
    geom = TSD_GEOM.get(cls)
    if geom is None:
        return ""
    if isinstance(geom, str):
        return geom
    lo, hi = geom
    return _rand_seq(rng, int(rng.integers(lo, hi + 1)))


def synthesize_te(cls: str, rng: np.random.Generator,
                  pools: Dict[str, List[str]]) -> str:
    """One synthetic element of the given Wicker superfamily."""
    group = CLASS_SPECS[cls][0]
    if group == "ltr":
        ltr = "TG" + _rand_seq(rng, int(rng.integers(120, 400))) + "CA"
        body = _internal(cls, rng, int(rng.integers(800, 4000)), pools)
        return ltr + body + _mutate(ltr, rng, 0.03)
    if group == "tir":
        lo, hi, motif = TIR_GEOM[cls]
        tir = _rand_seq(rng, int(rng.integers(lo, hi + 1)))
        if motif:
            tir = motif + tir[len(motif):]
        n = int(rng.integers(600, 8000 if cls == "Maverick" else 4000))
        body = _internal(cls, rng, n, pools)
        return tir + body + _mutate(_revcomp_str(tir), rng, 0.03)
    if group == "line":
        body = _internal(cls, rng, int(rng.integers(1500, 6000)), pools)
        return body + "A" * int(rng.integers(8, 20))
    if group == "sine":
        body = _internal(cls, rng, int(rng.integers(90, 450)), pools)
        return body + "A" * int(rng.integers(6, 16))
    if group == "helitron":
        body = _internal(cls, rng, int(rng.integers(500, 4000)), pools)
        hp = _rand_seq(rng, 8)
        tail = hp + _rand_seq(rng, 4) + _revcomp_str(hp) + \
            ("CTAGT", "CTAAT", "CTGGT", "CTGAT")[rng.integers(4)]
        return "ATC" + body + tail
    return _internal(cls, rng, int(rng.integers(300, 3000)), pools)


def synthetic_library(n_per_class: int = 50, seed: int = 0,
                      classes: Optional[List[str]] = None,
                      ) -> Dict[str, np.ndarray]:
    """Labeled library {name#Wicker: codes} for `trainer.make_dataset`."""
    lib, _tsds, _domains = synthetic_training_set(
        n_per_class=n_per_class, seed=seed, classes=classes)
    return lib


def synthetic_training_set(
    n_per_class: int = 50, seed: int = 0,
    classes: Optional[List[str]] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, str], Dict[str, str]]:
    """(library, {name: tsd string}, {name: Wicker domain label or ''}).

    The TSD block is generated per superfamily (TSD_GEOM); the domain
    label is the synthesis-time ground truth — the internals of the
    protein-backed classes ARE reverse-translated transposases from that
    superfamily's pool, so a protein scan would recover exactly this
    label (shortcut documented in models/pretrain.py).
    """
    rng = np.random.default_rng(seed)
    pools = load_protein_pools()
    lib: Dict[str, np.ndarray] = {}
    tsds: Dict[str, str] = {}
    domains: Dict[str, str] = {}
    for cls in classes or list(CLASS_SPECS):
        prefix = CLASS_SPECS[cls][1]
        has_pool = bool(prefix and _pool_for(pools, prefix))
        for i in range(n_per_class):
            seq = synthesize_te(cls, rng, pools)
            name = f"syn_{cls}_{i}#{cls}"
            lib[name] = encode_seq(seq)
            tsds[name] = synthesize_tsd(cls, rng)
            domains[name] = cls if has_pool else ""
    return lib, tsds, domains


# ---------------------------------------------------------------------------
# LTR-filter CNN frames: synthetic both-ends MSA matrices
# ---------------------------------------------------------------------------

def synthetic_frames(n: int = 300, seed: int = 0, width: int = 200,
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(frames [N, R, 2*width], labels [N]) for the HybridLTR-style CNN.

    Positive (label 1): copies of one element inserted at unrelated loci —
    interior columns agree across rows, flank columns are independent.
    Negative (label 0): segmental-duplication signature — homology runs
    through the flanks too — or no interior homology at all (the two
    failure modes `judge_both_ends_frame` rejects, FiLTR src/Util.py:10696).
    """
    rng = np.random.default_rng(seed)
    flank = width // 2
    max_rows = 100
    frames, labels = [], []
    for i in range(n):
        # row counts reach down to 2: REAL families are often 2-10 copies
        # (the round-5 hard-bench LTR families had 6-row frames, below the
        # old [8, 60) training floor, and the out-of-distribution CNN
        # vetoed two genuine LTR families wholesale); bias low so the
        # few-copy regime is well represented
        rows = int(rng.integers(2, 12) if rng.random() < 0.5
                   else rng.integers(12, 60))
        label = int(rng.random() < 0.5)
        core_l = rng.integers(0, 4, width - flank)
        core_r = rng.integers(0, 4, width - flank)
        mat = np.full((max_rows, 2 * width), 4, np.uint8)
        flank_master_l = rng.integers(0, 4, flank)
        flank_master_r = rng.integers(0, 4, flank)
        no_core = label == 0 and rng.random() < 0.4
        for r in range(rows):
            def noisy(base, rate=0.08):
                out = base.copy()
                flip = rng.random(len(out)) < rate
                out[flip] = rng.integers(0, 4, int(flip.sum()))
                return out
            if label == 1:
                fl = rng.integers(0, 4, flank)
                fr = rng.integers(0, 4, flank)
                cl, cr = noisy(core_l), noisy(core_r)
            elif no_core:
                fl, fr = rng.integers(0, 4, flank), rng.integers(0, 4, flank)
                cl = rng.integers(0, 4, width - flank)
                cr = rng.integers(0, 4, width - flank)
            else:
                fl, fr = noisy(flank_master_l), noisy(flank_master_r)
                cl, cr = noisy(core_l), noisy(core_r)
            mat[r, :flank] = fl
            mat[r, flank:width] = cl
            mat[r, width:2 * width - flank] = cr
            mat[r, 2 * width - flank:] = fr
            # ragged row extents: real copy frames N-pad where a copy's
            # matched span ends short of the frame window
            if rng.random() < 0.3:
                cut = int(rng.integers(0, flank))
                mat[r, :cut] = 4
            if rng.random() < 0.3:
                cut = int(rng.integers(0, flank))
                mat[r, 2 * width - cut:] = 4
        frames.append(mat)
        labels.append(label)
    return np.stack(frames), np.array(labels, np.int32)
