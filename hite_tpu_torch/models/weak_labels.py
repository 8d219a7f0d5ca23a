"""Weak-label mining from pipeline run outputs (the port's counterpart of
the JAX package's `models/weak_labels.py`).

Turns the confident_* FASTAs of completed pipeline runs into a
pseudo-labeled training corpus for the SuperfamilyCNN — the reference's
analog is retraining NeuralTE on Repbase-class data
(`bin/NeuralTE/src/CrossValidator.py`), which is not redistributable;
here every label is backed by STRUCTURAL or DOMAIN evidence mined from
the discovered family itself, never by a prior classifier call:

* `confident_tir.fa` entries: labeled with the Wicker class of their
  best vendored-transposase domain hit (TIRPeps) — entries without a
  domain hit are skipped, NOT guessed.
* `confident_helitron.fa` entries: the Helitron module's structural
  gate (LCV head + CTRR[T] tail + A|T host site) IS the class evidence.
* LTR internal entries (`*-I#LTR` in confident_TE.cons.fa): labeled
  Copia/Gypsy when the pol domain-ORDER grammar fires
  (`pipeline.domain.ltr_domain_order`); no-call internals are skipped.

SINE/LINE entries are skipped entirely: superfamily within the non-LTR
orders is not structurally determinable without the upstream-missing
LINEPeps/RepeatPeps blobs, and a guessed label would poison training.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hite_tpu_torch.device import resolve_device
from hite_tpu_torch.io.fasta import read_fasta
from hite_tpu_torch.utils.log import logger


def mine_weak_labels(
    out_dirs: Sequence[str],
    min_len: int = 100,
    device=None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Optional[str]]]:
    """(library, domains) with evidence-backed Wicker labels; the domain
    scans (`sw_protein`) run on `device` (None = the card).

    `library` maps unique entry names to uint8 code arrays; `domains`
    maps the same names to Wicker class labels (usable both as the
    training label and as the feature-block domain evidence)."""
    from hite_tpu_torch.models.classifier import WICKER_CLASSES
    from hite_tpu_torch.models.trainer import label_to_class
    from hite_tpu_torch.pipeline.domain import (
        DomainScanner, ltr_domain_order,
    )

    dev = resolve_device(device)
    data_dir = os.path.join(os.path.dirname(__file__), "..", "data",
                            "protein")
    tir_pep = os.path.join(data_dir, "TIRPeps.lib")
    scanner = (DomainScanner.from_fasta(tir_pep, device=dev)
               if os.path.exists(tir_pep) else None)

    lib: Dict[str, np.ndarray] = {}
    labels: Dict[str, Optional[str]] = {}
    stats = {"tir_domain": 0, "tir_skipped": 0, "helitron": 0,
             "ltr_order": 0, "ltr_skipped": 0}

    for di, out_dir in enumerate(out_dirs):
        # --- TIR entries: Wicker class of the best transposase hit
        tir_path = os.path.join(out_dir, "confident_tir.fa")
        if scanner is not None and os.path.exists(tir_path):
            entries = {n: s for n, s in read_fasta(tir_path).items()
                       if len(s) >= min_len}
            names = list(entries.keys())
            if names:
                hit_sets = scanner.scan([entries[n] for n in names])
                for n, hits in zip(names, hit_sets):
                    if not hits:
                        stats["tir_skipped"] += 1
                        continue
                    best = max(hits, key=lambda h: h.entry_cov)
                    wicker = best.entry.rpartition("#")[2]
                    ci = label_to_class(wicker)
                    if ci is None:
                        stats["tir_skipped"] += 1
                        continue
                    key = f"mined{di}_{n.partition('#')[0]}"
                    lib[key] = entries[n]
                    labels[key] = WICKER_CLASSES[ci]
                    stats["tir_domain"] += 1

        # --- Helitron entries: structural gate is the evidence
        hel_path = os.path.join(out_dir, "confident_helitron.fa")
        if os.path.exists(hel_path):
            for n, s in read_fasta(hel_path).items():
                if len(s) < min_len:
                    continue
                key = f"mined{di}_{n.partition('#')[0]}"
                lib[key] = s
                labels[key] = "Helitron"
                stats["helitron"] += 1

        # --- LTR internals: pol domain-order Copia/Gypsy calls
        cons_path = os.path.join(out_dir, "confident_TE.cons.fa")
        if os.path.exists(cons_path):
            internals = {n: s for n, s in read_fasta(cons_path).items()
                         if n.partition("#")[0].endswith("-I")
                         and len(s) >= min_len}
            names = list(internals.keys())
            if names:
                calls = ltr_domain_order([internals[n] for n in names],
                                         device=dev)
                for n, c in zip(names, calls):
                    if c == 0:
                        stats["ltr_skipped"] += 1
                        continue
                    key = f"mined{di}_{n.partition('#')[0]}"
                    lib[key] = internals[n]
                    labels[key] = "Copia" if c == 1 else "Gypsy"
                    stats["ltr_order"] += 1

    logger.info("weak_labels: mined %d labeled families from %d runs (%s)",
                len(lib), len(out_dirs), stats)
    return lib, labels
