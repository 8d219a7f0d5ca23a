"""Homology-based non-LTR detection against a curated library (stage 0b;
counterpart of the JAX package's `pipeline/other.py`).

Re-implements `module/judge_Other_transposons.py`: align every entry of a
curated non-LTR library to the genome with query coverage >= 0.95 and keep
the longest genomic copy per entry (`:48-77`).  With no curated library
configured or present the stage does nothing.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from hite_tpu_torch.config import PipelineConfig
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.io.fasta import read_fasta
from hite_tpu_torch.pipeline.copies import CopyFinder, GenomeIndex
from hite_tpu_torch.utils.log import logger, stage_timer


def run_other_detection(
    genome: Genome,
    cfg: PipelineConfig,
    lib_path: Optional[str] = None,
    gindex: Optional[GenomeIndex] = None,
) -> Dict[str, np.ndarray]:
    """Returns {entry_name#Class: longest genomic copy codes}."""
    if lib_path is None or not os.path.exists(lib_path):
        logger.info("other: no curated non-LTR library available, skipping")
        return {}
    lib = read_fasta(lib_path)
    gindex = gindex or GenomeIndex(genome, cfg.align)
    finder = CopyFinder(gindex)
    with stage_timer("other.map"):
        copies = finder.find_copies(list(lib.values()), min_coverage=0.95,
                                    max_copies=8)
    out: Dict[str, np.ndarray] = {}
    for name, hits in zip(lib.keys(), copies):
        if not hits:
            continue
        best = max(hits, key=lambda h: h.end - h.start)
        key = name if "#" in name else f"{name}#Unknown"
        out[key] = genome.extract(best.start, best.end)
    logger.info("other: %d curated entries recovered", len(out))
    return out
