"""Genome cleaning: redundant-contig removal + contig renaming (stage 0a;
counterpart of the JAX package's `pipeline/clean.py`).

Re-implements `module/genome_clean.py`: rename contigs to Chr{N}
(`:87-93`), self-align the assembly (minimap2 -x asm5 of <10Mb contigs,
`:15-19,95-98`), and drop contigs >= 95% covered by a longer contig
(`:22-26`).  The self-alignment is the library clustering's all-pairs
copy join (`libcluster._all_pairs_hits`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from hite_tpu_torch.config import PipelineConfig
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.utils.log import logger, stage_timer


def clean_genome(
    seqs: Dict[str, np.ndarray],
    cfg: PipelineConfig,
    coverage: float = 0.95,
    max_self_align_len: int = 10_000_000,
    rename: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Genome, Dict[str, str]]:
    """Drop redundant contigs; returns (cleaned genome on `device`, name
    map {old: new}).  The self-alignment runs on `device` (None = the
    card)."""
    from hite_tpu_torch.pipeline.libcluster import _all_pairs_hits
    from hite_tpu_torch.utils import intervals as iv

    names = list(seqs.keys())
    lens = np.array([len(seqs[n]) for n in names])
    small = [i for i in range(len(names)) if lens[i] <= max_self_align_len]

    drop = set()
    if len(small) > 1:
        with stage_timer("clean.self_align"):
            pool = [seqs[names[i]] for i in small]
            hits = _all_pairs_hits(pool, cfg.align, device=device)
        # contig j is redundant when spans of j covered by longer contigs'
        # mappings reach the coverage threshold
        for j in range(len(pool)):
            spans = []
            for a, hs in enumerate(hits):
                if a == j:
                    continue
                spans.extend([(os_, oe) for (t, _x, _y, os_, oe, _n) in hs
                              if t == j and lens[small[a]] >= lens[small[j]]])
            if spans:
                cov = iv.total_length(np.array(spans)) / max(lens[small[j]], 1)
                if cov >= coverage:
                    drop.add(small[j])
    kept = [n for i, n in enumerate(names) if i not in drop]
    if drop:
        logger.info("clean_genome: dropped %d redundant contigs", len(drop))

    name_map: Dict[str, str] = {}
    cleaned: Dict[str, np.ndarray] = {}
    for i, n in enumerate(kept):
        new = f"Chr{i + 1}" if rename else n
        name_map[n] = new
        cleaned[new] = seqs[n]
    return Genome.from_dict(cleaned, device=device), name_map
