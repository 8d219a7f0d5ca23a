"""Pipeline stages ported so far (counterpart of the JAX `pipeline/run.py`).

The port runs the TIR discovery path of `run_pipeline`
(`--te_type tir`) up to the TIR module's verified families:

    genome.init_mask(); _mask_tandem_regions(genome)      # stage 1a
    coarse = coarse_discover(genome, cfg.align, params)   # stage 1b
    gindex = GenomeIndex(genome, cfg.align, params.seg_len)
    modules = modules_stage(genome, coarse, cfg, gindex)  # stage 2

with `cfg = cfg.with_genome_size(genome.size)`.  `run_pipeline` and the
CLI arrive with the low-copy rescue and library slices (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from hite_tpu_torch.config import PipelineConfig
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.ops.tandem import long_tandem_mask, tandem_mask
from hite_tpu_torch.pipeline.copies import CopyFinder, GenomeIndex
from hite_tpu_torch.pipeline.tir import gate_tir, run_tir_detection
from hite_tpu_torch.pipeline.verify import ModuleResult, prepare_families
from hite_tpu_torch.utils.log import logger, stage_timer


def _mask_tandem_regions(genome: Genome, seg_len: int = 131_072,
                         batch: int = 16) -> int:
    """N-out tandem arrays in the masked genome copy (TRF -m equivalent);
    returns bp masked."""
    n_segs = genome.n_segments(seg_len)
    total = 0
    for b0, chunk in genome.segment_batches(seg_len, batch):
        dev = torch.from_numpy(chunk).to(genome.device)
        mask = (tandem_mask(dev) | long_tandem_mask(dev)).cpu().numpy()
        for bi in range(min(batch, n_segs - b0)):
            pos = np.nonzero(mask[bi])[0]
            if len(pos) == 0:
                continue
            lo = (b0 + bi) * seg_len + pos
            genome.masked[lo[lo < len(genome.masked)]] = 4
            total += len(pos)
    logger.info("tandem mask: %d bp masked", total)
    return total


def modules_stage(genome: Genome, coarse: np.ndarray, cfg: PipelineConfig,
                  gindex: GenomeIndex) -> Dict[str, ModuleResult]:
    """Gate the copy-verified modules, fetch every module's family
    representatives in ONE whole-genome join, then verify each module.

    The body of the JAX `run_pipeline` closure `_modules_stage`; only the
    TIR module is ported, so a config that asks for the Helitron or the
    non-LTR gate raises."""
    want = (lambda t: cfg.te_type in ("all", t))
    if want("helitron") or (want("non-ltr") and cfg.is_denovo_nonltr):
        raise NotImplementedError(
            "the Helitron and non-LTR gates are not ported yet (ROADMAP.md "
            "queue 1, 'Helitron and non-LTR gates'); run with te_type='tir'")
    gates = {}
    if want("tir"):
        gates["tir"] = gate_tir(genome, coarse, cfg)

    plans = {k: prepare_families(genome, g, cfg)
             for k, g in gates.items() if len(g)}
    union = [(k, i) for k, pl in plans.items() for i in pl.prefetch_idx]
    per_mod: Dict[str, list] = {k: [] for k in plans}
    if union:
        with stage_timer("modules.copies"):
            sets = CopyFinder(gindex).find_copies(
                [plans[k].seqs[i] for k, i in union],
                min_coverage=0.9, max_copies=cfg.msa.max_copies)
        for (k, _i), cs in zip(union, sets):
            per_mod[k].append(cs)

    return {k: run_tir_detection(genome, coarse, cfg, gindex, gated=g,
                                 plan=plans.get(k),
                                 rep_copy_sets=per_mod.get(k))
            for k, g in gates.items()}
