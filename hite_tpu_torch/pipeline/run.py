"""Pipeline stages ported so far (counterpart of the JAX `pipeline/run.py`).

The port runs stages 1-4 of `run_pipeline`: discovery, the three
copy-verified modules (TIR, Helitron, non-LTR), the low-copy rescue, the
FiLTR LTR stage and library assembly:

    genome.init_mask(); _mask_tandem_regions(genome)      # stage 1a
    coarse = coarse_discover(genome, cfg.align, params)   # stage 1b
    gindex = GenomeIndex(genome, cfg.align, params.seg_len)
    modules = modules_stage(genome, coarse, cfg, gindex)  # stage 2
    found = [m.accepted.intervals for m in modules.values()]
    _rescue_low_copy(genome, cfg, **modules)              # stage 2b
    ltr = ltr_stage(genome, cfg, gindex, found,           # stage 3
                    seg_len=params.seg_len)
    libs = library_stage(genome, cfg, ltr=ltr, **modules)  # stage 4

with `cfg = cfg.with_genome_size(genome.size)`.  As in the JAX package,
stage 3 masks the families accepted BEFORE the rescue, and runs when
`cfg.te_type` is "all" or "ltr".  `run_pipeline`, the output writers and
the CLI arrive with the annotation slice (ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hite_tpu_torch.config import PipelineConfig
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.io.fasta import read_fasta
from hite_tpu_torch.ops.tandem import long_tandem_mask, tandem_mask
from hite_tpu_torch.pipeline.candidates import CandidateSet
from hite_tpu_torch.pipeline.copies import CopyFinder, GenomeIndex
from hite_tpu_torch.pipeline.helitron import (
    gate_helitron, run_helitron_detection,
)
from hite_tpu_torch.pipeline.library import build_library
from hite_tpu_torch.pipeline.ltr import LTRResult
from hite_tpu_torch.pipeline.non_ltr import (
    gate_non_ltr, run_non_ltr_detection,
)
from hite_tpu_torch.pipeline.tir import gate_tir, run_tir_detection
from hite_tpu_torch.pipeline.verify import ModuleResult, prepare_families
from hite_tpu_torch.utils.log import logger, stage_timer

DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")


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


def _structural_rescue_tir_mask(genome: Genome, cfg: PipelineConfig,
                                intervals: np.ndarray) -> np.ndarray:
    """Bool mask of low-copy TIR candidates rescued by TERMINAL STRUCTURE.

    Reference `flank_region_align_v5`'s structural branch
    (`Util.py:8205-8213` -> `remove_no_tirs`): TRF-mask the candidate,
    then keep it when it carries a short-TIR superfamily signature
    (`get_short_tir_contigs`) or an itrsearch terminal inverted repeat.
    """
    from hite_tpu_torch.ops.terminal import find_terminal_repeat
    from hite_tpu_torch.pipeline.candidates import pad_rows, pad_seqs
    from hite_tpu_torch.pipeline.tir import _short_tir_signature

    n = len(intervals)
    if n == 0:
        return np.zeros(0, bool)
    dev = genome.device
    seqs = [genome.extract(int(s), int(e)) for s, e in intervals]
    mat, lens = pad_seqs(seqs, n_rows=pad_rows(n))
    tmask = tandem_mask(torch.from_numpy(mat).to(dev)).cpu().numpy()

    # TRF -m equivalent: N-out tandem arrays before the structure scan
    masked = []
    for i, s in enumerate(seqs):
        m = s.copy()
        m[tmask[i, : len(s)]] = 4
        masked.append(m)

    mmat, mlens = pad_seqs(masked, n_rows=pad_rows(n))
    # min_len 10 (not itrsearch's 7): a chance >=7bp 70%-identity inverted
    # match arises too often in 40bp end windows of random low-copy
    # sequence; genuinely short TIRs are rescued by the TSD-keyed
    # short-TIR signature branch below instead
    tr = find_terminal_repeat(
        torch.from_numpy(mmat).to(dev), torch.from_numpy(mlens).to(dev),
        inverted=True, window=cfg.terminal.end_window,
        min_identity=cfg.terminal.itr_identity,
        min_len=max(10, cfg.terminal.itr_min_len))
    has_itr = tr.found.cpu().numpy()[:n].copy()

    # a TSD in the candidate's genomic flanks is REQUIRED for both rescue
    # branches: the reference's rescue inputs are TSD-snapped candidates
    # from search_confident_tir_v4, so a chance >=10bp inverted end-match
    # alone must not rescue
    rescued = np.zeros(n, bool)
    for i, (s, e) in enumerate(intervals):
        for sz in (11, 10, 9, 8, 6, 5, 4, 3, 2):
            lf = genome.extract(int(s) - sz, int(s))
            rf = genome.extract(int(e), int(e) + sz)
            if len(lf) != sz or len(rf) != sz or (lf >= 4).any():
                continue
            tol = 1 if sz >= 8 else 0
            if (lf != rf).sum() <= tol and (
                    has_itr[i]
                    or _short_tir_signature(seqs[i], sz, cfg.plant)):
                rescued[i] = True
                break
    # LTR-signature veto (the structural gate's TG...CA skip,
    # Util.py:7822): a TG...CA candidate is an intact LTR element, and
    # rescuing it would hand the LTR family to the TIR library
    for i in np.nonzero(rescued)[0]:
        s = seqs[i]
        if len(s) >= 400 and s[0] == 3 and s[1] == 2 \
                and s[-2] == 1 and s[-1] == 0:
            rescued[i] = False
    return rescued


def _rescue_low_copy(genome: Genome, cfg: PipelineConfig, *, tir=None,
                     helitron=None, non_ltr=None) -> int:
    """Low-copy rescue: move low-copy candidates carrying TIR terminal
    STRUCTURE (TIR module only) or a near-intact TE protein DOMAIN into
    the accepted set of their module (`Util.py:8194-8290`); returns the
    number rescued.  Domain scans run on the genome's device."""
    from hite_tpu_torch.pipeline.domain import DomainScanner, rescue_by_domain

    # TIRPeps/HelitronPeps are vendored from the reference's library/ data
    # assets; LINEPeps.lib is a missing blob upstream too, so the non-LTR
    # rescue only activates when a user supplies it (HITE_TPU_LIBRARY_DIR)
    lib_dir = os.environ.get("HITE_TPU_LIBRARY_DIR",
                             os.path.join(DATA_DIR, "protein"))
    lib_for = {
        "tir": os.path.join(DATA_DIR, "protein", "TIRPeps.lib"),
        "helitron": os.path.join(DATA_DIR, "protein", "HelitronPeps.lib"),
        "non_ltr": os.path.join(lib_dir, "LINEPeps.lib"),
    }
    rescued_total = 0
    for key, mod in (("tir", tir), ("helitron", helitron),
                     ("non_ltr", non_ltr)):
        if mod is None or len(mod.low_copy) == 0:
            continue
        mask = np.zeros(len(mod.low_copy), bool)
        # structural branch (TIR only): TRF-masked ITR / short-TIR signature
        if key == "tir":
            mask |= _structural_rescue_tir_mask(
                genome, cfg, mod.low_copy.intervals)
            if mask.any():
                logger.info("tir: %d low-copy candidates carry TIR "
                            "terminal structure", int(mask.sum()))
        path = lib_for[key]
        if os.path.exists(path):
            scanner = DomainScanner.from_fasta(path, device=genome.device)
            seqs = [genome.extract(int(s), int(e))
                    for s, e in mod.low_copy.intervals]
            mask |= rescue_by_domain(seqs, scanner)
        if not mask.any():
            continue
        kept = mod.low_copy.intervals[mask]
        for s, e in kept:
            logger.info("%s: rescue keeps %d-%d (len %d)", key, int(s),
                        int(e), int(e) - int(s))
        mod.accepted = CandidateSetJoin(mod.accepted, kept)
        for s, e in kept:
            mod.consensus.append(genome.extract(int(s), int(e)))
            mod.copy_counts.append(1)
        mod.low_copy = mod.low_copy.subset(~mask)
        rescued_total += int(mask.sum())
        logger.info("%s: rescued %d low-copy candidates (structure/domain)",
                    key, int(mask.sum()))
    return rescued_total


def CandidateSetJoin(a: CandidateSet, extra_intervals: np.ndarray
                     ) -> CandidateSet:
    iv = np.concatenate([a.intervals,
                         np.asarray(extra_intervals).reshape(-1, 2)])
    return CandidateSet(intervals=iv)


def modules_stage(genome: Genome, coarse: np.ndarray, cfg: PipelineConfig,
                  gindex: GenomeIndex) -> Dict[str, ModuleResult]:
    """Gate all three copy-verified modules first (tir, helitron,
    non_ltr), then fetch EVERY module's family representatives in ONE
    whole-genome join (the reference pays one full minimap2 pass per
    module), then verify each module.  The body of the JAX `run_pipeline`
    closure `_modules_stage`."""
    want = (lambda t: cfg.te_type in ("all", t))
    gates = {}
    if want("tir"):
        gates["tir"] = gate_tir(genome, coarse, cfg)
    if want("helitron"):
        gates["helitron"] = gate_helitron(genome, coarse, cfg)
    if want("non-ltr") and cfg.is_denovo_nonltr:
        gates["non_ltr"] = gate_non_ltr(genome, coarse, cfg)

    plans = {k: prepare_families(genome, g, cfg)
             for k, g in gates.items() if len(g)}
    # reps + first alternates per similarity group ride the same join
    union = [(k, i) for k, pl in plans.items() for i in pl.prefetch_idx]
    per_mod: Dict[str, list] = {k: [] for k in plans}
    if union:
        with stage_timer("modules.copies"):
            sets = CopyFinder(gindex).find_copies(
                [plans[k].seqs[i] for k, i in union],
                min_coverage=0.9, max_copies=cfg.msa.max_copies)
        for (k, _i), cs in zip(union, sets):
            per_mod[k].append(cs)

    runners = {"tir": run_tir_detection,
               "helitron": run_helitron_detection,
               "non_ltr": run_non_ltr_detection}
    return {k: runners[k](genome, coarse, cfg, gindex, gated=g,
                          plan=plans.get(k), rep_copy_sets=per_mod.get(k))
            for k, g in gates.items()}


def ltr_stage(genome: Genome, cfg: PipelineConfig, gindex: GenomeIndex,
              found_intervals: Sequence[np.ndarray],
              seg_len: int = 131_072) -> LTRResult:
    """Stage 3, the FiLTR LTR path, on the genome masked with every family
    found so far (reference judge_LTR_transposons.py:111): self-join
    candidates, SW terminal refinement, the precision pre-filters, the
    frame rule with the LTR CNN (`cfg.ltr.use_deep_cnn`), the cross-class
    filters, and the superfamily CNN (`cfg.classify.use_neural`).  The
    body of the JAX `run_pipeline` closure `_ltr_stage` with the masking
    before it.  The legacy path (`cfg.ltr.use_filtr=False`) is not ported
    and raises."""
    from hite_tpu_torch.models import bundled_model_path
    from hite_tpu_torch.models.convert import load_model
    from hite_tpu_torch.models.ltr_filter import LTRFilterCNN
    from hite_tpu_torch.pipeline.ltr import (
        classify_ltr_records, run_ltr_detection,
    )
    from hite_tpu_torch.pipeline.ltr_deep import (
        cross_class_filter, deep_filter_records,
    )

    if not cfg.ltr.use_filtr:
        raise NotImplementedError(
            "the legacy LTR path (use_filtr=False, --use_FiLTR 0) is not "
            "ported yet (ROADMAP item 16.1)")
    masked_bp = genome.mask_intervals(
        (int(s), int(e)) for arr in found_intervals for s, e in arr)
    logger.info("pipeline: masked %d bp before LTR stage", masked_bp)
    res = run_ltr_detection(genome, cfg, gindex, seg_len=seg_len)
    cnn_model = None
    if cfg.ltr.use_deep_cnn:
        path = cfg.ltr.deep_model_path or bundled_model_path(
            "ltr_filter_cnn.pkl")
        if path and os.path.exists(path):
            cnn_model = load_model(LTRFilterCNN, path, genome.device)
    kept = deep_filter_records(genome, res.records, cfg, gindex,
                               cnn_model=cnn_model)
    kept, pools = cross_class_filter(genome, kept, cfg, gindex)
    res = LTRResult(records=kept, cross_class=pools)
    if cfg.classify.use_neural and res.records:
        with stage_timer("ltr.classify"):
            classify_ltr_records(genome, res.records, cfg)
    return res


def library_stage(genome: Genome, cfg: PipelineConfig, *,
                  tir: Optional[ModuleResult] = None,
                  helitron: Optional[ModuleResult] = None,
                  non_ltr: Optional[ModuleResult] = None,
                  ltr: Optional[LTRResult] = None,
                  other: Optional[Dict[str, np.ndarray]] = None
                  ) -> Dict[str, Dict[str, np.ndarray]]:
    """Stage 4: `build_library` over the modules' families, the LTR result
    and the curated library `cfg.curated_lib` when that file exists.
    `other` is stage 0b's curated-homology library (not ported yet)."""
    curated = read_fasta(cfg.curated_lib) if (
        cfg.curated_lib and os.path.exists(cfg.curated_lib)) else None
    return build_library(genome, cfg, tir=tir, helitron=helitron,
                         non_ltr=non_ltr, ltr=ltr, other=other,
                         curated=curated)
