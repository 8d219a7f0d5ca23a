"""End-to-end single-genome pipeline and its CLI (counterpart of the JAX
package's `pipeline/run.py`).

`run_pipeline(genome, cfg, out_dir=...)` runs every stage on the genome's
device, each under the JAX package's stage name and, with `cfg.recover`,
under a `Checkpointer` snapshot:

    0a  clean_genome: redundant contigs dropped, contigs renamed Chr1..N
    0b  run_other_detection: the curated library's copies ("other")
    1a  genome.init_mask(); _mask_tandem_regions(genome)
    1b  coarse_discover(genome, cfg.align, params)             ("coarse")
    2   modules_stage: TIR, Helitron and non-LTR over one join ("modules")
    2b  _rescue_low_copy: the low-copy structural / domain rescue
    3   ltr_stage: FiLTR (or, with use_filtr=False, the legacy path) on
        the genome masked with the families accepted BEFORE the rescue
                                                               ("ltr")
    4   library_stage: build_library                          ("library")
        write_outputs: the library FASTAs, intact_LTR.list, ...
    5   annotate_genome + write_annotation (cfg.annotate)
    6   the TE <-> domain table (cfg.domain)
    7   BM_HiTE / BM_RM2 / BM_EDTA against the gold library

`main(argv, device=None)` is the CLI with the JAX package's flags
(`python -m hite_tpu_torch --genome g.fa --out_dir o ...`): it runs on the
card, and raises without one unless the caller passes `device="cpu"`.
Genomes over 512 Mbp (the JAX package's packed host tier) are ROADMAP item
16.7; the JAX `mesh` argument is item 16.5.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from hite_tpu_torch.config import PipelineConfig
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.io.fasta import read_fasta, write_fasta
from hite_tpu_torch.ops.tandem import long_tandem_mask, tandem_mask
from hite_tpu_torch.pipeline.annotate import annotate_genome, write_annotation
from hite_tpu_torch.pipeline.candidates import CandidateSet
from hite_tpu_torch.pipeline.checkpoint import Checkpointer
from hite_tpu_torch.pipeline.coarse import CoarseParams, coarse_discover
from hite_tpu_torch.pipeline.copies import CopyFinder, GenomeIndex
from hite_tpu_torch.pipeline.helitron import (
    gate_helitron, run_helitron_detection,
)
from hite_tpu_torch.pipeline.library import build_library
from hite_tpu_torch.pipeline.ltr import LTRResult
from hite_tpu_torch.pipeline.non_ltr import (
    gate_non_ltr, run_non_ltr_detection,
)
from hite_tpu_torch.pipeline.other import run_other_detection
from hite_tpu_torch.pipeline.tir import gate_tir, run_tir_detection
from hite_tpu_torch.pipeline.verify import ModuleResult, prepare_families
from hite_tpu_torch.utils.log import STAGE_TIMES, logger, stage_timer

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


def mask_found(genome: Genome, found_intervals: Sequence[np.ndarray]
               ) -> int:
    """N-out every family found so far in the masked genome before the LTR
    stage (reference judge_LTR_transposons.py:111); returns bp masked."""
    masked_bp = genome.mask_intervals(
        (int(s), int(e)) for arr in found_intervals for s, e in arr)
    logger.info("pipeline: masked %d bp before LTR stage", masked_bp)
    return masked_bp


def ltr_stage(genome: Genome, cfg: PipelineConfig, gindex: GenomeIndex,
              found_intervals: Sequence[np.ndarray],
              seg_len: int = 131_072) -> LTRResult:
    """Stage 3 on the genome masked with `found_intervals` (`mask_found`;
    `run_pipeline` masks before its checkpoint and passes none).  FiLTR
    path: self-join candidates, SW terminal refinement, the precision
    pre-filters, the frame rule with the LTR CNN (`cfg.ltr.use_deep_cnn`)
    and the cross-class filters.  Legacy path (`cfg.ltr.use_filtr=False`,
    `--use_FiLTR 0`): `ltr_legacy.run_legacy_ltr_detection`.  Both end with
    the superfamily CNN (`cfg.classify.use_neural`).  The body of the JAX
    `run_pipeline` closure `_ltr_stage`."""
    from hite_tpu_torch.models import bundled_model_path
    from hite_tpu_torch.models.convert import load_model
    from hite_tpu_torch.models.ltr_filter import LTRFilterCNN
    from hite_tpu_torch.pipeline.ltr import (
        classify_ltr_records, run_ltr_detection,
    )
    from hite_tpu_torch.pipeline.ltr_deep import (
        cross_class_filter, deep_filter_records,
    )
    from hite_tpu_torch.pipeline.ltr_legacy import run_legacy_ltr_detection

    if found_intervals:
        mask_found(genome, found_intervals)
    if not cfg.ltr.use_filtr:
        # a DIFFERENT algorithm family: exact-repeat harvest +
        # LTR_retriever's structural filters, no deep filters
        res = run_legacy_ltr_detection(genome, cfg, gindex)
    else:
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
    """Stage 4: `build_library` over the modules' families, the LTR result,
    stage 0b's curated-homology library `other` and the curated library
    `cfg.curated_lib` when that file exists."""
    curated = read_fasta(cfg.curated_lib) if (
        cfg.curated_lib and os.path.exists(cfg.curated_lib)) else None
    return build_library(genome, cfg, tir=tir, helitron=helitron,
                         non_ltr=non_ltr, ltr=ltr, other=other,
                         curated=curated)


@dataclass
class RunResult:
    libs: Dict[str, Dict[str, np.ndarray]]
    tir: Optional[ModuleResult] = None
    helitron: Optional[ModuleResult] = None
    non_ltr: Optional[ModuleResult] = None
    ltr: Optional[LTRResult] = None
    metrics: Dict = field(default_factory=dict)
    # per-locus AnnotationHits when cfg.annotate (the GFF writer's input,
    # and the planted-truth accuracy evaluation's)
    annotation: list = field(default_factory=list)


def run_pipeline(
    genome: Genome,
    cfg: PipelineConfig,
    out_dir: Optional[str] = None,
    coarse_params: Optional[CoarseParams] = None,
) -> RunResult:
    """Full single-genome pipeline on `genome.device` (stages in the module
    doc).  Writes the output files under `out_dir` when given."""
    cfg = cfg.with_genome_size(genome.size)
    params = coarse_params or CoarseParams()
    want = (lambda t: cfg.te_type in ("all", t))
    ckpt = Checkpointer(out_dir, cfg, enabled=cfg.recover)

    # stage 0a: redundant-contig removal (reference genome_clean.py before
    # everything, main.py:435-441); surviving contigs are RENAMED Chr1..N
    # (genome_clean.py:87-93) and the original names kept in
    # contig_name.map.  The JAX package re-packs a >512 Mbp genome here
    # (`pack_host`); the packed tier is ROADMAP item 16.7.
    if cfg.clean_genome and len(genome.names) > 1:
        from hite_tpu_torch.pipeline.clean import clean_genome

        with stage_timer("pipeline.clean"):
            cleaned, name_map = clean_genome(genome.to_dict(), cfg,
                                             rename=True,
                                             device=genome.device)
        if len(cleaned.names) < len(genome.names):
            logger.info("pipeline: genome_clean dropped %d of %d contigs",
                        len(genome.names) - len(cleaned.names),
                        len(genome.names))
        genome = cleaned
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "contig_name.map"), "w") as fh:
                for old, new in name_map.items():
                    fh.write(f"{new}\t{old}\n")

    # stage 0b: curated-library homology (the reference's --curated_lib
    # pre-mask + judge_Other stage)
    other = ckpt.run("other",
                     lambda: run_other_detection(genome, cfg, cfg.curated_lib))

    # stage 1a: tandem masking before discovery (TRF -m,
    # Util.py:4672-4697)
    genome.init_mask()
    with stage_timer("pipeline.tandem_mask"):
        _mask_tandem_regions(genome)

    # stage 1b: coarse de-novo discovery on the masked genome
    with stage_timer("pipeline.coarse"):
        coarse = ckpt.run("coarse",
                          lambda: coarse_discover(genome, cfg.align, params))

    with stage_timer("pipeline.gindex"):
        gindex = GenomeIndex(genome, cfg.align, seg_len=params.seg_len)

    # stage 2: the three copy-verified modules over one shared join
    with stage_timer("pipeline.modules"):
        modules = ckpt.run("modules", lambda: modules_stage(
            genome, coarse, cfg, gindex))
    tir = modules.get("tir")
    helitron = modules.get("helitron")
    non_ltr = modules.get("non_ltr")
    found_intervals = [m.accepted.intervals for m in modules.values()]

    # stage 2b: low-copy structural/domain rescue (reference
    # flank_region_align_v5 rescue branch, Util.py:8215-8281)
    with stage_timer("pipeline.low_copy_rescue"):
        _rescue_low_copy(genome, cfg,
                         tir=tir, helitron=helitron, non_ltr=non_ltr)

    # stage 3: LTR on the genome masked with the families accepted before
    # the rescue (the mask is not part of the snapshot, so it is applied
    # here, on resumed runs too)
    ltr = None
    if want("ltr"):
        mask_found(genome, found_intervals)
        with stage_timer("pipeline.ltr"):
            ltr = ckpt.run("ltr", lambda: ltr_stage(
                genome, cfg, gindex, (), seg_len=params.seg_len))

    # stage 4: library assembly
    with stage_timer("pipeline.library"):
        libs = ckpt.run("library", lambda: library_stage(
            genome, cfg, tir=tir, helitron=helitron, non_ltr=non_ltr,
            ltr=ltr, other=other))

    result = RunResult(libs=libs, tir=tir, helitron=helitron,
                       non_ltr=non_ltr, ltr=ltr)

    if out_dir:
        with stage_timer("pipeline.write_outputs"):
            write_outputs(out_dir, genome, cfg, result)

    # stage 5: annotation over the unmasked genome (an empty library still
    # writes the empty gff/out/tbl set, like RepeatMasker)
    if cfg.annotate:
        with stage_timer("pipeline.annotate"):
            hits = (annotate_genome(genome, libs["merged"], cfg, gindex)
                    if libs.get("merged") else [])
            if out_dir:
                write_annotation(os.path.join(out_dir, "genome"), hits,
                                 genome)
        result.metrics["annotation_hits"] = len(hits)
        result.annotation = hits

    # stage 6: domain table (--domain; reference get_domain_info output)
    if cfg.domain and libs.get("merged"):
        from hite_tpu_torch.pipeline.domain import (
            DomainScanner, write_domain_table,
        )

        pep = os.path.join(DATA_DIR, "protein", "TIRPeps.lib")
        if os.path.exists(pep):
            with stage_timer("pipeline.domain"):
                scanner = DomainScanner.from_fasta(pep, device=genome.device)
                names = list(libs["merged"].keys())
                hit_sets = scanner.scan([libs["merged"][n] for n in names])
                if out_dir:
                    write_domain_table(
                        os.path.join(out_dir, "TE_domains.tsv"), names,
                        hit_sets)
            result.metrics["domain_hits"] = sum(len(h) for h in hit_sets)

    # stage 7: library benchmarking against the gold library (curated
    # species library, else the bundled test.ref, as the reference's
    # --species test, benchmarking.py:205-206); runs even with an empty
    # library, which scores zero (lib_evaluation.py:157-168)
    if gold_lib_path(cfg) and (cfg.bm_hite or cfg.bm_rm2 or cfg.bm_edta):
        from hite_tpu_torch.pipeline.benchmark import (
            evaluate_edta, evaluate_library, family_level_metrics,
        )

        gold = read_fasta(gold_lib_path(cfg))
        merged = libs.get("merged", {})
        with stage_timer("pipeline.benchmark"):
            if cfg.bm_hite:
                result.metrics["BM_HiTE"] = evaluate_library(
                    genome, merged, gold, cfg, gindex)
            if cfg.bm_rm2:
                result.metrics["BM_RM2"] = family_level_metrics(
                    merged, gold, cfg, device=genome.device)
            if cfg.bm_edta:
                result.metrics["BM_EDTA"] = evaluate_edta(
                    genome, merged, gold, cfg, gindex)
        if out_dir:
            with open(os.path.join(out_dir, "benchmark.json"), "w") as fh:
                json.dump({k: v for k, v in result.metrics.items()
                           if k.startswith("BM_")}, fh, indent=2,
                          default=float)

    # the snapshots are on disk before the caller (or the process) goes on
    ckpt.wait()
    result.metrics["stage_times"] = dict(STAGE_TIMES)
    return result


def gold_lib_path(cfg: PipelineConfig) -> Optional[str]:
    """Curated benchmark library for --species (reference
    benchmarking.py:176-206 registry; only `test` ships with the repo)."""
    if not (cfg.bm_hite or cfg.bm_rm2 or cfg.bm_edta):
        return None
    if cfg.species_lib:
        from hite_tpu_torch.pipeline.benchmark import species_library_path

        resolved = species_library_path(cfg.species_lib)
        if resolved:
            return resolved
    fallback = os.path.join(DATA_DIR, "test.ref")
    return fallback if os.path.exists(fallback) else None


def write_outputs(out_dir: str, genome: Genome, cfg: PipelineConfig,
                  result: RunResult) -> None:
    """The library FASTAs, the low-copy pool, intact_LTR.list, the LTR
    insertion-time table and stage_times.json."""
    os.makedirs(out_dir, exist_ok=True)
    libs = result.libs

    def dump(name: str, entries: Dict[str, np.ndarray]):
        write_fasta(os.path.join(out_dir, name), entries)

    dump("confident_tir.fa", libs.get("tir", {}))
    dump("confident_helitron.fa", libs.get("helitron", {}))
    dump("confident_non_ltr.fa", libs.get("non_ltr", {}))
    dump("confident_other.fa", libs.get("other", {}))
    dump("confident_ltr_cut.fa.cons", libs.get("ltr_cut", {}))
    dump("confident_TE.cons.fa", libs.get("merged", {}))

    # low-copy pool for pan-genome rescue (reference *_low_copy.fa)
    low = {}
    for mod, prefix in ((result.tir, "tir"), (result.helitron, "helitron"),
                        (result.non_ltr, "non_ltr")):
        if mod is None:
            continue
        for i, (s, e) in enumerate(mod.low_copy.intervals):
            low[f"{prefix}_low_{i}-{genome.location_str(int(s), int(e))}"] = \
                genome.extract(int(s), int(e))
    dump("low_confident_TE.fa", low)

    # intact LTR list (LTR_retriever .pass.list layout, FiLTR
    # src/Util.py:4146-4172)
    if result.ltr is not None:
        path = os.path.join(out_dir, "intact_LTR.list")
        with open(path, "w") as fh:
            fh.write("#LTR_loc\tCategory\tMotif\tTSD\t5'_TSD\t3'_TSD\t"
                     "Internal\tIdentity\tStrand\tSuperFamily\tTE_type\t"
                     "Insertion_Time\n")
            for r in result.ltr.records:
                ci, local = genome.contig_of(np.array([r.start]))
                name = genome.names[int(ci[0])]
                s = int(local[0])
                fh.write(
                    f"{name}:{s + 1}..{s + (r.end - r.start)}\tpass\t"
                    f"motif:TGCA\tTSD:{r.tsd_len}\t.\t.\t"
                    f"IN:{r.lltr_end - r.start}..{r.rltr_start - r.start}\t"
                    f"{r.identity:.4f}\t+\t{r.superfamily}\tLTR\t"
                    f"{int(r.insert_time)}\n")

    # LTR insertion-time table (reference draw_intact_LTR_insert_time
    # data, Util.py:13379, as a table)
    if result.ltr is not None and result.ltr.records:
        with open(os.path.join(out_dir, "ltr_insert_time.tsv"), "w") as fh:
            fh.write("element\tclassification\tidentity\t"
                     "insert_time_years\tcopies\n")
            for n, r in enumerate(result.ltr.records):
                fh.write(f"Intact_LTR_{n}\t{r.superfamily}\t{r.identity:.4f}"
                         f"\t{int(r.insert_time)}\t{r.copy_count}\n")

    with open(os.path.join(out_dir, "stage_times.json"), "w") as fh:
        json.dump({k: round(v, 3) for k, v in STAGE_TIMES.items()}, fh,
                  indent=2)


def config_from_argv(argv=None):
    """Parse reference-`main.py`-style flags into (PipelineConfig, args);
    the JAX package's flags, one for one."""
    import argparse

    p = argparse.ArgumentParser(
        description="hite_tpu_torch: TE discovery and annotation on an "
                    "NVIDIA GPU")
    p.add_argument("--genome", required=True)
    p.add_argument("--out_dir", default=".")
    p.add_argument("--te_type", default="all",
                   choices=["ltr", "tir", "helitron", "non-ltr", "all"])
    p.add_argument("--plant", type=int, default=1)
    p.add_argument("--miu", type=float, default=1.3e-8)
    p.add_argument("--curated_lib", default=None)
    p.add_argument("--annotate", type=int, default=0)
    p.add_argument("--recover", type=int, default=0)
    p.add_argument("--domain", type=int, default=0)
    p.add_argument("--BM_HiTE", type=int, default=0)
    p.add_argument("--BM_RM2", type=int, default=0)
    p.add_argument("--BM_EDTA", type=int, default=0)
    p.add_argument("--species", default=None,
                   help="curated benchmark library FASTA path, or 'test'")
    p.add_argument("--remove_nested", type=int, default=1)
    p.add_argument("--clean_genome", type=int, default=1,
                   help="drop redundant contigs before discovery (stage 0)")
    p.add_argument("--is_denovo_nonltr", type=int, default=1)
    p.add_argument("--min_TE_len", type=int, default=80)
    p.add_argument("--is_wicker", type=int, default=0)
    p.add_argument("--chrom_seg_length", type=int, default=131_072)
    # FiLTR toggle; --use_HybridLTR is the reference's other name for the
    # same subsystem (README.md:303-304 / nextflow.config:49 vs main.py:91)
    p.add_argument("--use_FiLTR", "--use_HybridLTR", dest="use_FiLTR",
                   type=int, default=1)
    args = p.parse_args(argv)

    cfg = PipelineConfig(
        genome=args.genome, out_dir=args.out_dir, te_type=args.te_type,
        plant=bool(args.plant), curated_lib=args.curated_lib,
        annotate=bool(args.annotate), remove_nested=bool(args.remove_nested),
        is_denovo_nonltr=bool(args.is_denovo_nonltr),
        recover=bool(args.recover), domain=bool(args.domain),
        bm_hite=bool(args.BM_HiTE), bm_rm2=bool(args.BM_RM2),
        bm_edta=bool(args.BM_EDTA),
        clean_genome=bool(args.clean_genome),
        species_lib=(None if args.species in (None, "test")
                     else args.species),
    )
    cfg = cfg.replace(
        ltr=dataclasses.replace(cfg.ltr, miu=args.miu,
                                use_filtr=bool(args.use_FiLTR)),
        library=dataclasses.replace(cfg.library, min_te_len=args.min_TE_len),
        classify=dataclasses.replace(cfg.classify,
                                     is_wicker=bool(args.is_wicker)),
    )
    return cfg, args


def main(argv=None, device: Optional[Union[str, torch.device]] = None
         ) -> RunResult:
    """CLI with the reference `main.py` flag names.  `device=None` runs on
    the card (and raises without one); pass "cpu" to run on the CPU."""
    cfg, args = config_from_argv(argv)
    genome = Genome.from_fasta(args.genome, device=device)
    params = CoarseParams(seg_len=args.chrom_seg_length)
    return run_pipeline(genome, cfg, out_dir=args.out_dir,
                        coarse_params=params)


if __name__ == "__main__":
    main()
