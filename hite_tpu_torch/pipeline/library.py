"""Non-redundant classified TE library assembly (counterpart of the JAX
package's `pipeline/library.py`).

Re-implements `module/get_nonRedundant_lib.py`: per-type clustering and
renaming, LTR-vs-other-TE containment removal, merge with the classified
LTR library and an optional curated library, nested removal, the final
consensus clustering (`confident_TE.cons.fa`), neural label refinement
and homology labels.  Every step runs on the genome's device: the
clustering joins, the SW scans that locate termini, and the BLOSUM62
confirm of the combined TIRPeps + HelitronPeps domain scan.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hite_tpu_torch.config import PipelineConfig
from hite_tpu_torch.device import resolve_device
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.pipeline.libcluster import (
    _all_pairs_hits, cluster_consensi, cluster_seqs, remove_nested,
)
from hite_tpu_torch.pipeline.ltr import LTRResult
from hite_tpu_torch.pipeline.verify import ModuleResult
from hite_tpu_torch.utils.log import logger, stage_timer

# structural labels the neural classifier may refine
REFINABLE = ("", "Unknown", "DNA", "LINE")


def _module_seqs(genome: Genome, result: ModuleResult) -> List[np.ndarray]:
    """Per-family sequence: MSA consensus when present, else excision."""
    out = []
    for i, (s, e) in enumerate(result.accepted.intervals):
        cons = result.consensus[i] if i < len(result.consensus) else None
        out.append(cons if cons is not None and len(cons) else
                   genome.extract(int(s), int(e)))
    return out


def _cluster_and_name(
    seqs: List[np.ndarray],
    cfg: PipelineConfig,
    prefix: str,
    te_class: str,
    labels: Optional[Sequence[str]] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Cluster one module's sequences and name one entry per k-mer
    sub-cluster consensus (`generate_cons_v1` Util.py:12457-12498):
    `{prefix}_{n}#{class}`."""
    if not seqs:
        return {}
    lab, reps = cluster_seqs(seqs, cfg.align,
                             coverage=cfg.library.cluster_cov_short,
                             device=device)
    cons = cluster_consensi(seqs, lab, reps, device=device)
    out = {}
    n = 0
    for r in reps:
        cls = labels[r] if labels is not None else te_class
        for c in cons[r]:
            out[f"{prefix}_{n}#{cls}"] = c
            n += 1
    return out


def build_library(
    genome: Genome,
    cfg: PipelineConfig,
    tir: Optional[ModuleResult] = None,
    helitron: Optional[ModuleResult] = None,
    non_ltr: Optional[ModuleResult] = None,
    ltr: Optional[LTRResult] = None,
    other: Optional[Dict[str, np.ndarray]] = None,
    curated: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Assemble per-type and merged libraries on the genome's device.

    Returns {"tir", "helitron", "non_ltr", "other", "ltr_cut", "ltr_intact",
    "merged"} -> {name: codes} dicts (names carry `#Class` suffixes)."""
    dev = genome.device
    libs: Dict[str, Dict[str, np.ndarray]] = {}

    # terminals the FiLTR cross-class filters pulled out of the LTR set
    # join their module libraries before per-type clustering
    xc = ltr.cross_class if ltr is not None else {}

    with stage_timer("library.per_type"):
        tir_seqs = (_module_seqs(genome, tir) if tir is not None else [])
        tir_seqs += xc.get("tir", [])
        if tir_seqs:
            libs["tir"] = _cluster_and_name(tir_seqs, cfg, "TIR", "DNA",
                                            device=dev)
        hel_seqs = (_module_seqs(genome, helitron)
                    if helitron is not None else [])
        hel_seqs += xc.get("helitron", [])
        if hel_seqs:
            libs["helitron"] = _cluster_and_name(
                hel_seqs, cfg, "Helitron", "RC/Helitron", device=dev)
        nl_seqs = (_module_seqs(genome, non_ltr)
                   if non_ltr is not None else [])
        type_labels = (list(non_ltr.accepted.meta.get(
            "te_type", ["LINE"] * len(non_ltr.accepted)))
            if non_ltr is not None else [])
        nl_seqs += xc.get("non_ltr", [])
        type_labels += ["SINE"] * len(xc.get("non_ltr", []))
        if nl_seqs:
            libs["non_ltr"] = _cluster_and_name(
                nl_seqs, cfg, "Non_LTR", "LINE", labels=type_labels,
                device=dev)
        if other:
            libs["other"] = dict(other)

    with stage_timer("library.ltr"):
        if ltr is not None and ltr.records:
            cut: Dict[str, np.ndarray] = {}
            terminals = ltr.terminal_seqs(genome)
            internals = ltr.internal_seqs(genome)
            _t_lab, t_reps = cluster_seqs(
                terminals, cfg.align, coverage=cfg.ltr.dedup_terminal_cov,
                device=dev)
            _i_lab, i_reps = cluster_seqs(
                internals, cfg.align, coverage=cfg.ltr.dedup_internal_cov,
                device=dev)
            for n, r in enumerate(t_reps):
                cut[f"LTR_{n}-LTR#LTR"] = terminals[r]
            for n, r in enumerate(i_reps):
                cut[f"LTR_{n}-I#LTR"] = internals[r]
            libs["ltr_cut"] = cut
            libs["ltr_intact"] = {
                f"Intact_LTR_{n}#LTR": genome.extract(rec.start, rec.end)
                for n, rec in enumerate(ltr.records)}

    # "LTRs consist of other TE elements" removal
    # (`get_nonRedundant_lib.py:60-61`): drop LTR entries whose sequence is
    # >= 95% covered by a TIR/Helitron/non-LTR consensus
    with stage_timer("library.ltr_containment"):
        inner = {}
        for key in ("tir", "helitron", "non_ltr"):
            inner.update(libs.get(key, {}))
        if inner and libs.get("ltr_cut"):
            ltr_names = list(libs["ltr_cut"].keys())
            ltr_seqs = [libs["ltr_cut"][n] for n in ltr_names]
            pool = ltr_seqs + list(inner.values())
            lab, _ = cluster_seqs(pool, cfg.align,
                                  coverage=cfg.library.full_length_cov,
                                  device=dev)
            drop = {name for i, name in enumerate(ltr_names)
                    if lab[i] != i and lab[i] >= len(ltr_seqs)}
            for name in drop:
                del libs["ltr_cut"][name]
            if drop:
                logger.info("library: dropped %d LTR entries contained in "
                            "other TE consensi", len(drop))

    # merge + final clustering
    with stage_timer("library.merge"):
        merged_entries: List[Tuple[str, np.ndarray]] = []
        for key in ("tir", "helitron", "non_ltr", "other", "ltr_cut"):
            merged_entries.extend(libs.get(key, {}).items())
        if curated:
            merged_entries.extend(curated.items())
        names = [n for n, _ in merged_entries]
        seqs = [s for _, s in merged_entries]
        merged: Dict[str, np.ndarray] = {}
        if seqs:
            if cfg.remove_nested and len(seqs) > 1:
                seqs = remove_nested(seqs, cfg.align,
                                     coverage=cfg.library.nested_coverage,
                                     device=dev)
            _lab, reps = cluster_seqs(seqs, cfg.align,
                                      coverage=cfg.library.cluster_cov_short,
                                      device=dev)
            for r in reps:
                if len(seqs[r]) >= cfg.library.min_te_len:
                    merged[names[r]] = seqs[r]
        libs["merged"] = merged

    # neural label refinement (NeuralTE classification of the library,
    # `get_nonRedundant_lib.py:66-79`)
    if cfg.classify.use_neural and libs.get("merged"):
        from hite_tpu_torch.models import bundled_model_path

        model_path = cfg.classify.model_path or bundled_model_path(
            "superfamily_cnn.pkl")
        if model_path:
            with stage_timer("library.refine_labels"):
                libs["merged"] = refine_labels(libs["merged"], cfg,
                                               model_path=model_path,
                                               genome=genome)
    # RepeatClassifier-style homology labelling against the curated lib
    # for anything still Unknown (TEClass_parallel.py semantics)
    if curated and libs.get("merged"):
        with stage_timer("library.homology_labels"):
            libs["merged"] = classify_by_homology(libs["merged"], curated,
                                                  cfg, device=dev)
    logger.info("library: %d merged entries", len(libs.get("merged", {})))
    return libs


def library_feature_evidence(
    seqs: List[np.ndarray],
    cfg: PipelineConfig,
    genome: Optional[Genome] = None,
    device=None,
):
    """(tsd_seqs, domain_classes) evidence blocks for library entries, on
    the genome's device (or `device` without a genome; None = the card).

    TSD: each entry's best full-length genomic copy is located and its
    flanks searched for a shared 2-11-mer (the reference's use_TSD-1 mode,
    get_nonRedundant_lib.py:66-79).  Domain: ONE scan against TIRPeps and
    HelitronPeps together (BLOSUM62 confirm in the SW kernel's protein
    mode); the best hit's superfamily (TIRPeps first) becomes the one-hot.
    """
    from hite_tpu_torch.models.trainer import label_to_class
    from hite_tpu_torch.pipeline.copies import CopyFinder, GenomeIndex
    from hite_tpu_torch.pipeline.domain import DomainScanner

    dev = genome.device if genome is not None else resolve_device(device)
    n = len(seqs)
    tsd_seqs: List[Optional[np.ndarray]] = [None] * n
    if genome is not None and n:
        finder = CopyFinder(GenomeIndex(genome, cfg.align))
        copy_sets = finder.find_copies(seqs, min_coverage=0.9, max_copies=3)
        for i, hits in enumerate(copy_sets):
            for h in hits:
                found = None
                for sz in (11, 10, 9, 8, 6, 5, 4, 3, 2):
                    lf = genome.extract(h.start - sz, h.start)
                    rf = genome.extract(h.end, h.end + sz)
                    if len(lf) != sz or len(rf) != sz or (lf >= 4).any():
                        continue
                    tol = 1 if sz >= 8 else 0
                    if (lf != rf).sum() <= tol:
                        found = lf
                        break
                if found is not None:
                    tsd_seqs[i] = found
                    break

    domain_classes: List[Optional[int]] = [None] * n
    data_dir = os.path.join(os.path.dirname(__file__), "..", "data",
                            "protein")
    # entry names carry a "{source}|" prefix that keeps TIRPeps first
    paths = [p for fn in ("TIRPeps.lib", "HelitronPeps.lib")
             if os.path.exists(p := os.path.join(data_dir, fn))]
    if paths:
        scanner = DomainScanner.from_fastas(paths, device=dev)
        # 3x the single-lib hit budget: one hit list is shared by BOTH
        # libraries, and abundant HelitronPeps hits must not evict a
        # TIRPeps hit that the source-priority pick would prefer
        hit_sets = scanner.scan(seqs, max_hits_per_cand=48)
        for i, hits in enumerate(hit_sets):
            if not hits:
                continue
            best = min(hits, key=lambda h: (int(h.entry.split("|", 1)[0]),
                                            -h.entry_cov))
            domain_classes[i] = label_to_class(best.entry.rpartition("#")[2])
    return tsd_seqs, domain_classes


def refine_labels(merged: Dict[str, np.ndarray],
                  cfg: PipelineConfig,
                  model_path: Optional[str] = None,
                  genome: Optional[Genome] = None,
                  device=None) -> Dict[str, np.ndarray]:
    """Relabel Unknown/generic entries with the trained SuperfamilyCNN, on
    the genome's device (or `device`).

    Features follow the reference's library-assembly mode (use_TSD 1 with
    the genome supplied, `get_nonRedundant_lib.py:71-76`): located
    termini + genomic-copy TSD block + protein-domain block.  The label is
    restricted to the entry's structural class (DNA -> DNA superfamilies,
    LINE -> non-LTR superfamilies)."""
    from hite_tpu_torch.models.classifier import (
        DNA_SUPERFAMILIES, NONLTR_SUPERFAMILIES, SuperfamilyCNN,
        predict_labels,
    )
    from hite_tpu_torch.models.convert import load_model
    from hite_tpu_torch.models.trainer import build_features, predict_logits

    model_path = model_path or cfg.classify.model_path
    if not (model_path and os.path.exists(model_path)):
        logger.warning("classifier model %s missing; labels unchanged",
                       model_path)
        return merged
    dev = genome.device if genome is not None else resolve_device(device)
    target = [n for n in merged if n.partition("#")[2] in REFINABLE]
    if not target:
        return merged
    model = load_model(SuperfamilyCNN, model_path, dev)
    seqs = [merged[n][:8192] for n in target]
    tsd_seqs, domain_classes = library_feature_evidence(seqs, cfg, genome,
                                                        device=dev)
    X = build_features(seqs, tsd_seqs=tsd_seqs,
                       domain_classes=domain_classes, device=dev)
    logits = predict_logits(model, X)
    restrict_for = {"DNA": DNA_SUPERFAMILIES, "LINE": NONLTR_SUPERFAMILIES}
    labels: Dict[str, str] = {}
    for cls in sorted({n.partition("#")[2] for n in target}):
        grp = [i for i, n in enumerate(target) if n.partition("#")[2] == cls]
        grp_labels = predict_labels(logits[grp],
                                    is_wicker=cfg.classify.is_wicker,
                                    restrict=restrict_for.get(cls))
        for i, lab in zip(grp, grp_labels):
            labels[target[i]] = lab
    out: Dict[str, np.ndarray] = {}
    for n, seq in merged.items():
        if n in labels:
            out[f"{n.partition('#')[0]}#{labels[n]}"] = seq
        else:
            out[n] = seq
    logger.info("library: refined %d labels with the neural classifier",
                len(target))
    return out


def classify_by_homology(
    merged: Dict[str, np.ndarray],
    curated: Dict[str, np.ndarray],
    cfg: PipelineConfig,
    min_cov: float = 0.8,
    device=None,
) -> Dict[str, np.ndarray]:
    """RepeatClassifier-style homology labelling against a classified
    library (`classification/TEClass_parallel.py`): an Unknown/generic
    entry covered >= min_cov of its length by chain hits on one curated
    entry takes that entry's `#Class` label."""
    unknown = [n for n in merged if n.partition("#")[2] in REFINABLE]
    if not unknown or not curated:
        return merged
    cur_names = [n for n in curated if "#" in n]
    pool = [merged[n] for n in unknown] + [curated[n] for n in cur_names]
    hits = _all_pairs_hits(pool, cfg.align, device=device)
    n_t = len(unknown)
    relabel: Dict[str, str] = {}
    for i, name in enumerate(unknown):
        L = len(merged[name])
        best = (0.0, None)
        by_j: Dict[int, int] = {}
        for (j, _qs, _qe, os_, oe, _ns) in hits[i]:
            if j < n_t:           # hit on another test entry
                continue
            by_j[j] = by_j.get(j, 0) + (oe - os_)
        for j, bp in by_j.items():
            frac = min(1.0, bp / max(L, 1))
            if frac > best[0]:
                best = (frac, j)
        if best[1] is not None and best[0] >= min_cov:
            label = cur_names[best[1] - n_t].partition("#")[2]
            if label:
                relabel[name] = label
    if not relabel:
        return merged
    out: Dict[str, np.ndarray] = {}
    for n, seq in merged.items():
        if n in relabel:
            out[f"{n.partition('#')[0]}#{relabel[n]}"] = seq
        else:
            out[n] = seq
    logger.info("library: homology-labelled %d entries from curated lib",
                len(relabel))
    return out
