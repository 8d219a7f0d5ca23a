"""Library evaluation: BM_HiTE, BM_EDTA and BM_RM2 (counterpart of the JAX
package's `pipeline/benchmark.py`).

Re-implements `module/lib_evaluation.py`: annotate the genome with both the
curated ("gold") library and the test library, then score base-level
overlap: TP = genome bases covered by both, FP = test-only, FN =
gold-only; sensitivity, precision and F1 = 2TP/(2TP+FP+FN)
(`lib_evaluation.py:157-168`).  `family_level_metrics` is the
RepeatModeler2 family count, with each fragment's divergence from the
batched Smith-Waterman (the hand-written kernel on the card).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from hite_tpu_torch.config import PipelineConfig
from hite_tpu_torch.device import resolve_device
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.ops.terminal import batched_local_align_auto
from hite_tpu_torch.pipeline.annotate import annotate_genome
from hite_tpu_torch.pipeline.candidates import pad_seqs
from hite_tpu_torch.pipeline.copies import GenomeIndex
from hite_tpu_torch.pipeline.libcluster import _all_pairs_hits
from hite_tpu_torch.utils import intervals as iv
from hite_tpu_torch.utils.log import logger


# Species -> curated Repbase-derived library filename, as shipped by the
# reference (`module/benchmarking.py:176-206`).  The libraries are Repbase
# data and are NOT vendored; callers point `library_dir` (or the
# HITE_TPU_LIBRARY_DIR environment variable) at a directory holding them.
SPECIES_LIBS: Dict[str, str] = {
    "dmel": "drorep.ref",
    "rice": "oryrep.ref",
    "cb": "cbrrep.ref",
    "zebrafish": "zebrep.no_ltr.ref",
    "maize": "maize.ref",
    "ath": "athrep.ref",
    "xentr": "xentr.ref",
    "chicken": "chicken.ref",
    "zebrafinch": "zebrafinch.ref",
    "mouse": "mouse.ref",
    "human": "human.ref",
    "test": "test.ref",
}


def species_library_path(species: str,
                         library_dir: Optional[str] = None) -> Optional[str]:
    """Resolve a --species name to its curated library FASTA path.

    Returns None when the species is unknown or the file is absent; direct
    file paths pass through unchanged (reference benchmarking.py registry).
    """
    if os.path.exists(species):
        return species
    fname = SPECIES_LIBS.get(species)
    if fname is None:
        return None
    for base in filter(None, (library_dir,
                              os.environ.get("HITE_TPU_LIBRARY_DIR"))):
        cand = os.path.join(base, fname)
        if os.path.exists(cand):
            return cand
    return None


def _hits_to_flat_intervals(genome: Genome, hits) -> np.ndarray:
    out = []
    name_to_start = {n: int(s) for n, s in zip(genome.names, genome.starts)}
    for h in hits:
        base = name_to_start[h.contig]
        out.append((base + h.start - 1, base + h.end))
    return np.array(out, np.int64).reshape(-1, 2)


def _annotated_intervals(genome, test_lib, gold_lib, cfg, gindex):
    """Merged flat intervals annotated by the test and the gold library."""
    gindex = gindex or GenomeIndex(genome, cfg.align)
    test_hits = annotate_genome(genome, test_lib, cfg, gindex, rescore=False)
    gold_hits = annotate_genome(genome, gold_lib, cfg, gindex, rescore=False)
    return (iv.merge(_hits_to_flat_intervals(genome, test_hits)),
            iv.merge(_hits_to_flat_intervals(genome, gold_hits)))


def _true_positive_bp(gold_iv: np.ndarray, test_iv: np.ndarray) -> int:
    """Gold bases covered by the test annotation."""
    if not (len(gold_iv) and len(test_iv)):
        return 0
    cov = iv.coverage_fraction(gold_iv, test_iv)
    return int(np.sum(cov * (gold_iv[:, 1] - gold_iv[:, 0])))


def evaluate_library(
    genome: Genome,
    test_lib: Dict[str, np.ndarray],
    gold_lib: Dict[str, np.ndarray],
    cfg: PipelineConfig,
    gindex: Optional[GenomeIndex] = None,
) -> Dict[str, float]:
    """Base-level TP/FP/FN/sensitivity/precision/F1 of test vs gold."""
    test_iv, gold_iv = _annotated_intervals(genome, test_lib, gold_lib, cfg,
                                            gindex)
    gold_bp = iv.total_length(gold_iv)
    test_bp = iv.total_length(test_iv)
    tp = _true_positive_bp(gold_iv, test_iv)
    fn = gold_bp - tp
    fp = test_bp - tp
    sens = tp / gold_bp if gold_bp else 0.0
    prec = tp / test_bp if test_bp else 0.0
    f1 = 2 * tp / (2 * tp + fp + fn) if (2 * tp + fp + fn) else 0.0
    metrics = dict(TP=tp, FP=fp, FN=fn, sensitivity=sens, precision=prec, F1=f1)

    # per-coverage-threshold metrics (reference prints 0.8/0.95/0.99,
    # lib_evaluation.py:79-90 + README.md:380-390): an interval counts
    # only when reciprocally covered >= t
    at_cov = {}
    for t in (0.8, 0.95, 0.99):
        if len(gold_iv) and len(test_iv):
            gcov = iv.coverage_fraction(gold_iv, test_iv)
            tcov = iv.coverage_fraction(test_iv, gold_iv)
            tp_t = int(np.sum((gcov >= t) * (gold_iv[:, 1] - gold_iv[:, 0])))
            tp_test = int(np.sum((tcov >= t) *
                                 (test_iv[:, 1] - test_iv[:, 0])))
        else:
            tp_t = tp_test = 0
        fn_t = gold_bp - tp_t
        fp_t = test_bp - tp_test
        at_cov[str(t)] = dict(
            TP=tp_t, FP=fp_t, FN=fn_t,
            sensitivity=tp_t / gold_bp if gold_bp else 0.0,
            precision=tp_test / test_bp if test_bp else 0.0,
            F1=(2 * tp_t / (2 * tp_t + fp_t + fn_t)
                if (2 * tp_t + fp_t + fn_t) else 0.0))
    metrics["at_coverage"] = at_cov
    # base-level bp accounting, NOT the reference's 100 kb-segment binning
    # (module/lib_evaluation.py:37-53): exact rather than segment-quantized,
    # so not directly comparable to the paper's numbers
    metrics["protocol"] = "base_level_bp (reference bins into 100kb segments)"
    logger.info("BM_HiTE: %s", metrics)
    return metrics


def evaluate_edta(
    genome: Genome,
    test_lib: Dict[str, np.ndarray],
    gold_lib: Dict[str, np.ndarray],
    cfg: PipelineConfig,
    gindex: Optional[GenomeIndex] = None,
) -> Dict[str, float]:
    """BM_EDTA: base-level confusion matrix including true negatives.

    EDTA's `lib-test.pl -cat Total` protocol as the reference drives it
    (`module/benchmarking.py:79-119`): TP = bases masked by both
    annotations, FN = gold-only, FP = test-only, TN = the rest of the
    genome; sensitivity, specificity, accuracy, precision, FDR and F1.
    """
    test_iv, gold_iv = _annotated_intervals(genome, test_lib, gold_lib, cfg,
                                            gindex)
    genome_bp = genome.size
    gold_bp = iv.total_length(gold_iv)
    test_bp = iv.total_length(test_iv)
    tp = _true_positive_bp(gold_iv, test_iv)
    fn = gold_bp - tp
    fp = test_bp - tp
    tn = max(0, genome_bp - gold_bp - fp)
    metrics = dict(
        TP=tp, FN=fn, FP=fp, TN=tn,
        sensitivity=tp / (tp + fn) if (tp + fn) else 0.0,
        specificity=tn / (tn + fp) if (tn + fp) else 0.0,
        accuracy=(tp + tn) / genome_bp if genome_bp else 0.0,
        precision=tp / (tp + fp) if (tp + fp) else 0.0,
        FDR=fp / (tp + fp) if (tp + fp) else 0.0,
        F1=2 * tp / (2 * tp + fp + fn) if (2 * tp + fp + fn) else 0.0,
    )
    logger.info("BM_EDTA: %s", metrics)
    return metrics


def family_level_metrics(
    test_lib: Dict[str, np.ndarray],
    gold_lib: Dict[str, np.ndarray],
    cfg: PipelineConfig,
    perfect_cov: float = 0.95,
    good_cov: float = 0.95,
    present_cov: float = 0.8,
    perfect_div: float = 0.05,
    present_div: float = 0.20,
    min_test_cov: float = 0.1,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, int]:
    """BM_RM2 family-level counts: the RepeatModeler2 protocol as
    `bin/get_family_summary_paper.sh` computes it from a RepeatMasker run
    of the TEST library masked with the curated families
    (`module/benchmarking.py:44-52`).

    Alignment fragments between test entries and curated families carry
    (gold coverage, test coverage, divergence); then per curated family:
      perfect — ONE fragment with gold & test coverage > 0.95 at div < 5%
      good    — fragments with div < 5% merged on the curated sequence
                cover > 0.95, minus perfect
      present — fragments with div < 20% merged cover > 0.8 (a superset
                that includes perfect/good)
    Fragments with test coverage <= 0.1 are dropped.  The fragments are
    the all-pairs copy join's chains and their divergence comes from SW
    (at most 4096 bases of each side, 64 fragments a launch), on `device`
    (None = the card)."""
    dev = resolve_device(device)
    gold_names = list(gold_lib.keys())
    test_names = list(test_lib.keys())
    ng = len(gold_names)
    pool = [gold_lib[n] for n in gold_names] + [test_lib[n] for n in test_names]
    lens = np.array([len(s) for s in pool])
    metrics = dict(perfect=0, good=0, present=0, total=ng, missing=ng)
    if ng == 0 or not test_names:
        logger.info("BM_RM2: %s", metrics)
        return metrics
    hits = _all_pairs_hits(pool, cfg.align, device=dev)

    # fragment list: (gold idx, gold span, test idx) from test->gold chains
    frag_meta: List[Tuple[int, int, int, int]] = []
    pairs: List[Tuple[np.ndarray, np.ndarray]] = []
    for ti in range(ng, len(pool)):
        for (j, _qs, _qe, os_, oe, _ns) in hits[ti]:
            if j >= ng or oe - os_ < 30:
                continue
            frag_meta.append((j, os_, oe, ti))
            pairs.append((pool[ti], pool[j][os_:oe]))

    # per-fragment SW: identity + aligned test span (clipped to 4096)
    test_cov = np.zeros(len(pairs))
    div = np.ones(len(pairs))
    B = 64
    order = sorted(range(len(pairs)),
                   key=lambda i: max(len(pairs[i][0]), len(pairs[i][1])))
    for b0 in range(0, len(order), B):
        sel = order[b0 : b0 + B]
        a_seqs = [pairs[i][0][:4096] for i in sel]
        b_seqs = [pairs[i][1][:4096] for i in sel]
        width = max(max((len(s) for s in a_seqs), default=64),
                    max((len(s) for s in b_seqs), default=64), 64)
        width = 1 << (width - 1).bit_length()
        rows = 1 << (len(sel) - 1).bit_length()
        a_mat, _ = pad_seqs(a_seqs, width, n_rows=rows)
        b_mat, _ = pad_seqs(b_seqs, width, n_rows=rows)
        al = batched_local_align_auto(torch.from_numpy(a_mat).to(dev),
                                      torch.from_numpy(b_mat).to(dev))
        qs, qe = al.qs.cpu().numpy(), al.qe.cpu().numpy()
        matches, alen = al.matches.cpu().numpy(), al.alen.cpu().numpy()
        for bi, i in enumerate(sel):
            t_len = max(len(pairs[i][0]), 1)
            test_cov[i] = (qe[bi] - qs[bi]) / t_len
            div[i] = 1.0 - matches[bi] / max(int(alen[bi]), 1)

    perfect_set = set()
    good_perfect_set = set()
    present_set = set()
    for g in range(ng):
        spans95: List[Tuple[int, int]] = []
        spans80: List[Tuple[int, int]] = []
        for fi, (gj, os_, oe, _ti) in enumerate(frag_meta):
            if gj != g or test_cov[fi] <= min_test_cov:
                continue
            gold_cov = (oe - os_) / max(lens[g], 1)
            if div[fi] < perfect_div:
                spans95.append((os_, oe))
                if gold_cov > perfect_cov and test_cov[fi] > perfect_cov:
                    perfect_set.add(g)
            if div[fi] < present_div:
                spans80.append((os_, oe))
        if spans95 and iv.total_length(
                iv.merge(np.array(spans95))) / lens[g] > good_cov:
            good_perfect_set.add(g)
        if spans80 and iv.total_length(
                iv.merge(np.array(spans80))) / lens[g] > present_cov:
            present_set.add(g)

    metrics = dict(
        perfect=len(perfect_set),
        good=len(good_perfect_set - perfect_set),
        present=len(present_set),
        total=ng,
        missing=ng - len(present_set | good_perfect_set | perfect_set),
    )
    logger.info("BM_RM2: %s", metrics)
    return metrics
