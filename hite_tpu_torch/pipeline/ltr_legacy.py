"""Legacy LTR path (`--use_FiLTR 0`): LTR_harvest/LTR_FINDER + LTR_retriever
equivalents (counterpart of the JAX package's `pipeline/ltr_legacy.py`).

The reference's legacy path is a different algorithm family from FiLTR
(`main.py:186-242`, `module/Util.py:569-704`): LTRharvest finds maximal
EXACT repeats (seed length >= 30 bp, pair distance 1-15 kb), extends each
to a >= 85% similar LTR pair, and LTR_retriever demands direct structural
evidence — a 4-6 bp TSD and/or the TG...CA motif — for every element (no
ML filters, no frame judge).

1. Exact-repeat seeding: the shared self-join with `run_gap` 2, so
   diagonal k-mer runs merge only while contiguous and every HSP is an
   exact repeat of at least `seed_len`.
2. Extension: each seed opens a window of up to 2 kb on both sides, and
   `ltr.refine_and_filter`'s batched Smith-Waterman pins the LTR pair.
3. LTR_retriever's filters: TSD and/or motif, end-to-end agreement of the
   two LTRs (one more SW launch), and joint evidence for diverged pairs.

Both generators produce `LTRRecord`s, so the stages downstream are shared.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from hite_tpu_torch.config import PipelineConfig
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.ops.selfjoin import selfjoin_scan_packed, selfjoin_sorted
from hite_tpu_torch.ops.terminal import batched_local_align_auto
from hite_tpu_torch.pipeline.candidates import pad_rows, pad_seqs
from hite_tpu_torch.pipeline.coarse import _chunk_grid, chunk_slice
from hite_tpu_torch.pipeline.copies import CopyFinder
from hite_tpu_torch.pipeline.ltr import LTRRecord, LTRResult, refine_and_filter
from hite_tpu_torch.utils.log import logger, stage_timer


def harvest_exact_seeds(
    genome: Genome,
    cfg: PipelineConfig,
    seed_len: int = 20,
    use_masked: bool = True,
) -> List[Tuple[int, int, int, int]]:
    """Maximal exact-repeat seeds (qs, qe, ss, se) in the element window.

    LTRharvest suffix-array semantics: exact repeats >= `seed_len` whose
    start-to-start distance lies in [min_interior, max_interior +
    max_ltr_len], one seed (the longest) per 100 bp (locus, offset) cell.
    Genomes past 2^26 bp run as overlapping chunks."""
    lcfg = cfg.ltr
    acfg = cfg.align
    flat_d, L = genome.device_flat_padded(use_masked)
    Lp = int(flat_d.shape[0])
    max_off = lcfg.max_interior + lcfg.max_ltr_len
    best: dict = {}

    def one_chunk(chunk_d: torch.Tensor, off: int, Cl: int) -> None:
        s_dbin, s_qpos, s_spos, n_pairs_d = selfjoin_sorted(
            chunk_d, k=acfg.kmer_size, window=4, diag_band=32)
        n_pairs = int(n_pairs_d)
        budget = 1 << 20
        need = -(-max(n_pairs, 1) // budget)
        slices = 1 if need <= 1 else 1 << (need - 1).bit_length()
        packed = selfjoin_scan_packed(
            s_dbin, s_qpos, s_spos, n_pairs_d, k=acfg.kmer_size,
            run_gap=2, min_seeds=2, min_hsp_len=seed_len,
            max_hsps=32_768, max_seed_pairs=budget,
            budget_slices=min(slices, 64)).cpu().numpy()
        qs, qe, ss, se = (packed[i].astype(np.int64) for i in range(4))
        valid = packed[4].astype(bool)
        m = valid & (ss < Cl) & (ss > qs)          # forward strand, s right of q
        offd = ss - qs
        m &= (offd >= lcfg.min_interior) & (offd <= max_off)
        for a, b_, c, d in zip(qs[m], qe[m], ss[m], se[m]):
            # one seed per (locus, offset) cell; keep the longest repeat
            # (the suffix array's MAXIMAL-repeat property)
            key = ((off + int(a)) // 100, int(c - a) // 100)
            ln = int(b_ - a)
            cur = best.get(key)
            if cur is None or ln > cur[0]:
                best[key] = (ln, off + int(a), off + int(b_),
                             off + int(c), off + int(d))

    cap = 1 << 26
    if Lp <= cap:
        one_chunk(flat_d, 0, Lp)
    else:
        for c0 in _chunk_grid(L, cap, max_off):
            one_chunk(chunk_slice(flat_d, c0, cap), c0, cap)
    seeds = [(a, b_, c, d) for (_ln, a, b_, c, d) in best.values()]
    seeds.sort()
    return seeds


def _seed_windows(
    seeds: List[Tuple[int, int, int, int]],
    cfg: PipelineConfig,
    ext: int = 0,
) -> List[Tuple[int, int, int, int]]:
    """Extension windows: each exact seed +- `ext` bp on both sides,
    clipped so the two windows never overlap (a closer pair is a tandem,
    which the tandem gate downstream owns).

    ``ext=0`` derives min(2000, cfg.ltr.max_ltr_len), the JAX package's
    deliberate deviation from ltrharvest's `-maxlenltr 7000`
    (`Util.py:666-668`): the window SW is O(width^2) per pair."""
    if ext <= 0:
        ext = min(2000, cfg.ltr.max_ltr_len)
    wins = []
    for (qa, qb, sa, sb) in seeds:
        mid = (qb + sa) // 2
        la = max(0, qa - ext)
        lb = min(qb + ext, mid)
        ra = max(sa - ext, mid)
        rb = sb + ext
        if lb - la >= 2 and rb - ra >= 2:
            wins.append((la, lb, ra, rb))
    return wins


def retriever_filter(
    genome: Genome,
    records: List[LTRRecord],
    boundary_tol: int = 10,
    min_old_identity: float = 0.91,
) -> List[LTRRecord]:
    """LTR_retriever's structural filter stack (`main.py:219-242`,
    `Util.py:697-704`):

    1. TSD and/or TG...CA motif (at most 1 mismatch in the 4 motif bases).
    2. Boundary agreement: the SW alignment of lLTR against rLTR must reach
       within `boundary_tol` bp of all four termini (ltrharvest `-vic 10`).
    3. Pairs below `min_old_identity` must carry BOTH a TSD and the motif.
    """
    if not records:
        return []

    # batched lLTR-vs-rLTR end-to-end alignment (boundary agreement)
    dev = genome.device
    lseqs = [genome.extract(r.lltr_start, r.lltr_end) for r in records]
    rseqs = [genome.extract(r.rltr_start, r.rltr_end) for r in records]
    width = max(max((len(s) for s in lseqs), default=64),
                max((len(s) for s in rseqs), default=64), 64)
    width = 1 << (width - 1).bit_length()
    rows = pad_rows(len(records))
    lmat, _ = pad_seqs(lseqs, width, n_rows=rows)
    rmat, _ = pad_seqs(rseqs, width, n_rows=rows)
    al = batched_local_align_auto(torch.from_numpy(lmat).to(dev),
                                  torch.from_numpy(rmat).to(dev))
    qs, qe = al.qs.cpu().numpy(), al.qe.cpu().numpy()
    ss, se = al.ss.cpu().numpy(), al.se.cpu().numpy()

    kept = []
    n_struct = n_bound = n_div = 0
    for i, r in enumerate(records):
        l2 = genome.extract(r.start, r.start + 2)
        r2 = genome.extract(r.end - 2, r.end)
        # TG...CA with <=1 mismatch across the 4 motif bases
        # (ltrharvest -motif TGCA -motifmis 1)
        mm = 4
        if len(l2) == 2 and len(r2) == 2:
            mm = int(l2[0] != 3) + int(l2[1] != 2) + \
                 int(r2[0] != 1) + int(r2[1] != 0)
        has_motif = mm <= 1
        has_tsd = r.tsd_len > 0
        if not (has_motif or has_tsd):
            n_struct += 1
            continue
        agree = (qs[i] <= boundary_tol and ss[i] <= boundary_tol
                 and qe[i] >= len(lseqs[i]) - boundary_tol
                 and se[i] >= len(rseqs[i]) - boundary_tol)
        if not agree:
            n_bound += 1
            continue
        if r.identity < min_old_identity and not (has_motif and has_tsd):
            n_div += 1
            continue
        kept.append(r)
    if len(kept) < len(records):
        logger.info(
            "ltr.legacy: retriever filter dropped %d/%d "
            "(%d no TSD/motif, %d boundary disagreement, "
            "%d diverged without joint TSD+motif)",
            len(records) - len(kept), len(records), n_struct, n_bound,
            n_div)
    return kept


def run_legacy_ltr_detection(
    genome: Genome,
    cfg: PipelineConfig,
    gindex=None,
) -> LTRResult:
    """Legacy LTR module: harvest seeds -> window SW -> retriever filters,
    then copy counts from the genome-wide join.  No frame judge, CNN,
    recombination or cross-class filters run on this path."""
    with stage_timer("ltr.legacy_seeds"):
        seeds = harvest_exact_seeds(genome, cfg)
    logger.info("ltr.legacy: %d exact-repeat seeds", len(seeds))
    pairs = _seed_windows(seeds, cfg)
    with stage_timer("ltr.legacy_refine"):
        records = refine_and_filter(genome, pairs, cfg)
    records = retriever_filter(genome, records)
    logger.info("ltr.legacy: %d intact LTR records", len(records))

    if records and gindex is not None:
        finder = CopyFinder(gindex)
        copies = finder.find_copies(
            [genome.extract(r.start, r.end) for r in records],
            min_coverage=0.8, max_copies=cfg.msa.max_copies)
        for r, c in zip(records, copies):
            r.copy_count = max(1, len(c))
    return LTRResult(records=records)
