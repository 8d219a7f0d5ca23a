"""LTR retrotransposon detection, FiLTR path (counterpart of the JAX
package's `pipeline/ltr.py`).

1. Candidates: LtrDetector's k-mer distance-to-next-occurrence profile is
   the whole-genome self-join of the coarse stage (`ops.selfjoin`): seed
   pairs whose offset lies in the element-size window chain (host FMEA)
   into LTR pairs; genomes past 2^26 bp run as overlapping chunks.
2. Terminal refinement: one batched Smith-Waterman of the lLTR and rLTR
   windows (the hand-written kernel on the card) pins the LTR boundaries
   and their identity; an alignment running through both flanks marks a
   pair interior to a larger repeat.
3. A tandem filter on the terminals, a 4-6 bp TSD snap, TG...CA or TSD
   evidence for weak pairs, and best-identity overlap dedup.
4. FiLTR's precision pre-filters (recombination products, records nesting
   another) and copy counts from the genome-wide join.
5. `classify_ltr_records`: the superfamily CNN restricted to the LTR
   superfamilies, overridden by pol domain order.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hite_tpu_torch.config import PipelineConfig
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.ops.chain import chain_hsps, chain_hsps_host
from hite_tpu_torch.ops.encode import kmer_codes
from hite_tpu_torch.ops.kmer import build_index
from hite_tpu_torch.ops.seedext import pair_hsps
from hite_tpu_torch.ops.selfjoin import selfjoin_scan_packed, selfjoin_sorted
from hite_tpu_torch.ops.tandem import tandem_fraction
from hite_tpu_torch.ops.terminal import batched_local_align_auto
from hite_tpu_torch.pipeline.candidates import pad_rows, pad_seqs
from hite_tpu_torch.pipeline.coarse import _chunk_grid, chunk_slice
from hite_tpu_torch.pipeline.copies import CopyFinder, GenomeIndex
from hite_tpu_torch.utils.log import count, logger, stage_timer

# Genomes whose padded length passes this run the LTR-pair self-join as
# overlapping chunks of this size (the JAX package's literal `cap`)
LTR_CHUNK_BP = 1 << 26


@dataclass
class LTRRecord:
    """One intact LTR element (flat genome coords, SCN-equivalent record)."""

    start: int
    end: int
    lltr_start: int
    lltr_end: int
    rltr_start: int
    rltr_end: int
    identity: float
    insert_time: float          # years, T = K / (2 miu)
    tsd_len: int = 0
    copy_count: int = 1
    superfamily: str = "unknown"   # set by classify_ltr_records


@dataclass
class LTRResult:
    records: List[LTRRecord] = field(default_factory=list)
    # terminal sequences re-routed by the FiLTR cross-class filters
    # ({"tir"|"helitron"|"non_ltr": [codes]}, ltr_deep.cross_class_filter)
    cross_class: Dict[str, List[np.ndarray]] = field(default_factory=dict)

    def terminal_seqs(self, genome: Genome) -> List[np.ndarray]:
        return [genome.extract(r.lltr_start, r.lltr_end) for r in self.records]

    def internal_seqs(self, genome: Genome) -> List[np.ndarray]:
        return [genome.extract(r.lltr_end, r.rltr_start) for r in self.records]


def jukes_cantor_time(identity: float, miu: float) -> float:
    """JC69 insertion time from LTR-pair identity (FiLTR src/Util.py:4174)."""
    d = max(0.0, 1.0 - identity)
    if d >= 0.745:
        return 5e8
    k = -0.75 * math.log(1 - 4 * d / 3)
    return k / (2 * miu)


def ltr_pair_candidates(
    genome: Genome,
    cfg: PipelineConfig,
    seg_len: int = 131_072,
) -> List[Tuple[int, int, int, int]]:
    """Self-join LTR-pair candidates: (lltr_s, lltr_e, rltr_s, rltr_e) on
    the masked genome.

    One self-join (window 4, diagonal band 32) and its HSP scan over a
    seed-pair budget of 2^20 a slice (up to 64 slices), then forward
    HSPs whose offset lies in the element-size window chain on the host.
    Genomes past LTR_CHUNK_BP run as overlapping chunks (halo = the largest
    element span) with 10 bp-rounded dedup, like the reference's 10 Mb
    chromosome chunking (bin/FiLTR-main/main.py:135-156).  `seg_len` is
    kept for the JAX package's signature; the self-join does not read it.
    """
    lcfg = cfg.ltr
    acfg = cfg.align
    flat_d, L = genome.device_flat_padded(use_masked=True)
    Lp = int(flat_d.shape[0])
    halo = 2 * lcfg.max_ltr_len + lcfg.max_interior
    out: List[Tuple[int, int, int, int]] = []
    seen: set = set()

    def one_chunk(chunk_d: torch.Tensor, off: int, Cl: int) -> None:
        s_dbin, s_qpos, s_spos, n_pairs_d = selfjoin_sorted(
            chunk_d, k=acfg.kmer_size, window=4, diag_band=32)
        n_pairs = int(n_pairs_d)
        budget = 1 << 20
        need = -(-max(n_pairs, 1) // budget)
        slices = 1 if need <= 1 else 1 << (need - 1).bit_length()
        slices = min(slices, 64)
        packed = selfjoin_scan_packed(
            s_dbin, s_qpos, s_spos, n_pairs_d, k=acfg.kmer_size,
            run_gap=96, min_seeds=4, min_hsp_len=30, max_hsps=32_768,
            max_seed_pairs=budget, budget_slices=slices).cpu().numpy()
        qs, qe, ss, se = (packed[i].astype(np.int64) for i in range(4))
        valid = packed[4].astype(bool)
        # forward-strand HSPs whose offset lies in the element-size window
        m = valid & (ss < Cl) & (ss > qs)
        offd = ss - qs
        m &= (offd >= lcfg.min_ltr_len + lcfg.min_interior - 400)
        m &= offd <= halo
        if not m.any():
            return
        ch = chain_hsps_host(qs[m], qe[m], ss[m], se[m],
                             extend_threshold=200,
                             min_len=lcfg.min_ltr_len)
        for a, b_, c, d in ch:
            gap = c - b_                 # interior length
            ltr_len = min(b_ - a, d - c)
            if not (lcfg.min_ltr_len <= ltr_len <= lcfg.max_ltr_len):
                continue
            if not (lcfg.min_interior - 200 <= gap <= lcfg.max_interior):
                continue
            if b_ > c:                   # overlapping pair -> tandem
                continue
            # 10bp-rounded dedup (reference get_integer_pos; also folds
            # chunk-overlap duplicates)
            key = tuple(int(x) // 10 for x in
                        (off + a, off + b_, off + c, off + d))
            if key in seen:
                continue
            seen.add(key)
            out.append((off + int(a), off + int(b_), off + int(c),
                        off + int(d)))

    cap = LTR_CHUNK_BP
    if Lp <= cap:
        one_chunk(flat_d, 0, Lp)
    else:
        with stage_timer("ltr.chunked_candidates"):
            for c0 in _chunk_grid(L, cap, halo):
                count("ltr.candidates.chunks")
                one_chunk(chunk_slice(flat_d, c0, cap), c0, cap)
    return out


def refine_and_filter(
    genome: Genome,
    pairs: List[Tuple[int, int, int, int]],
    cfg: PipelineConfig,
) -> List[LTRRecord]:
    """Terminal-window alignment refinement + structural filters."""
    if not pairs:
        return []
    lcfg = cfg.ltr
    F = 50  # window flank
    dev = genome.device

    # window per pair: the LTR +- F bp, padded to one pow2 width
    lwins: List[np.ndarray] = []
    rwins: List[np.ndarray] = []
    metas: List[Tuple[int, int]] = []
    for (la, lb, ra, rb) in pairs:
        lwins.append(genome.extract(la, lb, F))
        rwins.append(genome.extract(ra, rb, F))
        lf_l = la - max(0, la - F)
        lf_r = ra - max(0, ra - F)
        metas.append((la - lf_l, ra - lf_r))  # window start coords

    width = max(max(len(w) for w in lwins), max(len(w) for w in rwins))
    width = 1 << (width - 1).bit_length()
    n_rows = pad_rows(len(pairs))
    lmat, _ = pad_seqs(lwins, width, n_rows=n_rows)
    rmat, _ = pad_seqs(rwins, width, n_rows=n_rows)

    al = batched_local_align_auto(torch.from_numpy(lmat).to(dev),
                                  torch.from_numpy(rmat).to(dev))
    _score, aqs, aqe, ass_, ase, matches, alen = (t.cpu().numpy()
                                                  for t in al)

    kept: List[Tuple[LTRRecord, int]] = []
    for i, (la, lb, ra, rb) in enumerate(pairs):
        if alen[i] < lcfg.min_ltr_len:
            continue
        ident = matches[i] / max(alen[i], 1)
        if ident < lcfg.min_pair_identity:
            continue
        lw0, rw0 = metas[i]
        # false positive: the terminal alignment continues through both
        # flanks on either side (pair interior to a larger repeat)
        ext_left = aqs[i] <= 5 and ass_[i] <= 5
        ext_right = (aqe[i] >= len(lwins[i]) - 5
                     and ase[i] >= len(rwins[i]) - 5)
        if ext_left and ext_right:
            continue
        # refined boundaries in genome coords
        n_la = lw0 + int(aqs[i])
        n_lb = lw0 + int(aqe[i])
        n_ra = rw0 + int(ass_[i])
        n_rb = rw0 + int(ase[i])
        if n_ra - n_lb < lcfg.min_interior - 2 * F:
            continue
        rec = LTRRecord(
            start=n_la, end=n_rb,
            lltr_start=n_la, lltr_end=n_lb,
            rltr_start=n_ra, rltr_end=n_rb,
            identity=float(ident),
            insert_time=jukes_cantor_time(float(ident), lcfg.miu),
        )
        kept.append((rec, i))

    # tandem filter on terminals
    if kept:
        tseqs = [genome.extract(r.lltr_start, r.lltr_end) for r, _ in kept]
        tmat, tlens = pad_seqs(tseqs, n_rows=pad_rows(len(tseqs)))
        tf = tandem_fraction(torch.from_numpy(tmat).to(dev),
                             torch.from_numpy(tlens).to(dev)).cpu().numpy()
        kept = [kr for kr, frac in zip(kept, tf[: len(kept)]) if frac < 0.5]

    # TSD (4-6bp) snap: search +-4bp boundary shifts for a flanking TSD and
    # snap the element ends to it; TG...CA / TSD evidence is required for
    # weak-identity pairs
    for rec, _i in kept:
        best = None
        for dl in range(-4, 5):
            for dr in range(-4, 5):
                s0 = rec.start + dl
                e0 = rec.end + dr
                for s in (6, 5, 4):
                    lflank = genome.extract(s0 - s, s0)
                    rflank = genome.extract(e0, e0 + s)
                    if len(lflank) == s and len(rflank) == s and \
                            (lflank == rflank).all() and (lflank < 4).all():
                        score = (-s, abs(dl) + abs(dr))
                        if best is None or score < best[0]:
                            best = (score, dl, dr, s)
        if best is not None:
            _sc, dl, dr, s = best
            rec.start += dl
            rec.lltr_start += dl
            rec.end += dr
            rec.rltr_end += dr
            rec.tsd_len = s
        seq_l = genome.extract(rec.start, rec.start + 2)
        seq_r = genome.extract(rec.end - 2, rec.end)
        has_tgca = (len(seq_l) == 2 and len(seq_r) == 2
                    and seq_l[0] == 3 and seq_l[1] == 2
                    and seq_r[0] == 1 and seq_r[1] == 0)
        if rec.identity < 0.9 and not (has_tgca or rec.tsd_len):
            rec.identity = -1.0  # mark for removal
    records = [r for r, _ in kept if r.identity >= 0]

    # overlap dedup: keep the best-identity record per locus
    records.sort(key=lambda r: -r.identity)
    final: List[LTRRecord] = []
    for r in records:
        dup = any(min(r.end, f.end) - max(r.start, f.start)
                  > 0.5 * (r.end - r.start) for f in final)
        if not dup:
            final.append(r)
    return final


def remove_dirty_records(records: List[LTRRecord]) -> List[LTRRecord]:
    """Drop LTR records whose internal region fully contains another
    candidate element (`remove_dirty_LTR`, FiLTR src/Util.py:7140-7180):
    such "LTRs" are recombination products of two nested insertions."""
    if len(records) < 2:
        return records
    order = sorted(range(len(records)), key=lambda i: records[i].start)
    kept: List[LTRRecord] = []
    for oi, i in enumerate(order):
        cur = records[i]
        dirty = False
        for j in order[oi + 1:]:
            nxt = records[j]
            if nxt.start > cur.rltr_end:
                break
            if (cur.lltr_end < nxt.start < cur.rltr_start
                    and cur.lltr_end < nxt.end < cur.rltr_start):
                dirty = True
                break
        if not dirty:
            kept.append(cur)
    if len(kept) < len(records):
        logger.info("ltr.dirty: dropped %d records containing another LTR",
                    len(records) - len(kept))
    return kept


def recomb_chain_cov(term: torch.Tensor, internal: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Chained-coverage fraction float32 [B] of each terminal row of
    uint8 [B, wt] inside its own internal region row of [B, wi]: seed the
    terminal's k-mers against the internal region's index, HSPs, device
    FMEA chains, longest chain / the terminal's valid bases (the JAX
    package vmaps this over rows)."""
    idx = build_index(internal, k)
    h = pair_hsps(kmer_codes(term, k), idx, k=k, stride=1, max_hits=8,
                  diag_band=16, run_gap=64, min_seeds=3, min_hsp_len=21,
                  max_hsps=512)
    ch = chain_hsps(h, extend_threshold=50, max_chains=64, min_len=21)
    qlen = (term < 4).sum(1).clamp(min=1)
    cov = torch.where(ch.valid, ch.qe - ch.qs, 0).amax(1)
    return cov.to(torch.float32) / qlen.to(torch.float32)


def recombination_filter(
    genome: Genome,
    records: List[LTRRecord],
    cfg: PipelineConfig,
    coverage: float = 0.95,
) -> List[LTRRecord]:
    """Drop records whose LEFT terminal aligns over >= coverage of its
    length inside the element's own internal region.

    Reference `get_recombination_ltr` (FiLTR src/Util.py:7099-7138, driven
    at src/LTR_filter.py:543-577): blastn left-LTR vs internal, any hit of
    alignment_length/query_len >= 0.95 marks a recombination product.
    Here the blastn is the seed -> HSP -> chain engine, in batches of 8
    rows per shape bucket (pow2 terminal width >= 64, pow2 internal width
    >= 256), the JAX package's buckets."""
    if not records:
        return records
    k = cfg.align.kmer_size
    dev = genome.device

    buckets: Dict[Tuple[int, int], List[int]] = {}
    terms: List[np.ndarray] = []
    ints: List[np.ndarray] = []
    for i, r in enumerate(records):
        t = genome.extract(r.lltr_start, r.lltr_end)
        s = genome.extract(r.lltr_end, r.rltr_start)
        terms.append(t)
        ints.append(s)
        if len(t) < 2 * k or len(s) < 2 * k:
            continue
        key = (1 << max(6, (len(t) - 1).bit_length()),
               1 << max(8, (len(s) - 1).bit_length()))
        buckets.setdefault(key, []).append(i)

    drop = np.zeros(len(records), bool)
    B = 8
    for (wt, wi), idxs in buckets.items():
        for b0 in range(0, len(idxs), B):
            sel = idxs[b0 : b0 + B]
            tmat, _ = pad_seqs([terms[i] for i in sel], wt, n_rows=B)
            smat, _ = pad_seqs([ints[i] for i in sel], wi, n_rows=B)
            cov = recomb_chain_cov(torch.from_numpy(tmat).to(dev),
                                   torch.from_numpy(smat).to(dev),
                                   k).cpu().numpy()
            for bi, i in enumerate(sel):
                if cov[bi] >= coverage:
                    drop[i] = True
    kept = [r for i, r in enumerate(records) if not drop[i]]
    if drop.any():
        logger.info("ltr.recombination: dropped %d/%d records",
                    int(drop.sum()), len(records))
    return kept


def run_ltr_detection(
    genome: Genome,
    cfg: PipelineConfig,
    gindex: Optional[GenomeIndex] = None,
    seg_len: int = 131_072,
) -> LTRResult:
    """Full LTR module on the (optionally pre-masked) genome."""
    with stage_timer("ltr.candidates"):
        pairs = ltr_pair_candidates(genome, cfg, seg_len=seg_len)
    logger.info("ltr: %d raw LTR-pair candidates", len(pairs))
    with stage_timer("ltr.refine"):
        records = refine_and_filter(genome, pairs, cfg)
    logger.info("ltr: %d intact LTR records after refinement", len(records))
    # FiLTR precision pre-filters (step 1 of LTR_filter.py: recombination
    # products, then records nesting another candidate)
    with stage_timer("ltr.precision_prefilters"):
        records = recombination_filter(genome, records, cfg)
        records = remove_dirty_records(records)

    # copy counts from the genome-wide join
    if records and gindex is not None:
        copies = CopyFinder(gindex).find_copies(
            [genome.extract(r.start, r.end) for r in records],
            min_coverage=0.8, max_copies=cfg.msa.max_copies)
        for r, c in zip(records, copies):
            r.copy_count = max(1, len(c))
    return LTRResult(records=records)


def classify_ltr_records(
    genome: Genome,
    records: List[LTRRecord],
    cfg: PipelineConfig,
    model_path: Optional[str] = None,
) -> List[LTRRecord]:
    """Assign LTR superfamilies to intact elements with the trained CNN,
    on the genome's device.

    Reference: NeuralTE classification of intact_LTR.fa (no-TSD model,
    `judge_LTR_transposons.py:251-264`); predictions are restricted to the
    LTR superfamilies, as NeuralTE's LTR vocabulary is by construction.
    Features: the first 8192 bp, the record's exact LTR length as the
    terminal, and its TSD block; pol domain order (Copia INT before RT,
    Gypsy after) overrides the CNN's call.
    """
    from hite_tpu_torch.models import bundled_model_path
    from hite_tpu_torch.models.classifier import (
        LTR_SUPERFAMILIES, WICKER_TO_RM, SuperfamilyCNN, predict_labels,
    )
    from hite_tpu_torch.models.convert import load_model
    from hite_tpu_torch.models.trainer import build_features, predict_logits
    from hite_tpu_torch.pipeline.domain import ltr_domain_order

    if not records:
        return records
    model_path = model_path or cfg.classify.model_path or bundled_model_path(
        "superfamily_cnn.pkl")
    if not (model_path and os.path.exists(model_path)):
        logger.warning("ltr classifier model missing; superfamilies unknown")
        return records
    dev = genome.device
    model = load_model(SuperfamilyCNN, model_path, dev)
    seqs = [genome.extract(r.start, r.end)[:8192] for r in records]
    term_lens = np.array([r.lltr_end - r.lltr_start for r in records],
                         np.int32)
    tsd_seqs = []
    for r in records:
        if r.tsd_len > 0:
            tsd = genome.extract(r.start - r.tsd_len, r.start)
            tsd_seqs.append(tsd if len(tsd) == r.tsd_len else None)
        else:
            tsd_seqs.append(None)
    X = build_features(seqs, tsd_seqs=tsd_seqs, term_lens=term_lens,
                       device=dev)
    labels = predict_labels(predict_logits(model, X),
                            is_wicker=cfg.classify.is_wicker,
                            restrict=LTR_SUPERFAMILIES)
    internals = [genome.extract(r.lltr_end, r.rltr_start)[:8192]
                 for r in records]
    order = ltr_domain_order(internals, device=dev)
    for r, lab, o in zip(records, labels, order):
        if o:
            lab = ("Copia", "Gypsy")[o - 1]
            if not cfg.classify.is_wicker:
                lab = WICKER_TO_RM[lab]
        r.superfamily = lab
    return records
