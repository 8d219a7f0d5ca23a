"""Deep LTR filtering: both-ends frame matrices, the frame rule, the CNN
and FiLTR's cross-class filters (counterpart of the JAX package's
`pipeline/ltr_deep.py`).

FiLTR's high-copy LTR judgement (`bin/FiLTR-main/src/LTR_filter.py:27-209`):
for each intact-LTR candidate the full-length copies are fetched and their
+-100 bp boundary frames projected onto the candidate's own frame; flank
homology must BREAK at the element boundaries (the frame rule,
`judge_ltr_from_both_ends_frame`, src/Util.py:10477) and the flanks must
not cluster (LTR_filter.py:72-103); the dual-branch CNN
(`models.ltr_filter.LTRFilterCNN`) confirms among rule-True high-copy
candidates, and a rule verdict of False vetoes
(`alter_deep_learning_results`, src/Util.py:10711-10757).

The frame pipeline (projection, flank-homogeneity statistics, rule) runs
as batched tensor functions over [B, R, 2W] record buckets on the
genome's device, their record axis sharded over a `mesh` when one is
given (the JAX package's `_frame_judge_batch_sharded`; row-independent,
so bit-identical); `make_training_frames` turns labeled intervals into
the CNN's training inputs.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hite_tpu_torch.config import PipelineConfig
from hite_tpu_torch.device import resolve_device
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.io.fasta import revcomp as np_revcomp
from hite_tpu_torch.models.features import (
    frame_image, kmer_frequencies, one_hot_float,
)
from hite_tpu_torch.models.ltr_filter import LTRFilterCNN, kmer_channels
from hite_tpu_torch.ops.boundary import (
    adaptive_threshold, column_stats, search_boundary,
)
from hite_tpu_torch.ops.msa import project_to_center
from hite_tpu_torch.parallel.mesh import run_sharded
from hite_tpu_torch.pipeline.candidates import pad_rows, pad_seqs
from hite_tpu_torch.pipeline.copies import CopyFinder, GenomeIndex
from hite_tpu_torch.pipeline.ltr import LTRRecord
from hite_tpu_torch.utils.log import logger, stage_timer

FRAME_FLANK = 100   # FiLTR both-ends frame width (.matrix files)
FRAME_CORE = 100    # bp of element interior kept on each side


def _frame_inputs(
    genome: Genome,
    rec: LTRRecord,
    copies,
    max_rows: int = 100,
) -> Optional[Tuple[np.ndarray, list]]:
    """(center [2W], per-copy row list) for the both-ends frame, or None."""
    width = FRAME_FLANK + FRAME_CORE
    center_l = genome.extract(rec.start, rec.start + FRAME_CORE, FRAME_FLANK)
    center_r = genome.extract(rec.end - FRAME_CORE, rec.end, FRAME_FLANK)
    if len(center_l) < width or len(center_r) < width:
        return None
    center = np.concatenate([center_l[:width], center_r[-width:]])

    rows = []
    for h in copies[:max_rows]:
        seq_l = genome.extract(h.start, h.start + FRAME_CORE, FRAME_FLANK)
        seq_r = genome.extract(h.end - FRAME_CORE, h.end, FRAME_FLANK)
        if h.strand == 1:
            seq_l, seq_r = np_revcomp(seq_r), np_revcomp(seq_l)
        if len(seq_l) < width or len(seq_r) < width:
            continue
        rows.append(np.concatenate([seq_l[:width], seq_r[-width:]]))
    if len(rows) < 1:
        return None
    return center.astype(np.uint8), rows


def both_ends_frame(genome: Genome, rec: LTRRecord, copies,
                    max_rows: int = 100) -> Optional[np.ndarray]:
    """uint8 [R, 2 (FLANK + CORE)] left | right boundary frames of each
    copy, projected onto the record's own frame on the genome's device
    (FiLTR's `.matrix` files, `get_both_ends_frame`, src/Util.py:1401-1497),
    or None without copy context."""
    inputs = _frame_inputs(genome, rec, copies, max_rows)
    if inputs is None:
        return None
    center, rows = inputs
    dev = genome.device
    mat, lens = pad_seqs(rows, 2 * (FRAME_FLANK + FRAME_CORE),
                         n_rows=pad_rows(len(rows)))
    return project_to_center(torch.from_numpy(center).to(dev),
                             torch.from_numpy(mat).to(dev),
                             torch.from_numpy(lens).to(dev)).cpu().numpy()


def _rule_core(M: torch.Tensor) -> torch.Tensor:
    """Frame rule of [..., R, 2W] matrices -> bool [...]: homology breaks
    at both boundaries (`judge_both_ends_frame`, src/Util.py:10696);
    all-N padding rows are masked."""
    row_ok = (M < 4).any(-1)
    thr = adaptive_threshold(row_ok.sum(-1))
    stats = column_stats(M, thr, row_ok=row_ok)
    width = FRAME_FLANK + FRAME_CORE
    left = search_boundary(stats.homo, FRAME_FLANK, side="left", radius=30)
    right = search_boundary(stats.homo, 2 * width - FRAME_FLANK,
                            side="right", radius=30)
    return left.found & right.found


def rule_judge_frame(M: np.ndarray, device=None) -> bool:
    """True when flank homology breaks at both boundaries of one frame
    matrix [R, 2W] (`judge_ltr_from_both_ends_frame` ->
    `judge_both_ends_frame`, src/Util.py:10477/10696): a real LTR's copies
    come from different loci, so columns OUTSIDE the element must not be
    homologous, while columns inside are.  `_rule_core` on `device` (None
    = the card)."""
    dev = resolve_device(device)
    return bool(_rule_core(torch.from_numpy(np.asarray(M)).to(dev)))


def _flank_homo_core(M: torch.Tensor) -> torch.Tensor:
    """Flank-homogeneity statistics int32 [..., 5] of [..., R, 2W] frames:
    (rows, left-homo rows, right-homo rows, joined-homo rows, joined
    non-homo rows).  A row is "homo" when another row is homologous to it
    — membership in a > 1-size cluster of the reference's cd-hit
    single-linkage clustering (sort_frame, FiLTR utils/data_util.py:2792+):
    aligned-column identity of the projected rows, per side >= 20 columns
    of overlap at >= 0.8 (cd-hit -c .8 -A 20), joined >= 0.95 mutual
    coverage at >= 0.95 (-c .95 -aS/aL .95).  The counts are exact in
    float32 (and in TF32: the operands are 0/1)."""
    width = FRAME_FLANK
    row_ok = (M < 4).sum(-1) > 0                            # [..., R]
    R = M.shape[-2]
    eye = torch.eye(R, dtype=torch.bool, device=M.device)

    def side(S, min_ov_abs, min_id, mutual):
        oh = one_hot_float(S, 4)                             # N/gap -> 0
        valid = (S < 4).float()
        matches = torch.einsum("...ilc,...jlc->...ij", oh, oh)
        overlap = torch.einsum("...il,...jl->...ij", valid, valid)
        ident = matches / overlap.clamp(min=1.0)
        nvalid = valid.sum(-1)
        min_ov = torch.clamp(
            mutual * torch.minimum(nvalid[..., :, None], nvalid[..., None, :]),
            min=min_ov_abs)
        homo = (overlap >= min_ov) & (ident >= min_id) & ~eye
        homo &= row_ok[..., :, None] & row_ok[..., None, :]
        return homo.any(-1)

    left_h = side(M[..., :width], 20.0, 0.8, 0.0)
    right_h = side(M[..., -width:], 20.0, 0.8, 0.0)
    joined = torch.cat([M[..., :width], M[..., -width:]], dim=-1)
    joined_h = side(joined, 50.0, 0.95, 0.95)
    return torch.stack([row_ok.sum(-1), (left_h & row_ok).sum(-1),
                        (right_h & row_ok).sum(-1),
                        (joined_h & row_ok).sum(-1),
                        (row_ok & ~joined_h).sum(-1)], -1).to(torch.int32)


def _frame_judge_core(centers: torch.Tensor, mats: torch.Tensor,
                      lens: torch.Tensor):
    """The frame pipeline of a record bucket: project the copies onto each
    center frame, flank-homogeneity statistics and the rule verdict.

    centers uint8 [B, 2W], mats uint8 [B, R, 2W], lens int32 [B, R] ->
    (M uint8 [B, R, 2W], stats int32 [B, 5], rule bool [B])."""
    M = project_to_center(centers, mats, lens)
    return M, _flank_homo_core(M), _rule_core(M)


def _homogeneity_ok(n: int, lh: int, rh: int, jh: int, jr: int) -> bool:
    """FiLTR's flank-homogeneity cluster filters (LTR_filter.py:72-103) on
    `_flank_homo_core`'s counts: (a) per side (`sort_matrix_dir`), a real
    LTR's copies come from different loci, so each side's flank rows must
    be mostly mutually NON-homologous (a homologous fraction >= 0.8 with
    < 20 rows, 0.9 otherwise, is the truncated-terminal / repeat-region
    signature); (b) joined (`filter_ltr_by_flanking_cluster`), rows whose
    concatenated flanks are near-identical to another row's must stay
    below the rest (an LTR inside a mobile higher-order repeat).  One
    frame row is too few (the single-copy gate re-admits structured
    ones)."""
    if n <= 1:
        return False
    thr = 0.8 if n < 20 else 0.9
    return lh / n < thr and rh / n < thr and jh < jr


def flank_homogeneity_ok(M: np.ndarray, device=None) -> bool:
    """FiLTR's flank-homogeneity cluster filters on one frame matrix
    [R, 2W]: `_homogeneity_ok` of its `_flank_homo_core` counts, on
    `device` (None = the card)."""
    dev = resolve_device(device)
    stats = _flank_homo_core(torch.from_numpy(np.asarray(M)).to(dev))
    return _homogeneity_ok(*(int(x) for x in stats.cpu()))


def single_copy_gate(
    genome: Genome,
    records: Sequence[LTRRecord],
    copy_counts: Sequence[int],
    cfg: PipelineConfig,
) -> List[bool]:
    """FiLTR single-copy filter (`filter_single_copy_ltr`,
    src/Util.py:5955+, driven at LTR_filter.py:702-726): an element with
    <= 1 full-length copies survives only when it has TSD structure AND a
    >= 95%-intact LTR protein in its internal region; an intact OTHER-class
    TE protein (TIR/Helitron transposase: the BLOSUM62 confirm of the SW
    kernel's protein mode) inside disqualifies it outright.

    LTRPeps.lib is a missing blob upstream; a user copy activates via
    HITE_TPU_LIBRARY_DIR.  Without it the protein half runs on the RT
    motif grammar (`domain.rt_motif_present`)."""
    from hite_tpu_torch.pipeline.domain import (
        DomainScanner, rescue_by_domain, rt_motif_present,
    )

    singles = [i for i, c in enumerate(copy_counts) if c <= 1]
    keep = [True] * len(records)
    if not singles:
        return keep

    dev = genome.device
    data_dir = os.path.join(os.path.dirname(__file__), "..", "data",
                            "protein")
    lib_dir = os.environ.get("HITE_TPU_LIBRARY_DIR", data_dir)
    ltr_pep = os.path.join(lib_dir, "LTRPeps.lib")
    internals = [genome.extract(records[i].lltr_end, records[i].rltr_start)
                 for i in singles]

    if os.path.exists(ltr_pep):
        has_ltr_protein = rescue_by_domain(
            internals, DomainScanner.from_fasta(ltr_pep, device=dev))
    else:
        has_ltr_protein = rt_motif_present(internals, device=dev)
    has_other_protein = np.zeros(len(singles), bool)
    for other in ("TIRPeps.lib", "HelitronPeps.lib"):
        path = os.path.join(data_dir, other)
        if os.path.exists(path):
            has_other_protein |= rescue_by_domain(
                internals, DomainScanner.from_fasta(path, device=dev))

    dropped = 0
    for si, i in enumerate(singles):
        r = records[i]
        if has_other_protein[si]:
            keep[i] = False
            dropped += 1
            continue
        # structure = a 4-6 bp TSD (refine_and_filter snapped rec.tsd_len
        # from the reference's +-4 bp end-window search)
        if not (r.tsd_len > 0 and bool(has_ltr_protein[si])):
            keep[i] = False
            dropped += 1
    if dropped:
        logger.info("ltr.single_copy: dropped %d/%d single-copy records",
                    dropped, len(singles))
    return keep


def cnn_inputs(M: np.ndarray, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(image float32 [100, L, 3], k-mer channels float32 [16, 16, 2]) of a
    frame matrix, computed on `device` (None = the card): the frame image
    and the 3-/4-mer frequencies of the matrix's bases (padded to a pow2
    length as the JAX package pads them; the padding is masked)."""
    dev = resolve_device(device)
    img = frame_image(torch.from_numpy(M).to(dev), n_rows=100)
    flat = M[M < 4]
    if len(flat) < 32:
        flat = np.zeros(64, np.uint8)
    n_true = flat.shape[0]
    P = 1 << (n_true - 1).bit_length()
    if P > n_true:
        flat = np.concatenate([flat, np.full(P - n_true, 4, np.uint8)])
    seq = torch.from_numpy(flat[None, :]).to(dev)
    lens = torch.tensor([n_true], device=dev)
    km = kmer_channels(kmer_frequencies(seq, lens, 3),
                       kmer_frequencies(seq, lens, 4))[0]
    return img.cpu().numpy(), km.cpu().numpy()


def deep_filter_records(
    genome: Genome,
    records: Sequence[LTRRecord],
    cfg: PipelineConfig,
    gindex: Optional[GenomeIndex] = None,
    cnn_model: Optional[LTRFilterCNN] = None,
    low_copy_threshold: int = 5,
    mesh=None,
) -> List[LTRRecord]:
    """Filter intact-LTR records with the frame rule (+ the CNN when
    `cnn_model`, an `LTRFilterCNN` on the genome's device as
    `models.convert.load_model` returns it, is given), on the genome's
    device.  The JAX package takes the flax parameter tree instead.

    Merge semantics (alter_deep_learning_results): rule False vetoes; the
    CNN only confirms among rule-True candidates with more than
    `low_copy_threshold` copies; fewer-copy candidates are judged by the
    rule alone, like the reference.  With `mesh` (`parallel.mesh.Mesh`)
    each bucket's record axis is padded to a multiple of the mesh size
    and sharded over it."""
    dev = genome.device
    gindex = gindex or GenomeIndex(genome, cfg.align)
    finder = CopyFinder(gindex)
    model = cnn_model

    kept: List[LTRRecord] = []
    kept_copies: List[int] = []
    width2 = 2 * (FRAME_FLANK + FRAME_CORE)
    with stage_timer("ltr.deep_filter"):
        copy_sets = finder.find_copies(
            [genome.extract(r.start, r.end) for r in records],
            min_coverage=0.8, max_copies=cfg.msa.max_copies)

        # bucket records by frame row count; each bucket of <= 16 records
        # runs the frame pipeline as one batch
        buckets: Dict[int, List[Tuple[int, np.ndarray, list]]] = {}
        for i, (rec, copies) in enumerate(zip(records, copy_sets)):
            inputs = (_frame_inputs(genome, rec, copies)
                      if len(copies) > 1 else None)
            if inputs is None:
                # too little copy context for the frame filters: multi-copy
                # records without frames pass (the reference's
                # not-found-boundary fallback); single-copy ones defer to
                # the structure + protein gate below
                kept.append(records[i])
                kept_copies.append(len(copies))
                continue
            center, rows = inputs
            buckets.setdefault(pad_rows(len(rows)), []).append(
                (i, center, rows))

        cnn_batch: List[Tuple[int, np.ndarray]] = []  # (rec idx, M)
        for rb, items in sorted(buckets.items()):
            B = 16
            for b0 in range(0, len(items), B):
                sub = items[b0 : b0 + B]
                Bp = max(1, 1 << (len(sub) - 1).bit_length())
                if mesh is not None:
                    Bp = -(-Bp // mesh.size) * mesh.size
                centers = np.full((Bp, width2), 4, np.uint8)
                mats = np.full((Bp, rb, width2), 4, np.uint8)
                lens = np.zeros((Bp, rb), np.int32)
                for bi, (_i, center, rows) in enumerate(sub):
                    centers[bi] = center
                    m, l = pad_seqs(rows, width2, n_rows=rb)
                    mats[bi] = m
                    lens[bi] = l
                if mesh is not None:
                    judged = run_sharded(mesh, _frame_judge_core, centers,
                                         mats, lens, device=dev)
                else:
                    judged = _frame_judge_core(
                        torch.from_numpy(centers).to(dev),
                        torch.from_numpy(mats).to(dev),
                        torch.from_numpy(lens).to(dev))
                Ms, stats, rules = (t.cpu().numpy() for t in judged)
                for bi, (i, _c, _r) in enumerate(sub):
                    if not (_homogeneity_ok(*(int(x) for x in stats[bi]))
                            and rules[bi]):
                        continue
                    if model is not None and \
                            len(copy_sets[i]) > low_copy_threshold:
                        cnn_batch.append((i, Ms[bi]))
                    else:
                        rec = records[i]
                        rec.copy_count = max(rec.copy_count,
                                             len(copy_sets[i]))
                        kept.append(rec)
                        kept_copies.append(len(copy_sets[i]))

        if cnn_batch:   # one CNN forward for every high-copy rule-True record
            imgs, kms = zip(*[cnn_inputs(M, dev) for _i, M in cnn_batch])
            with torch.no_grad():
                logits = model(torch.from_numpy(np.stack(imgs)).to(dev),
                               torch.from_numpy(np.stack(kms)).to(dev)
                               ).cpu().numpy()
            e = np.exp(logits - logits.max(axis=1, keepdims=True))
            probs = (e / e.sum(axis=1, keepdims=True))[:, 1]
            for (i, _M), p in zip(cnn_batch, probs):
                if p >= cfg.ltr.deep_threshold:
                    rec = records[i]
                    rec.copy_count = max(rec.copy_count, len(copy_sets[i]))
                    kept.append(rec)
                    kept_copies.append(len(copy_sets[i]))

        # restore input order (buckets interleave records)
        order = {id(r): i for i, r in enumerate(records)}
        pairs = sorted(zip(kept, kept_copies), key=lambda p: order[id(p[0])])
        kept = [p[0] for p in pairs]
        kept_copies = [p[1] for p in pairs]

        # FiLTR single-copy gate: <= 1 full-length copies need TSD structure
        # + intact LTR protein (and no other-class TE protein inside)
        mask = single_copy_gate(genome, kept, kept_copies, cfg)
        kept = [r for r, m in zip(kept, mask) if m]
    logger.info("ltr.deep_filter: %d/%d records kept", len(kept), len(records))
    return kept


def cross_class_filter(
    genome: Genome,
    records: Sequence[LTRRecord],
    cfg: PipelineConfig,
    gindex: Optional[GenomeIndex] = None,
    mesh=None,
) -> Tuple[List[LTRRecord], Dict[str, List[np.ndarray]]]:
    """FiLTR's TIR/Helitron/SINE cross-class filters (`LTR_filter.py:175-200`):
    an intact-LTR record whose LEFT TERMINAL is itself a structurally
    confirmed TIR / Helitron / SINE element is a repeat pair masquerading
    as an LTR; it leaves the LTR set and its terminal is re-routed to that
    module's library (the reference's `confident_*_from_ltr.fa`).

    Every terminal's copies come from ONE genome-wide join and ONE batched
    family analysis (its family axis sharded over `mesh` when given);
    each class judge re-reads those analyses.  Returns
    (kept records, {"tir"|"helitron"|"non_ltr": [terminal codes]})."""
    from hite_tpu_torch.ops.terminal import find_terminal_repeat
    from hite_tpu_torch.pipeline.boundary_adjust import (
        adjust_candidate, analyze_families_batched,
    )
    from hite_tpu_torch.pipeline.helitron import make_helitron_judge
    from hite_tpu_torch.pipeline.non_ltr import make_nonltr_judge
    from hite_tpu_torch.pipeline.tir import make_tir_judge

    pools: Dict[str, List[np.ndarray]] = {}
    if not records:
        return [], pools
    dev = genome.device
    term_iv = np.array([[r.lltr_start, r.lltr_end] for r in records],
                       np.int64)
    routed: Dict[int, str] = {}

    gindex = gindex or GenomeIndex(genome, cfg.align)
    finder = CopyFinder(gindex)

    with stage_timer("ltr.cross_class"):
        all_copy_sets = finder.find_copies(
            [genome.extract(int(s), int(e)) for s, e in term_iv],
            min_coverage=0.9, max_copies=cfg.msa.max_copies)
        all_batch = [((int(term_iv[i, 0]), int(term_iv[i, 1])), copies)
                     for i, copies in enumerate(all_copy_sets)]
        all_analyses = analyze_families_batched(genome, all_batch, cfg.msa,
                                                mesh=mesh)

    def rejudge(idxs: List[int], judge, min_copies: int) -> List[int]:
        """Terminals whose full-length copy frames pass the class judge
        (one round of the boundary engine, as the reference runs
        judge_boundary_v5 once on each terminal's frames)."""
        hits = []
        for i in idxs:
            interval, copies = all_batch[i]
            res = adjust_candidate(genome, interval, copies, cfg.msa,
                                   judge, min_copies,
                                   precomputed=all_analyses[i])
            if res.accepted:
                hits.append((i, res.consensus))
        return hits

    with stage_timer("ltr.cross_class"):
        # TIR: copy frames pass the TSD-vote judge AND the adjusted
        # consensus carries a terminal inverted repeat (itrsearch step)
        tir_hits = rejudge(list(range(len(records))),
                           make_tir_judge(cfg.plant), 2)
        if tir_hits:
            mats, lens = pad_seqs([c for _, c in tir_hits],
                                  n_rows=pad_rows(len(tir_hits)))
            tr = find_terminal_repeat(
                torch.from_numpy(mats).to(dev), torch.from_numpy(lens).to(dev),
                inverted=True, window=cfg.terminal.end_window,
                min_identity=cfg.terminal.itr_identity,
                min_len=cfg.terminal.itr_min_len)
            ok = tr.found.cpu().numpy()
            for bi, (i, _c) in enumerate(tir_hits):
                if ok[bi]:
                    routed.setdefault(int(i), "tir")

        todo = [i for i in range(len(records)) if i not in routed]
        # Helitron: copy frames pass the ATC-head/CTRRT-tail judge
        for i, _c in rejudge(todo, make_helitron_judge(), 2):
            routed.setdefault(int(i), "helitron")

        todo = [i for i in range(len(records)) if i not in routed]
        # SINE: length window + the non-LTR tail/TSD judge on copy frames
        sine_todo = [i for i in todo
                     if cfg.non_ltr.sine_min
                     <= term_iv[i, 1] - term_iv[i, 0] <= cfg.non_ltr.sine_max]
        for i, _c in rejudge(sine_todo, make_nonltr_judge(cfg), 2):
            routed.setdefault(int(i), "non_ltr")

    kept = [r for i, r in enumerate(records) if i not in routed]
    for i, cls in sorted(routed.items()):
        pools.setdefault(cls, []).append(
            genome.extract(int(term_iv[i, 0]), int(term_iv[i, 1])))
    if routed:
        logger.info("ltr.cross_class: re-routed %d/%d records (%s)",
                    len(routed), len(records),
                    {c: len(v) for c, v in pools.items()})
    return kept, pools


def make_training_frames(
    genome: Genome,
    positives: Sequence[LTRRecord],
    negatives: Sequence[Tuple[int, int]],
    cfg: PipelineConfig,
    gindex: Optional[GenomeIndex] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The CNN's training data on the genome's device: (images float32
    [N, 100, 400, 3], k-mer planes float32 [N, 16, 16, 2], labels int32
    [N], 1 = a real LTR element) of the positive records and the negative
    intervals that have a both-ends frame, positives first (the
    reference's Reproduction/ scripts build samples the same way from
    curated and rejected candidates)."""
    dev = genome.device
    gindex = gindex or GenomeIndex(genome, cfg.align)
    finder = CopyFinder(gindex)
    imgs, kms, labels = [], [], []
    for label, items in ((1, [(r.start, r.end) for r in positives]),
                         (0, list(negatives))):
        if not items:
            continue
        copy_sets = finder.find_copies(
            [genome.extract(int(s), int(e)) for s, e in items],
            min_coverage=0.8, max_copies=cfg.msa.max_copies)
        for (s, e), copies in zip(items, copy_sets):
            rec = LTRRecord(start=int(s), end=int(e), lltr_start=int(s),
                            lltr_end=int(s), rltr_start=int(e),
                            rltr_end=int(e), identity=1.0, insert_time=0.0)
            M = both_ends_frame(genome, rec, copies)
            if M is None:
                continue
            img, km = cnn_inputs(M, dev)
            imgs.append(img)
            kms.append(km)
            labels.append(label)
    if not imgs:
        return (np.zeros((0, 100, 2 * (FRAME_FLANK + FRAME_CORE), 3)),
                np.zeros((0, 16, 16, 2)), np.zeros(0, np.int32))
    return np.stack(imgs), np.stack(kms), np.array(labels, np.int32)
