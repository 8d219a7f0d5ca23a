"""TIR transposon detection module (counterpart of the JAX `pipeline/tir.py`).

Re-implements `module/judge_TIR_transposons.py` (SURVEY.md §3.3): from
coarse repeat candidates, (1) gate by tandem content, (2) find TSD +
terminal-inverted-repeat structure and snap boundaries to the TSD
(`search_confident_tir_v4` `Util.py:7734-7845` + itrsearch on 40bp ends
`Util.py:6556-6575`), (3) cluster into families, (4) iterate dynamic
boundary adjustment over the family MSA (3 rounds of `flank_region_align_v5`
— here `pipeline.boundary_adjust`), with the TIR-specific judge scoring
terminal 5-mer inverted-complementarity and per-row TSD votes across +-4bp
boundary shifts (`judge_boundary_v5` TIR branch `Util.py:9356-9411`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hite_tpu_torch.config import PipelineConfig
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.io.fasta import encode_seq, revcomp as np_revcomp
from hite_tpu_torch.ops.tandem import tandem_fraction
from hite_tpu_torch.ops.terminal import find_terminal_repeat
from hite_tpu_torch.ops.tsd import tsd_search
from hite_tpu_torch.pipeline.boundary_adjust import FamilyAnalysis
from hite_tpu_torch.pipeline.candidates import (
    bucket_iter, pad_rows, pad_seqs,
)
from hite_tpu_torch.pipeline.copies import GenomeIndex
from hite_tpu_torch.pipeline.verify import (
    ModuleResult, verify_families,
)
from hite_tpu_torch.utils.log import count, logger, stage_timer


def tsd_votes_host(M: np.ndarray, bl: int, br: int,
                   sizes: Sequence[int] = (2, 3, 4, 5, 6, 8, 9, 10, 11),
                   ) -> Dict[int, int]:
    """Per-size TSD vote counts over the family matrix at [bl, br)."""
    R, L = M.shape
    votes: Dict[int, int] = {}
    for s in sizes:
        if bl - s < 0 or br + s > L:
            votes[s] = 0
            continue
        l = M[:, bl - s : bl]
        r = M[:, br : br + s]
        ok = (l < 4).all(1) & (r < 4).all(1)
        mm = (l != r).sum(1)
        tol = 1 if s >= 8 else 0
        votes[s] = int((ok & (mm <= tol)).sum())
    return votes


_TIR_SIZES = (2, 3, 4, 5, 6, 8, 9, 10, 11)


def make_tir_judge(plant: bool):
    """Judge for the boundary-adjust engine: TIR termini + TSD votes.

    All +-4bp shift combos are scored in a handful of vectorized host
    window ops (the windows are ~100 elements: a device dispatch per op
    would cost more than the whole judge)."""

    def judge(fa: FamilyAnalysis) -> Tuple[bool, int, int]:
        M = fa.M
        present = int(((M < 4).any(1)).sum())
        cons = fa.cons
        L = len(cons)
        d = np.arange(-4, 5)
        bls = fa.left_pos + d               # [9] candidate left boundaries
        brs = fa.right_pos + d              # [9] candidate right boundaries

        # terminal 5-mers for every shift (invalid shifts masked)
        bl_ok = bls >= 5
        br_ok = brs <= L - 5
        t5 = np.stack([cons[b : b + 5] if 0 <= b and b + 5 <= L
                       else np.full(5, 4, np.uint8) for b in bls])
        t3 = np.stack([cons[b - 5 : b] if b - 5 >= 0 and b <= L
                       else np.full(5, 4, np.uint8) for b in brs])
        bl_ok &= (t5 < 4).all(1)
        br_ok &= (t3 < 4).all(1)
        # gap code 5 appears in consensus columns; sanitize to N before the
        # complement table lookup (invalid rows are masked via br_ok anyway)
        t3rc = np.stack([np_revcomp(np.minimum(row, 4)) for row in t3])
        ham = (t5[:, None, :] != t3rc[None, :, :]).sum(-1)     # [9, 9]
        pair_ok = (bl_ok[:, None] & br_ok[None, :]
                   & ((brs[None, :] - bls[:, None]) >= 30) & (ham <= 1))
        if not pair_ok.any():
            return False, fa.left_pos, fa.right_pos

        # per-size TSD votes for all shift combos at once: [9, 9] per size
        R_, Lm = M.shape
        vbest = np.full((9, 9), -1, np.int32)
        for s in _TIR_SIZES:
            need = max(2, int(np.ceil((0.5 if s == 2 else 0.3) * present)))
            lw = np.stack([M[:, b - s : b] if b - s >= 0
                           else np.full((R_, s), 4, M.dtype) for b in bls])
            rw = np.stack([M[:, b : b + s] if b + s <= Lm
                           else np.full((R_, s), 4, M.dtype) for b in brs])
            l_ok = (lw < 4).all(-1)                            # [9, R]
            r_ok = (rw < 4).all(-1)
            mm = (lw[:, None] != rw[None, :]).sum(-1)          # [9, 9, R]
            tol = 1 if s >= 8 else 0
            votes = ((l_ok[:, None] & r_ok[None, :]) & (mm <= tol)).sum(-1)
            vbest = np.where(votes >= need, np.maximum(vbest, votes), vbest)

        pair_ok &= vbest >= 0
        if not pair_ok.any():
            return False, fa.left_pos, fa.right_pos
        shift_cost = np.abs(d)[:, None] + np.abs(d)[None, :]
        # lexicographic (ham, -vbest, |dl|+|dr|) minimum over valid combos
        key = (ham.astype(np.int64) * 1_000_000
               - vbest.astype(np.int64) * 1_000 + shift_cost)
        key = np.where(pair_ok, key, np.iinfo(np.int64).max)
        i, j = np.unravel_index(np.argmin(key), key.shape)
        bl, br = int(bls[i]), int(brs[j])
        # LTR-signature rejection at the judge (the structural gate's
        # TG...CA skip, Util.py:7822, applied to the FAMILY consensus):
        # a full LTR element with a genuine TSD and a chance <=1-mismatch
        # inverted terminal 5-mer otherwise passes as a TIR family, its
        # loci get masked before the LTR stage, and the real LTR family
        # is lost (measured: two of four planted LTR families annexed by
        # the TIR module on the hard bench substrate).
        if br - bl >= 400 and cons[bl] == 3 and cons[bl + 1] == 2 \
                and cons[br - 2] == 1 and cons[br - 1] == 0:
            return False, fa.left_pos, fa.right_pos
        return True, bl, br

    return judge


def _short_tir_signature(sub: np.ndarray, tsd_size: int, plant: bool) -> bool:
    """Superfamily-specific short-TIR acceptance (`get_short_tir_contigs`,
    `Util.py:7297-7334`): hAT (TSD 8, <4kb), Mutator (TSD 9-11), plant
    CACTA (CACTA/CACTG start + TSD 2-3), CCC terminals — all requiring
    revcomp-identical terminal 5-mers."""
    if len(sub) < 20:
        return False
    t5 = sub[:5]
    t3 = sub[-5:]
    if (t5 >= 4).any() or (t3 >= 4).any():
        return False
    if not (t5 == np_revcomp(t3)).all():
        return False
    if tsd_size == 8 and len(sub) < 4000:
        return True                                   # hAT
    if 9 <= tsd_size <= 11:
        return True                                   # Mutator
    cacta = encode_seq("CACT")
    if plant and tsd_size in (2, 3) and (sub[:4] == cacta).all() \
            and sub[4] in (0, 2):
        return True                                   # CACTA / CACTG
    ccc = encode_seq("CCC")
    ggg = encode_seq("GGG")
    if not plant and (sub[:3] == ccc).all() and (sub[-3:] == ggg).all():
        return True                                   # CCC terminals
    return False


def structural_gate(
    genome: Genome,
    intervals: np.ndarray,
    cfg: PipelineConfig,
) -> Tuple[np.ndarray, np.ndarray]:
    """TSD + terminal-inverted-repeat structural gate on raw candidates.

    Returns (adjusted_intervals [M, 2], keep_index [M]) — candidates whose
    flanks carry a TSD whose implied element has an ITR.
    """
    tcfg = cfg.tsd
    flank = tcfg.search_radius       # context to search TSDs in
    W = flank + 20
    kept: List[int] = []
    adjusted: List[Tuple[int, int]] = []

    lens = intervals[:, 1] - intervals[:, 0]
    for width, idxs in bucket_iter(range(len(intervals)), lens + 2 * flank):
        seqs = [genome.extract(intervals[i, 0], intervals[i, 1], flank)
                for i in idxs]
        n_rows = pad_rows(len(seqs))
        blank = np.full(W, 4, np.uint8)
        flanks_l = np.stack([s[:W] if len(s) >= 2 * W else blank
                             for s in seqs] + [blank] * (n_rows - len(seqs)))
        flanks_r = np.stack([s[-W:] if len(s) >= 2 * W else blank
                             for s in seqs] + [blank] * (n_rows - len(seqs)))
        hit = tsd_search(torch.from_numpy(flanks_l).to(genome.device),
                         torch.from_numpy(flanks_r).to(genome.device),
                         sizes=tcfg.sizes, plant=cfg.plant,
                         boundary_l=flank, boundary_r=20)
        found = hit.found.cpu().numpy()
        dist = hit.dist.cpu().numpy()
        lp = hit.left_pos.cpu().numpy()
        rp = hit.right_pos.cpu().numpy()

        # element extraction for the ITR check: try the best few TSD choices
        # per candidate (ranked by boundary distance, larger size on ties —
        # the reference validates its top combos with itrsearch similarly)
        el_seqs: List[np.ndarray] = []
        el_info: List[Tuple[int, int, int, int, int]] = []  # (cand, abs_s, abs_e, rank, tsd)
        for bi, i in enumerate(idxs):
            if not found[bi].any():
                continue
            order = [s for s in sorted(
                range(len(tcfg.sizes)),
                key=lambda s: (dist[bi, s], -tcfg.sizes[s])) if found[bi, s]]
            seq = seqs[bi]
            L = len(seq)
            # genome.extract clips at contig edges; actual left flank length:
            ci, local = genome.contig_of(np.array([intervals[i, 0]]))
            lf = min(flank, int(local[0]))
            for rank, s_i in enumerate(order[:3]):
                size = tcfg.sizes[s_i]
                el_s = int(lp[bi, s_i]) + size
                el_e = L - W + int(rp[bi, s_i])
                if el_e - el_s < cfg.library.min_te_len:
                    continue
                sub = seq[el_s:el_e]
                # LTR-signature rejection: TG...CA termini (Util.py:7822)
                if len(sub) > 4 and sub[0] == 3 and sub[1] == 2 \
                        and sub[-2] == 1 and sub[-1] == 0:
                    continue
                el_seqs.append(sub)
                abs_s = int(intervals[i, 0]) - lf + el_s
                el_info.append((i, abs_s, abs_s + (el_e - el_s), rank, size))
        if not el_seqs:
            continue
        mat, elens = pad_seqs(el_seqs, n_rows=pad_rows(len(el_seqs)))
        tr = find_terminal_repeat(
            torch.from_numpy(mat).to(genome.device),
            torch.from_numpy(elens).to(genome.device), inverted=True,
            window=cfg.terminal.end_window,
            min_identity=cfg.terminal.itr_identity,
            min_len=cfg.terminal.itr_min_len)
        ok = tr.found.cpu().numpy()
        best_by_cand: Dict[int, Tuple[int, int, int]] = {}
        for bi, (i, a_s, a_e, rank, _size) in enumerate(el_info):
            if ok[bi] and (i not in best_by_cand or rank < best_by_cand[i][0]):
                best_by_cand[i] = (rank, a_s, a_e)
        # superfamily short-TIR rescue (get_short_tir_contigs,
        # Util.py:7297-7334): candidates whose general ITR scan failed but
        # whose TSD size + terminal structure match hAT / Mutator / plant
        # CACTA / CCC-terminal signatures, requiring revcomp-identical
        # terminal 5-mers
        for bi, (i, a_s, a_e, rank, size) in enumerate(el_info):
            if i in best_by_cand or rank != 0:
                continue
            if _short_tir_signature(el_seqs[bi], size, cfg.plant):
                best_by_cand[i] = (rank, a_s, a_e)
        for i, (_rank, a_s, a_e) in best_by_cand.items():
            kept.append(i)
            adjusted.append((a_s, a_e))
    return (np.array(adjusted, np.int64).reshape(-1, 2),
            np.array(kept, np.int64))


def gate_tir(
    genome: Genome,
    coarse_intervals: np.ndarray,
    cfg: PipelineConfig,
) -> np.ndarray:
    """TIR gating phase: tandem filter + TSD/ITR structural gate."""
    if len(coarse_intervals) == 0:
        return np.zeros((0, 2), np.int64)
    with stage_timer("tir.tandem_filter"):
        seqs = [genome.extract(s, e) for s, e in coarse_intervals]
        mat, lens = pad_seqs(seqs, n_rows=pad_rows(len(seqs)))
        frac = tandem_fraction(torch.from_numpy(mat).to(genome.device),
                               torch.from_numpy(lens).to(genome.device)
                               ).cpu().numpy()
        frac = frac[: len(coarse_intervals)]
        coarse_intervals = coarse_intervals[frac < cfg.tandem.tandem_region_cutoff]

    with stage_timer("tir.structural_gate"):
        gated, kept = structural_gate(genome, coarse_intervals, cfg)
    logger.info("tir: %d/%d candidates pass TSD+ITR gate",
                len(gated), len(coarse_intervals))
    count("tir.gated", len(gated))
    return gated


def run_tir_detection(
    genome: Genome,
    coarse_intervals: np.ndarray,
    cfg: PipelineConfig,
    gindex: Optional[GenomeIndex] = None,
    gated: Optional[np.ndarray] = None,
    plan=None,
    rep_copy_sets=None,
    mesh=None,
) -> ModuleResult:
    """Full TIR module: gate -> cluster -> iterate boundary adjustment."""
    if gated is None:
        gated = gate_tir(genome, coarse_intervals, cfg)
    return verify_families(
        genome, gated, cfg, make_tir_judge(cfg.plant),
        min_copies=cfg.msa.min_copy_tir, stage="tir", gindex=gindex,
        plan=plan, rep_copy_sets=rep_copy_sets, mesh=mesh)
