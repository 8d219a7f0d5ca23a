"""Helitron detection module (counterpart of the JAX `pipeline/helitron.py`).

Re-implements `module/judge_Helitron_transposons.py` (SURVEY.md §2.A):
coarse candidates are scanned in both orientations with the LCV terminal
banks (HelitronScanner scanHead/scanTail -> pairends -> draw, replaced by
`ops.lcv`), paired head+tail hits excise helitron candidates, then the
shared verification engine iterates MSA boundary adjustment with the
Helitron judge (`judge_boundary_v6` `Util.py:9821-10159`): the consensus
must carry an 'ATC'-context 5' head within its first bases and a
CTAGT/CTAAT/CTGGT/CTGAT 3' tail, and Helitrons need only >=2 copies.

`cfg.helitron.use_eahelitron` (off by default) adds the EAHelitron
structure gate (`ops.eahelitron`) and unions its spans with the LCV gate's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from hite_tpu_torch.config import PipelineConfig
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.io.fasta import encode_seq, revcomp as np_revcomp
from hite_tpu_torch.ops.lcv import default_banks, lcv_scores
from hite_tpu_torch.ops.tandem import tandem_fraction
from hite_tpu_torch.pipeline.boundary_adjust import FamilyAnalysis
from hite_tpu_torch.pipeline.candidates import bucket_iter, pad_rows, pad_seqs
from hite_tpu_torch.pipeline.copies import GenomeIndex
from hite_tpu_torch.pipeline.verify import ModuleResult, verify_families
from hite_tpu_torch.utils import intervals as iv
from hite_tpu_torch.utils.log import count, logger, stage_timer

TAIL_MOTIFS = [encode_seq(m) for m in ("CTAGT", "CTAAT", "CTGGT", "CTGAT")]
HEAD_MOTIF = encode_seq("ATC")


def _motif_starts(cons: np.ndarray, motif: np.ndarray) -> np.ndarray:
    """Bool [L]: motif match starting at each position (sliding window)."""
    n = len(motif)
    L = len(cons)
    out = np.zeros(L, bool)
    if L >= n:
        w = np.lib.stride_tricks.sliding_window_view(cons, n)
        out[: L - n + 1] = (w == motif).all(1)
    return out


def make_helitron_judge():
    """Judge: homology boundaries + ATC head / CTRRT tail motifs, over
    precomputed sliding-window motif hits for every +-5 bp shift (host
    numpy: the windows are ~10 bp)."""

    def judge(fa: FamilyAnalysis) -> Tuple[bool, int, int]:
        cons = fa.cons
        L = len(cons)
        atc = _motif_starts(cons, HEAD_MOTIF)
        tail_any = np.zeros(L, bool)
        for m in TAIL_MOTIFS:
            tail_any |= _motif_starts(cons, m)
        n_cum = np.concatenate([[0], np.cumsum(cons >= 4)])

        def n_free(a: int, b: int) -> bool:
            return n_cum[min(b, L)] - n_cum[max(a, 0)] == 0

        best = None
        for dl in range(-5, 6):
            for dr in range(-5, 6):
                bl = fa.left_pos + dl
                br = fa.right_pos + dr
                if bl < 0 or br > L or br - bl < 30:
                    continue
                # head window reaches 2bp outside: Helitrons insert at an
                # A|T host site, so the consensus 'A' just left of the
                # boundary completes the ATC context
                h0 = max(bl - 2, 0)
                if not n_free(h0, bl + 10) or not n_free(br - 10, br):
                    continue
                # motif must START within the window and fit inside it
                if not atc[h0 : max(bl + 10 - 2, h0)].any():
                    continue
                if not tail_any[max(br - 10, 0) : max(br - 4, 0)].any():
                    continue
                score = abs(dl) + abs(dr)
                if best is None or score < best[0]:
                    best = (score, bl, br)
        if best is None:
            return False, fa.left_pos, fa.right_pos
        return True, best[1], best[2]

    return judge


def lcv_gate(
    genome: Genome,
    intervals: np.ndarray,
    cfg: PipelineConfig,
) -> np.ndarray:
    """Head+tail LCV pairing gate; returns trimmed candidate intervals."""
    hcfg = cfg.helitron
    head_bank, tail_bank = default_banks()
    out: List[Tuple[int, int]] = []
    lens = intervals[:, 1] - intervals[:, 0]
    flank = cfg.msa.flanking_len   # gate-stage candidate context
    dev = genome.device

    for width, idxs in bucket_iter(range(len(intervals)), lens + 2 * flank):
        seqs = [genome.extract(intervals[i, 0], intervals[i, 1], flank)
                for i in idxs]
        mat, slens = pad_seqs(seqs, width, n_rows=pad_rows(len(seqs)))
        # revcomp each row within its own length (revcomping the padded
        # row would shift the content to the tail of the row)
        mat_r, _ = pad_seqs([np_revcomp(s) for s in seqs], width,
                            n_rows=pad_rows(len(seqs)))
        for orient, m_arr in ((0, mat), (1, mat_r)):
            arr = torch.from_numpy(m_arr).to(dev)
            h_sc, _h_w = lcv_scores(arr, head_bank, tile=min(width, 2048))
            t_sc, t_w = lcv_scores(arr, tail_bank, tile=min(width, 2048))
            h_sc = h_sc.cpu().numpy()
            t_sc = t_sc.cpu().numpy()
            t_w = t_w.cpu().numpy()
            for bi, i in enumerate(idxs):
                L = int(slens[bi]) if bi < len(seqs) else 0
                if L == 0:
                    continue
                heads = np.nonzero(h_sc[bi, :L] >= hcfg.min_score_head)[0]
                tails = np.nonzero(t_sc[bi, :L] >= hcfg.min_score_tail)[0]
                if len(heads) == 0 or len(tails) == 0:
                    continue
                # pair the best-scoring head with the farthest valid tail
                h = int(heads[np.argmax(h_sc[bi, heads])])
                valid_t = tails[(tails > h + 50)
                                & (tails < h + hcfg.head_tail_max_gap)]
                if len(valid_t) == 0:
                    continue
                t = int(valid_t[np.argmax(t_sc[bi, valid_t])])
                end = t + int(t_w[bi, t])
                # map back to genome coordinates
                ci, local = genome.contig_of(np.array([intervals[i, 0]]))
                lf = min(flank, int(local[0]))
                if orient == 0:
                    g_s = int(intervals[i, 0]) - lf + h
                    g_e = int(intervals[i, 0]) - lf + end
                else:
                    g_e = int(intervals[i, 0]) - lf + (L - h)
                    g_s = int(intervals[i, 0]) - lf + (L - end)
                if g_e - g_s >= cfg.library.min_te_len:
                    out.append((g_s, g_e))
    return np.array(out, np.int64).reshape(-1, 2)


def eahelitron_gate(
    genome: Genome,
    intervals: np.ndarray,
    cfg: PipelineConfig,
) -> np.ndarray:
    """EAHelitron-style 5'ATC..hairpin-CTRRT structure gate (both strands).

    Returns trimmed candidate intervals; unioned with the LCV gate when
    `cfg.helitron.use_eahelitron` (the reference concatenates EAHelitron
    and HelitronScanner candidates, judge_Helitron_transposons.py:49-54).
    """
    from hite_tpu_torch.ops.eahelitron import (
        hel3_scan, select_pairs, tc5_scan,
    )

    hcfg = cfg.helitron
    flank = cfg.msa.flanking_len   # gate-stage candidate context
    out: List[Tuple[int, int]] = []
    lens = intervals[:, 1] - intervals[:, 0]

    for width, idxs in bucket_iter(range(len(intervals)), lens + 2 * flank):
        seqs = []
        metas = []  # (interval idx, left-flank actually available)
        for i in idxs:
            s = genome.extract(intervals[i, 0], intervals[i, 1], flank)
            # reference skips candidates containing a 10bp N run
            # (run_EAHelitron, Util.py:137-140)
            isn = (s >= 4).astype(np.int8)
            if len(s) >= 10 and np.convolve(isn, np.ones(10, np.int8),
                                            "valid").max() >= 10:
                continue
            ci, local = genome.contig_of(np.array([intervals[i, 0]]))
            seqs.append(s)
            metas.append((i, min(flank, int(local[0]))))
        if not seqs:
            continue
        n = len(seqs)
        rows = pad_rows(n)
        mat, slens = pad_seqs(seqs, width, n_rows=rows)
        # reverse strand: revcomp each row within its own length so row-local
        # positions stay in [0, len)
        mat_r, _ = pad_seqs([np_revcomp(s) for s in seqs], width, n_rows=rows)
        for orient, m_arr in ((0, mat), (1, mat_r)):
            arr = torch.from_numpy(m_arr).to(genome.device)
            hel3 = hel3_scan(arr, hcfg.ea_fuzzy_level).cpu().numpy()
            tc5 = tc5_scan(arr).cpu().numpy()
            raw_s = np.array([m[1] for m in metas])
            raw_e = raw_s + (intervals[[m[0] for m in metas], 1]
                             - intervals[[m[0] for m in metas], 0])
            if orient == 1:  # raw boundaries in the flipped frame
                L_all = slens[:n].astype(np.int64)
                raw_s, raw_e = L_all - raw_e, L_all - raw_s
            picks = select_pairs(hel3[:n], tc5[:n], slens[:n], raw_s, raw_e,
                                 upstream=hcfg.ea_upstream,
                                 min_len=cfg.library.min_te_len)
            for b, pick in enumerate(picks):
                if pick is None:
                    continue
                s_loc, e_loc = pick
                if orient == 1:  # map back to forward frame
                    L = int(slens[b])
                    s_loc, e_loc = L - e_loc, L - s_loc
                i, lf = metas[b]
                g0 = int(intervals[i, 0]) - lf
                out.append((g0 + s_loc, g0 + e_loc))
    return np.array(out, np.int64).reshape(-1, 2)


def gate_helitron(
    genome: Genome,
    coarse_intervals: np.ndarray,
    cfg: PipelineConfig,
) -> np.ndarray:
    """Helitron gating phase: tandem filter + LCV (+EAHelitron) gates."""
    if len(coarse_intervals) == 0:
        return np.zeros((0, 2), np.int64)

    with stage_timer("helitron.tandem_filter"):
        seqs = [genome.extract(s, e) for s, e in coarse_intervals]
        mat, lens = pad_seqs(seqs, n_rows=pad_rows(len(seqs)))
        frac = tandem_fraction(torch.from_numpy(mat).to(genome.device),
                               torch.from_numpy(lens).to(genome.device)
                               ).cpu().numpy()
        frac = frac[: len(coarse_intervals)]
        coarse_intervals = coarse_intervals[frac < cfg.tandem.tandem_region_cutoff]

    with stage_timer("helitron.lcv_gate"):
        gated = lcv_gate(genome, coarse_intervals, cfg)
    logger.info("helitron: %d/%d candidates pass LCV head+tail gate",
                len(gated), len(coarse_intervals))
    if cfg.helitron.use_eahelitron:
        with stage_timer("helitron.eahelitron_gate"):
            ea = eahelitron_gate(genome, coarse_intervals, cfg)
        logger.info("helitron: +%d EAHelitron structure candidates", len(ea))
        count("helitron.eahelitron", len(ea))
        if len(ea):
            gated, _ = iv.dedup(np.concatenate([gated, ea]), q=10)
    return gated


def run_helitron_detection(
    genome: Genome,
    coarse_intervals: np.ndarray,
    cfg: PipelineConfig,
    gindex: Optional[GenomeIndex] = None,
    gated: Optional[np.ndarray] = None,
    plan=None,
    rep_copy_sets=None,
    mesh=None,
) -> ModuleResult:
    if gated is None:
        gated = gate_helitron(genome, coarse_intervals, cfg)
    return verify_families(
        genome, gated, cfg, make_helitron_judge(),
        min_copies=cfg.msa.min_copy_helitron, stage="helitron",
        gindex=gindex, plan=plan, rep_copy_sets=rep_copy_sets, mesh=mesh)
