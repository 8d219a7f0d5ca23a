"""Genome annotation with a TE library (RepeatMasker replacement;
counterpart of the JAX package's `pipeline/annotate.py`).

Every library consensus is mapped onto the genome by the copy join in
library-vs-genome mode, each hit's identity is rescored by the batched
Smith-Waterman (the hand-written kernel on the card), overlapping hits are
resolved per locus by alignment score, and the GFF / .out / .tbl /
full-length GFF files are written (hits covering >= 95% of their
consensus are full length, `Util.py:13679-13753`).  The JAX package's
`mesh` argument (a sharded library batch) is not ported: ROADMAP item
16.5.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from hite_tpu_torch.config import PipelineConfig
from hite_tpu_torch.device import resolve_device
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.io.fasta import revcomp
from hite_tpu_torch.io.gff import (
    AnnotationHit, write_full_length_gff, write_gff, write_rm_out, write_tbl,
)
from hite_tpu_torch.ops.terminal import batched_local_align_auto
from hite_tpu_torch.pipeline.candidates import pad_seqs
from hite_tpu_torch.pipeline.copies import CopyFinder, GenomeIndex
from hite_tpu_torch.utils.log import logger, stage_timer


def rescore_hit_identities(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    max_width: int = 4096,
    batch: int = 64,
    device: Optional[Union[str, torch.device]] = None,
) -> np.ndarray:
    """Alignment identities (matches / alignment length of the best local
    alignment) of (consensus, hit-region) pairs, float64.

    Pairs are sorted by their longer side and aligned `batch` at a time at
    the batch's power-of-two width (at least 64) and row count; a side
    longer than `max_width` is cut to its centre `max_width` bases (TE
    divergence is locus-wide).  SW runs on `device` (None = the card)."""
    dev = resolve_device(device)
    out = np.zeros(len(pairs), np.float64)
    if not pairs:
        return out

    def clip(s: np.ndarray) -> np.ndarray:
        if len(s) <= max_width:
            return s
        mid = len(s) // 2
        return s[mid - max_width // 2 : mid + max_width // 2]

    order = sorted(range(len(pairs)),
                   key=lambda i: max(len(pairs[i][0]), len(pairs[i][1])))
    for b0 in range(0, len(order), batch):
        sel = order[b0 : b0 + batch]
        a_seqs = [clip(pairs[i][0]) for i in sel]
        b_seqs = [clip(pairs[i][1]) for i in sel]
        width = max(max(len(s) for s in a_seqs),
                    max(len(s) for s in b_seqs), 64)
        width = 1 << (width - 1).bit_length()
        B = 1 << (len(sel) - 1).bit_length()
        a_mat, _ = pad_seqs(a_seqs, width, n_rows=B)
        b_mat, _ = pad_seqs(b_seqs, width, n_rows=B)
        al = batched_local_align_auto(torch.from_numpy(a_mat).to(dev),
                                      torch.from_numpy(b_mat).to(dev))
        matches = al.matches.cpu().numpy()
        alen = al.alen.cpu().numpy()
        for bi, i in enumerate(sel):
            out[i] = matches[bi] / max(int(alen[bi]), 1)
    return out


def annotate_genome(
    genome: Genome,
    library: Dict[str, np.ndarray],
    cfg: PipelineConfig,
    gindex: Optional[GenomeIndex] = None,
    min_hit_fraction: float = 0.3,
    rescore: bool = True,
) -> List[AnnotationHit]:
    """Map library entries onto the genome; returns per-locus hits.

    One copy join over the UNMASKED genome (`gindex`, default
    `GenomeIndex(genome, cfg.align)`, reuses the sorted stream cached on
    the genome).  The JAX package builds its finder with `max_chains=256`,
    which only its legacy segments mapper reads; the port's join needs no
    such argument.  `rescore=False` skips the SW identity pass for
    interval-only consumers (the BM_HiTE / BM_EDTA evaluators)."""
    gindex = gindex or GenomeIndex(genome, cfg.align)
    finder = CopyFinder(gindex)
    names = list(library.keys())
    seqs = [library[n] for n in names]

    with stage_timer("annotate.map"):
        # min_abs_len: RepeatMasker hit semantics — keep LOCAL fragment
        # hits >= min_te_len bp even below min_hit_fraction of the entry,
        # so single-unit copies annotate against tandem-dimer / nested
        # composite entries and truncated copies against their family
        copy_sets = finder.find_copies(
            seqs, min_coverage=min_hit_fraction,
            max_copies=10_000 // max(len(names), 1) + 200,
            max_len_ratio=1.5,
            min_abs_len=max(80, cfg.library.min_te_len))

    hits: List[AnnotationHit] = []
    rescore_pairs: List[Tuple[np.ndarray, np.ndarray]] = []
    k = cfg.align.kmer_size
    for name, seq, copies in zip(names, seqs, copy_sets):
        family, _, te_class = name.partition("#")
        te_class = te_class or "Unknown"
        L = len(seq)
        for h in copies:
            ci, local = genome.contig_of(np.array([h.start]))
            ci = int(ci[0])
            span = h.end - h.start
            # seed-density identity proxy (refined by the SW pass below)
            ident = min(1.0, (h.nseeds / max(span - k + 1, 1))
                        ** (1.0 / k) + 0.05)
            if rescore:
                region = genome.extract(h.start, h.end)
                if h.strand == 1:
                    region = revcomp(region)
                rescore_pairs.append((seq, region))
            hits.append(AnnotationHit(
                contig=genome.names[ci],
                start=int(local[0]) + 1,
                end=int(local[0]) + span,
                strand="+" if h.strand == 0 else "-",
                family=family,
                te_class=te_class,
                identity=float(ident),
                full_length=span >= cfg.library.full_length_cov * L,
            ))
    if rescore and hits:
        with stage_timer("annotate.rescore"):
            idents = rescore_hit_identities(rescore_pairs,
                                            device=genome.device)
        for h, ident in zip(hits, idents):
            if ident > 0:
                h.identity = float(ident)
    resolved = resolve_overlaps(hits)
    logger.info("annotate: %d hits (%d after overlap resolution)",
                len(hits), len(resolved))
    return resolved


def resolve_overlaps(hits: List[AnnotationHit]) -> List[AnnotationHit]:
    """Resolve overlapping hits by ALIGNMENT SCORE, like RepeatMasker's
    locus resolution (pan_annotate_genome.py:27): score = span scaled by
    the SW-rescored identity under the engine's +1/-2 scoring, so a clean
    short hit beats a longer but diverged one at nested loci."""

    def _score(h: AnnotationHit) -> float:
        return (h.end - h.start + 1) * (3.0 * h.identity - 2.0)

    hits = sorted(hits, key=lambda h: (h.contig, h.start))
    resolved: List[AnnotationHit] = []
    for h in hits:
        if resolved and resolved[-1].contig == h.contig and \
                h.start <= resolved[-1].end - 10:
            if _score(h) > _score(resolved[-1]):
                resolved[-1] = h
            continue
        resolved.append(h)
    return resolved


def write_annotation(
    out_prefix: str,
    hits: List[AnnotationHit],
    genome: Genome,
) -> None:
    write_gff(out_prefix + ".gff", hits)
    write_rm_out(out_prefix + ".out", hits)
    write_tbl(out_prefix + ".tbl", hits, genome.size)
    write_full_length_gff(out_prefix + ".full_length.gff", hits)
