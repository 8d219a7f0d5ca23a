"""Dynamic boundary adjustment engine (flank_region_align_v5 equivalent).

Counterpart of the JAX `pipeline/boundary_adjust.py`: fetch a candidate's
copies, extend them with flanking context, build the family alignment
matrix (anchor-projection MSA), and let per-column homology decide
whether the candidate is a real TE and where its boundaries lie.  Many
families are analyzed in one batched call: the family axis is an explicit
leading batch dimension (the JAX package vmaps `_analyze_core`).  With a
`mesh` the family axis is sharded over every mesh device (`parallel.mesh.
run_sharded`; the JAX package's `_analyze_batch_sharded`): the analysis
is row-independent, so the result is the unsharded one bit for bit.

The prep of a call (`_prep`) works on the whole wave by index, not one
copy at a time: every copy's flank is scored against its candidate in
one batched pass on the genome's device (`ops.kmerset`), and each batch's
centers and copy rows are gathered there from the genome's codes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from itertools import chain
from operator import attrgetter
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hite_tpu_torch.config import MSAConfig
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.ops.boundary import (
    adaptive_threshold, column_stats, consensus, search_boundary,
)
from hite_tpu_torch.ops.kmerset import in_set_counts, kmer_code_set, row_chunks
from hite_tpu_torch.ops.msa import project_to_center
from hite_tpu_torch.parallel.mesh import Mesh, run_sharded
from hite_tpu_torch.pipeline.candidates import BUCKETS, bucket_for
from hite_tpu_torch.pipeline.copies import CopyHit
from hite_tpu_torch.utils.log import count, stage_timer


@dataclass
class FamilyAnalysis:
    """Device results for one candidate family, pulled to host."""

    M: np.ndarray               # [R, L] alignment matrix (0-3,4 N,5 gap)
    homo: np.ndarray            # [L] homologous columns
    cons: np.ndarray            # [L] majority consensus (5 = gap-majority)
    left_found: bool
    left_pos: int
    right_found: bool
    right_pos: int
    # long-copy truncation: when > 0 the matrix is the frame's first and
    # last `trunc_at` bp, and columns >= trunc_at map to genome + trunc_gap
    trunc_at: int = 0
    trunc_gap: int = 0


@dataclass
class AdjustResult:
    accepted: bool
    start: int                  # adjusted flat genome coords
    end: int
    copy_count: int
    low_copy: bool
    consensus: Optional[np.ndarray] = None


def _analyze_core(centers, copies_mats, lens, anchors_l, anchors_r, *,
                  radius=50, int_window=20, ext_window=10, trunc_at=0):
    """Family analysis over a family batch: centers [F, W], copies
    [F, R, W], lens [F, R], anchors [F].  Returns (M, homo, cons, left,
    right) batched over F."""
    if trunc_at:
        # head and tail halves project independently (each on its own
        # dominant diagonal)
        T = trunc_at
        Mh = project_to_center(centers[:, :T], copies_mats[..., :T], lens)
        Mt = project_to_center(centers[:, T:], copies_mats[..., T:], lens)
        M = torch.cat([Mh, Mt], -1)
    else:
        M = project_to_center(centers, copies_mats, lens)
    row_ok = lens > 0
    thr = adaptive_threshold(row_ok.sum(-1))
    stats = column_stats(M, thr, row_ok=row_ok)
    left = search_boundary(stats.homo, anchors_l, side="left", radius=radius,
                           int_window=int_window, ext_window=ext_window)
    right = search_boundary(stats.homo, anchors_r, side="right",
                            radius=radius, int_window=int_window,
                            ext_window=ext_window)
    cons, _support = consensus(M, row_ok=row_ok)
    return M, stats.homo, cons, left, right


KEEP_MIN = 8          # copies the flank subset keeps at least
FAMILY_FRAC = 0.25    # a flank at or below this family share is clean


def _subset_copies_by_flank(center: np.ndarray, copy_seqs: List[np.ndarray],
                            flank: int, keep_min: int = KEEP_MIN,
                            family_frac: float = FAMILY_FRAC
                            ) -> List[np.ndarray]:
    """Prefer copies whose flanks are family-free (dense-genome case):
    drop copies whose flank 8-mers largely belong to the candidate, as
    long as `keep_min` clean rows remain.  One family at a time, one copy
    at a time: the rule `_flank_keep` applies to a whole wave, kept as its
    oracle."""
    n = len(copy_seqs)
    if n <= keep_min:
        return copy_seqs
    fam = kmer_code_set(center)
    if not len(fam):
        return copy_seqs
    scores = np.zeros(n)
    for i, cs in enumerate(copy_seqs):
        fl = cs[:flank]
        fr = cs[-flank:] if len(cs) > flank else cs[:0]
        fk = kmer_code_set(np.concatenate([fl, np.full(1, 4, np.uint8), fr]))
        scores[i] = float(np.isin(fk, fam).mean()) if len(fk) else 0.0
    clean = [i for i in range(n) if scores[i] <= family_frac]
    if len(clean) >= keep_min:
        return [copy_seqs[i] for i in clean]
    order = np.argsort(scores, kind="stable")[:keep_min]
    return [copy_seqs[i] for i in sorted(order)]


def _pow2_at_least(n: np.ndarray) -> np.ndarray:
    """Elementwise 1 << (n - 1).bit_length() (1 for n <= 1)."""
    return (1 << np.frexp(np.maximum(n, 1) - 1)[1]).astype(np.int64)


def _contig_bounds(genome: Genome, pos: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """[start, end) of the contig holding each flat position."""
    ci, _local = genome.contig_of(pos)
    c0 = genome.starts[ci]
    return c0, c0 + genome.lengths[ci]


def _to_dev(dev, *cols) -> torch.Tensor:
    """Host int64 columns stacked into one [len(cols), n] upload."""
    return torch.from_numpy(np.stack([np.asarray(c, np.int64)
                                      for c in cols])).to(dev)


def _read_rows(src: torch.Tensor, table: torch.Tensor, width: int
               ) -> torch.Tensor:
    """uint8 [n, width] rows cut from frames of the codes `src`.  `table`
    int64 [7, n] holds each row's (lo, hi, rev, head, tail_at, tail_len,
    tail_src): its frame is src[lo:hi], reverse-complemented where rev;
    the row is the frame's first `head` codes, then from column tail_at
    `tail_len` codes from frame offset tail_src, and N elsewhere."""
    out = torch.empty((table.shape[1], width), dtype=torch.uint8,
                      device=src.device)
    j = torch.arange(width, device=src.device)
    for a, b in row_chunks(table.shape[1], 32 * width):
        lo, hi, rev, head, tail_at, tail_len, tail_src = table[:, a:b, None]
        rev = rev.bool()
        t = j - tail_at
        off = torch.where(j < head, j, -1)
        off = torch.where((t >= 0) & (t < tail_len), tail_src + t, off)
        pos = torch.where(rev, hi - 1 - off, lo + off)
        c = src[pos.clamp_(0, src.shape[0] - 1)]
        c = torch.where(rev & (c < 4), 3 - c, c)
        out[a:b] = torch.where(off >= 0, c, 4)
    return out


def _copy_frames(genome: Genome, copy_lists: Sequence[Sequence], flank: int):
    """Every copy's frame, item-major: (src, lo, hi, rev), frame i being
    src[lo:hi], reverse-complemented where rev.  CopyHits read the
    genome's device codes over their flank-extended, contig-clipped
    interval; copies given as code arrays (strand-corrected frames, from
    other genomes in the pan rescue) are uploaded joined."""
    given = [len(cp) > 0 and isinstance(cp[0], np.ndarray)
             for cp in copy_lists]
    if any(given):
        if not all(g or not len(cp) for g, cp in zip(given, copy_lists)):
            raise ValueError("copies mix code arrays and CopyHits")
        seqs = list(chain.from_iterable(copy_lists))
        n = np.fromiter(map(len, seqs), np.int64, len(seqs))
        lo = np.zeros(len(seqs), np.int64)
        np.cumsum(n[:-1], out=lo[1:])
        pool = np.concatenate(seqs + [np.full(1, 4, np.uint8)])
        src = torch.from_numpy(pool.astype(np.uint8, copy=False)).to(
            genome.device)
        return src, lo, lo + n, np.zeros(len(seqs), bool)
    hits = list(chain.from_iterable(copy_lists))

    def col(name: str) -> np.ndarray:
        return np.fromiter(map(attrgetter(name), hits), np.int64, len(hits))

    start, end = col("start"), col("end")
    c0, c1 = _contig_bounds(genome, start)
    lo = np.maximum(c0, start - flank)
    hi = np.maximum(np.minimum(c1, end + flank), lo)
    return genome.device_flat_padded()[0], lo, hi, col("strand") == 1


def _flank_keep(g_src: torch.Tensor, src: torch.Tensor, item: np.ndarray,
                lo: np.ndarray, hi: np.ndarray, rev: np.ndarray,
                n_cp: np.ndarray, fam_lo: np.ndarray, fam_hi: np.ndarray,
                flank: int, stage: str, k: int = 8) -> np.ndarray:
    """Mask of the copies each item keeps, `_subset_copies_by_flank`'s rule
    for every item of a wave at once.  Items with more than KEEP_MIN
    copies and a family span of k bp or more are scored: each copy's row
    `frame[:flank] + N + frame[-flank:]` (the tail only where the frame is
    longer than `flank`) and each family's span of the genome go to the
    device as one batch (`ops.kmerset.in_set_counts`), and the two counts
    a row come back.  The score is their float64 ratio, 0 for a row with
    no valid 8-mer; an item whose span has none keeps every copy."""
    keep = np.ones(len(item), bool)
    fam_len = np.maximum(fam_hi - fam_lo, 0)
    scored = (n_cp > KEEP_MIN) & (fam_len >= k)
    count(f"{stage}.ba_scored_items", int(scored.sum()))
    if not scored.any():
        return keep
    dev = src.device
    sc = np.flatnonzero(scored[item])                # the scored copies
    owner = (np.cumsum(scored) - 1)[item[sc]]
    n = hi[sc] - lo[sc]
    a = np.minimum(n, flank)
    b = np.where(n > flank, flank, 0)
    rows = _read_rows(src, _to_dev(dev, lo[sc], hi[sc], rev[sc], a, a + 1,
                                   b, n - b), 2 * flank + 1)
    fl, fs = fam_len[scored], fam_lo[scored]
    span = fl + 1                                    # each span, then an N
    fam = _to_dev(dev, fs, np.cumsum(span) - span, fl)
    own = torch.repeat_interleave(
        torch.arange(len(fl), device=dev), _to_dev(dev, span)[0],
        output_size=int(span.sum()))
    off = torch.arange(own.shape[0], device=dev) - fam[1][own]
    stream = torch.where(
        off < fam[2][own],
        g_src[(fam[0][own] + off).clamp_(max=g_src.shape[0] - 1)], 4)
    distinct, in_fam, fam_n = in_set_counts(
        rows, _to_dev(dev, owner)[0], stream, own, len(fl), k)
    score = np.zeros(len(sc))
    np.divide(in_fam, distinct, out=score, where=distinct > 0)
    clean = score <= FAMILY_FRAC
    n_clean = np.bincount(owner[clean], minlength=len(fl))
    order = np.lexsort((sc, score, owner))           # stable by score
    rank = np.empty(len(sc), np.int64)
    rank[order] = (np.arange(len(sc))
                   - np.searchsorted(owner[order], owner[order]))
    pick = np.where(n_clean[owner] >= KEEP_MIN, clean, rank < KEEP_MIN)
    keep[sc] = pick | (fam_n[owner] == 0)
    return keep


@dataclass
class _Prep:
    """One call's host prep: per item (center frame, anchors, matrix
    geometry) and per kept copy, item-major (frame, rank)."""

    g_src: torch.Tensor         # the genome's device codes (centers)
    src: torch.Tensor           # the copies' codes
    lo_c: np.ndarray            # center frame [lo_c, lo_c + Lc)
    Lc: np.ndarray
    al: np.ndarray
    ar: np.ndarray
    width: np.ndarray
    R: np.ndarray
    trunc_at: np.ndarray
    trunc_gap: np.ndarray
    item: np.ndarray            # kept copies
    rank: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    rev: np.ndarray


def _prep(genome: Genome, items, cfg: MSAConfig, stage: str) -> _Prep:
    """Every item's frames and copy subset, by index over the wave.
    Frames longer than twice the 512 bucket become head+tail
    concatenations (matrix columns >= trunc_at map to genome +
    trunc_gap)."""
    flank = cfg.frame_flank
    F = len(items)
    iv = np.array([it[0] for it in items], np.int64).reshape(F, 2)
    copy_lists = [cp for _iv, cp in items]
    n_cp = np.fromiter(map(len, copy_lists), np.int64, F)
    item = np.repeat(np.arange(F), n_cp)
    src, lo, hi, rev = _copy_frames(genome, copy_lists, flank)
    g_src = genome.device_flat_padded()[0]
    s, e = iv[:, 0], iv[:, 1]
    c0, c1 = _contig_bounds(genome, s)
    lo_c = np.maximum(c0, s - flank)
    Lc = np.maximum(np.minimum(c1, e + flank) - lo_c, 0)
    al = s - lo_c
    ar = al + (e - s)
    with stage_timer(f"{stage}.ba_score"):
        # the family set is the center's element span, center[al:ar]
        keep = _flank_keep(g_src, src, item, lo, hi, rev, n_cp,
                           lo_c + np.minimum(al, Lc),
                           lo_c + np.minimum(ar, Lc), flank, stage)
    kept = np.flatnonzero(keep)
    n_kept = np.bincount(item[kept], minlength=F)
    rank = np.arange(len(kept)) - (np.cumsum(n_kept) - n_kept)[item[kept]]
    T = bucket_for(cfg.long_copy_trunc)
    trunc = Lc > 2 * T
    buckets = np.asarray(BUCKETS)
    width = np.where(trunc, 2 * T, buckets[np.minimum(
        np.searchsorted(buckets, Lc), len(buckets) - 1)])
    trunc_gap = np.where(trunc, Lc - 2 * T, 0)
    return _Prep(g_src=g_src, src=src, lo_c=lo_c, Lc=Lc, al=al,
                 ar=ar - trunc_gap, width=width,
                 R=np.maximum(4, _pow2_at_least(n_kept)),
                 trunc_at=np.where(trunc, T, 0), trunc_gap=trunc_gap,
                 item=item[kept], rank=rank, lo=lo[kept], hi=hi[kept],
                 rev=rev[kept])


def _pack(p: _Prep, idxs: np.ndarray, Fp: int, rb: int, width: int,
          trunc_at: int):
    """One batch's device arrays (centers [Fp, width], mats [Fp, rb,
    width], lens [Fp, rb], al, ar [Fp]), built by gathers: item b's kept
    copy of rank r is row r of family b; pad rows and families are N."""
    dev = p.g_src.device
    F = len(idxs)
    T = trunc_at
    tabc = np.zeros((7, Fp), np.int64)
    Lc = p.Lc[idxs]
    tabc[0, :F] = p.lo_c[idxs]
    tabc[1, :F] = p.lo_c[idxs] + Lc
    if T:
        tabc[3, :F], tabc[4, :F], tabc[5, :F] = T, T, T
        tabc[6, :F] = Lc - T
    else:
        tabc[3, :F] = Lc
    slot = np.full(len(p.R), -1, np.int64)
    slot[idxs] = np.arange(F)
    c = np.flatnonzero(slot[p.item] >= 0)
    row = slot[p.item[c]] * rb + p.rank[c]
    n = p.hi[c] - p.lo[c]
    tabm = np.zeros((7, Fp * rb), np.int64)
    tabm[0, row], tabm[1, row], tabm[2, row] = p.lo[c], p.hi[c], p.rev[c]
    if T:
        m = np.minimum(n, T)
        tabm[3, row], tabm[4, row], tabm[5, row] = m, T, m
        tabm[6, row] = n - m
    else:
        tabm[3, row] = np.minimum(n, p.width[p.item[c]])
    tab = torch.from_numpy(np.concatenate([tabc, tabm], 1)).to(dev)
    centers = _read_rows(p.g_src, tab[:, :Fp], width)
    mats = _read_rows(p.src, tab[:, Fp:], width).view(Fp, rb, width)
    lens = tab[3, Fp:].view(Fp, rb).to(torch.int32)
    anchors = np.zeros((2, Fp), np.int32)
    anchors[0, :F], anchors[1, :F] = p.al[idxs], p.ar[idxs]
    al, ar = torch.from_numpy(anchors).to(dev)
    return centers, mats, lens, al, ar


def _run_batch(genome: Genome, centers, mats, lens, al, ar, trunc_at,
               mesh: Optional[Mesh] = None):
    """Analyze one padded family batch of device arrays (its family axis
    sharded over `mesh` when given), fetch to host."""
    fn = functools.partial(_analyze_core, trunc_at=trunc_at)
    if mesh is not None:
        M, homo, cons, left, right = run_sharded(
            mesh, fn, centers, mats, lens, al, ar, device=genome.device)
    else:
        M, homo, cons, left, right = fn(centers, mats, lens, al, ar)
    host = lambda x: x.cpu().numpy()
    return (host(M), host(homo), host(cons), host(left.found),
            host(left.pos), host(right.found), host(right.pos))


def analyze_family(genome: Genome, interval: Tuple[int, int],
                   copies: Sequence[CopyHit], cfg: MSAConfig
                   ) -> Tuple[FamilyAnalysis, int]:
    """Build + analyze one family matrix; returns (analysis, center_start).
    `copies` are CopyHits or strand-corrected, flank-extended code
    arrays."""
    return analyze_families_batched(genome, [(interval, copies)], cfg)[0]


def analyze_families_batched(
    genome: Genome,
    items: Sequence[Tuple[Tuple[int, int], Sequence[CopyHit]]],
    cfg: MSAConfig,
    mesh: Optional[Mesh] = None,
    stage: str = "boundary",
) -> List[Tuple[FamilyAnalysis, int]]:
    """Bucketed batched analysis of many families in few device calls:
    one batch per trunc mode, capped so F x R x W <= 2^23 cells, the
    family dim padded to a power of two (as in the JAX package) and, with
    `mesh`, on to a multiple of the mesh size, each batch's family axis
    sharded over the mesh (identical results).  The prep of every batch
    (`_prep`: frames, the flank subsets under `{stage}.ba_score`,
    bucketing, packing by gathers on the genome's device) runs under the
    span `{stage}.ba_prep`, the analyses and their unpacking under
    `{stage}.ba_batch`."""
    if not items:
        return []
    with stage_timer(f"{stage}.ba_prep"):
        p = _prep(genome, items, cfg, stage)
        capped = []
        for trunc_at in dict.fromkeys(p.trunc_at.tolist()):
            idxs = np.flatnonzero(p.trunc_at == trunc_at)
            rb, width = int(p.R[idxs].max()), int(p.width[idxs].max())
            cap = max(8, (1 << 23) // max(rb * width, 1))
            for b0 in range(0, len(idxs), cap):
                capped.append((trunc_at, idxs[b0 : b0 + cap]))
        packed = []
        for trunc_at, idxs in capped:
            F = len(idxs)
            Fp = max(4, 1 << (F - 1).bit_length())
            if mesh is not None:
                Fp = -(-Fp // mesh.size) * mesh.size
            rb, width = int(p.R[idxs].max()), int(p.width[idxs].max())
            packed.append((trunc_at, idxs,
                           _pack(p, idxs, Fp, rb, width, trunc_at)))
    out: List[Optional[Tuple[FamilyAnalysis, int]]] = [None] * len(items)
    with stage_timer(f"{stage}.ba_batch"):
        for trunc_at, idxs, arrays in packed:
            M, homo, cons, lf, lp, rf, rp = _run_batch(
                genome, *arrays, trunc_at, mesh)
            for b, i in enumerate(idxs.tolist()):
                fa = FamilyAnalysis(
                    M=M[b], homo=homo[b], cons=cons[b],
                    left_found=bool(lf[b]), left_pos=int(lp[b]),
                    right_found=bool(rf[b]), right_pos=int(rp[b]),
                    trunc_at=trunc_at, trunc_gap=int(p.trunc_gap[i]))
                out[i] = (fa, int(p.lo_c[i]))
    return out  # type: ignore[return-value]


# A judge inspects the analysis and returns (accept, bl, br) in center coords.
Judge = Callable[[FamilyAnalysis], Tuple[bool, int, int]]


def adjust_candidate(
    genome: Genome,
    interval: Tuple[int, int],
    copies: Sequence[CopyHit],
    cfg: MSAConfig,
    judge: Judge,
    min_copies: int,
    precomputed: Optional[Tuple[FamilyAnalysis, int]] = None,
) -> AdjustResult:
    """One round of boundary adjustment for one candidate."""
    n = len(copies)
    if n < min_copies:
        return AdjustResult(accepted=False, start=int(interval[0]),
                            end=int(interval[1]), copy_count=n, low_copy=True)
    fa, center_start = precomputed or analyze_family(
        genome, interval, copies, cfg)
    if not (fa.left_found and fa.right_found):
        return AdjustResult(accepted=False, start=int(interval[0]),
                            end=int(interval[1]), copy_count=n,
                            low_copy=False)
    ok, bl, br = judge(fa)
    T, gap = fa.trunc_at, fa.trunc_gap

    def _g(p: int) -> int:
        return p + gap if (T and p >= T) else p

    if not ok or _g(br) - _g(bl) < 30:
        return AdjustResult(accepted=False, start=int(interval[0]),
                            end=int(interval[1]), copy_count=n,
                            low_copy=False)
    if T and br >= T > bl:
        # truncated family: head consensus + the frame's cut-out middle
        # genome sequence + tail consensus
        head = fa.cons[bl:T]
        tail = fa.cons[T:br]
        mid = genome.extract(center_start + T, center_start + T + gap)
        cons = np.concatenate([head[head < 4], mid[mid < 4], tail[tail < 4]])
    else:
        cons = fa.cons[bl:br]
        cons = cons[cons < 4]
    return AdjustResult(accepted=True, start=center_start + _g(bl),
                        end=center_start + _g(br), copy_count=n,
                        low_copy=False, consensus=cons.astype(np.uint8))
