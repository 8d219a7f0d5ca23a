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
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hite_tpu_torch.config import MSAConfig
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.io.fasta import revcomp as np_revcomp
from hite_tpu_torch.ops.boundary import (
    adaptive_threshold, column_stats, consensus, search_boundary,
)
from hite_tpu_torch.ops.msa import project_to_center
from hite_tpu_torch.parallel.mesh import Mesh, run_sharded
from hite_tpu_torch.pipeline.candidates import bucket_for, pad_seqs
from hite_tpu_torch.pipeline.copies import CopyHit
from hite_tpu_torch.utils.log import stage_timer


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


def _kmer_code_set(v: np.ndarray, k: int = 8) -> np.ndarray:
    v = np.asarray(v, np.int64)
    if len(v) < k:
        return np.zeros(0, np.int64)
    m = len(v) - k + 1
    ok = np.ones(m, bool)
    code = np.zeros(m, np.int64)
    for j in range(k):
        w = v[j : m + j]
        ok &= w < 4
        code = code * 4 + np.where(w < 4, w, 0)
    return np.unique(code[ok])


def _subset_copies_by_flank(center: np.ndarray, copy_seqs: List[np.ndarray],
                            flank: int, keep_min: int = 8,
                            family_frac: float = 0.25) -> List[np.ndarray]:
    """Prefer copies whose flanks are family-free (dense-genome case):
    drop copies whose flank 8-mers largely belong to the candidate, as
    long as `keep_min` clean rows remain."""
    n = len(copy_seqs)
    if n <= keep_min:
        return copy_seqs
    fam = _kmer_code_set(center)
    if not len(fam):
        return copy_seqs
    scores = np.zeros(n)
    for i, cs in enumerate(copy_seqs):
        fl = cs[:flank]
        fr = cs[-flank:] if len(cs) > flank else cs[:0]
        fk = _kmer_code_set(np.concatenate([fl, np.full(1, 4, np.uint8), fr]))
        scores[i] = float(np.isin(fk, fam).mean()) if len(fk) else 0.0
    clean = [i for i in range(n) if scores[i] <= family_frac]
    if len(clean) >= keep_min:
        return [copy_seqs[i] for i in clean]
    order = np.argsort(scores, kind="stable")[:keep_min]
    return [copy_seqs[i] for i in sorted(order)]


def _prep_family(genome: Genome, interval: Tuple[int, int],
                 copies: Sequence[CopyHit], cfg: MSAConfig):
    """Host-side family prep: (c_pad, mat, lens, anchor_l, anchor_r,
    center_start, width, R_bucket, trunc_at, trunc_gap).  Frames longer
    than twice the 512 bucket become head+tail concatenations."""
    s, e = int(interval[0]), int(interval[1])
    flank = cfg.frame_flank
    center = genome.extract(s, e, flank)
    ci, _local = genome.contig_of(np.array([s]))
    c_start = int(genome.starts[int(ci[0])])
    left_flank = min(flank, s - c_start)
    center_start = s - left_flank
    anchor_l = left_flank
    anchor_r = left_flank + (e - s)

    if copies and isinstance(copies[0], np.ndarray):
        copy_seqs = list(copies)
    else:
        copy_seqs = [genome.extract(h.start, h.end, flank) for h in copies]
        copy_seqs = [np_revcomp(cs) if h.strand == 1 else cs
                     for cs, h in zip(copy_seqs, copies)]
    copy_seqs = _subset_copies_by_flank(center[anchor_l:anchor_r], copy_seqs,
                                        flank)
    R_bucket = (max(4, 1 << (len(copy_seqs) - 1).bit_length())
                if copy_seqs else 4)

    T = bucket_for(cfg.long_copy_trunc)
    Lc = len(center)
    if Lc > 2 * T:
        trunc_at, trunc_gap = T, Lc - 2 * T
        center = np.concatenate([center[:T], center[-T:]])
        anchor_r -= trunc_gap
        width = 2 * T
        mat = np.full((R_bucket, width), 4, np.uint8)
        lens = np.zeros(R_bucket, np.int32)
        for r, cs in enumerate(copy_seqs):
            n = min(len(cs), T)
            mat[r, :n] = cs[:n]
            mat[r, T : T + n] = cs[-n:]
            lens[r] = n
    else:
        trunc_at, trunc_gap = 0, 0
        width = bucket_for(Lc)
        mat, lens = pad_seqs(copy_seqs, width, n_rows=R_bucket)
    c_pad = np.full(width, 4, np.uint8)
    c_pad[: len(center)] = center
    return (c_pad, mat, lens, anchor_l, anchor_r, center_start, width,
            R_bucket, trunc_at, trunc_gap)


def _run_batch(genome: Genome, centers, mats, lens, al, ar, trunc_at,
               mesh: Optional[Mesh] = None):
    """Upload one padded family batch, analyze it (its family axis
    sharded over `mesh` when given), fetch to host."""
    dev = genome.device
    fn = functools.partial(_analyze_core, trunc_at=trunc_at)
    if mesh is not None:
        M, homo, cons, left, right = run_sharded(
            mesh, fn, centers, mats, lens, al, ar, device=dev)
    else:
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        M, homo, cons, left, right = fn(t(centers), t(mats), t(lens), t(al),
                                        t(ar))
    host = lambda x: x.cpu().numpy()
    return (host(M), host(homo), host(cons), host(left.found),
            host(left.pos), host(right.found), host(right.pos))


def analyze_family(genome: Genome, interval: Tuple[int, int],
                   copies: Sequence[CopyHit], cfg: MSAConfig
                   ) -> Tuple[FamilyAnalysis, int]:
    """Build + analyze one family matrix; returns (analysis, center_start)."""
    (c_pad, mat, lens, anchor_l, anchor_r, center_start, _w, _r,
     trunc_at, trunc_gap) = _prep_family(genome, interval, copies, cfg)
    M, homo, cons, lf, lp, rf, rp = _run_batch(
        genome, c_pad[None], mat[None], lens[None],
        np.array([anchor_l], np.int32), np.array([anchor_r], np.int32),
        trunc_at)
    fa = FamilyAnalysis(M=M[0], homo=homo[0], cons=cons[0],
                        left_found=bool(lf[0]), left_pos=int(lp[0]),
                        right_found=bool(rf[0]), right_pos=int(rp[0]),
                        trunc_at=trunc_at, trunc_gap=trunc_gap)
    return fa, center_start


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
    sharded over the mesh (identical results).  The host prep of every
    batch runs under the span `{stage}.ba_prep`, the device batches and
    their unpacking under `{stage}.ba_batch`."""
    with stage_timer(f"{stage}.ba_prep"):
        preps = [_prep_family(genome, it, cp, cfg) for it, cp in items]
        buckets: dict = {}
        for i, p in enumerate(preps):
            buckets.setdefault(p[8], []).append(i)   # trunc_at
        capped = []
        for trunc_at, idxs in buckets.items():
            rb = max(preps[i][7] for i in idxs)
            width = max(preps[i][6] for i in idxs)
            cap = max(8, (1 << 23) // max(rb * width, 1))
            for b0 in range(0, len(idxs), cap):
                capped.append((trunc_at, idxs[b0 : b0 + cap]))
        packed = []
        for trunc_at, idxs in capped:
            F = len(idxs)
            Fp = max(4, 1 << (F - 1).bit_length())
            if mesh is not None:
                Fp = -(-Fp // mesh.size) * mesh.size
            rb = max(preps[i][7] for i in idxs)
            width = max(preps[i][6] for i in idxs)
            centers = np.full((Fp, width), 4, np.uint8)
            mats = np.full((Fp, rb, width), 4, np.uint8)
            lens = np.zeros((Fp, rb), np.int32)
            al = np.zeros(Fp, np.int32)
            ar = np.zeros(Fp, np.int32)
            for b, i in enumerate(idxs):
                p = preps[i]
                centers[b, : p[6]] = p[0]
                mats[b, : p[7], : p[6]] = p[1]
                lens[b, : p[7]] = p[2]
                al[b] = p[3]
                ar[b] = p[4]
            packed.append((trunc_at, idxs, (centers, mats, lens, al, ar)))
    out: List[Optional[Tuple[FamilyAnalysis, int]]] = [None] * len(items)
    with stage_timer(f"{stage}.ba_batch"):
        for trunc_at, idxs, arrays in packed:
            M, homo, cons, lf, lp, rf, rp = _run_batch(
                genome, *arrays, trunc_at, mesh)
            for b, i in enumerate(idxs):
                fa = FamilyAnalysis(
                    M=M[b], homo=homo[b], cons=cons[b],
                    left_found=bool(lf[b]), left_pos=int(lp[b]),
                    right_found=bool(rf[b]), right_pos=int(rp[b]),
                    trunc_at=trunc_at, trunc_gap=preps[i][9])
                out[i] = (fa, preps[i][5])
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
