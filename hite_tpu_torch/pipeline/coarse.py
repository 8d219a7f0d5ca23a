"""Coarse-boundary de-novo repeat discovery (reference stage "FMEA").

Counterpart of the JAX `pipeline/coarse.py`.  Strategy "selfjoin" (the
default): the whole-genome k-mer self-join finds every interval that
aligns somewhere else, HSPs are chained exactly on the host, and
candidates are deduped with 10 bp rounding + >=95% mutual-overlap merging
(reference `Util.py:4344-4395`).  Genomes past `max_selfjoin_bp` run as
overlapping chunks on the chunk grid the JAX package uses.  Strategy
"pairs" (an explicit opt-in): every live segment pair (i, j <= i) runs
the seed -> HSP -> chain kernels (`ops.seedext`, `ops.chain`) in batches
of `pair_batch` pairs.  With a `mesh` the chunked self-join shards its
chunk batch over the mesh's "dp" axis (`_selfjoin_intervals_mesh`, the
JAX package's mesh path, quirks included); `parallel/dispatch.py` shards
the pair grid.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from hite_tpu_torch.config import AlignConfig
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.ops import encode as enc
from hite_tpu_torch.ops.chain import Chains, chain_hsps, chain_hsps_host
from hite_tpu_torch.ops.kmer import KmerIndex, build_index
from hite_tpu_torch.ops.seedext import pair_hsps
from hite_tpu_torch.ops.selfjoin import selfjoin_scan_packed, selfjoin_sorted
from hite_tpu_torch.parallel.mesh import Mesh, device_guard, shard_rows
from hite_tpu_torch.utils import intervals as iv
from hite_tpu_torch.utils.log import count, logger, stage_timer


@dataclass(frozen=True)
class CoarseParams:
    """Kernel geometry (same fields and defaults as the JAX package)."""

    seg_len: int = 131_072
    stride: int = 2
    max_hits: int = 8
    diag_band: int = 32
    run_gap: int = 96
    min_seeds: int = 4
    max_hsps: int = 2048
    max_chains: int = 512
    pair_batch: int = 16
    strategy: str = "selfjoin"
    window: int = 4
    max_hsps_global: int = 32_768
    max_seed_pairs: int = 1 << 20
    max_budget_slices: int = 64
    hard_budget_slices: int = 1024
    max_selfjoin_bp: int = 1 << 26


@functools.lru_cache(maxsize=32)
def get_pair_aligner(cfg: AlignConfig, params: CoarseParams
                     ) -> "PairAligner":
    """One aligner a (config, geometry), as the JAX package caches it."""
    return PairAligner(cfg, params)


class PairAligner:
    """Batched segment-pair aligner over per-segment sorted indexes."""

    def __init__(self, cfg: AlignConfig, params: CoarseParams):
        self.cfg = cfg
        self.p = params

    def prepare(self, segs: np.ndarray, device
                ) -> Tuple[torch.Tensor, KmerIndex, KmerIndex]:
        """Segments uint8 [n_segs, S] -> (their k-mer codes, the forward
        and reverse-complement bucketed indexes), on `device`."""
        k = self.cfg.kmer_size
        segs_d = torch.from_numpy(segs).to(device)
        return (enc.kmer_codes(segs_d, k),
                build_index(segs_d, k, buckets=True),
                build_index(enc.revcomp(segs_d), k, buckets=True))

    def align_pairs(self, km: torch.Tensor, fwd: KmerIndex, rc: KmerIndex,
                    pairs: np.ndarray) -> Tuple[Chains, Chains]:
        """pairs int [B, 2] of (query seg, subject seg), an array or a
        tensor -> the forward and reverse-complement chains [B,
        max_chains] of each pair (a self pair drops its own diagonal)."""
        cfg, p = self.cfg, self.p
        dev = km.device
        bi = torch.as_tensor(pairs[:, 0], device=dev)
        bj = torch.as_tensor(pairs[:, 1], device=dev)
        hsp_kw = dict(k=cfg.kmer_size, stride=p.stride,
                      max_hits=p.max_hits, diag_band=p.diag_band,
                      run_gap=p.run_gap, min_seeds=p.min_seeds,
                      min_hsp_len=cfg.min_hsp_len, max_hsps=p.max_hsps)
        chain_kw = dict(extend_threshold=cfg.fixed_extend_base_threshold,
                        max_chains=p.max_chains, min_len=80)
        rows = lambda ix: KmerIndex(ix.codes[bj], ix.pos[bj], ix.buckets[bj])
        q = km[bi]
        fh = pair_hsps(q, rows(fwd), exclude_self=bi == bj, **hsp_kw)
        rh = pair_hsps(q, rows(rc), exclude_self=False, **hsp_kw)
        return chain_hsps(fh, **chain_kw), chain_hsps(rh, **chain_kw)


def _chains_to_intervals(fc: Chains, rch: Chains, pairs: np.ndarray,
                         seg_len: int) -> np.ndarray:
    """Chain batches -> flat-coordinate candidate intervals [N, 2] (query
    spans, then subject spans, forward chains before rc ones)."""
    out: List[np.ndarray] = []
    for chains, is_rc in ((fc, False), (rch, True)):
        qs, qe, ss, se = (t.cpu().numpy() for t in
                          (chains.qs, chains.qe, chains.ss, chains.se))
        valid = chains.valid.cpu().numpy()          # [B, C]
        if not valid.any():
            continue
        qoff = (pairs[:, 0] * seg_len)[:, None]
        soff = (pairs[:, 1] * seg_len)[:, None]
        if is_rc:
            # the index was built on revcomp(segment): spans cover
            # [p, p+k), so the base-coordinate length is seg_len
            s0, s1 = seg_len - se, seg_len - ss
        else:
            s0, s1 = ss, se
        b_idx, c_idx = np.nonzero(valid)
        out.append(np.stack([(qs + qoff)[b_idx, c_idx],
                             (qe + qoff)[b_idx, c_idx]], axis=1))
        out.append(np.stack([(s0 + soff)[b_idx, c_idx],
                             (s1 + soff)[b_idx, c_idx]], axis=1))
    if not out:
        return np.zeros((0, 2), dtype=np.int64)
    return np.concatenate(out).astype(np.int64)


def _pairs_intervals(genome: Genome, cfg: AlignConfig, p: CoarseParams,
                     use_masked: bool) -> np.ndarray:
    """Candidate intervals of every live segment pair (i, j <= i), batched
    to `p.pair_batch` pairs (the last batch padded with its last pair)."""
    segs = genome.segment_view(p.seg_len, use_masked=use_masked)
    n_segs = segs.shape[0]
    aligner = get_pair_aligner(cfg, p)
    with stage_timer("coarse.prepare"):
        km, fwd, rc = aligner.prepare(segs, genome.device)
    # skip pairs where either side is (almost) fully masked
    live = (segs < 4).mean(axis=1) >= 0.02
    all_pairs = np.array(
        [(i, j) for i in range(n_segs) for j in range(i + 1)
         if live[i] and live[j]], dtype=np.int64).reshape(-1, 2)
    cand: List[np.ndarray] = []
    with stage_timer("coarse.align"):
        for b0 in range(0, len(all_pairs), p.pair_batch):
            batch = all_pairs[b0 : b0 + p.pair_batch]
            pad = np.repeat(batch[-1:], p.pair_batch - len(batch), axis=0)
            fc, rch = aligner.align_pairs(km, fwd, rc,
                                          np.concatenate([batch, pad]))
            n = len(batch)
            cand.append(_chains_to_intervals(
                Chains(*(t[:n] for t in fc)), Chains(*(t[:n] for t in rch)),
                batch, p.seg_len))
    return np.concatenate(cand) if cand else np.zeros((0, 2), np.int64)


def _chunk_grid(L: int, C: int, halo: int) -> List[int]:
    """Overlapping-chunk start offsets (the JAX package's grid)."""
    if L <= C:
        return [0]
    step = max(1, C - 2 * halo)
    starts = [min(s, max(0, L - C))
              for s in range(0, max(1, L - 2 * halo), step)]
    return sorted(set(starts))


def chunk_slice(flat: torch.Tensor, c0: int, C: int) -> torch.Tensor:
    """flat[c0 : c0 + C] with the start clamped in bounds
    (`lax.dynamic_slice` semantics)."""
    c0 = min(max(int(c0), 0), flat.shape[0] - C)
    return flat[c0 : c0 + C]


def _selfjoin_intervals(genome: Genome, cfg: AlignConfig, p: CoarseParams,
                        use_masked: bool, halo: int = 30_000) -> np.ndarray:
    """Candidate intervals via the whole-genome self-join (chunked past
    `p.max_selfjoin_bp`; halo-overlap duplicates collapse in dedup)."""
    flat_d, L = genome.device_flat_padded(use_masked)
    Lp = flat_d.shape[0]
    C = p.max_selfjoin_bp
    if Lp <= C:
        return _selfjoin_chunk(flat_d, 0, cfg, p)
    out: List[np.ndarray] = []
    with stage_timer("coarse.chunked_selfjoin"):
        for c0 in _chunk_grid(L, C, halo):
            count("coarse.selfjoin.chunks")
            got = _selfjoin_chunk(chunk_slice(flat_d, c0, C), c0, cfg, p)
            if len(got):
                out.append(got)
    if not out:
        return np.zeros((0, 2), dtype=np.int64)
    return np.concatenate(out)


# scan slices per call (bounds the [K, S] scan temporaries)
SCAN_SLICES_PER_PROGRAM = 64


def _selfjoin_intervals_mesh(genome: Genome, cfg: AlignConfig,
                             p: CoarseParams, use_masked: bool, halo: int,
                             mesh: Mesh) -> np.ndarray:
    """The chunked self-join with the chunk batch sharded over the mesh's
    "dp" axis (chunks replicated over "tp"; one replica computes each).

    The chunks are the single path's grid (`_chunk_grid` over C =
    min(max_selfjoin_bp, Lp)), the batch padded to a multiple of dp with
    all-N chunks.  As in the JAX package's mesh path, ONE scan budget is
    sized from the largest chunk's seed-pair count, computed on the host
    after every shard's sorts, and capped at SCAN_SLICES_PER_PROGRAM
    with a warning; each chunk then scans unwindowed with that budget.
    Past the cap this drops seed pairs that the single path's windowed
    scan keeps (ROADMAP queue 3, quirk 12)."""
    flat_d, L = genome.device_flat_padded(use_masked)
    C = min(p.max_selfjoin_bp, flat_d.shape[0])
    starts = _chunk_grid(L, C, halo)
    dp = mesh.shape["dp"]
    n_chunks = -(-len(starts) // dp) * dp
    # chunk i is flat[s : s + C]; s + C <= max(C, L) <= Lp, and the
    # padded tail of flat is N like the JAX package's host-built chunks
    chunks = torch.stack([flat_d[s : s + C] for s in starts]
                         + [torch.full((C,), enc.CODE_N, dtype=torch.uint8,
                                       device=flat_d.device)]
                         * (n_chunks - len(starts)))
    shards = shard_rows(mesh, chunks, axes=("dp",))
    sorted_parts = []
    with stage_timer("coarse.selfjoin.mesh_sort"):
        for dev, (part,) in shards:
            with device_guard(dev):
                sorted_parts.append((dev, [selfjoin_sorted(
                    c, k=cfg.kmer_size, window=p.window,
                    diag_band=p.diag_band) for c in part]))
        n_pairs = max(int(srt[3]) for _d, per in sorted_parts
                      for srt in per)
    slices = _sized_slices(n_pairs, p)
    if slices > SCAN_SLICES_PER_PROGRAM:
        logger.warning(
            "coarse.selfjoin.mesh: capping scan at %d slices (needed %d)",
            SCAN_SLICES_PER_PROGRAM, slices)
        slices = SCAN_SLICES_PER_PROGRAM
    kw = dict(k=cfg.kmer_size, run_gap=p.run_gap, min_seeds=p.min_seeds,
              min_hsp_len=cfg.min_hsp_len, max_hsps=p.max_hsps_global,
              max_seed_pairs=p.max_seed_pairs, budget_slices=slices)
    with stage_timer("coarse.selfjoin.mesh_scan"):
        scanned = []
        for dev, per in sorted_parts:
            with device_guard(dev):
                scanned += [selfjoin_scan_packed(*srt, **kw) for srt in per]
        packed = [t.cpu().numpy() for t in scanned]
    out: List[np.ndarray] = []
    for i, c0 in enumerate(starts):
        got = _chunk_hsps_to_intervals(packed[i], C, cfg)
        if len(got):
            out.append(got + c0)
    if not out:
        return np.zeros((0, 2), dtype=np.int64)
    return np.concatenate(out)


def _scan_windowed(s_dbin, s_qpos, s_spos, n_pairs_d, slices: int,
                   cfg: AlignConfig, p: CoarseParams) -> np.ndarray:
    """selfjoin_scan_packed over `slices` budget slices, at most
    SCAN_SLICES_PER_PROGRAM per call (window boundaries split runs like
    slice boundaries; chaining re-merges them)."""
    W = SCAN_SLICES_PER_PROGRAM
    kw = dict(k=cfg.kmer_size, run_gap=p.run_gap, min_seeds=p.min_seeds,
              min_hsp_len=cfg.min_hsp_len, max_hsps=p.max_hsps_global,
              max_seed_pairs=p.max_seed_pairs)
    if slices <= W:
        return selfjoin_scan_packed(s_dbin, s_qpos, s_spos, n_pairs_d,
                                    budget_slices=slices, **kw).cpu().numpy()
    S = p.max_seed_pairs
    n = s_qpos.shape[0]
    outs = []
    for w0 in range(0, slices, W):
        start = min(w0 * S, max(0, n - W * S))
        sub = [a[start : start + W * S] for a in (s_dbin, s_qpos, s_spos)]
        outs.append(selfjoin_scan_packed(
            sub[0], sub[1], sub[2], n_pairs_d, budget_slices=W,
            **kw).cpu().numpy())
    return np.concatenate(outs, axis=1)


def _sized_slices(n_pairs: int, p: CoarseParams) -> int:
    """Scan-slice count (a power of two) sized from the measured seed-pair
    count, auto-scaling past the soft cap up to the hard one."""
    need = -(-max(n_pairs, 1) // p.max_seed_pairs)
    slices = 1 if need <= 1 else 1 << (need - 1).bit_length()
    if slices > p.max_budget_slices:
        if slices <= p.hard_budget_slices:
            logger.info(
                "coarse.selfjoin: %d seed pairs -> auto-scaled to %d scan "
                "slices (soft cap %d)", n_pairs, slices, p.max_budget_slices)
        else:
            slices = p.hard_budget_slices
            logger.warning(
                "coarse.selfjoin: %d seed pairs saturate even the hard "
                "%d-slice budget; high-diagonal-band seeds dropped",
                n_pairs, slices)
    elif slices > 1:
        logger.info("coarse.selfjoin: %d seed pairs -> %d scan slices",
                    n_pairs, slices)
    return slices


def _chunk_hsps_to_intervals(packed: np.ndarray, Lp: int,
                             cfg: AlignConfig) -> np.ndarray:
    """Packed HSP rows of one chunk -> chained chunk-local intervals."""
    valid = packed[4].astype(bool)
    qs, qe, ss, se = (packed[i][valid] for i in range(4))
    out: List[np.ndarray] = []
    for m, is_rc in ((ss < Lp, False), (ss >= Lp, True)):
        if not m.any():
            continue
        chains = chain_hsps_host(
            qs[m], qe[m], ss[m], se[m],
            extend_threshold=cfg.fixed_extend_base_threshold, min_len=80)
        if not len(chains):
            continue
        out.append(chains[:, 0:2])
        s_iv = chains[:, 2:4]
        if is_rc:
            s_iv = np.stack([2 * Lp - s_iv[:, 1], 2 * Lp - s_iv[:, 0]],
                            axis=1)
        out.append(s_iv)
    if not out:
        return np.zeros((0, 2), dtype=np.int64)
    return np.concatenate(out).astype(np.int64)


def _selfjoin_chunk(flat_d: torch.Tensor, offset: int, cfg: AlignConfig,
                    p: CoarseParams) -> np.ndarray:
    """Self-join one device-resident chunk; returns flat-genome intervals."""
    Lp = flat_d.shape[0]
    with stage_timer("coarse.selfjoin"):
        s_dbin, s_qpos, s_spos, n_pairs_d = selfjoin_sorted(
            flat_d, k=cfg.kmer_size, window=p.window, diag_band=p.diag_band)
        slices = _sized_slices(int(n_pairs_d), p)
        packed = _scan_windowed(s_dbin, s_qpos, s_spos, n_pairs_d,
                                slices, cfg, p)
    with stage_timer("coarse.chain"):
        got = _chunk_hsps_to_intervals(packed, Lp, cfg)
    return got + offset if len(got) else got


def coarse_discover(
    genome: Genome,
    cfg: AlignConfig,
    params: Optional[CoarseParams] = None,
    use_masked: bool = True,
    max_repeat_len: int = 30_000,
    min_repeat_len: int = 80,
    mesh: Optional[Mesh] = None,
) -> np.ndarray:
    """Candidate repeat intervals (flat coords): int64 [N, 2], deduped.
    With `mesh`, the self-join strategy shards its chunk batch over the
    mesh's "dp" axis (`_selfjoin_intervals_mesh`)."""
    p = params or CoarseParams()
    if p.strategy == "selfjoin" and mesh is not None:
        intervals = _selfjoin_intervals_mesh(genome, cfg, p, use_masked,
                                             halo=max_repeat_len, mesh=mesh)
    elif p.strategy == "selfjoin":
        intervals = _selfjoin_intervals(genome, cfg, p, use_masked,
                                        halo=max_repeat_len)
    elif p.strategy == "pairs":
        intervals = _pairs_intervals(genome, cfg, p, use_masked)
    else:
        raise ValueError(f"unknown coarse strategy {p.strategy!r}")
    return _dedup_intervals(intervals, genome, cfg, min_repeat_len,
                            max_repeat_len)


def _dedup_intervals(intervals: np.ndarray, genome: Genome,
                     cfg: AlignConfig, min_repeat_len: int,
                     max_repeat_len: int) -> np.ndarray:
    """Length gate, 10bp-rounded dedup, >=95%-mutual-overlap merge,
    contig containment (`Util.py:4344-4395`)."""
    if len(intervals) == 0:
        return intervals
    with stage_timer("coarse.dedup"):
        lens = intervals[:, 1] - intervals[:, 0]
        keep = (lens >= min_repeat_len) & (lens < max_repeat_len)
        intervals = intervals[keep]
        intervals, _ = iv.dedup(intervals, q=cfg.round_coord_bp)
        groups = iv.mutual_overlap_groups(intervals, frac=cfg.merge_overlap)
        lens = intervals[:, 1] - intervals[:, 0]
        best: dict = {}
        for i, g in enumerate(groups):
            if g not in best or lens[i] > lens[best[g]]:
                best[g] = i
        intervals = intervals[sorted(best.values())]
    ok = genome.in_contig(intervals[:, 0], intervals[:, 1])
    intervals = intervals[ok]
    logger.info("coarse_discover: %d candidate repeat intervals",
                len(intervals))
    return intervals
