"""Genome-wide full-length copy retrieval (minimap2 replacement).

Counterpart of the JAX `pipeline/copies.py`.  Strategy "join" (the
default): each batch of candidates is mapped against the whole genome by
ONE sort-merge k-mer join (`ops.libjoin`) — indexed against a genome
stream sorted once and cached on the genome, or chunked with a halo past
`max_libjoin_bp` — then chained exactly per (candidate, strand, contig)
on the host; chains covering >= `min_coverage` of the candidate on both
sides are its copies.  Candidates that share join k-mers are dealt into
similarity waves so none starves of pairing slots.  Strategy "segments"
(an explicit opt-in): the legacy mapper, every candidate against each
genome segment's bucketed k-mer index (`ops.seedext`), chained on the
device (`ops.chain.chain_hsps`), a block of segments at a time.

With a `mesh` (`parallel.mesh.Mesh`) the segments mapper cuts its
candidate batch over every mesh device, each segment's index replicated
(the JAX package's `_cached_map_batch_sharded`); it keeps the single
path's segment blocks and their row order, so its hits equal the
unsharded mapper's.  The join under a mesh runs on the genome's device,
as the JAX package's join does on its CPU backend (it shards the genome
stream only on a TPU, with results identical either way); its indexed
cache key carries the mesh's identity, as the JAX package's does.
Partitioning the genome stream across cards is a multi-GPU sort whose
exactness against the per-code caps (`_join_max_occ`, `fill_w`) is still
to be shown (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hite_tpu_torch.config import AlignConfig
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.ops import encode as enc
from hite_tpu_torch.ops.chain import Chains, chain_hsps, chain_hsps_host
from hite_tpu_torch.ops.kmer import KmerIndex, build_index
from hite_tpu_torch.ops.libjoin import (
    libjoin_genome_sorted, libjoin_pairs, libjoin_pairs_indexed,
    libjoin_scan_packed,
)
from hite_tpu_torch.ops.seedext import pair_hsps
from hite_tpu_torch.parallel.mesh import Mesh, replicate, run_sharded
from hite_tpu_torch.pipeline.candidates import pad_rows, pad_seqs
from hite_tpu_torch.pipeline.coarse import chunk_slice
from hite_tpu_torch.utils.log import count, logger


@dataclass
class CopyHit:
    """One genomic copy of a candidate: flat interval + strand + seeds."""

    start: int
    end: int
    strand: int      # 0 = forward, 1 = reverse
    nseeds: int


class GenomeIndex:
    """Genome handle for copy retrieval.  The join needs only the genome's
    cached device upload; the segments mapper's per-segment sorted
    indexes (forward and reverse complement, with prefix buckets) are
    built on first access."""

    def __init__(self, genome: Genome, cfg: AlignConfig,
                 seg_len: int = 131_072, use_masked: bool = False):
        self.genome = genome
        self.cfg = cfg
        self.seg_len = seg_len
        self.use_masked = use_masked
        src = (genome.masked if (use_masked and genome.masked is not None)
               else genome.flat)
        self.n_segs = (len(src) + seg_len - 1) // seg_len
        self._built = None

    def _indexes(self) -> Tuple[KmerIndex, KmerIndex]:
        if self._built is None:
            segs = torch.from_numpy(self.genome.segment_view(
                self.seg_len, use_masked=self.use_masked)).to(
                    self.genome.device)
            k = self.cfg.kmer_size
            self._built = (build_index(segs, k, buckets=True),
                           build_index(enc.revcomp(segs), k, buckets=True))
        return self._built

    @property
    def fwd(self) -> KmerIndex:
        return self._indexes()[0]

    @property
    def rc(self) -> KmerIndex:
        return self._indexes()[1]


def _segment(index: KmerIndex, s: int) -> KmerIndex:
    return KmerIndex(index.codes[s], index.pos[s], index.buckets[s])


def _map_batch(cfg: AlignConfig, cand_kms: torch.Tensor, fwd: KmerIndex,
               rc: KmerIndex, *, stride: int, max_hits: int, diag_band: int,
               run_gap: int, min_seeds: int, max_hsps: int,
               max_chains: int) -> Tuple[Chains, Chains]:
    """Candidate k-mer rows int32 [B, Qk] against ONE segment's forward
    and reverse-complement indexes: the chains [B, max_chains] of each
    strand (the JAX package's `_cached_map_batch`, vmapped there)."""
    hsp_kw = dict(k=cfg.kmer_size, min_hsp_len=cfg.min_hsp_len,
                  stride=stride, max_hits=max_hits, diag_band=diag_band,
                  run_gap=run_gap, min_seeds=min_seeds, max_hsps=max_hsps)
    chain_kw = dict(extend_threshold=cfg.fixed_extend_base_threshold,
                    max_chains=max_chains, min_len=50)
    fc = chain_hsps(pair_hsps(cand_kms, fwd, **hsp_kw), **chain_kw)
    rch = chain_hsps(pair_hsps(cand_kms, rc, **hsp_kw), **chain_kw)
    return fc, rch


def _map_block(cfg: AlignConfig, cand_mat: torch.Tensor, gindex: GenomeIndex,
               s0: int, seg_block: int, out_budget: int,
               mesh: Optional[Mesh] = None, reps: Optional[dict] = None,
               **geom) -> Tuple[np.ndarray, int]:
    """A candidate batch uint8 [B, W] against the segment block [s0, s0 +
    seg_block): (the first `out_budget` valid chains as int32 [n, 8] rows
    (cand, seg, strand, qs, qe, ss, se, nseeds), the count of valid
    chains).  Rows run strand-major, then segment, candidate and chain,
    the order of the JAX package's `_cached_map_block` compaction.  With
    `mesh`, each segment's candidate batch is cut over the mesh, every
    shard against `reps[device]`, that device's (fwd, rc) indexes."""
    cand_kms = enc.kmer_codes(cand_mat, cfg.kmer_size)
    parts: List[List[torch.Tensor]] = [[], []]
    for s in range(s0, s0 + seg_block):
        if mesh is None:
            fc, rch = _map_batch(cfg, cand_kms, _segment(gindex.fwd, s),
                                 _segment(gindex.rc, s), **geom)
        else:
            def one(km: torch.Tensor, s: int = s) -> Tuple[Chains, Chains]:
                fwd, rc = reps[km.device]
                return _map_batch(cfg, km, _segment(fwd, s),
                                  _segment(rc, s), **geom)

            fc, rch = run_sharded(mesh, one, cand_kms,
                                  device=cand_kms.device)
        for strand, ch in ((0, fc), (1, rch)):
            B, C = ch.qs.shape
            cand_i = torch.arange(B, dtype=torch.int32,
                                  device=ch.qs.device)[:, None].expand(B, C)
            row = torch.stack([cand_i, torch.full_like(cand_i, s),
                               torch.full_like(cand_i, strand), ch.qs,
                               ch.qe, ch.ss, ch.se, ch.nseeds], dim=-1)
            parts[strand].append(row[ch.valid])
    rows = torch.cat(parts[0] + parts[1]).cpu().numpy()
    return rows[:out_budget], len(rows)


class CopyFinder:
    """Batched candidate -> genome copy mapping: sort-merge joins
    (strategy "join", the default) or the legacy per-segment mapper
    (strategy "segments", an explicit opt-in; `stride`, `max_hits`,
    `max_hsps` and `max_chains` are its kernel geometry)."""

    def __init__(self, index: GenomeIndex, *, stride: int = 1,
                 max_hits: int = 8, diag_band: int = 32, run_gap: int = 96,
                 min_seeds: int = 4, max_hsps: int = 1024,
                 max_chains: int = 128, mesh: Optional[Mesh] = None,
                 strategy: str = "join", fill_w: int = 8):
        if strategy not in ("join", "segments"):
            raise ValueError(f"unknown copy strategy {strategy!r}")
        self.index = index
        self.mesh = mesh
        self.strategy = strategy
        # the segments mapper's candidate rows divide over the mesh
        self._batch_multiple = (mesh.size if mesh is not None
                                and strategy == "segments" else 1)
        self.diag_band = diag_band
        self.run_gap = run_gap
        self.min_seeds = min_seeds
        self._geom = dict(stride=stride, max_hits=max_hits,
                          diag_band=diag_band, run_gap=run_gap,
                          min_seeds=min_seeds, max_hsps=max_hsps,
                          max_chains=max_chains)
        self._seg_block = min(8, index.n_segs)
        self._out_budget = 1 << 15
        self._join_slice = 1 << 20
        self._join_quota = 1 << 19
        self._join_budget = 1 << 20
        self._join_max_slices = 64
        self._join_fill_w = fill_w
        self._join_max_occ = 1024
        self._join_max_hsps = 1 << 15
        self.max_libjoin_bp = 1 << 24

    def find_copies(self, cand_seqs: Sequence[np.ndarray], *,
                    min_coverage: float = 0.95, max_copies: int = 100,
                    max_len_ratio: float = 1.2, min_abs_len: int = 0
                    ) -> List[List[CopyHit]]:
        """Up to max_copies full-length CopyHits per candidate;
        `min_abs_len > 0` additionally keeps fragment hits of that size."""
        if not cand_seqs:
            return []
        kw = dict(min_coverage=min_coverage, max_copies=max_copies,
                  max_len_ratio=max_len_ratio, min_abs_len=min_abs_len)
        if self.strategy == "segments":
            return self._find_copies_segments(cand_seqs, **kw)
        return self._find_copies_join(cand_seqs, **kw)

    def _find_copies_segments(self, cand_seqs, *, min_coverage, max_copies,
                              max_len_ratio, min_abs_len=0):
        """Every candidate against each block of segments; chains covering
        >= min_coverage of the candidate (or, with `min_abs_len`, fragment
        chains of that size) are its copies."""
        idx = self.index
        cfg = idx.cfg
        n_c = len(cand_seqs)
        out: List[List[CopyHit]] = [[] for _ in cand_seqs]
        m = self._batch_multiple
        n_rows = pad_rows(n_c, min_rows=max(4, m))
        mat, lens = pad_seqs(cand_seqs, n_rows=-(-n_rows // m) * m)
        lens_f = np.maximum(lens[:n_c].astype(np.float64), 1)

        def _collect(rows: np.ndarray) -> None:
            cand, seg, strand = rows[:, 0], rows[:, 1], rows[:, 2]
            qs, qe, ss, se, ns = (rows[:, i] for i in range(3, 8))
            keep = cand < n_c
            lf = lens_f[np.minimum(cand, n_c - 1)]
            slen = se - ss
            full = (((qe - qs) >= min_coverage * lf)
                    & (slen >= min_coverage * lf)
                    & (slen <= max_len_ratio * lf))
            if min_abs_len:
                qlen_r = qe - qs
                frag = ((qlen_r >= min_abs_len) & (slen >= 0.7 * qlen_r)
                        & (slen <= 1.5 * qlen_r))
                keep &= full | frag
            else:
                keep &= full
            for i in np.nonzero(keep)[0]:
                s0, s1 = int(ss[i]), int(se[i])
                if strand[i] == 1:
                    s0, s1 = idx.seg_len - s1, idx.seg_len - s0
                soff = int(seg[i]) * idx.seg_len
                out[int(cand[i])].append(CopyHit(
                    start=soff + s0, end=soff + s1,
                    strand=int(strand[i]), nseeds=int(ns[i])))

        SB = self._seg_block
        starts = sorted({min(s, idx.n_segs - SB)
                         for s in range(0, idx.n_segs, SB)})
        # candidate rows a call capped by width (2^21 cells); the JAX
        # package pads the last call to row_cap all-N rows for its static
        # shapes, which yield no chains, so the port runs the real rows
        W = mat.shape[1]
        row_cap = max(8, (1 << 21) // W)
        row_cap = 1 << (row_cap.bit_length() - 1)
        reps = (None if self.mesh is None else replicate(
            (idx.fwd, idx.rc), self.mesh.shard_devices()))
        for b0 in range(0, mat.shape[0], row_cap):
            sub_d = torch.from_numpy(mat[b0 : b0 + row_cap]).to(
                idx.genome.device)
            seen: set = set()
            for s0 in starts:
                rows, n_hits = _map_block(cfg, sub_d, idx, s0, SB,
                                          self._out_budget, self.mesh, reps,
                                          **self._geom)
                if n_hits > self._out_budget:
                    logger.warning(
                        "find_copies: %d hits exceed the %d block budget; "
                        "truncated", n_hits, self._out_budget)
                if len(rows):
                    rows = rows.copy()
                    rows[:, 0] += b0           # sub-batch -> global cand
                    # overlapping final block: drop re-mapped segments
                    fresh = np.array([s not in seen for s in rows[:, 1]])
                    _collect(rows[fresh])
                seen.update(range(s0, s0 + SB))
        return _dedup_cap(out, max_copies)

    def _find_copies_join(self, cand_seqs, *, min_coverage, max_copies,
                          max_len_ratio, min_abs_len=0):
        """Deal k-mer-sharing candidates into waves of <= fill_w/2 members
        of one group; each wave is one whole-genome join."""
        groups = _kmer_sketch_groups(cand_seqs, k=self.index.cfg.kmer_size,
                                     thresh=0.15)
        chunk = max(1, self._join_fill_w // 2)
        waves: dict = {}
        seen: dict = {}
        for i, g in enumerate(groups):
            j = seen.get(g, 0)
            seen[g] = j + 1
            waves.setdefault(j // chunk, []).append(i)
        kw = dict(min_coverage=min_coverage, max_copies=max_copies,
                  max_len_ratio=max_len_ratio, min_abs_len=min_abs_len)
        if len(waves) == 1:
            return self._find_copies_join_batch(cand_seqs, **kw)
        logger.info("find_copies.join: %d candidates in %d similarity waves",
                    len(cand_seqs), len(waves))
        out: List[List[CopyHit]] = [[] for _ in cand_seqs]
        for _, idxs in sorted(waves.items()):
            sub = self._find_copies_join_batch([cand_seqs[i] for i in idxs],
                                               **kw)
            for i, hits in zip(idxs, sub):
                out[i] = hits
        return out

    def _find_copies_join_batch(self, cand_seqs, *, min_coverage,
                                max_copies, max_len_ratio, min_abs_len=0):
        """One whole-genome join for a batch of candidates + exact chaining
        per (candidate, strand, contig) of the compacted HSP rows."""
        idx = self.index
        cfg = idx.cfg
        genome = idx.genome
        dev = genome.device
        k = cfg.kmer_size
        n_c = len(cand_seqs)
        out: List[List[CopyHit]] = [[] for _ in cand_seqs]

        lens = np.array([len(s) for s in cand_seqs], dtype=np.int64)
        if lens.sum() == 0:
            return out
        starts = np.concatenate([[0], np.cumsum(lens[:-1] + 1)])
        P = pad_rows(int(lens.sum()) + n_c, min_rows=1024)
        cand_flat = np.full(P, 4, dtype=np.uint8)
        cand_id = np.zeros(P, dtype=np.int32)
        for i, s in enumerate(cand_seqs):
            cand_flat[starts[i] : starts[i] + lens[i]] = s
            cand_id[starts[i] : starts[i] + lens[i]] = i
        cand_flat_d = torch.from_numpy(cand_flat).to(dev)
        cand_id_d = torch.from_numpy(cand_id).to(dev)
        lens_f = np.maximum(lens.astype(np.float64), 1)

        def _one_chunk(chunk_d, c0: int, Cl: int, g_sorted=None) -> None:
            # a chunk whose seed pairs overflow the per-slice quota RETRIES
            # with a doubled quota (at most twice) instead of dropping seeds
            quota = self._join_quota
            jkw = dict(k=k, diag_band=self.diag_band,
                       fill_w=self._join_fill_w, max_occ=self._join_max_occ,
                       slice_size=self._join_slice)
            for _attempt in range(3):
                if g_sorted is not None:
                    res = libjoin_pairs_indexed(*g_sorted, cand_flat_d,
                                                cand_id_d, slice_quota=quota,
                                                **jkw)
                else:
                    res = libjoin_pairs(chunk_d, cand_flat_d, cand_id_d,
                                        slice_quota=quota, **jkw)
                s_cand, s_dbin, s_qpos, s_spos, counts_d = res
                n_total, n_emit = (int(x) for x in counts_d.cpu().numpy())
                if n_total <= n_emit or quota >= 4 * self._join_quota:
                    break
                quota *= 2
                logger.info(
                    "find_copies.join: %d seed pairs exceeded the "
                    "per-slice quota (%d emitted); retrying at quota %d",
                    n_total, n_emit, quota)
            if n_total > n_emit:
                logger.warning(
                    "find_copies.join: %d seed pairs exceeded the per-slice "
                    "quota; %d emitted", n_total, n_emit)
            need = -(-max(n_emit, 1) // self._join_budget)
            slices = 1 if need <= 1 else 1 << (need - 1).bit_length()
            if slices > self._join_max_slices:
                logger.warning(
                    "find_copies.join: %d pairs exceed %d slices x %d "
                    "budget; tail dropped", n_emit, self._join_max_slices,
                    self._join_budget)
                slices = self._join_max_slices
            packed = libjoin_scan_packed(
                s_cand, s_dbin, s_qpos, s_spos, k=k, run_gap=self.run_gap,
                min_seeds=self.min_seeds, min_hsp_len=cfg.min_hsp_len,
                max_hsps=self._join_max_hsps,
                max_seed_pairs=self._join_budget,
                budget_slices=slices).cpu().numpy()
            cand, qs, qe, ss, se, ns, valid = (
                packed[i].astype(np.int64) for i in range(7))
            n_good = int(packed[7, 0])
            if n_good > int(valid.sum()):
                logger.warning(
                    "find_copies.join: %d HSPs exceed the %d output quota; "
                    "truncated", n_good, int(valid.sum()))
            m = (valid != 0) & (cand < n_c)
            if not m.any():
                return
            cand, qs, qe, ss, se, ns = (a[m] for a in
                                        (cand, qs, qe, ss, se, ns))
            strand = (ss >= Cl).astype(np.int64)
            # chains never span contigs: subject contig joins the group key
            mid = (ss + se) // 2
            fwd_mid = np.where(strand == 1, 2 * Cl - mid, mid) + c0
            ctg, _ = genome.contig_of(
                np.clip(fwd_mid, 0, len(genome.flat) - 1))
            key = (cand * 2 + strand) * (len(genome.names) + 1) + ctg
            order = np.argsort(key, kind="stable")
            key = key[order]
            cand, qs, qe, ss, se, ns = (a[order] for a in
                                        (cand, qs, qe, ss, se, ns))
            bounds = np.concatenate(
                [[0], np.nonzero(np.diff(key))[0] + 1, [len(key)]])
            for b0, b1 in zip(bounds[:-1], bounds[1:]):
                ci = int(cand[b0])
                st = int(strand[b0])
                g_qs, g_qe = qs[b0:b1], qe[b0:b1]
                g_ss, g_se, g_ns = ss[b0:b1], se[b0:b1], ns[b0:b1]
                T_ci = int(min(cfg.fixed_extend_base_threshold,
                               max(100, lens[ci] // 2)))
                ch = chain_hsps_host(g_qs, g_qe, g_ss, g_se,
                                     extend_threshold=T_ci, min_len=50,
                                     diag_tol=T_ci)
                if min_abs_len:
                    # tight-diagonal fragment pass: keeps per-unit chains
                    # of head-to-tail tandem arrays as fragment hits
                    ch2 = chain_hsps_host(g_qs, g_qe, g_ss, g_se,
                                          extend_threshold=T_ci, min_len=50,
                                          diag_tol=self.run_gap)
                    if len(ch2):
                        ch = np.concatenate([ch, ch2]) if len(ch) else ch2
                if not len(ch):
                    continue
                lf = lens_f[ci]
                qlen = ch[:, 1] - ch[:, 0]
                slen = ch[:, 3] - ch[:, 2]
                keep = ((qlen >= min_coverage * lf)
                        & (slen >= min_coverage * lf)
                        & (slen <= max_len_ratio * lf))
                if min_abs_len:
                    keep |= ((qlen >= min_abs_len) & (slen >= 0.7 * qlen)
                             & (slen <= 1.5 * qlen))
                if not keep.any():
                    continue
                ch = ch[keep]
                cont = ((g_qs[None, :] >= ch[:, 0:1])
                        & (g_qe[None, :] <= ch[:, 1:2])
                        & (g_ss[None, :] >= ch[:, 2:3])
                        & (g_se[None, :] <= ch[:, 3:4]))
                ch_ns = cont @ g_ns
                if st == 1:
                    s0 = 2 * Cl - ch[:, 3]
                    s1 = 2 * Cl - ch[:, 2]
                else:
                    s0, s1 = ch[:, 2], ch[:, 3]
                for j in range(len(ch)):
                    out[ci].append(CopyHit(
                        start=c0 + int(s0[j]), end=c0 + int(s1[j]),
                        strand=st, nseeds=int(ch_ns[j])))

        flat_d, _L = genome.device_flat_padded(idx.use_masked)
        Lp = int(flat_d.shape[0])
        if Lp <= self.max_libjoin_bp:
            # INDEXED join: the sorted two-strand stream is built once per
            # genome and cached on the genome's device cache.  It is built
            # on the genome's device whatever the mesh, so every mesh
            # shares one entry (the masking eviction reads key[1])
            ck = ("join_sorted", idx.use_masked, k)
            g_sorted = genome._device_cache.get(ck)
            if g_sorted is None:
                g_sorted = libjoin_genome_sorted(flat_d, k=k)
                genome._device_cache[ck] = g_sorted
            _one_chunk(flat_d, 0, Lp, g_sorted=g_sorted)
        else:
            # chunks with a halo: any copy lies whole in at least one chunk;
            # cross-chunk duplicates collapse in the dedup tail
            C = self.max_libjoin_bp
            for c0 in join_chunk_starts(Lp, C, int(lens.max())):
                count("copies.join.chunks")
                _one_chunk(chunk_slice(flat_d, c0, C), c0, C)
        return _dedup_cap(out, max_copies)


def join_chunk_starts(Lp: int, C: int, max_len: int) -> List[int]:
    """Start offsets of the chunked copy join over a padded genome of Lp
    bp: chunks of C bp overlapping by a halo of min(C / 4, max(65,536,
    2 * the longest candidate)), so any copy lies whole in one chunk; the
    last chunk ends at Lp."""
    halo = int(min(C // 4, max(65_536, 2 * max_len)))
    out: List[int] = []
    for c0 in range(0, max(1, Lp - 2 * halo), C - 2 * halo):
        out.append(min(c0, Lp - C))
        if out[-1] == Lp - C:
            break
    return out


_MINHASH_SALTS = np.arange(1, 65, dtype=np.uint64) * np.uint64(
    0x9E3779B97F4A7C15)


def _kmer_sketch_groups(seqs: Sequence[np.ndarray], k: int,
                        thresh: float = 0.15, sketch: int = 64,
                        linkage: str = "single") -> List[int]:
    """Group candidates by exact k-mer sharing (min-hash Jaccard).

    "single": union-find components over pairs >= thresh (join waves);
    "greedy": cd-hit-style founders in length-ascending order (family
    representatives)."""
    n = len(seqs)
    if n <= 1:
        return [0] * n
    salts = _MINHASH_SALTS[:sketch]
    sk = np.full((n, sketch), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    has_sketch = np.zeros(n, bool)
    for i, s in enumerate(seqs):
        v = np.asarray(s, np.int64)
        if len(v) < k:
            continue
        m = len(v) - k + 1
        ok = np.ones(m, bool)
        code = np.zeros(m, np.int64)
        for j in range(k):
            w = v[j : m + j]
            ok &= w < 4
            code = code * 4 + np.where(w < 4, w, 0)
        codes = np.unique(code[ok])
        if not len(codes):
            continue
        h = (codes.astype(np.uint64)[:, None] ^ salts[None, :]) \
            * np.uint64(0xC2B2AE3D27D4EB4F)
        sk[i] = h.min(axis=0)
        has_sketch[i] = True
    if linkage == "greedy":
        order = sorted(range(n), key=lambda i: len(seqs[i]))
        group = np.full(n, -1, np.int64)
        founders: List[int] = []
        for i in order:
            if not has_sketch[i]:
                group[i] = i
                continue
            if founders:
                agree = (sk[founders] == sk[i][None, :]).mean(axis=1)
                j = int(np.argmax(agree))
                if agree[j] >= thresh:
                    group[i] = founders[j]
                    continue
            founders.append(i)
            group[i] = i
        return [int(g) for g in group]

    parent = np.arange(n)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = int(parent[x])
        return x

    B = max(1, (1 << 24) // (n * sketch + 1))
    for a0 in range(0, n, B):
        agree = (sk[a0 : a0 + B, None, :] == sk[None, :, :]).mean(axis=2)
        ii, jj = np.nonzero(agree >= thresh)
        for a, b in zip(ii + a0, jj):
            if a < b and has_sketch[a] and has_sketch[b]:
                ra, rb = find(int(a)), find(int(b))
                if ra != rb:
                    parent[ra] = rb
    return [find(i) for i in range(n)]


def _dedup_cap(out: List[List[CopyHit]], max_copies: int
               ) -> List[List[CopyHit]]:
    """Drop >=80%-overlapping duplicate hits, cap at max_copies per
    candidate (prefer more seeds)."""
    for c, hits in enumerate(out):
        hits.sort(key=lambda h: -h.nseeds)
        kept: List[CopyHit] = []
        for h in hits:
            dup = any(min(h.end, g.end) - max(h.start, g.start)
                      > 0.8 * (h.end - h.start) for g in kept)
            if not dup:
                kept.append(h)
            if len(kept) >= max_copies:
                break
        out[c] = kept
    return out
