"""Library-sequence clustering and nested-insertion removal (counterpart
of the JAX package's `pipeline/libcluster.py`).

Replaces cd-hit-est (`get_nonRedundant_lib.py:33-49`, -c 0.8 -aS/-aL 0.95)
and `remove_nested_lib.py` for library FASTA sets: sequences are packed
into a spacer-separated mini-genome on the given device, mapped against
it all-vs-all by the copy join, and a greedy longest-first pass keeps one
representative per >= coverage cluster; nested insertions (a shorter
entry embedded >= 95% inside a longer one) are excised.  Each function
takes `device` (None = the card); `build_library` passes the genome's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from hite_tpu_torch.config import AlignConfig
from hite_tpu_torch.device import resolve_device
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.models.features import kmer_frequencies
from hite_tpu_torch.ops.boundary import consensus as col_consensus
from hite_tpu_torch.ops.msa import project_to_center
from hite_tpu_torch.pipeline.candidates import bucket_for, pad_rows, pad_seqs
from hite_tpu_torch.pipeline.copies import CopyFinder, GenomeIndex
from hite_tpu_torch.utils.log import logger

SPACER = 100

Hit = Tuple[int, int, int, int, int, int]


def _pack(seqs: Sequence[np.ndarray], device=None
          ) -> Tuple[Genome, np.ndarray]:
    """Pack sequences into a mini-genome; returns (genome, starts [N])."""
    g = Genome.from_dict({f"s{i}": s for i, s in enumerate(seqs)},
                         device=device)
    return g, g.starts.copy()


def _all_pairs_hits(seqs: Sequence[np.ndarray], cfg: AlignConfig,
                    min_chain: int = 50, device=None) -> List[List[Hit]]:
    """For each seq: list of (other, 0, 0, os, oe, nseeds) chain hits of
    at least `min_chain` bp on another sequence."""
    mini, starts = _pack(seqs, device)
    seg_len = 1 << max(14, (len(mini.flat) - 1).bit_length() - 2)
    seg_len = min(seg_len, 1 << 18)
    gindex = GenomeIndex(mini, cfg, seg_len=seg_len)
    # the JAX package passes max_chains=256 here, an argument that only its
    # legacy "segments" mapper reads; the join strategy (the only one
    # ported) ignores it, so the port's CopyFinder does not take it
    finder = CopyFinder(gindex)

    hits: List[List[Hit]] = [[] for _ in seqs]
    copy_sets = finder.find_copies(list(seqs), min_coverage=0.0,
                                   max_copies=256, max_len_ratio=10.0)
    ends = starts + np.array([len(s) for s in seqs])
    for i, chs in enumerate(copy_sets):
        for h in chs:
            j_arr = np.searchsorted(starts, h.start, side="right") - 1
            j = int(np.clip(j_arr, 0, len(seqs) - 1))
            if j == i:
                continue
            if h.end > ends[j] + SPACER // 2:
                continue
            os_ = max(0, h.start - starts[j])
            oe = min(len(seqs[j]), h.end - starts[j])
            if oe - os_ >= min_chain:
                hits[i].append((j, 0, 0, int(os_), int(oe), h.nseeds))
    return hits


def cluster_seqs(
    seqs: Sequence[np.ndarray],
    cfg: AlignConfig,
    *,
    coverage: float = 0.95,
    device=None,
) -> Tuple[np.ndarray, List[int]]:
    """Greedy longest-first clustering by mutual coverage.

    Returns (labels [N] — index of each sequence's representative,
    representative indices in priority order)."""
    n = len(seqs)
    if n == 0:
        return np.zeros(0, np.int64), []
    lens = np.array([len(s) for s in seqs])
    # cov[j, i]: fraction of seq j covered by seq i's mapping onto it
    cov = np.zeros((n, n))
    for i, hs in enumerate(_all_pairs_hits(seqs, cfg, device=device)):
        by_j: Dict[int, List[Tuple[int, int]]] = {}
        for (j, _qs, _qe, os_, oe, _ns) in hs:
            by_j.setdefault(j, []).append((os_, oe))
        for j, spans in by_j.items():
            merged: List[Tuple[int, int]] = []
            for s0, e0 in sorted(spans):
                if merged and s0 <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], e0))
                else:
                    merged.append((s0, e0))
            covered = sum(e0 - s0 for s0, e0 in merged)
            cov[j, i] = covered / max(lens[j], 1)
    order = np.argsort(-lens, kind="stable")
    labels = np.full(n, -1, np.int64)
    reps: List[int] = []
    for i in order:
        if labels[i] >= 0:
            continue
        labels[i] = i
        reps.append(int(i))
        for j in order:
            if labels[j] >= 0 or j == i:
                continue
            if cov[j, i] >= coverage or \
                    cov[i, j] >= coverage * lens[j] / max(lens[i], 1):
                labels[j] = i
    return labels, reps


def subcluster_members(
    member_seqs: Sequence[np.ndarray],
    *,
    k: int = 4,
    dist_threshold: float = 0.25,
    device=None,
) -> List[List[int]]:
    """Split one coverage-cluster into k-mer-distance sub-clusters.

    Stand-in for the per-cluster Ninja tree clustering of
    `deredundant_for_LTR_v5` (`Util.py:12457-12515`): batched 4-mer
    frequency vectors (on `device`) grouped by single-linkage connected
    components at a cosine-distance threshold (in numpy float32, as the
    JAX package computes it).  Returns index lists, largest first."""
    n = len(member_seqs)
    if n <= 1:
        return [list(range(n))]
    dev = resolve_device(device)
    mat, lens = pad_seqs(member_seqs, n_rows=pad_rows(n))
    freqs = kmer_frequencies(torch.from_numpy(mat).to(dev),
                             torch.from_numpy(lens).to(dev),
                             k).cpu().numpy()[:n]
    norm = np.linalg.norm(freqs, axis=1, keepdims=True)
    unit = freqs / np.maximum(norm, 1e-9)
    adj = (1.0 - unit @ unit.T) <= dist_threshold   # cosine distance
    parent = np.arange(n)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(n):
        for j in range(i + 1, n):
            if adj[i, j]:
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[ri] = rj
    groups: Dict[int, List[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    return sorted(groups.values(), key=len, reverse=True)


def _star_consensus(center: np.ndarray, member_seqs: List[np.ndarray],
                    device=None) -> np.ndarray:
    """Majority consensus of members projected onto `center`; the center
    itself when fewer than half its columns keep a base."""
    dev = resolve_device(device)
    width = bucket_for(len(center))
    mat, lens = pad_seqs(member_seqs, width,
                         n_rows=pad_rows(len(member_seqs)))
    c_pad = np.full(width, 4, np.uint8)
    c_pad[: len(center)] = center
    lens_d = torch.from_numpy(lens).to(dev)
    M = project_to_center(torch.from_numpy(c_pad).to(dev),
                          torch.from_numpy(mat).to(dev), lens_d)
    # mask pow2-padding rows so they don't count as gap-majority votes
    cons, _sup = col_consensus(M, row_ok=lens_d > 0)
    cons = cons.cpu().numpy()[: len(center)]
    cons = cons[cons < 4]
    return cons.astype(np.uint8) if len(cons) >= 0.5 * len(center) else center


def cluster_consensi(
    seqs: Sequence[np.ndarray],
    labels: np.ndarray,
    reps: Sequence[int],
    min_members: int = 3,
    max_members: int = 50,
    device=None,
) -> Dict[int, List[np.ndarray]]:
    """Per-cluster consensus list via sub-clustering + anchor-projection MSA
    (`generate_cons_v1`, `Util.py:12457-12498`): every k-mer sub-cluster
    with >= min_members yields a column-majority consensus, smaller ones
    their longest member.  Returns {rep: [consensus codes, ...]}, the
    sub-cluster holding the representative first."""
    out: Dict[int, List[np.ndarray]] = {}
    for rep in reps:
        members = [i for i in range(len(seqs)) if labels[i] == rep]
        if len(members) < min_members:
            out[rep] = [seqs[rep]]
            continue
        members = members[:max_members]
        groups = subcluster_members([seqs[i] for i in members],
                                    device=device)
        rep_local = members.index(rep) if rep in members else 0
        groups.sort(key=lambda g: rep_local not in g)
        consensi: List[np.ndarray] = []
        for g in groups:
            g_idx = [members[i] for i in g]
            if len(g_idx) < min_members:
                consensi.append(seqs[max(g_idx, key=lambda i: len(seqs[i]))])
                continue
            center_i = max(g_idx, key=lambda i: len(seqs[i]))
            consensi.append(_star_consensus(
                seqs[center_i], [seqs[i] for i in g_idx], device))
        out[rep] = consensi
    return out


def cluster_consensus(
    seqs: Sequence[np.ndarray],
    labels: np.ndarray,
    reps: Sequence[int],
    min_members: int = 3,
    max_members: int = 50,
    device=None,
) -> Dict[int, np.ndarray]:
    """One consensus per cluster (the representative's sub-cluster)."""
    multi = cluster_consensi(seqs, labels, reps, min_members=min_members,
                             max_members=max_members, device=device)
    return {rep: cons[0] for rep, cons in multi.items()}


def remove_nested(
    seqs: Sequence[np.ndarray],
    cfg: AlignConfig,
    *,
    coverage: float = 0.95,
    min_interior_margin: int = 50,
    device=None,
) -> List[np.ndarray]:
    """Excise nested insertions of shorter entries inside longer ones
    (decision-level `remove_nested_lib.py:29-117`): when >= coverage of a
    shorter entry aligns strictly inside a longer entry (away from its
    ends), the inserted span is cut out of the longer entry."""
    n = len(seqs)
    out = [s.copy() for s in seqs]
    hits = _all_pairs_hits(seqs, cfg, device=device)
    lens = np.array([len(s) for s in seqs])
    cut_spans: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for i, hs in enumerate(hits):
        # i maps into j: if i is shorter and lands interior to j, mark the cut
        for (j, _qs, _qe, os_, oe, _ns) in hs:
            if lens[i] >= lens[j]:
                continue
            if (oe - os_) < coverage * lens[i]:
                continue
            if os_ > min_interior_margin and oe < lens[j] - min_interior_margin:
                cut_spans[j].append((os_, oe))
    for j, spans in enumerate(cut_spans):
        if not spans:
            continue
        keep = np.ones(lens[j], bool)
        for s0, e0 in spans:
            keep[s0:e0] = False
        out[j] = out[j][keep]
        logger.info("remove_nested: excised %d bp from entry %d",
                    int((~keep).sum()), j)
    return out
