"""Sharded dispatch of the all-vs-all segment-pair grid (counterpart of the
JAX package's `parallel/dispatch.py`).

The reference's only scale-out is Nextflow task fan-out of genome chunks
(`main.nf:627-648`).  Here the pair batch of coarse strategy "pairs" is
cut over every mesh device while the per-segment k-mer indexes are
replicated (one copy a distinct device); each shard runs the port's pair
kernels (`pipeline.coarse.PairAligner`) on its device and the chains
come back to the caller's device, where candidate merging stays on the
host.  The grid is row-independent, so the result equals the
single-device `coarse_discover(strategy="pairs")`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from hite_tpu_torch.config import AlignConfig
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.ops.chain import Chains
from hite_tpu_torch.ops.kmer import KmerIndex
from hite_tpu_torch.parallel.mesh import Mesh, replicate, run_sharded
from hite_tpu_torch.pipeline.coarse import (
    CoarseParams, _chains_to_intervals, _dedup_intervals, get_pair_aligner,
)
from hite_tpu_torch.utils.log import stage_timer


class ShardedPairAligner:
    """Pair-grid aligner with the batch axis sharded over the whole mesh."""

    def __init__(self, mesh: Mesh, cfg: AlignConfig, params: CoarseParams):
        self.mesh = mesh
        self.base = get_pair_aligner(cfg, params)
        self._reps = None

    def prepare(self, segs: np.ndarray, device
                ) -> Tuple[torch.Tensor, KmerIndex, KmerIndex]:
        """The base aligner's k-mer codes and indexes on `device`, and a
        replica of them on every other mesh device."""
        built = self.base.prepare(segs, device)
        self._reps = replicate(built, self.mesh.shard_devices())
        return built

    def align_pairs(self, km: torch.Tensor, fwd: KmerIndex, rc: KmerIndex,
                    pairs: np.ndarray) -> Tuple[Chains, Chains]:
        """`PairAligner.align_pairs` with `pairs` cut into one contiguous
        shard a mesh device (each against that device's replica of the
        indexes `prepare` built); the chains on km's device."""
        reps = self._reps

        def one(shard: torch.Tensor) -> Tuple[Chains, Chains]:
            return self.base.align_pairs(*reps[shard.device], shard)

        return run_sharded(self.mesh, one, pairs, device=km.device)


def coarse_discover_sharded(
    genome: Genome,
    cfg: AlignConfig,
    mesh: Mesh,
    params: Optional[CoarseParams] = None,
    use_masked: bool = True,
    max_repeat_len: int = 30_000,
    min_repeat_len: int = 80,
) -> np.ndarray:
    """Mesh-sharded coarse discovery over the segment-pair grid; equal to
    the single-device `coarse_discover` with strategy "pairs" (the grid is
    deterministic).  The batch rounds to a multiple of the device count,
    and the last batch pads with its last pair, as in the JAX package."""
    p = params or CoarseParams()
    n_dev = mesh.size
    batch = max(p.pair_batch, n_dev)
    batch = (batch // n_dev) * n_dev

    segs = genome.segment_view(p.seg_len, use_masked=use_masked)
    n_segs = segs.shape[0]
    aligner = ShardedPairAligner(mesh, cfg, p)
    with stage_timer("coarse.prepare"):
        km, fwd, rc = aligner.prepare(segs, genome.device)

    # the single-device path's masked-pair skipping
    live = (segs < 4).mean(axis=1) >= 0.02
    all_pairs = np.array(
        [(i, j) for i in range(n_segs) for j in range(i + 1)
         if live[i] and live[j]], dtype=np.int64).reshape(-1, 2)
    cand: List[np.ndarray] = []
    with stage_timer("coarse.align.sharded"):
        for b0 in range(0, len(all_pairs), batch):
            chunk = all_pairs[b0 : b0 + batch]
            pad = np.repeat(chunk[-1:], batch - len(chunk), axis=0)
            fc, rch = aligner.align_pairs(km, fwd, rc,
                                          np.concatenate([chunk, pad]))
            n = len(chunk)
            cand.append(_chains_to_intervals(
                Chains(*(t[:n] for t in fc)), Chains(*(t[:n] for t in rch)),
                chunk, p.seg_len))
    intervals = np.concatenate(cand) if cand else np.zeros((0, 2), np.int64)
    return _dedup_intervals(intervals, genome, cfg, min_repeat_len,
                            max_repeat_len)
