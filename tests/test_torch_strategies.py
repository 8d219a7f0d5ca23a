"""The off-default strategies held against the JAX package: the coarse
"pairs" strategy, `CopyFinder(strategy="segments")`, the bucketed k-mer
index they search, and `map_reads` with its `max_chains`."""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(2)


def _hits(hit_sets):
    return [[dataclasses.astuple(h) for h in hits] for hits in hit_sets]


@pytest.mark.parametrize("k", [12, 16])
def test_bucketed_index_and_lookup_match_jax(k):
    """build_index / lookup with prefix buckets, including a bucket past
    the 4095 entries the bounded search is exact for (a poly-A run)."""
    import jax.numpy as jnp

    from hite_tpu.ops import kmer as jk
    from hite_tpu_torch.ops import kmer

    rng = np.random.default_rng(k)
    seg = rng.integers(0, 4, 12_000).astype(np.uint8)
    seg[2000:7000] = 0
    seg[9000:9050] = 4
    ref = jk.build_index(jnp.asarray(seg), k)
    got = kmer.build_index(torch.from_numpy(seg), k, buckets=True)
    for a, b in ((got.codes, ref.codes), (got.pos, ref.pos),
                 (got.buckets, ref.buckets)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    from hite_tpu.ops.encode import kmer_codes

    q = np.concatenate([np.asarray(kmer_codes(jnp.asarray(seg[:4000]), k)),
                        np.array([-1, 0], np.int32)])
    shift = 2 * (k - 8)
    r_s, r_v = jk.lookup(ref, jnp.asarray(q), 8, bucket_shift=shift)
    g_s, g_v = kmer.lookup(got, torch.from_numpy(q), 8, bucket_shift=shift)
    assert np.array_equal(g_s.numpy(), np.asarray(r_s))
    assert np.array_equal(g_v.numpy(), np.asarray(r_v))
    plain = kmer.build_index(torch.from_numpy(seg), k)
    assert plain.buckets is None


def test_coarse_pairs_strategy_matches_jax():
    """tests/test_parallel.py's genome: 120 kbp, 8 copies of a 600 bp
    element, seg_len 16384, pair_batch 8."""
    from hite_tpu.config import AlignConfig as JaxAlign
    from hite_tpu.genome import synthetic_genome as jax_synth
    from hite_tpu.pipeline.coarse import CoarseParams as JaxParams
    from hite_tpu.pipeline.coarse import coarse_discover as jax_coarse
    from hite_tpu_torch.config import AlignConfig
    from hite_tpu_torch.genome import synthetic_genome
    from hite_tpu_torch.pipeline.coarse import CoarseParams, coarse_discover

    rng = np.random.default_rng(7)
    te = "".join("ACGT"[c] for c in rng.integers(0, 4, size=600))
    jg, ins = jax_synth(120_000, [te], [8], seed=3, mutation_rate=0.02)
    g, _ = synthetic_genome(120_000, [te], [8], seed=3, mutation_rate=0.02,
                            device="cpu")
    kw = dict(seg_len=16_384, pair_batch=8, strategy="pairs")
    ref = jax_coarse(jg, JaxAlign(fixed_extend_base_threshold=2000),
                     JaxParams(**kw))
    got = coarse_discover(g, AlignConfig(fixed_extend_base_threshold=2000),
                          CoarseParams(**kw))
    assert got.dtype == np.int64
    assert np.array_equal(got, ref)
    # every planted copy lies under the candidates (a copy across a
    # segment edge comes back in two pieces)
    for _t, s, e in ins:
        cov = np.zeros(e - s, bool)
        for a, b in got:
            cov[max(a, s) - s : max(min(b, e) - s, 0)] = True
        assert cov.mean() > 0.9, (s, e)
    with pytest.raises(ValueError):
        coarse_discover(g, AlignConfig(), CoarseParams(strategy="grid"))


@pytest.fixture(scope="module")
def planted():
    """tests/test_libjoin.py's genome: 200 kbp, 6 + 8 copies."""
    from hite_tpu.genome import synthetic_genome as jax_synth
    from hite_tpu.io.fasta import decode_seq, encode_seq
    from hite_tpu_torch.genome import synthetic_genome

    rng = np.random.default_rng(7)
    tes = [decode_seq(rng.integers(0, 4, size=L).astype(np.uint8))
           for L in (900, 420)]
    jg, ins = jax_synth(200_000, tes, [6, 8], seed=3, mutation_rate=0.01)
    g, _ = synthetic_genome(200_000, tes, [6, 8], seed=3,
                            mutation_rate=0.01, device="cpu")
    cands = [encode_seq(t) for t in tes]
    cands.append((3 - cands[0])[::-1].astype(np.uint8))
    return jg, g, cands, ins


def test_segments_copy_finder_matches_jax(planted):
    from hite_tpu.config import AlignConfig as JaxAlign
    from hite_tpu.pipeline.copies import CopyFinder as JaxFinder
    from hite_tpu.pipeline.copies import GenomeIndex as JaxIndex
    from hite_tpu_torch.config import AlignConfig
    from hite_tpu_torch.pipeline.copies import CopyFinder, GenomeIndex

    jg, g, cands, ins = planted
    jf = JaxFinder(JaxIndex(jg, JaxAlign()), strategy="segments")
    gi = GenomeIndex(g, AlignConfig())
    f = CopyFinder(gi, strategy="segments")
    assert gi.n_segs == jf.index.n_segs
    ref = jf.find_copies(cands, min_coverage=0.9)
    got = f.find_copies(cands, min_coverage=0.9)
    assert _hits(got) == _hits(ref)
    for ti, n in ((0, 6), (1, 8)):
        assert len(got[ti]) == n
    assert all(h.strand == 1 for h in got[2])
    assert f.find_copies([]) == []
    with pytest.raises(ValueError):
        CopyFinder(gi, strategy="grid")


def test_segments_geometry_matches_jax(planted):
    """A narrow geometry (max_chains 2, max_hsps 64, stride 2) cuts hits
    the same way in both packages, fragment hits (`min_abs_len`) and the
    per-candidate cap included."""
    from hite_tpu.config import AlignConfig as JaxAlign
    from hite_tpu.pipeline.copies import CopyFinder as JaxFinder
    from hite_tpu.pipeline.copies import GenomeIndex as JaxIndex
    from hite_tpu_torch.config import AlignConfig
    from hite_tpu_torch.pipeline.copies import CopyFinder, GenomeIndex

    jg, g, cands, _ins = planted
    geom = dict(stride=2, max_hits=4, max_hsps=64, max_chains=2)
    kw = dict(min_coverage=0.95, min_abs_len=200, max_copies=5)
    ref = JaxFinder(JaxIndex(jg, JaxAlign(), seg_len=65_536),
                    strategy="segments", **geom).find_copies(cands, **kw)
    got = CopyFinder(GenomeIndex(g, AlignConfig(), seg_len=65_536),
                     strategy="segments", **geom).find_copies(cands, **kw)
    assert _hits(got) == _hits(ref)
    assert any(got) and all(len(h) <= 5 for h in got)


def test_map_reads_max_chains_matches_jax():
    """map_reads passes max_chains=16 again; its mappings equal the JAX
    package's (the join reads no max_chains, so they are the join's)."""
    from hite_tpu.config import PipelineConfig as JaxConfig
    from hite_tpu.genome import Genome as JaxGenome
    from hite_tpu.pipeline.rnaseq import map_reads as jax_map
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.pipeline import copies, rnaseq

    rng = np.random.default_rng(19)
    bg = rng.integers(0, 4, 60_000).astype(np.uint8)
    reads = [bg[s : s + 150].copy() for s in rng.integers(0, 59_000, 24)]
    reads.append(rng.integers(0, 4, 150).astype(np.uint8))
    seen = []
    orig = copies.CopyFinder.__init__

    def spy(self, *a, **kw):
        seen.append(kw)
        orig(self, *a, **kw)

    copies.CopyFinder.__init__ = spy
    try:
        got = rnaseq.map_reads(Genome.from_dict({"chr1": bg}, device="cpu"),
                               reads, PipelineConfig().align)
    finally:
        copies.CopyFinder.__init__ = orig
    assert seen and seen[0]["max_chains"] == 16
    ref = jax_map(JaxGenome.from_dict({"chr1": bg}), reads,
                  JaxConfig().align)
    assert [None if m is None else dataclasses.astuple(m) for m in got] == \
        [None if m is None else dataclasses.astuple(m) for m in ref]
    assert sum(m is not None for m in got) >= 20 and got[-1] is None
