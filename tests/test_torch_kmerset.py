"""Batched k-mer sets (`hite_tpu_torch/ops/kmerset.py`) and their two
callers, on the CPU.

The boundary engine's flank subsets (`boundary_adjust._flank_keep`, a
whole wave at once) must equal the per-copy rule
`_subset_copies_by_flank` item by item, on a dense toy genome with
reverse-strand copies, copies clipped at contig edges, frames shorter
than twice the flank and shorter than the flank (contigs of 150 and 80
bp), N runs, centers under 8 bp, a family span of N, score ties, and
both branches of the rule (8 or more clean copies; the 8 lowest).  The
batched analyses must equal one family at a time and the JAX package's
analyses.  The min-hash sketches must equal the NumPy per-sequence loop
bit for bit at k = 8 and 12 (sequences under k and all-N included), and
`_kmer_sketch_groups` the JAX package's groups under both linkages.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(2)

FLANK = 100


def _genome():
    """Three contigs of dense planted families (A scattered, B in runs, C
    1.5 kbp), an exact tandem array of T, an N run, and two contigs
    shorter than 2 x flank."""
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.io.fasta import revcomp

    rng = np.random.default_rng(19)
    fams = {"A": rng.integers(0, 4, 400), "B": rng.integers(0, 4, 250),
            "C": rng.integers(0, 4, 1500), "T": rng.integers(0, 4, 220)}
    planted = {f: [] for f in fams}
    contigs = {}
    layout = {"c0": "AAB" * 4 + "C", "c1": "BBBBBBA" * 2 + "C",
              "c2": "ABABC", "c3": "T" * 12}
    for name, plan in layout.items():
        parts, pos = [], 0
        for f in plan:
            gap = int(rng.integers(0 if f == "B" else 150, 400))
            te = fams[f].astype(np.uint8)
            if f == "T":                # identical copies, no gap: ties
                gap = 0 if pos else 300
            elif rng.random() < 0.5:
                te = revcomp(te)
            te = te.copy()
            mut = rng.random(len(te)) < (0.03 if f != "T" else 0)
            te[mut] = rng.integers(0, 4, int(mut.sum()))
            parts += [rng.integers(0, 4, gap).astype(np.uint8), te]
            planted[f].append((name, pos + gap, pos + gap + len(te)))
            pos += gap + len(te)
        parts.append(rng.integers(0, 4, 300).astype(np.uint8))
        contigs[name] = np.concatenate(parts)
    contigs["c1"][900:960] = 4
    contigs["tiny150"] = rng.integers(0, 4, 150).astype(np.uint8)
    contigs["tiny80"] = rng.integers(0, 4, 80).astype(np.uint8)
    return Genome.from_dict(contigs, device="cpu"), planted


def _items(genome, planted):
    """(interval, CopyHits) items covering every case of the docstring."""
    from hite_tpu_torch.pipeline.copies import CopyHit

    rng = np.random.default_rng(7)
    flat = {n: int(s) for n, s in zip(genome.names, genome.starts)}
    size = {n: int(n_) for n, n_ in zip(genome.names, genome.lengths)}

    def hits_of(fam, extra=0, strand=None):
        out = [CopyHit(flat[c] + s, flat[c] + e,
                       int(rng.integers(0, 2)) if strand is None else strand,
                       9)
               for c, s, e in planted[fam]]
        for _ in range(extra):          # chance hits, edges and tiny contigs
            c = str(rng.choice(genome.names))
            s = int(rng.integers(0, size[c]))
            e = min(size[c], s + int(rng.integers(5, 700)))
            out.append(CopyHit(flat[c] + s, flat[c] + e,
                               int(rng.integers(0, 2)), 3))
        rng.shuffle(out)
        return out

    def iv(fam, i=0):
        c, s, e = planted[fam][i]
        return (flat[c] + s, flat[c] + e)

    items = [
        (iv("A"), hits_of("A", 6)),                 # clean flanks
        (iv("B", 2), hits_of("B", 4)),              # tandem: 8 lowest
        (iv("B", 5), hits_of("B")),
        (iv("T", 5), hits_of("T", 2, strand=0)),    # tied at the cut
        (iv("C"), hits_of("C", 3)),                 # truncated frames
        (iv("A", 3), hits_of("A")[:8]),             # 8 copies: no scoring
        (iv("A", 1), []),
        ((iv("A")[0], iv("A")[0] + 5), hits_of("A")),   # center < 8 bp
        ((flat["c1"] + 905, flat["c1"] + 955), hits_of("B", 2)),  # all N
        ((flat["c0"], flat["c0"] + 300), hits_of("B", 9)),  # contig start
        ((flat["tiny150"] + 10, flat["tiny150"] + 140),
         hits_of("A", 2) + [CopyHit(flat["tiny150"] + 5,
                                    flat["tiny150"] + 145, 1, 2),
                            CopyHit(flat["tiny80"] + 3, flat["tiny80"] + 70,
                                    0, 2),
                            CopyHit(flat["tiny80"], flat["tiny80"] + 80,
                                    1, 2)]),
    ]
    last = "c2"
    items.append(((flat[last] + size[last] - 200, flat[last] + size[last]),
                  hits_of("C", 12)))                # contig end
    return items


@pytest.fixture(scope="module")
def case():
    genome, planted = _genome()
    return genome, _items(genome, planted)


def _copy_seqs(genome, hits):
    from hite_tpu_torch.io.fasta import revcomp

    seqs = [genome.extract(h.start, h.end, FLANK) for h in hits]
    return [revcomp(s) if h.strand == 1 else s for s, h in zip(seqs, hits)]


def _family_span(genome, interval):
    s, e = interval
    center = genome.extract(s, e, FLANK)
    ci, _ = genome.contig_of(np.array([s]))
    al = min(FLANK, s - int(genome.starts[int(ci[0])]))
    return center[al : al + e - s]


def _scores(span, seqs):
    from hite_tpu_torch.ops.kmerset import kmer_code_set

    fam = kmer_code_set(span)
    out = []
    for cs in seqs:
        fr = cs[-FLANK:] if len(cs) > FLANK else cs[:0]
        fk = kmer_code_set(np.concatenate([cs[:FLANK], [4], fr]))
        out.append(float(np.isin(fk, fam).mean()) if len(fk) else 0.0)
    return np.array(out), len(fam)


def _same(a, b):
    from hite_tpu_torch.scripts.mesh_scaling import same_analyses

    return same_analyses(a, b)


@pytest.mark.parametrize("chunk_bytes", [None, 2048])
def test_flank_subsets_match_per_copy_rule(case, chunk_bytes, monkeypatch):
    from hite_tpu_torch.config import MSAConfig
    from hite_tpu_torch.io.fasta import revcomp
    from hite_tpu_torch.ops import kmerset
    from hite_tpu_torch.pipeline import boundary_adjust as ba

    if chunk_bytes:
        monkeypatch.setattr(kmerset, "CHUNK_BYTES", chunk_bytes)
    genome, items = case
    p = ba._prep(genome, items, MSAConfig(), "test")
    branches = set()
    for i, (interval, hits) in enumerate(items):
        seqs = _copy_seqs(genome, hits)
        span = _family_span(genome, interval)
        want = ba._subset_copies_by_flank(span, seqs, FLANK)
        rows = np.flatnonzero(p.item == i)
        got = [genome.flat[p.lo[r] : p.hi[r]] for r in rows]
        got = [revcomp(g) if p.rev[r] else g for g, r in zip(got, rows)]
        assert len(got) == len(want), i
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), i
        if len(seqs) > 8:
            sc, n_fam = _scores(span, seqs)
            if not n_fam:
                branches.add("no family set")
            elif (sc <= 0.25).sum() >= 8:
                branches.add("clean")
            else:
                cut = np.sort(sc)[7]
                branches.add("lowest" + (" tied" if (sc == cut).sum() > 1
                                         and (sc < cut).sum() < 8 else ""))
    assert {"clean", "lowest tied", "no family set"} <= branches, branches
    short = (p.hi - p.lo)
    assert (short < FLANK).any() and ((short > FLANK)
                                     & (short < 2 * FLANK)).any()
    assert p.rev.any() and (~p.rev).any() and (p.trunc_at > 0).any()


def test_batched_equals_one_family_at_a_time(case):
    from hite_tpu_torch.config import MSAConfig
    from hite_tpu_torch.pipeline.boundary_adjust import (
        analyze_families_batched, analyze_family,
    )

    genome, items = case
    got = analyze_families_batched(genome, items, MSAConfig())
    for (interval, hits), (fa, cs) in zip(items, got):
        # one family alone is padded to its own width, the batch to the
        # widest of its trunc mode: the columns they share agree
        one, c1 = analyze_family(genome, interval, hits, MSAConfig())
        W = one.M.shape[1]
        assert cs == c1
        assert np.array_equal(fa.M[: one.M.shape[0], :W], one.M)
        assert np.array_equal(fa.homo[:W], one.homo)
        assert np.array_equal(fa.cons[:W], one.cons)
        # a side not found reports the batch's width
        assert (fa.left_found, fa.right_found, fa.trunc_at, fa.trunc_gap) \
            == (one.left_found, one.right_found, one.trunc_at, one.trunc_gap)
        assert not fa.left_found or fa.left_pos == one.left_pos
        assert not fa.right_found or fa.right_pos == one.right_pos


def _jax_genome(genome):
    from hite_tpu.genome import Genome

    return Genome.from_dict({n: genome.flat[s : s + n_]
                             for n, s, n_ in zip(genome.names, genome.starts,
                                                 genome.lengths)})


def test_batched_analyses_match_jax(case):
    from hite_tpu.config import MSAConfig as JaxMSA
    from hite_tpu.pipeline.boundary_adjust import (
        analyze_families_batched as jax_analyze,
    )
    from hite_tpu.pipeline.copies import CopyHit as JaxHit
    from hite_tpu_torch.config import MSAConfig
    from hite_tpu_torch.pipeline.boundary_adjust import (
        analyze_families_batched,
    )

    genome, items = case
    jitems = [(iv, [JaxHit(**dataclasses.asdict(h)) for h in hits])
              for iv, hits in items]
    ref = jax_analyze(_jax_genome(genome), jitems, JaxMSA())
    got = analyze_families_batched(genome, items, MSAConfig())
    assert _same(got, ref)
    assert any(fa.left_found and fa.right_found for fa, _c in got)


def test_code_array_copies_match_jax(case):
    """The pan rescue's copies: strand-corrected frames as code arrays."""
    from hite_tpu.config import MSAConfig as JaxMSA
    from hite_tpu.pipeline.boundary_adjust import (
        analyze_family as jax_family,
    )
    from hite_tpu_torch.config import MSAConfig
    from hite_tpu_torch.pipeline.boundary_adjust import (
        analyze_families_batched, analyze_family,
    )

    genome, items = case
    interval, hits = items[1]
    seqs = _copy_seqs(genome, hits)
    got = analyze_family(genome, interval, seqs, MSAConfig())
    ref = jax_family(_jax_genome(genome), interval, seqs, JaxMSA())
    assert _same([got], [ref])
    with pytest.raises(ValueError):
        analyze_families_batched(genome, [(interval, seqs), items[0]],
                                 MSAConfig())


def _seqs(seed):
    """Ragged sequences: random, under k, all-N, N runs, and mutated
    copies of a few families (so sketches agree)."""
    rng = np.random.default_rng(seed)
    fams = [rng.integers(0, 4, int(rng.integers(150, 3000))).astype(np.uint8)
            for _ in range(6)]
    out = [np.zeros(0, np.uint8), np.full(40, 4, np.uint8),
           rng.integers(0, 4, 7).astype(np.uint8),
           rng.integers(0, 4, 11).astype(np.uint8)]
    for _ in range(90):
        f = fams[int(rng.integers(0, len(fams)))]
        a = int(rng.integers(0, len(f) // 3))
        s = f[a : len(f) - int(rng.integers(0, len(f) // 3))].copy()
        mut = rng.random(len(s)) < rng.uniform(0, 0.2)
        s[mut] = rng.integers(0, 5, int(mut.sum()))
        out.append(s)
    out += [rng.integers(0, 4, int(rng.integers(12, 900))).astype(np.uint8)
            for _ in range(20)]
    out[40][5:400] = 4
    return out


@pytest.mark.parametrize("k", [8, 12])
def test_minhash_sketches_match_numpy(k, monkeypatch):
    from hite_tpu_torch.ops import kmerset
    from hite_tpu_torch.pipeline.copies import _MINHASH_SALTS

    seqs = _seqs(k)
    want = np.full((len(seqs), 64), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    has = np.zeros(len(seqs), bool)
    for i, s in enumerate(seqs):
        codes = kmerset.kmer_code_set(s, k)
        if len(codes):
            want[i] = ((codes.astype(np.uint64)[:, None] ^ _MINHASH_SALTS)
                       * np.uint64(0xC2B2AE3D27D4EB4F)).min(axis=0)
            has[i] = True
    assert not has[:3].any() and has[3] == (k <= 11)
    for chunk in (None, 1 << 16):
        if chunk:
            monkeypatch.setattr(kmerset, "CHUNK_BYTES", chunk)
        sk, got_has = kmerset.minhash_sketches(seqs, k, _MINHASH_SALTS,
                                               "cpu")
        assert np.array_equal(got_has, has)
        assert sk.dtype == np.uint64 and np.array_equal(sk, want)


@pytest.mark.parametrize("k,thresh,linkage", [(8, 0.1, "greedy"),
                                               (12, 0.15, "single")])
def test_sketch_groups_match_jax(k, thresh, linkage):
    from hite_tpu.pipeline.copies import _kmer_sketch_groups as jax_groups
    from hite_tpu_torch.pipeline.copies import _kmer_sketch_groups

    seqs = _seqs(100 + k)
    got = _kmer_sketch_groups(seqs, k=k, thresh=thresh, linkage=linkage,
                              device="cpu")
    assert got == jax_groups(seqs, k=k, thresh=thresh, linkage=linkage)
    assert 3 <= len(set(got)) < len(seqs) - 10


def test_in_set_counts_match_numpy():
    from hite_tpu_torch.ops.kmerset import in_set_counts, kmer_code_set

    rng = np.random.default_rng(3)
    sets = [rng.integers(0, 4, n).astype(np.uint8) for n in (0, 5, 60, 300)]
    sets[3][100:120] = 4
    rows = np.concatenate([
        rng.integers(0, 5, (40, 50)),
        np.stack([s[:50] if len(s) >= 50 else np.full(50, 4)
                  for s in sets] * 3)]).astype(np.uint8)
    owner = np.concatenate([rng.integers(0, 4, 40), np.tile(range(4), 3)])
    stream = np.concatenate([np.append(s, 4) for s in sets]).astype(np.uint8)
    stream_owner = np.repeat(np.arange(4), [len(s) + 1 for s in sets])
    distinct, in_set, set_n = in_set_counts(
        torch.from_numpy(rows), torch.from_numpy(owner),
        torch.from_numpy(stream), torch.from_numpy(stream_owner), 4, k=8)
    for r in range(len(rows)):
        fk = kmer_code_set(rows[r])
        assert distinct[r] == len(fk)
        assert in_set[r] == np.isin(fk, kmer_code_set(sets[owner[r]])).sum()
    assert list(set_n) == [0, 0, 53, 293 - 27]
    assert in_set[40 + 2] == distinct[40 + 2] > 0
