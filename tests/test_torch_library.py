"""Library assembly of hite_tpu_torch vs hite_tpu, function by function.

Each scenario runs on both packages on the CPU and must agree exactly:
the all-pairs mini-genome hits, greedy clustering, k-mer sub-clustering,
the star consensus with its padding-row mask, nested-insertion removal,
per-type clustering and naming, the TSD and domain evidence of library
entries (the combined TIRPeps + HelitronPeps scan), the neural label
refinement with the bundled classifier, and homology labels.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_modules_path import CODON
from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(2)


def _rand(rng, n):
    return rng.integers(0, 4, n).astype(np.uint8)


def _mutate(rng, s, rate):
    c = s.copy()
    m = rng.random(len(c)) < rate
    c[m] = (c[m] + rng.integers(1, 4, m.sum())) % 4
    return c


def _pkgs():
    from hite_tpu import config as jc
    from hite_tpu.pipeline import libcluster as jlc, library as jlib
    from hite_tpu_torch import config as tc
    from hite_tpu_torch.pipeline import libcluster as tlc, library as tlib

    return (jc, jlc, jlib), (tc, tlc, tlib)


def _cfgs():
    (jc, _, _), (tc, _, _) = _pkgs()
    kw = dict(fixed_extend_base_threshold=2000)
    return (jc.PipelineConfig(align=jc.AlignConfig(**kw)),
            tc.PipelineConfig(align=tc.AlignConfig(**kw)))


def _same_seqs(a, b):
    assert len(a) == len(b)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def _same_lib(a, b):
    assert list(a) == list(b)
    assert all(np.array_equal(a[n], b[n]) for n in a)


@pytest.fixture(scope="module")
def families():
    """Two families of variants, a nested insertion and a short entry."""
    rng = np.random.default_rng(0)
    fam_a, fam_b = _rand(rng, 800), _rand(rng, 600)
    inner = _rand(rng, 400)
    host = np.concatenate([_rand(rng, 600), inner, _rand(rng, 600)])
    return [fam_a, _mutate(rng, fam_a, 0.05), _mutate(rng, fam_a, 0.05),
            fam_b, _mutate(rng, fam_b, 0.05), host, inner,
            _rand(rng, 120)]


def test_all_pairs_hits(families):
    (_, jlc, _), (_, tlc, _) = _pkgs()
    jcfg, tcfg = _cfgs()
    ref = jlc._all_pairs_hits(families, jcfg.align)
    got = tlc._all_pairs_hits(families, tcfg.align, device="cpu")
    assert ref == got
    assert sum(map(len, got)) > 0


@pytest.mark.parametrize("coverage", [0.95, 0.5])
def test_cluster_seqs(families, coverage):
    (_, jlc, _), (_, tlc, _) = _pkgs()
    jcfg, tcfg = _cfgs()
    jl, jr = jlc.cluster_seqs(families, jcfg.align, coverage=coverage)
    tl, tr = tlc.cluster_seqs(families, tcfg.align, coverage=coverage,
                              device="cpu")
    assert np.array_equal(jl, tl) and jr == tr
    if coverage == 0.95:
        assert tl[0] == tl[1] == tl[2] and tl[3] == tl[4] != tl[0]
    empty = tlc.cluster_seqs([], tcfg.align, device="cpu")
    assert len(empty[0]) == 0 and empty[1] == []


def test_subcluster_members():
    (_, jlc, _), (_, tlc, _) = _pkgs()
    rng = np.random.default_rng(7)
    fa, fb = _rand(rng, 600), _rand(rng, 600)
    members = [fa, _mutate(rng, fa, 0.03), _mutate(rng, fa, 0.03),
               fb, _mutate(rng, fb, 0.03), _mutate(rng, fb, 0.03)]
    for sub in (members, members[:3], members[:1]):
        assert jlc.subcluster_members(sub) == \
            tlc.subcluster_members(sub, device="cpu")
    assert sorted(map(sorted, tlc.subcluster_members(members,
                                                     device="cpu"))) \
        == [[0, 1, 2], [3, 4, 5]]


@pytest.mark.parametrize("n_members", [3, 5, 9])
def test_cluster_consensi(n_members):
    """Consensus of sub-clusters whose row count is not a power of two
    (the padding rows are masked out of the votes), with one cluster too
    small for a consensus and one holding two sub-families."""
    (_, jlc, _), (_, tlc, _) = _pkgs()
    rng = np.random.default_rng(8 + n_members)
    fam = _rand(rng, 500)
    other = _rand(rng, 450)
    seqs = [fam] + [_mutate(rng, fam, 0.04) for _ in range(n_members - 1)]
    seqs += [other, _mutate(rng, other, 0.04)]
    seqs += [_mutate(rng, _rand(rng, 480), 0.0) for _ in range(3)]
    labels = np.array([0] * n_members + [n_members] * 2
                      + [0] * 3, np.int64)
    reps = [0, n_members]
    ref = jlc.cluster_consensi(seqs, labels, reps)
    got = tlc.cluster_consensi(seqs, labels, reps, device="cpu")
    assert list(ref) == list(got) == reps
    for r in reps:
        _same_seqs(ref[r], got[r])
    c = got[0][0]
    n = min(len(c), len(fam))
    assert (c[:n] == fam[:n]).mean() > 0.97
    one = tlc.cluster_consensus(seqs, labels, reps, device="cpu")
    assert all(np.array_equal(one[r], got[r][0]) for r in reps)


def test_remove_nested(families):
    (_, jlc, _), (_, tlc, _) = _pkgs()
    jcfg, tcfg = _cfgs()
    ref = jlc.remove_nested(families, jcfg.align)
    got = tlc.remove_nested(families, tcfg.align, device="cpu")
    _same_seqs(ref, got)
    assert len(got[5]) <= len(families[5]) - 350   # the insertion excised


def test_cluster_and_name(families):
    (_, _, jlib), (_, _, tlib) = _pkgs()
    jcfg, tcfg = _cfgs()
    labels = ["SINE", "LINE"] * 4
    for lab in (None, labels):
        ref = jlib._cluster_and_name(list(families), jcfg, "X", "DNA",
                                     labels=lab)
        got = tlib._cluster_and_name(list(families), tcfg, "X", "DNA",
                                     labels=lab, device="cpu")
        _same_lib(ref, got)


@pytest.mark.parametrize("case", ["hit", "no_hit"])
def test_classify_by_homology(case):
    (_, _, jlib), (_, _, tlib) = _pkgs()
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(9)
    te, other = _rand(rng, 900), _rand(rng, 700)
    merged = ({"fam_0#Unknown": te, "fam_1#DNA/hAT": other,
               "fam_2#DNA": _mutate(rng, te, 0.02)} if case == "hit"
              else {"fam_0#Unknown": other[:600]})
    curated = {"gold#LTR/Gypsy": te, "plain": other}
    ref = jlib.classify_by_homology(merged, curated, jcfg)
    got = tlib.classify_by_homology(merged, curated, tcfg, device="cpu")
    _same_lib(ref, got)
    assert ("fam_0#LTR/Gypsy" in got) == (case == "hit")


@pytest.fixture(scope="module")
def evidence_genome():
    """A 60 kbp genome with 3 TSD-flanked copies of an element carrying a
    TIRPeps protein, 2 copies of a random element, and the entries."""
    from hite_tpu_torch.io.fasta import encode_seq
    from hite_tpu_torch.ops.protein import decode_protein
    from hite_tpu_torch.pipeline.domain import read_protein_fasta
    from hite_tpu_torch.pipeline.run import DATA_DIR

    lib = read_protein_fasta(os.path.join(DATA_DIR, "protein",
                                          "TIRPeps.lib"))
    _n, prot = min(lib.items(), key=lambda kv: abs(len(kv[1]) - 200))
    orf = encode_seq("".join(CODON.get(a, "GCA")
                             for a in decode_protein(prot)))
    rng = np.random.default_rng(21)
    bg = _rand(rng, 60_000)
    te = np.concatenate([_rand(rng, 100), orf, _rand(rng, 100)])
    te2 = _rand(rng, 700)
    for pos in (5_000, 20_000, 35_000):
        tsd = _rand(rng, 6)
        bg[pos - 6 : pos] = tsd
        bg[pos + len(te) : pos + len(te) + 6] = tsd
        bg[pos : pos + len(te)] = te
    for pos in (45_000, 52_000):
        bg[pos : pos + len(te2)] = te2
    return bg, [te, te2, _rand(rng, 500)]


def test_library_feature_evidence(evidence_genome):
    from hite_tpu.genome import Genome as JG
    from hite_tpu_torch.genome import Genome as TG

    (_, _, jlib), (_, _, tlib) = _pkgs()
    jcfg, tcfg = _cfgs()
    bg, entries = evidence_genome
    jt, jd = jlib.library_feature_evidence(entries, jcfg,
                                           JG.from_dict({"chr1": bg}))
    tt, td = tlib.library_feature_evidence(
        entries, tcfg, TG.from_dict({"chr1": bg}, device="cpu"))
    assert jd == td and td[0] is not None and td[2] is None
    assert [None if x is None else x.tolist() for x in jt] == \
        [None if x is None else x.tolist() for x in tt]
    assert tt[0] is not None and len(tt[0]) == 6
    # without a genome: the domain block only
    j2, d2 = jlib.library_feature_evidence(entries, jcfg, None)
    t2, e2 = tlib.library_feature_evidence(entries, tcfg, None, device="cpu")
    assert j2 == t2 == [None] * 3 and d2 == e2 == td


def test_refine_labels_bundled_model(evidence_genome):
    """The bundled SuperfamilyCNN relabels DNA / LINE / Unknown entries
    within their structural class; other labels stay."""
    from hite_tpu.genome import Genome as JG
    from hite_tpu_torch.genome import Genome as TG
    from hite_tpu_torch.models import bundled_model_path

    (_, _, jlib), (_, _, tlib) = _pkgs()
    jcfg, tcfg = _cfgs()
    bg, entries = evidence_genome
    merged = {"TIR_0#DNA": entries[0], "Non_LTR_0#LINE": entries[1],
              "X_0#Unknown": entries[2], "LTR_0-LTR#LTR": entries[1][:300],
              "Helitron_0#RC/Helitron": entries[2][:200]}
    ref = jlib.refine_labels(merged, jcfg, model_path=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "hite_tpu", "data", "models", "superfamily_cnn.pkl"),
        genome=JG.from_dict({"chr1": bg}))
    got = tlib.refine_labels(merged, tcfg,
                             model_path=bundled_model_path(
                                 "superfamily_cnn.pkl"),
                             genome=TG.from_dict({"chr1": bg},
                                                 device="cpu"))
    _same_lib(ref, got)
    assert got.keys() != merged.keys()
    assert "LTR_0-LTR#LTR" in got and "Helitron_0#RC/Helitron" in got
    assert [n for n in got if n.startswith("TIR_0#")][0].startswith(
        "TIR_0#DNA/")
