"""hite_tpu_torch's RNA-seq stage against hite_tpu's, function by function.

The same seeded inputs through both packages: reads, trimming, GTF/GFF
features, the read mapping on a 30 kbp genome (32 reads: the JAX mapping
is about a minute per 80 reads on the CPU), counting, the normalisation,
the written tables (byte-equal), gene-TE positions and associations, the
Welch t-test and BH FDR (equal within 1e-12: both call the same scipy)
and the DE calls.
"""

import dataclasses
import filecmp
import gzip
import math
import os
import sys

import numpy as np
import pytest
import torch

from hite_tpu.pipeline import rnaseq as jrs
from hite_tpu_torch.pipeline import rnaseq as trs
from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(2)

P_TOL = 1e-12


def _same(a, b):
    """Lists of dataclasses from the two packages hold equal fields."""
    return [None if x is None else dataclasses.astuple(x) for x in a] == \
        [None if x is None else dataclasses.astuple(x) for x in b]


def _same_files(d1, d2, names):
    for n in names:
        assert filecmp.cmp(os.path.join(d1, n), os.path.join(d2, n),
                           shallow=False), n


def _fastq(path, seqs, quals):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as fh:
        for i, (s, q) in enumerate(zip(seqs, quals)):
            fh.write(f"@read{i} extra\n{s}\n+\n{q}\n")
        fh.write("\n")


@pytest.mark.parametrize("gz", [False, True])
def test_read_fastq(tmp_path, gz):
    rng = np.random.default_rng(1)
    seqs = ["".join("ACGTN"[c] for c in rng.integers(0, 5, n))
            for n in rng.integers(20, 150, 12)]
    quals = ["".join(chr(33 + int(q)) for q in rng.integers(0, 42, len(s)))
             for s in seqs]
    path = str(tmp_path / ("r.fq.gz" if gz else "r.fq"))
    _fastq(path, seqs, quals)
    for kw in ({}, {"max_reads": 5}):
        (s1, q1), (s2, q2) = jrs.read_fastq(path, **kw), \
            trs.read_fastq(path, **kw)
        assert len(s1) == len(s2) == (5 if kw else 12)
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(s1 + q1, s2 + q2))


def test_trim_reads():
    rng = np.random.default_rng(2)
    seqs, quals = [], []
    for _ in range(200):
        n = int(rng.integers(10, 160))
        seqs.append(rng.integers(0, 4, n).astype(np.uint8))
        q = rng.integers(0, 41, n).astype(np.int16)
        # quality crashes, low ends and all-low reads
        if rng.random() < 0.5:
            q[int(rng.integers(0, n)):] = rng.integers(0, 14)
        if rng.random() < 0.3:
            q[: int(rng.integers(0, 5))] = 1
        quals.append(q)
    quals[0][:] = 2
    for p in (jrs.TrimParams(), jrs.TrimParams(window=6, window_qual=20,
                                               min_len=20)):
        tp = trs.TrimParams(**dataclasses.asdict(p))
        for s, q in zip(seqs, quals):
            a, b = jrs.trim_read(s, q, p), trs.trim_read(s, q, tp)
            assert (a is None and b is None) or np.array_equal(a, b)
        got, want = trs.trim_reads(seqs, quals, tp), jrs.trim_reads(seqs,
                                                                    quals, p)
        assert len(got) == len(want) and all(
            np.array_equal(a, b) for a, b in zip(got, want))


def test_read_gtf_features(tmp_path):
    path = str(tmp_path / "g.gff")
    with open(path, "w") as fh:
        fh.write("##gff-version 3\n")
        fh.write('chr1\thite\texon\t5001\t7000\t.\t+\t.\tgene_id "geneA";\n')
        fh.write("chr1\thite\tgene\t1\t10\t.\t-\t.\tID=g1;Name=x\n")
        fh.write("chr2\thite\tgene\t50\t90\t.\t+\t.\tgene_id=geneC\n")
        fh.write("chr2\thite\tmRNA\t50\t90\t.\t+\t.\tParent=g1\n")
        fh.write("short\tline\n")
    for kw in ({}, {"feature_type": "gene"}, {"feature_type": "exon"},
               {"attr": "ID"}, {"feature_type": "mRNA", "attr": "Parent"}):
        assert _same(trs.read_gtf_features(path, **kw),
                     jrs.read_gtf_features(path, **kw)), kw


def _hits(mod, n=30, seed=4):
    from importlib import import_module

    hit = import_module(f"{mod}.io.gff").AnnotationHit
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = int(rng.integers(1, 20_000))
        out.append(hit(f"chr{int(rng.integers(1, 3))}", s,
                       s + int(rng.integers(50, 900)),
                       "+-"[int(rng.integers(0, 2))],
                       f"fam_{int(rng.integers(0, 4))}#DNA", "DNA",
                       float(rng.random())))
    return out


def test_features_from_hits():
    assert _same(trs.features_from_hits(_hits("hite_tpu_torch")),
                 jrs.features_from_hits(_hits("hite_tpu")))


@pytest.fixture(scope="module")
def mapped():
    """32 reads on a 30 kbp genome: gene and TE reads, a read from a
    duplicated region (multi-mapped), a random read (unmapped), short and
    mutated reads; both packages' map_reads and quantify_sample."""
    from hite_tpu.config import AlignConfig as JAlign
    from hite_tpu.genome import Genome as JGenome
    from hite_tpu_torch.config import AlignConfig as TAlign
    from hite_tpu_torch.genome import Genome as TGenome

    rng = np.random.default_rng(7)
    bg = rng.integers(0, 4, 30_000).astype(np.uint8)
    bg[25_000:25_400] = bg[12_000:12_400]      # a duplicated block
    contigs = {"chr1": bg[:18_000], "chr2": bg[18_000:]}
    reads = []
    for lo, hi, n in ((3_000, 5_000, 12), (20_000, 21_000, 8),
                      (12_000, 12_400, 2)):
        for _ in range(n):
            p = int(rng.integers(lo, hi - 90))
            reads.append(bg[p: p + 90].copy())
    reads.append(rng.integers(0, 4, 90).astype(np.uint8))
    for _ in range(9):
        p = int(rng.integers(1_000, 17_000))
        r = bg[p: p + int(rng.integers(40, 120))].copy()
        m = rng.random(len(r)) < 0.03
        r[m] = (r[m] + 1) % 4
        reads.append(r)
    feats = [jrs.Feature("geneA", "chr1", 3_001, 5_000, "+"),
             jrs.Feature("geneB", "chr1", 8_001, 9_000, "-"),
             jrs.Feature("TE_1", "chr2", 2_001, 3_000, "+"),
             jrs.Feature("TE_1_dup1", "chr2", 2_900, 3_300, "+")]
    tfeats = [trs.Feature(*dataclasses.astuple(f)) for f in feats]
    cfg_kw = dict(fixed_extend_base_threshold=2000)
    jg = JGenome.from_dict({k: v.copy() for k, v in contigs.items()})
    tg = TGenome.from_dict({k: v.copy() for k, v in contigs.items()},
                           device="cpu")
    return dict(
        reads=reads, feats=feats, tfeats=tfeats,
        jmap=jrs.map_reads(jg, reads, JAlign(**cfg_kw)),
        tmap=trs.map_reads(tg, reads, TAlign(**cfg_kw)),
        jq=jrs.quantify_sample(jg, reads, feats, JAlign(**cfg_kw)),
        tq=trs.quantify_sample(tg, reads, tfeats, TAlign(**cfg_kw)))


def test_map_reads(mapped):
    assert len(mapped["reads"]) <= 40
    assert _same(mapped["tmap"], mapped["jmap"])
    n = sum(m is not None for m in mapped["tmap"])
    assert 20 <= n < len(mapped["reads"]), n
    assert {m.contig for m in mapped["tmap"] if m} == {"chr1", "chr2"}


def test_quantify_sample(mapped):
    assert mapped["tq"] == mapped["jq"]
    assert mapped["tq"]["geneA"]["counts"] >= 10


def test_feature_counts():
    rng = np.random.default_rng(8)
    feats = []
    for i in range(40):
        s = int(rng.integers(1, 5_000))
        feats.append((f"f{i % 30}", f"c{int(rng.integers(0, 3))}", s,
                      s + int(rng.integers(10, 400))))
    maps = [None if rng.random() < 0.1 else
            (f"c{int(rng.integers(0, 4))}", s, s + int(rng.integers(30, 150)))
            for s in rng.integers(1, 5_200, 400)]
    want = jrs.feature_counts(
        [m and jrs.ReadMapping(*m) for m in maps],
        [jrs.Feature(*f) for f in feats])
    got = trs.feature_counts(
        [m and trs.ReadMapping(*m) for m in maps],
        [trs.Feature(*f) for f in feats])
    assert got == want and list(got) == list(want) and sum(got.values())


def _tables(seed=9, n_samples=3):
    rng = np.random.default_rng(seed)
    per_sample = {}
    for s in range(n_samples):
        counts = {f"gene{g}": int(rng.integers(0, 500))
                  for g in range(12) if rng.random() < 0.85}
        lengths = {f: int(rng.integers(200, 5000)) for f in counts}
        per_sample[f"s{s}"] = (counts, lengths)
    return per_sample


def test_expression_tables_written(tmp_path):
    per = _tables()
    tables = {}
    for name, mod in (("jax", jrs), ("port", trs)):
        d = tmp_path / name
        d.mkdir()
        t = {s: mod.expression_table(c, ln) for s, (c, ln) in per.items()}
        t["empty"] = mod.expression_table({"geneX": 0}, {})
        for s, tab in t.items():
            mod.write_count_file(str(d / f"{s}.count"), tab)
        mod.merge_expression_tables(t, str(d / "gene_express.table"))
        tables[name] = (t, mod.expression_from_table(
            str(d / "gene_express.table")))
    assert tables["port"] == tables["jax"]
    _same_files(tmp_path / "jax", tmp_path / "port",
                [f"{s}.count" for s in list(per) + ["empty"]]
                + ["gene_express.table"])


def test_te_position():
    rng = np.random.default_rng(10)
    for _ in range(3000):
        gs = int(rng.integers(1, 40_000))
        ge = gs + int(rng.integers(0, 5_000))
        ts = int(rng.integers(max(1, gs - 14_000), ge + 14_000))
        te = ts + int(rng.integers(0, 6_000))
        st = "+-"[int(rng.integers(0, 2))]
        w = int(rng.choice([10_000, 500, 0]))
        assert trs.te_position(ts, te, gs, ge, st, w) == \
            jrs.te_position(ts, te, gs, ge, st, w)


def _assoc_inputs(mod, seed=11):
    rng = np.random.default_rng(seed)
    genes = [mod.Feature(f"gene{i}", f"chr{i % 2}", s, s + 2_000,
                         "+-"[i % 2])
             for i, s in enumerate(rng.integers(1, 60_000, 15))]
    tes = [mod.Feature(f"TE_{i}", f"chr{i % 3}", s, s + 600, "+")
           for i, s in enumerate(rng.integers(1, 60_000, 40))]
    return genes, tes


@pytest.mark.parametrize("window", [10_000, 1_000])
def test_associations_written(tmp_path, window):
    out = {}
    for name, mod in (("jax", jrs), ("port", trs)):
        rows = mod.associate_genes_tes("g0", *_assoc_inputs(mod), window)
        mod.write_associations(str(tmp_path / f"{name}.tsv"), rows)
        out[name] = rows
    assert out["jax"] and _same(out["port"], out["jax"])
    assert filecmp.cmp(tmp_path / "jax.tsv", tmp_path / "port.tsv",
                       shallow=False)


def test_welch_and_bh():
    rng = np.random.default_rng(12)
    for _ in range(50):
        x = rng.normal(10, 3, int(rng.integers(0, 8)))
        y = rng.normal(12, 1, int(rng.integers(0, 8)))
        a, b = trs._welch_t_pvalue(x, y), jrs._welch_t_pvalue(x, y)
        assert (math.isnan(a) and math.isnan(b)) or abs(a - b) <= P_TOL
    for n in (0, 1, 7, 60):
        p = rng.random(n)
        p[rng.random(n) < 0.2] = np.nan
        if n:
            p[0] = p[-1]           # a tie
        a, b = trs.bh_fdr(p), jrs.bh_fdr(p)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        assert np.all(np.abs(a[~np.isnan(a)] - b[~np.isnan(b)]) <= P_TOL)


def _de_inputs(mod, seed=13):
    """20 genes x 10 genomes: insertions at three positions, some genes
    strongly up or down with an insertion, missing and NaN values."""
    rng = np.random.default_rng(seed)
    expression, assoc = {}, []
    for g in range(20):
        gene = f"gene{g}"
        expression[gene] = {}
        eff = [0.0, 40.0, -8.0, 3.0][g % 4]
        for k in range(10):
            genome = f"g{k}"
            pos = None
            if (g + k) % 3 == 0:
                pos = ("Upstream", "Inside", "Downstream")[(g * k) % 3]
                assoc.append(mod.GeneTEAssociation(
                    gene, genome, f"TE_{k}", "chr1", 100, 200, 300, 900,
                    pos))
            v = 10.0 + rng.normal(0, 1) + (eff if pos else 0.0)
            if rng.random() < 0.05:
                v = float("nan")
            if rng.random() > 0.05:
                expression[gene][genome] = max(v, 0.0) if v == v else v
    return expression, assoc


def test_detect_and_write_de_genes(tmp_path):
    res = {}
    for name, mod in (("jax", jrs), ("port", trs)):
        res[name] = mod.detect_de_genes(*_de_inputs(mod))
        mod.write_de_genes(str(tmp_path / name), res[name], plot=False)
    a, b = res["port"], res["jax"]
    assert len(a) == len(b) and any(r.significant for r in b)
    for x, y in zip(a, b):
        assert (x.gene_name, x.insert_type, x.significant, x.direction) == \
            (y.gene_name, y.insert_type, y.significant, y.direction)
        assert x.fold_change == y.fold_change
        assert (math.isnan(x.p_adjust) and math.isnan(y.p_adjust)) or \
            abs(x.p_adjust - y.p_adjust) <= P_TOL
    _same_files(tmp_path / "jax", tmp_path / "port",
                ["all_gene_TEs_details.tsv", "DE_genes_from_TEs.tsv"])


def test_write_de_genes_without_matplotlib(tmp_path, monkeypatch):
    """The volcano plot is best-effort: with matplotlib missing, as on a
    machine without it, the TSVs are written all the same."""
    results = trs.detect_de_genes(*_de_inputs(trs))
    trs.write_de_genes(str(tmp_path / "with"), results, plot=False)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    trs.write_de_genes(str(tmp_path / "without"), results, plot=True)
    assert not (tmp_path / "without" / "DE_genes_from_TEs.pdf").exists()
    _same_files(tmp_path / "with", tmp_path / "without",
                ["all_gene_TEs_details.tsv", "DE_genes_from_TEs.tsv"])
