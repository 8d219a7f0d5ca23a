"""hite_tpu_torch's pan-genome module against hite_tpu.pipeline.pan.

Three small genomes (`scripts.pan_run.small_pan_codes`: a core, a
dispensable and a private TIR family and a SINE family low-copy in g1
that the cross-genome rescue takes up) through `run_pan_pipeline` on both
sides: the rescue fires on both, and panTE.fa, pan_PAV.tsv,
pan_classification.json and ltr_insert_time.csv are byte-equal.  On the
same pan library: `pan_downstream_analysis` with gene GFFs and RNA reads
for two genomes (every output file byte-equal, DE rows written),
`pan_benchmark` and the CLI's benchmarking mode; and the helpers
`sweep_genome_copies`, `preprocess_genome_list`, `ltr_insert_time_outputs`
and `gene_te_associations`.
"""

import dataclasses
import filecmp
import json
import os
import sys

import numpy as np
import pytest
import torch

from hite_tpu_torch.io.fasta import write_fasta
from hite_tpu_torch.scripts.pan_run import downstream_inputs, small_pan_codes
from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(2)

PAN_FILES = ["panTE.fa", "pan_PAV.tsv", "pan_classification.json",
             "ltr_insert_time.csv"]


def _mods(port):
    if port:
        from hite_tpu_torch import config, genome
        from hite_tpu_torch.pipeline import coarse, pan
    else:
        from hite_tpu import config, genome
        from hite_tpu.pipeline import coarse, pan
    return config, genome, coarse, pan


def _genomes(port, codes):
    _c, genome, _co, _p = _mods(port)
    kw = {"device": "cpu"} if port else {}
    return {n: genome.Genome.from_dict({"chr1": c.copy()}, **kw)
            for n, c in codes.items()}


def _cfg(port):
    config = _mods(port)[0]
    return config.PipelineConfig(
        align=config.AlignConfig(fixed_extend_base_threshold=2000))


def _same_files(d1, d2, names):
    bad = [n for n in names if not filecmp.cmp(
        os.path.join(d1, n), os.path.join(d2, n), shallow=False)]
    assert not bad, f"differ: {bad}"


@pytest.fixture(scope="module")
def pan_runs(tmp_path_factory):
    codes, truths = small_pan_codes()
    out = {}
    for port in (False, True):
        _c, _g, coarse, pan = _mods(port)
        gs = _genomes(port, codes)
        d = str(tmp_path_factory.mktemp("port" if port else "jax"))
        res = pan.run_pan_pipeline(
            gs, _cfg(port), out_dir=d,
            coarse_params=coarse.CoarseParams(seg_len=16_384, pair_batch=16))
        out[port] = dict(res=res, dir=d)
    return codes, truths, out


def test_run_pan_pipeline_files(pan_runs):
    _codes, _truths, runs = pan_runs
    listed = [sorted(f for f in os.listdir(runs[p]["dir"])
                     if f != "genomes" and not f.endswith(".pdf"))
              for p in (False, True)]
    assert listed[0] == listed[1] == sorted(PAN_FILES)
    _same_files(runs[False]["dir"], runs[True]["dir"], PAN_FILES)


def test_run_pan_pipeline_result(pan_runs):
    _codes, _truths, runs = pan_runs
    a, b = runs[True]["res"], runs[False]["res"]
    assert a.rescued == b.rescued and a.rescued >= 1
    assert list(a.pan_lib) == list(b.pan_lib)
    assert all(np.array_equal(a.pan_lib[k], b.pan_lib[k]) for k in a.pan_lib)
    assert np.array_equal(a.pav, b.pav)
    assert (a.pav_families, a.pav_genomes) == (b.pav_families, b.pav_genomes)
    assert a.occupancy == b.occupancy
    assert a.classification == b.classification
    assert {"core", "dispensable", "private"} <= set(a.classification.values())
    for g in a.per_genome:
        x, y = a.per_genome[g], b.per_genome[g]
        assert list(x.libs) == list(y.libs)
        for key in x.libs:
            assert list(x.libs[key]) == list(y.libs[key]), (g, key)
        for m in ("tir", "helitron", "non_ltr"):
            assert np.array_equal(getattr(x, m).low_copy.intervals,
                                  getattr(y, m).low_copy.intervals), (g, m)


def test_pan_downstream_analysis(pan_runs, tmp_path):
    codes, truths, runs = pan_runs
    metas = downstream_inputs(codes, truths, str(tmp_path / "in"))
    assert sum(len(open(m["RNA"][0]).read().split("\n")) // 4
               for m in metas if "RNA" in m) <= 40
    out, summary = {}, {}
    for port in (False, True):
        pan = _mods(port)[3]
        d = str(tmp_path / ("port" if port else "jax"))
        res = pan.PanResult(pan_lib=runs[False]["res"].pan_lib,
                            per_genome={})
        summary[port] = pan.pan_downstream_analysis(
            _genomes(port, codes), res, metas, _cfg(port), d, window=300)
        out[port] = d
    assert summary[True] == summary[False]
    assert summary[True]["annotated"] == 3
    assert summary[True]["associations"] >= 1
    assert summary[True]["samples"] == 2
    names = sorted(f for f in os.listdir(out[False])
                   if not f.endswith(".pdf"))
    assert names == sorted(f for f in os.listdir(out[True])
                           if not f.endswith(".pdf"))
    for want in ("g1.gff", "gene_te_associations.tsv", "gene_express.table",
                 "all_gene_TEs_details.tsv", "DE_genes_from_TEs.tsv"):
        assert want in names, names
    _same_files(out[False], out[True], names)
    rows = open(os.path.join(out[True], "all_gene_TEs_details.tsv")).read()
    assert len(rows.strip().split("\n")) >= 2, "stage 7 wrote no rows"


def test_pan_benchmark(pan_runs, tmp_path):
    codes, truths, runs = pan_runs
    lib = runs[False]["res"].pan_lib
    gold = {}
    for t in truths.values():
        gold.update(t["families"])
    metrics = {}
    for port in (False, True):
        pan = _mods(port)[3]
        d = tmp_path / ("port" if port else "jax")
        metrics[port] = pan.pan_benchmark(_genomes(port, codes), lib, gold,
                                          _cfg(port), out_dir=str(d))
    assert metrics[True] == metrics[False]
    assert list(metrics[True]) == list(codes)
    assert all(m["F1"] > 0.5 for m in metrics[True].values()), metrics
    _same_files(tmp_path / "jax", tmp_path / "port", ["pan_benchmark.json"])


def test_main_te_lib_mode(pan_runs, tmp_path):
    """The CLI's benchmarking mode (--TE_lib + --species) over FASTA
    genomes: pan_benchmark.json byte-equal to the JAX CLI's."""
    from hite_tpu.pipeline.pan import main as jmain
    from hite_tpu_torch.pipeline.pan import main as tmain

    codes, truths, runs = pan_runs
    gdir = tmp_path / "genomes"
    gdir.mkdir()
    for n in ("g1", "g3"):
        write_fasta(str(gdir / f"{n}.fa"), {"chr1": codes[n]})
    write_fasta(str(tmp_path / "lib.fa"), runs[False]["res"].pan_lib)
    write_fasta(str(tmp_path / "gold.fa"), truths["g1"]["families"])
    argv = ["--pan_genomes_dir", str(gdir), "--TE_lib",
            str(tmp_path / "lib.fa"), "--species", str(tmp_path / "gold.fa")]
    jmain(argv + ["--out_dir", str(tmp_path / "jax")])
    tmain(argv + ["--out_dir", str(tmp_path / "port")], device="cpu")
    _same_files(tmp_path / "jax", tmp_path / "port", ["pan_benchmark.json"])
    assert set(json.load(open(tmp_path / "port" / "pan_benchmark.json"))) \
        == {"g1.fa", "g3.fa"}


def _sweep(port, find_rng_seed, n_cands, gnames, max_copies):
    from importlib import import_module

    pan = _mods(port)[3]
    CopyHit = import_module(
        f"{'hite_tpu_torch' if port else 'hite_tpu'}.pipeline.copies").CopyHit
    rng = np.random.default_rng(find_rng_seed)
    table = {(g, i): int(rng.integers(0, max_copies + 2))
             for g in gnames for i in range(n_cands)}
    calls = []

    def find(gname, seqs):
        calls.append((gname, [int(s[0]) for s in seqs]))
        return [[CopyHit(10 * k, 10 * k + 9, k % 2, 5)
                 for k in range(table[(gname, int(s[0]))])] for s in seqs]

    cands = [np.full(50, i, np.uint8) for i in range(n_cands)]
    out = pan.sweep_genome_copies(gnames, find, cands, max_copies)
    return calls, {g: [[dataclasses.astuple(h) for h in hs] for hs in v]
                   for g, v in out.items()}


@pytest.mark.parametrize("seed,max_copies", [(0, 3), (1, 5), (2, 1)])
def test_sweep_genome_copies(seed, max_copies):
    gnames = ["gA", "gB", "gC", "gD"]
    got = _sweep(True, seed, 9, gnames, max_copies)
    want = _sweep(False, seed, 9, gnames, max_copies)
    assert got == want
    assert len(got[0][-1][1]) < 9, "no candidate was dropped early"


def _genome_list(tmp_path, lines):
    gdir = tmp_path / "genomes"
    gdir.mkdir(exist_ok=True)
    for n in ("a.fa", "b.fa", "c.fa"):
        (gdir / n).write_text(">chr1\nACGT\n")
    (tmp_path / "a.gff").write_text("chr1\tx\tgene\t1\t4\t.\t+\t.\tID=g1\n")
    (tmp_path / "b.gff3").write_text("chr1\tx\tgene\t1\t4\t.\t+\t.\tID=g2\n")
    (tmp_path / "r1.fq").write_text("@r\nACGT\n+\nIIII\n")
    (tmp_path / "r2.fq").write_text("@r\nACGT\n+\nIIII\n")
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(lines) + "\n")
    return str(lst), str(gdir)


def test_preprocess_genome_list(tmp_path):
    from hite_tpu.pipeline.pan import preprocess_genome_list as jpre
    from hite_tpu_torch.pipeline.pan import preprocess_genome_list as tpre

    lst, gdir = _genome_list(tmp_path, [
        "# comment", "a.fa\ta.gff\t0\tr1.fq", "", "b.fa\tb.gff3\t1\tr1.fq\tr2.fq",
        "c.fa"])
    metas = {name: fn(lst, gdir, genes_dir=str(tmp_path),
                      rna_dir=str(tmp_path), out_dir=str(tmp_path / name))
             for name, fn in (("jax", jpre), ("port", tpre))}
    assert metas["port"] == metas["jax"] and len(metas["port"]) == 3
    _same_files(tmp_path / "jax", tmp_path / "port", ["genome_metadata.json"])
    for bad, exc in ((["z.fa"], FileNotFoundError),
                     (["a.fa\ta.txt"], ValueError),
                     (["a.fa\tmissing.gff"], FileNotFoundError),
                     (["a.fa\ta.gff\t0\tnone.fq"], FileNotFoundError)):
        lst, gdir = _genome_list(tmp_path, bad)
        for fn in (jpre, tpre):
            with pytest.raises(exc):
                fn(lst, gdir, genes_dir=str(tmp_path), rna_dir=str(tmp_path))


def _per_genome(port):
    from importlib import import_module

    pkg = "hite_tpu_torch" if port else "hite_tpu"
    ltr = import_module(f"{pkg}.pipeline.ltr")
    run = import_module(f"{pkg}.pipeline.run")
    rng = np.random.default_rng(14)

    def rec(sf):
        return ltr.LTRRecord(0, 100, 0, 20, 80, 100, 0.98,
                             float(rng.random() * 1e7), superfamily=sf)

    return {
        "g1": run.RunResult(libs={}, ltr=ltr.LTRResult(records=[
            rec("LTR/Copia"), rec("LTR/Gypsy"), rec("LTR/Pao"),
            rec("LTR/Copia")])),
        "g2": run.RunResult(libs={}, ltr=None),
        "g3": run.RunResult(libs={}, ltr=ltr.LTRResult(records=[
            rec("LTR/Gypsy"), rec("LTR/unknown")])),
    }


def test_ltr_insert_time_outputs(tmp_path, monkeypatch):
    from hite_tpu.pipeline.pan import ltr_insert_time_outputs as jfn
    from hite_tpu_torch.pipeline.pan import ltr_insert_time_outputs as tfn

    for name, fn, port in (("jax", jfn, False), ("port", tfn, True)):
        path = fn(_per_genome(port), str(tmp_path / name))
        assert path == str(tmp_path / name / "ltr_insert_time.csv")
    _same_files(tmp_path / "jax", tmp_path / "port", ["ltr_insert_time.csv"])
    assert len(open(path).read().strip().split("\n")) == 5
    # the boxplot is best-effort: without matplotlib the CSV stands alone
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tfn(_per_genome(True), str(tmp_path / "bare"))
    assert os.listdir(tmp_path / "bare") == ["ltr_insert_time.csv"]
    _same_files(tmp_path / "jax", tmp_path / "bare", ["ltr_insert_time.csv"])


def test_pan_summary_plots_without_matplotlib(pan_runs, tmp_path,
                                              monkeypatch):
    from hite_tpu_torch.pipeline.pan import pan_summary_plots

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    pan_summary_plots(pan_runs[2][True]["res"], str(tmp_path))
    assert os.listdir(tmp_path) == []


def test_gene_te_associations():
    from hite_tpu.pipeline.pan import gene_te_associations as jfn
    from hite_tpu_torch.pipeline.pan import gene_te_associations as tfn

    from test_torch_rnaseq import _hits

    rng = np.random.default_rng(15)
    genes = {f"gene{i}": (f"chr{int(rng.integers(1, 3))}", int(s),
                          int(s) + 1500)
             for i, s in enumerate(rng.integers(1, 20_000, 12))}
    for window in (10_000, 300):
        want = jfn(None, _hits("hite_tpu"), genes, window)
        got = tfn(None, _hits("hite_tpu_torch"), genes, window)
        assert got == want and got
