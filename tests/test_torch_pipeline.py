"""hite_tpu_torch's `run_pipeline` vs a fresh `hite_tpu.run_pipeline`.

The 160 kbp `pipeline_parity` genome (planted TIR, SINE and LTR
families) through every stage on the CPU with annotation, the domain
table and all three library benchmarks on: every output file must be
byte-equal (apart from `stage_times.json`) and the metrics equal; the
port's run on an 8-shard CPU mesh (`parallel.mesh`) writes the same
files.  Also stage 0a, the redundant-contig clean, on
`tests/test_pipeline.py`'s two-contig genome: the same contig map and
accepted families.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from test_torch_tir_path import (  # noqa: F401  (autouse)
    _substrate, compile_cache,
)

torch.set_num_threads(2)

FILES = ["confident_tir.fa", "confident_helitron.fa", "confident_non_ltr.fa",
         "confident_other.fa", "confident_ltr_cut.fa.cons",
         "confident_TE.cons.fa", "low_confident_TE.fa", "intact_LTR.list",
         "ltr_insert_time.tsv", "genome.gff", "genome.out", "genome.tbl",
         "genome.full_length.gff", "TE_domains.tsv", "benchmark.json"]
FLAGS = dict(annotate=True, domain=True, bm_hite=True, bm_rm2=True,
             bm_edta=True)


def _run(port, contigs, params_kw, cfg_kw, align_kw, out_dir, mesh=None):
    if port:
        from hite_tpu_torch import config, genome
        from hite_tpu_torch.pipeline import coarse, run
    else:
        from hite_tpu import config, genome
        from hite_tpu.pipeline import coarse, run
    g = genome.Genome.from_dict({k: v.copy() for k, v in contigs.items()},
                                **({"device": "cpu"} if port else {}))
    cfg = config.PipelineConfig(align=config.AlignConfig(**align_kw),
                                **cfg_kw)
    return run.run_pipeline(g, cfg, out_dir=out_dir,
                            coarse_params=coarse.CoarseParams(**params_kw),
                            **({"mesh": mesh} if mesh is not None else {}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    contigs, params_kw, align_kw = _substrate("parity_160k")
    out = {}
    for port in (False, True):
        d = str(tmp_path_factory.mktemp("port" if port else "jax"))
        out[port] = (_run(port, contigs, params_kw, FLAGS, align_kw, d), d)
    return out


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The port's run of `runs` on a 2 x 4 mesh of CPU shards."""
    from hite_tpu_torch.parallel.mesh import make_mesh

    contigs, params_kw, align_kw = _substrate("parity_160k")
    d = str(tmp_path_factory.mktemp("port_mesh"))
    mesh = make_mesh(devices=[torch.device("cpu")] * 8)
    return _run(True, contigs, params_kw, FLAGS, align_kw, d, mesh=mesh), d


@pytest.mark.parametrize("name", FILES)
def test_mesh_file_byte_equal(runs, mesh_run, name):
    """`run_pipeline(mesh=...)` (the chunked self-join, the family
    analyses and the frame judge sharded) against `hite_tpu`'s unsharded
    run."""
    ref_dir = runs[False][1]
    assert sorted(os.listdir(mesh_run[1])) == sorted(os.listdir(ref_dir))
    assert filecmp.cmp(os.path.join(ref_dir, name),
                       os.path.join(mesh_run[1], name), shallow=False), name


def test_same_files(runs):
    names = [sorted(f for f in os.listdir(runs[p][1])) for p in runs]
    assert names[0] == names[1] == sorted(FILES + ["stage_times.json"])


@pytest.mark.parametrize("name", FILES)
def test_file_byte_equal(runs, name):
    a, b = (os.path.join(runs[p][1], name) for p in (False, True))
    assert filecmp.cmp(a, b, shallow=False), name


def test_metrics_equal(runs):
    ref, got = (dict(runs[p][0].metrics) for p in (False, True))
    for m in (ref, got):
        m.pop("stage_times")
    assert got == ref
    assert got["annotation_hits"] >= 10
    assert set(got) == {"annotation_hits", "domain_hits", "BM_HiTE",
                        "BM_RM2", "BM_EDTA"}
    res = runs[True][0]
    assert len(res.annotation) == got["annotation_hits"]
    assert len(res.libs["merged"]) >= 3 and len(res.ltr.records) >= 1
    for stage in ("pipeline.coarse", "pipeline.modules", "pipeline.ltr",
                  "pipeline.library", "pipeline.annotate", "annotate.map",
                  "annotate.rescore", "pipeline.benchmark"):
        assert stage in res.metrics["stage_times"], stage


def test_clean_stage_drops_redundant_contig(tmp_path):
    """Stage 0a on `tests/test_pipeline.py`'s genome: the 10 kbp contig
    copied from the 40 kbp one is dropped, the survivor renamed Chr1."""
    rng = np.random.default_rng(5)
    big = rng.integers(0, 4, 40_000).astype(np.uint8)
    contigs = {"c1": big, "c2": big[1_000:11_000].copy()}
    params = dict(seg_len=16_384, pair_batch=16)
    align = dict(fixed_extend_base_threshold=2000)
    res = {}
    for port in (False, True):
        d = str(tmp_path / ("port" if port else "jax"))
        res[port] = (_run(port, contigs, params, {"te_type": "tir"}, align,
                          d), d)
    maps = [open(os.path.join(d, "contig_name.map")).read()
            for _r, d in res.values()]
    assert maps[0] == maps[1] == "Chr1\tc1\n"
    ref, got = res[False][0], res[True][0]
    assert "pipeline.clean" in got.metrics["stage_times"]
    assert np.array_equal(got.tir.accepted.intervals,
                          ref.tir.accepted.intervals)
    assert got.helitron is None and got.ltr is None
    assert filecmp.cmp(os.path.join(res[False][1], "confident_TE.cons.fa"),
                       os.path.join(res[True][1], "confident_TE.cons.fa"),
                       shallow=False)
