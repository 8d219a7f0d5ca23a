"""Stages 3-5 of run_pipeline on hite_tpu_torch vs hite_tpu: the FiLTR LTR
stage and library assembly, from the same stage 1-2b results.

The JAX package runs stages 1-2b (tandem mask, coarse discovery, the
three modules over one shared join, the low-copy rescue) once, as
`test_torch_modules_path.py` replays them (that file holds the port's
stages 1-2b equal to these); both sides then start from those results:
the tandem-masked genome and the module families.  The JAX side runs
the body of its `run_pipeline`'s stage 3 (masking with the families
accepted before the rescue, `run_ltr_detection`, `deep_filter_records`
with the bundled CNN, `cross_class_filter`, `classify_ltr_records`),
stage 4 (`build_library`) and stage 5 (`annotate_genome` with the merged
library); the port runs `run.ltr_stage`, `run.library_stage` and
`annotate.annotate_genome`.  LTR records, cross-class pools, every library
dict and every annotation hit must be equal, name for name, base for base
and identity for identity.  This file: the 160 kbp `pipeline_parity`
genome, and the legacy LTR stage on a 3-element LTR genome;
`test_torch_library_path_2mbp.py`: the 2 Mbp bench substrate.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_modules_path import MODS, _replay
from test_torch_tir_path import _substrate

torch.set_num_threads(2)


def _port_module(m):
    """A port ModuleResult holding the same families as a JAX one."""
    from hite_tpu_torch.pipeline.candidates import CandidateSet
    from hite_tpu_torch.pipeline.verify import ModuleResult

    return ModuleResult(
        accepted=CandidateSet(
            intervals=m.accepted.intervals.copy(),
            meta={k: v.copy() for k, v in m.accepted.meta.items()}),
        consensus=[c.copy() for c in m.consensus],
        low_copy=CandidateSet(intervals=m.low_copy.intervals.copy()),
        copy_counts=list(m.copy_counts))


def _jax_stages_3_4(rep, found):
    """The JAX run_pipeline's stage 3 closure body and stage 4."""
    from hite_tpu.models import bundled_model_path
    from hite_tpu.models.trainer import load_params
    from hite_tpu.pipeline.library import build_library
    from hite_tpu.pipeline.ltr import (
        LTRResult, classify_ltr_records, run_ltr_detection,
    )
    from hite_tpu.pipeline.ltr_deep import (
        cross_class_filter, deep_filter_records,
    )

    g, cfg, gindex = rep["genome"], rep["cfg"], rep["gindex"]
    g.mask_intervals((int(s), int(e)) for arr in found for s, e in arr)
    res = run_ltr_detection(g, cfg, gindex, seg_len=gindex.seg_len)
    kept = deep_filter_records(
        g, res.records, cfg, gindex,
        cnn_params=load_params(bundled_model_path("ltr_filter_cnn.pkl")))
    kept, pools = cross_class_filter(g, kept, cfg, gindex)
    ltr = LTRResult(records=kept, cross_class=pools)
    if ltr.records:
        classify_ltr_records(g, ltr.records, cfg)
    libs = build_library(g, cfg, ltr=ltr, **rep["mods"])
    return g.masked.copy(), ltr, libs


def _annotate(port, g, libs, cfg, gindex):
    """Stage 5 as run_pipeline runs it: the merged library on the genome's
    unmasked join."""
    if port:
        from hite_tpu_torch.pipeline.annotate import annotate_genome
    else:
        from hite_tpu.pipeline.annotate import annotate_genome
    return annotate_genome(g, libs["merged"], cfg, gindex)


def run_stages_3_4(name):
    """(JAX (masked, ltr, libs, hits), port (masked, ltr, libs, hits),
    launches)."""
    from hite_tpu_torch import kernels
    from hite_tpu_torch.config import AlignConfig, PipelineConfig
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.pipeline.copies import GenomeIndex
    from hite_tpu_torch.pipeline.run import library_stage, ltr_stage

    contigs, params_kw, align_kw = _substrate(name)
    rep = _replay(False, contigs, params_kw, align_kw)
    # run_pipeline masks with the families accepted BEFORE the rescue
    found = [rep["verified"][k]["accepted"] for k in MODS]
    masked = rep["genome"].masked.copy()
    mods = {k: _port_module(m) for k, m in rep["mods"].items()}
    ref = _jax_stages_3_4(rep, found)
    ref += (_annotate(False, rep["genome"], ref[2], rep["cfg"],
                      rep["gindex"]),)

    g = Genome.from_dict(contigs, device="cpu")
    g.masked = masked
    tcfg = PipelineConfig(align=AlignConfig(**align_kw)
                          ).with_genome_size(g.size)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(rep["cfg"])
    gindex = GenomeIndex(g, tcfg.align, seg_len=rep["gindex"].seg_len)
    kernels.reset_launches()
    ltr = ltr_stage(g, tcfg, gindex, found, seg_len=gindex.seg_len)
    libs = library_stage(g, tcfg, ltr=ltr, **mods)
    hits = _annotate(True, g, libs, tcfg, gindex)
    return ref, (g.masked.copy(), ltr, libs, hits), dict(kernels.LAUNCHES)


def check_ltr(ref, got):
    (jm, jltr), (tm, tltr) = ref[:2], got[:2]
    assert np.array_equal(jm, tm)
    assert [dataclasses.asdict(r) for r in jltr.records] == \
        [dataclasses.asdict(r) for r in tltr.records]
    assert list(jltr.cross_class) == list(tltr.cross_class)
    for k in jltr.cross_class:
        assert [v.tolist() for v in jltr.cross_class[k]] == \
            [v.tolist() for v in tltr.cross_class[k]]


def check_libs(ref, got):
    jl, tl = ref[2], got[2]
    assert list(jl) == list(tl)
    for key in jl:
        assert list(jl[key]) == list(tl[key]), key
        for name in jl[key]:
            assert np.array_equal(jl[key][name], tl[key][name]), name


def check_annotation(ref, got):
    """Every hit equal in every field; identities (float64 ratios of the
    SW rescore's exact counts) compared exactly."""
    jh, th = ref[3], got[3]
    assert [dataclasses.asdict(h) for h in jh] == \
        [dataclasses.asdict(h) for h in th]


@pytest.fixture(scope="module")
def stages():
    return run_stages_3_4("parity_160k")


def test_ltr_stage(stages):
    ref, got, _ = stages
    check_ltr(ref, got)
    assert len(got[1].records) >= 1


def test_library_stage(stages):
    ref, got, launches = stages
    check_libs(ref, got)
    labels = {n.partition("#")[2].split("/")[0] for n in got[2]["merged"]}
    assert {"DNA", "SINE", "LTR"} <= labels
    assert launches == {"sw": 0, "sw_protein": 0}   # CPU: plain versions


def test_annotation(stages):
    """Stage 5 on the merged library: the same hits; the rescore's SW runs
    on the CPU's plain version."""
    ref, got, _ = stages
    check_annotation(ref, got)
    assert len(got[3]) >= 10
    assert any(h.full_length for h in got[3])


def test_ltr_stage_legacy_path():
    """`ltr_stage` with `use_filtr=False` (`--use_FiLTR 0`) equals the JAX
    `run_pipeline`'s legacy stage 3 (mask, `run_legacy_ltr_detection`,
    `classify_ltr_records`) on a 2-element LTR genome: the same masked
    genome and records.  (The 160 kbp genome's legacy windows need 8192-wide
    SW at 128 rows, hours for the CPU's plain version.)"""
    from test_ltr import _make_ltr_genome

    from hite_tpu.pipeline.copies import GenomeIndex as JaxIndex
    from hite_tpu.pipeline.ltr import classify_ltr_records
    from hite_tpu.pipeline.ltr_legacy import run_legacy_ltr_detection
    from hite_tpu_torch.config import AlignConfig, PipelineConfig
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.pipeline.copies import GenomeIndex
    from hite_tpu_torch.pipeline.run import ltr_stage

    jg, starts, _el_len, _ = _make_ltr_genome(n_elements=2)
    found = [np.array([[5_000, 5_600], [70_000, 70_400]])]
    tcfg = PipelineConfig(align=AlignConfig(fixed_extend_base_threshold=2000))
    tcfg = tcfg.replace(ltr=dataclasses.replace(tcfg.ltr, use_filtr=False))
    tcfg = tcfg.with_genome_size(jg.size)

    from hite_tpu.config import AlignConfig as JaxAlign
    from hite_tpu.config import PipelineConfig as JaxConfig

    jcfg = JaxConfig(align=JaxAlign(fixed_extend_base_threshold=2000))
    jcfg = jcfg.replace(ltr=dataclasses.replace(jcfg.ltr, use_filtr=False))
    jcfg = jcfg.with_genome_size(jg.size)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)

    g = Genome.from_dict({"chr1": jg.flat[: jg.size].copy()}, device="cpu")
    jg.init_mask()
    jg.mask_intervals((int(s), int(e)) for arr in found for s, e in arr)
    ref = run_legacy_ltr_detection(jg, jcfg, JaxIndex(jg, jcfg.align))
    classify_ltr_records(jg, ref.records, jcfg)

    got = ltr_stage(g, tcfg, GenomeIndex(g, tcfg.align), found)
    assert np.array_equal(g.masked, jg.masked)
    assert [dataclasses.asdict(r) for r in got.records] == \
        [dataclasses.asdict(r) for r in ref.records]
    assert got.cross_class == {}
    assert any(abs(r.start - p) <= 10 for r in got.records for p in starts)
