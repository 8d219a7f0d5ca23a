"""Stages 3-4 of run_pipeline on hite_tpu_torch vs hite_tpu: the FiLTR LTR
stage and library assembly, from the same stage 1-2b results.

The JAX package runs stages 1-2b (tandem mask, coarse discovery, the
three modules over one shared join, the low-copy rescue) once, as
`test_torch_modules_path.py` replays them (that file holds the port's
stages 1-2b equal to these); both sides then start from those results:
the tandem-masked genome and the module families.  The JAX side runs
the body of its `run_pipeline`'s stage 3 (masking with the families
accepted before the rescue, `run_ltr_detection`, `deep_filter_records`
with the bundled CNN, `cross_class_filter`, `classify_ltr_records`) and
stage 4 (`build_library`); the port runs `run.ltr_stage` and
`run.library_stage`.  LTR records, cross-class pools and every library
dict must be equal, name for name and base for base.  This file: the
160 kbp `pipeline_parity` genome; `test_torch_library_path_2mbp.py`: the
2 Mbp bench substrate.
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


def run_stages_3_4(name):
    """(JAX (masked, ltr, libs), port (masked, ltr, libs), launches)."""
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

    g = Genome.from_dict(contigs, device="cpu")
    g.masked = masked
    tcfg = PipelineConfig(align=AlignConfig(**align_kw)
                          ).with_genome_size(g.size)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(rep["cfg"])
    gindex = GenomeIndex(g, tcfg.align, seg_len=rep["gindex"].seg_len)
    kernels.reset_launches()
    ltr = ltr_stage(g, tcfg, gindex, found, seg_len=gindex.seg_len)
    libs = library_stage(g, tcfg, ltr=ltr, **mods)
    return ref, (g.masked.copy(), ltr, libs), dict(kernels.LAUNCHES)


def check_ltr(ref, got):
    (jm, jltr, _), (tm, tltr, _) = ref, got
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


def test_ltr_stage_rejects_legacy_path(stages):
    """`use_filtr=False` (the legacy LTR path) is not ported: it raises
    before masking anything."""
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.pipeline.run import ltr_stage

    _, (masked, _, _), _ = stages
    g = Genome.from_dict({"chr1": masked[:1000].copy()}, device="cpu")
    g.init_mask()
    cfg = PipelineConfig()
    cfg = cfg.replace(ltr=dataclasses.replace(cfg.ltr, use_filtr=False))
    with pytest.raises(NotImplementedError, match="16.1"):
        ltr_stage(g, cfg, None, [np.array([[0, 500]])])
    assert np.array_equal(g.masked, g.flat)
