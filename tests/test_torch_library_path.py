"""The legacy LTR stage (`--use_FiLTR 0`) of hite_tpu_torch vs hite_tpu.

Stages 3-5 of the default FiLTR path, from the JAX package's stage 1-2b
results, are held in `test_torch_modules_path.py` beside the stage 1-2b
checks, so that one JAX replay of each substrate serves both.
"""

import dataclasses

import numpy as np
import torch
from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(2)


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
