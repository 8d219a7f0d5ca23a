"""The legacy LTR path (`--use_FiLTR 0`) of hite_tpu_torch vs hite_tpu.

Both packages replay stage 1a (tandem mask) and run the legacy functions
on the CPU: `harvest_exact_seeds` and `_seed_windows` on the 160 kbp
`pipeline_parity` genome, the 7-copy LTR genome and the JAX legacy tests'
3-element LTR genome; `run_legacy_ltr_detection` (seeds, window SW,
LTR_retriever filters, copy counts) on the 3-element genome; and
`retriever_filter` on the JAX tests' hand-made records.  Seeds, windows
and records (`dataclasses.asdict`) must be equal.  The first two genomes
give 100-200 windows 8192 wide, a refinement SW that the CPU's plain
version cannot run in a test's time; `chip_smoke.py` drives the whole
path on them on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import ltr6_genome
from test_ltr import _make_ltr_genome
from test_torch_tir_path import _substrate

torch.set_num_threads(2)


def _contigs(name):
    if name == "parity_160k":
        contigs, _params, align_kw = _substrate(name)
        return contigs, align_kw
    if name == "ltr7":
        return {"chr1": ltr6_genome()[0]}, {}
    g = _make_ltr_genome()[0]
    return ({"chr1": g.flat[: g.size].copy()},
            dict(fixed_extend_base_threshold=2000))


def _replay(port, name):
    """(genome, cfg, gindex, legacy module) after stage 1a."""
    if port:
        from hite_tpu_torch import config, genome
        from hite_tpu_torch.pipeline import copies, ltr_legacy, run
    else:
        from hite_tpu import config, genome
        from hite_tpu.pipeline import copies, ltr_legacy, run
    contigs, align_kw = _contigs(name)
    g = genome.Genome.from_dict(contigs, **({"device": "cpu"} if port
                                            else {}))
    cfg = config.PipelineConfig(align=config.AlignConfig(**align_kw))
    cfg = cfg.replace(ltr=dataclasses.replace(cfg.ltr, use_filtr=False))
    cfg = cfg.with_genome_size(g.size)
    g.init_mask()
    run._mask_tandem_regions(g)
    return g, cfg, copies.GenomeIndex(g, cfg.align), ltr_legacy


@pytest.mark.parametrize("name", ["parity_160k", "ltr7", "ltr3"])
def test_seeds_and_windows(name):
    jg, jcfg, _, jl = _replay(False, name)
    tg, tcfg, _, tl = _replay(True, name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert np.array_equal(tg.masked, jg.masked)
    seeds = tl.harvest_exact_seeds(tg, tcfg)
    assert seeds == jl.harvest_exact_seeds(jg, jcfg)
    assert tl._seed_windows(seeds, tcfg) == jl._seed_windows(seeds, jcfg)
    assert len(seeds) >= 3


def test_run_legacy_ltr_detection():
    jg, jcfg, jidx, jl = _replay(False, "ltr3")
    tg, tcfg, tidx, tl = _replay(True, "ltr3")
    ref = jl.run_legacy_ltr_detection(jg, jcfg, jidx)
    got = tl.run_legacy_ltr_detection(tg, tcfg, tidx)
    assert [dataclasses.asdict(r) for r in got.records] == \
        [dataclasses.asdict(r) for r in ref.records]
    _g, starts, el_len, _ = _make_ltr_genome()
    assert any(abs(r.start - p) <= 10 and abs(r.end - p - el_len) <= 10
               for r in got.records for p in starts)
    assert all(r.copy_count >= 1 for r in got.records)


def _records(port, rec_tuples):
    if port:
        from hite_tpu_torch.pipeline.ltr import LTRRecord
    else:
        from hite_tpu.pipeline.ltr import LTRRecord
    return [LTRRecord(*t[:8], tsd_len=t[8]) for t in rec_tuples]


def test_retriever_filter():
    """The JAX tests' two scenarios in one genome: motif without TSD kept,
    neither motif nor TSD dropped, shifted termini dropped, a diverged
    pair with one half of the evidence dropped."""
    from hite_tpu.genome import Genome as JaxGenome
    from hite_tpu.pipeline.ltr_legacy import retriever_filter as jfilter
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.pipeline.ltr_legacy import retriever_filter

    rng = np.random.default_rng(52)
    bg = rng.integers(0, 4, 12_000).astype(np.uint8)
    bg[1750:2000] = bg[1000:1250]
    bg[1000], bg[1001], bg[1998], bg[1999] = 3, 2, 1, 0
    bg[3200:3400] = bg[2500:2700]
    bg[2500], bg[2501], bg[3398], bg[3399] = 0, 0, 3, 3
    ltr = rng.integers(0, 4, 250).astype(np.uint8)
    ltr[0], ltr[1], ltr[-2], ltr[-1] = 3, 2, 1, 0
    bg[5000:5250] = ltr
    bg[6750:7000] = ltr
    recs = [(1000, 2000, 1000, 1250, 1750, 2000, 0.95, 1e6, 0),
            (2500, 3400, 2500, 2700, 3200, 3400, 0.95, 1e6, 0),
            (5000, 7000, 5000, 5250, 6750, 7000, 0.98, 1e5, 5),
            (4940, 6940, 4940, 5190, 6690, 6940, 0.98, 1e5, 5),
            (5000, 7000, 5000, 5250, 6750, 7000, 0.85, 1e5, 0)]
    ref = jfilter(JaxGenome.from_dict({"chr1": bg}), _records(False, recs))
    got = retriever_filter(Genome.from_dict({"chr1": bg}, device="cpu"),
                           _records(True, recs))
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in ref]
    assert [r.start for r in got] == [1000, 5000]
