"""The FiLTR LTR stage and the library of hite_tpu_torch vs hite_tpu on a
genome whose LTR family has 7 copies.

`test_torch_ltr.py`'s chain (pair candidates through superfamily labels)
on the 120 kbp `ltr6_genome`: its records have more than 5 copies, so
`deep_filter_records` sends them to the LTR CNN (with the bundled
parameters), and both packages must run it once and keep the same
records.  Then `build_library` over the LTR result on each side: the
library dicts equal name for name and base for base.
"""

import numpy as np
import pytest

from chip_smoke import ltr6_genome
from test_torch_ltr import STAGES, run_chains
from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def chains():
    return run_chains({"chr1": ltr6_genome()[0]}, {})


@pytest.mark.parametrize("stage", STAGES)
def test_ltr_chain_stage(chains, stage):
    ref, got, _calls = chains
    assert ref[stage] == got[stage], stage


def test_cnn_confirm_ran(chains):
    """Records of more than 5 copies reach the CNN: one batched forward
    on each side (a forward hook on the port's LTRFilterCNN), the same
    records kept, the planted family found."""
    ref, got, calls = chains
    assert max(r["copy_count"] for r in got["detected"]) > 5
    assert calls["jax"] == calls["port"] == 1
    assert ref["deep"] == got["deep"] and len(got["deep"]) >= 2
    truth = ltr6_genome()[1]
    hit = [any(abs(r["start"] - s) <= 10 and abs(r["end"] - e) <= 10
               for s, e in truth) for r in got["classified"]]
    assert sum(hit) >= 2


def test_library_of_the_ltr_family(chains):
    """`build_library` over the LTR result alone (no module families):
    every library dict equal on both sides."""
    from hite_tpu.pipeline.library import build_library as jbuild
    from hite_tpu_torch.pipeline.library import build_library

    ref, got, _calls = chains
    jlibs = jbuild(*ref["state"][:2], ltr=ref["state"][2])
    tlibs = build_library(*got["state"][:2], ltr=got["state"][2])
    assert list(jlibs) == list(tlibs)
    for key in jlibs:
        assert list(jlibs[key]) == list(tlibs[key]), key
        for name in jlibs[key]:
            assert np.array_equal(jlibs[key][name], tlibs[key][name]), name
    assert any(n.endswith("#LTR") for n in tlibs["merged"])
