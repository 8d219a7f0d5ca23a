"""Stages 3-5 of run_pipeline on hite_tpu_torch vs hite_tpu on the 2 Mbp
bench substrate (117 planted copies of 11 families in all four classes),
from the same stage 1-2b results: see `test_torch_library_path.py`."""

import pytest

from test_torch_library_path import (
    check_annotation, check_libs, check_ltr, run_stages_3_4,
)


@pytest.fixture(scope="module")
def stages():
    return run_stages_3_4("bench_2mbp")


def test_ltr_stage(stages):
    ref, got, _ = stages
    check_ltr(ref, got)
    assert len(got[1].records) >= 4


def test_library_stage(stages):
    """Every library dict equal; the merged library holds the DNA,
    RC/Helitron, SINE and LTR classes of the planted families."""
    ref, got, _ = stages
    check_libs(ref, got)
    labels = {n.partition("#")[2].split("/")[0] for n in got[2]["merged"]}
    assert {"DNA", "RC", "SINE", "LTR"} <= labels


def test_annotation(stages):
    """Stage 5: every hit equal; the planted copies are annotated."""
    ref, got, _ = stages
    check_annotation(ref, got)
    assert len(got[3]) >= 100
