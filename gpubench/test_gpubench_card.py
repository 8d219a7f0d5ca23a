"""Chip-only checks of the benchmark (marker `card`; they skip without a
CUDA card).  On the chip: `python -m pytest -p no:xdist -o addopts=""
gpubench/test_gpubench_card.py -m card`."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from gpubench import control, harness
from gpubench.conftest import ROOT
from gpubench.reference import judge

CELLS = ("hite-32mbp.dmel",)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_controls_fail_at_the_cells_size(card, cell):
    """Three seeds at the cell's own size: the program within the limits,
    every control outside them."""
    spec = harness.load_spec(ROOT, cell)
    for row in control.readings(cell, [101, 2**31 + 102, 103]):
        assert judge(row["program"], spec["limits"]), row
        for name in ("coarse_ends", "half_copies", "half_families"):
            assert not judge(row[name], spec["limits"]), (name, row)


@pytest.mark.card
def test_a_short_run_prints_its_result_last(card):
    r = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", CELLS[0],
         "--seed", "2147483999", "--seconds", "1", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert r.stderr.strip().splitlines()[-1].startswith("compared ")
    assert os.path.isdir(os.path.join(ROOT, "hite_tpu_torch", "_build"))
