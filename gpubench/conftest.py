"""Fixtures of the benchmark's own tests (run them with
`python -m pytest gpubench/ -p xdist -n 4 --dist load`; the card-only ones
on the chip with `python -m pytest -p no:xdist -o addopts="" gpubench/
-m card`)."""

from __future__ import annotations

import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# a cell small enough for the CPU: one TIR, one SINE and one LTR family on
# 240 kbp, with the small genomes' coarse parameters
MINI_CONFIG = {
    "name": "mini", "genome_bp": 240_000, "scale": 1, "threads": 2,
    "pipeline": {"annotate": True, "recover": True,
                 "align": {"fixed_extend_base_threshold": 2000}},
    "coarse": {"seg_len": 32_768, "pair_batch": 16, "stride": 4,
               "max_hits": 4, "max_selfjoin_bp": 131_072},
}
MINI_TRAFFIC = {
    "content_seed": 7, "min_gap_bp": 200,
    "families": [
        {"class": "TIR", "per_scale": 1, "terminal_bp": 20, "tsd_bp": 5,
         "mutation": 0.02, "cycle": [{"copies": 8, "interior_bp": 460}]},
        {"class": "SINE", "per_scale": 1, "polya_bp": 14, "tsd_bp": 12,
         "mutation": 0.02, "cycle": [{"copies": 8, "interior_bp": 300}]},
        {"class": "LTR", "per_scale": 1, "interior_bp": 1500, "tsd_bp": 5,
         "mutation": 0.01, "cycle": [{"copies": 4, "ltr_bp": 300}]},
    ],
    "hard": None,
}
# the same with three LTR families: over one family a class dropped may
# not show, as the TIR module takes some LTR elements for DNA/Maverick
# and carries the family (the cell's LTR_1, PERF.md)
MINI_LTR_TRAFFIC = {**MINI_TRAFFIC, "families": MINI_TRAFFIC["families"][:2] + [
    {"class": "LTR", "per_scale": 3, "tsd_bp": 5, "mutation": 0.01,
     "cycle": [{"copies": 4, "ltr_bp": 300, "interior_bp": 1500},
               {"copies": 4, "ltr_bp": 250, "interior_bp": 1300},
               {"copies": 4, "ltr_bp": 350, "interior_bp": 1700}]}]}
MINI_CELL = "mini.small"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this benchmark's chip-only test")
    return "cuda:0"


def copy_bench(dst: str) -> str:
    """A checkout's benchmark files (BENCHMARK.json and gpubench/) in dst."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(HERE, os.path.join(dst, "gpubench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def add_cell(root: str, limits_from: str = "hite-32mbp.dmel",
             traffic: dict = MINI_TRAFFIC) -> str:
    """Drops the mini configuration, traffic and cell into a copy, as a
    later change would: new files and new entries only."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "mini", "source": "test",
                             "file": "gpubench/configs/mini.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": MINI_CELL, "config": "mini",
                               "traffic": "small", "chips": 1,
                               "why": "test"})
    with open(path, "w") as fh:
        json.dump(bench, fh)
    g = os.path.join(root, "gpubench")
    with open(os.path.join(g, "configs", "mini.json"), "w") as fh:
        json.dump(MINI_CONFIG, fh)
    with open(os.path.join(g, "traffic", "small.json"), "w") as fh:
        json.dump(traffic, fh)
    with open(os.path.join(g, "cells", limits_from + ".json")) as fh:
        judged = json.load(fh)
    with open(os.path.join(g, "cells", MINI_CELL + ".json"), "w") as fh:
        json.dump({k: judged[k] for k in ("limits", "family_classes")}, fh)
    return MINI_CELL


def _mini(tmp_path, monkeypatch, traffic: dict) -> str:
    root = copy_bench(str(tmp_path))
    add_cell(root, traffic=traffic)
    tmp = tmp_path / "tmpdir"
    tmp.mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    return root


@pytest.fixture
def mini_root(tmp_path, monkeypatch):
    """A copy of the benchmark with the mini cell added; TMPDIR inside."""
    return _mini(tmp_path, monkeypatch, MINI_TRAFFIC)


@pytest.fixture
def mini_ltr_root(tmp_path, monkeypatch):
    """The same, its traffic with three LTR families."""
    return _mini(tmp_path, monkeypatch, MINI_LTR_TRAFFIC)
