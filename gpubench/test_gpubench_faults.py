"""The comparison that decides `correct`, shown to fail: on the CPU at a
size a test run holds (the mini cell of `conftest.py`), a sound run is
correct, each control fails the limits, and a run with the timed path
broken underneath comes out not correct, once for each fault a one-card
cell can have (a step that returns its state unchanged; half of the batch
left out; an answer altered where it is produced; a whole class of
families dropped).  A run here skips the
look for a card and drives the rest of the run."""

from __future__ import annotations

import json

import numpy as np
import pytest

from gpubench import control, harness
from gpubench.conftest import MINI_CELL
from gpubench.reference import judge


def _run(root, capsys, seed=3_000_000_017):
    rc = harness.main(["--workload", MINI_CELL, "--seed", str(seed),
                       "--seconds", "0", "--trace", "0"],
                      root=root, device="cpu")
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_sound_run_is_correct(mini_root, capsys):
    res = _run(mini_root, capsys)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert list(res)[-1] == "compared"
    assert set(res["metrics"]) == {"mbp_per_s", "peak_device_gib",
                                   "setup_s"}


def test_sound_run_is_correct_with_three_ltr_families(mini_ltr_root,
                                                      capsys):
    res = _run(mini_ltr_root, capsys)
    assert res["correct"] is True and res["failed"] == 0
    assert res["compared"]["family_miss"]["value"] == 0.0


def test_controls_fail_and_the_program_passes(mini_root):
    spec = harness.load_spec(mini_root, MINI_CELL)
    rows = control.readings(MINI_CELL, [11, 2**31 + 3], root=mini_root,
                            device="cpu")
    for row in rows:
        assert judge(row["program"], spec["limits"]), row
        assert judge(row["reference"], spec["limits"]), row
        for name in ("coarse_ends", "half_copies", "half_families"):
            assert not judge(row[name], spec["limits"]), (name, row)


def test_a_step_that_returns_its_state_unchanged_is_caught(
        mini_root, capsys, monkeypatch):
    import hite_tpu_torch.pipeline.run as run

    def unchanged(genome, cfg, out_dir=None, coarse_params=None, mesh=None):
        return run.RunResult(libs={})

    monkeypatch.setattr(run, "run_pipeline", unchanged)
    assert _run(mini_root, capsys)["correct"] is False


def test_half_of_the_batch_left_out_is_caught(mini_root, capsys,
                                              monkeypatch):
    import hite_tpu_torch.pipeline.run as run

    real = run.annotate_genome

    def half(*a, **k):
        return real(*a, **k)[::2]

    monkeypatch.setattr(run, "annotate_genome", half)
    assert _run(mini_root, capsys)["correct"] is False


def test_an_answer_altered_where_it_is_produced_is_caught(
        mini_root, capsys, monkeypatch):
    import hite_tpu_torch.pipeline.run as run

    real = run.library_stage

    def altered(*a, **k):
        # each entry as the library stage produces it, its first 60 bp lost
        libs = real(*a, **k)
        merged = libs["merged"]
        for name in merged:
            merged[name] = np.asarray(merged[name])[60:]
        return libs

    monkeypatch.setattr(run, "library_stage", altered)
    assert _run(mini_root, capsys)["correct"] is False


def test_a_class_of_families_dropped_is_caught(mini_ltr_root, capsys,
                                               monkeypatch):
    import hite_tpu_torch.pipeline.run as run
    from hite_tpu_torch.pipeline.ltr import LTRResult

    real = run.ltr_stage

    def no_ltr(*a, **k):
        # the LTR stage runs, and its elements never reach the library
        res = real(*a, **k)
        return LTRResult(records=[], cross_class=res.cross_class)

    monkeypatch.setattr(run, "ltr_stage", no_ltr)
    res = _run(mini_ltr_root, capsys)
    assert res["correct"] is False
    assert res["compared"]["family_miss"]["value"] > res["compared"][
        "family_miss"]["limit"]
