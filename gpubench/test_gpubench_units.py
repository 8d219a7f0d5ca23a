"""The benchmark's yardstick on the CPU: the generator, the window's rate,
the trace reduction, the family count, the refusal without a card, files
found by name, and the import check."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gpubench import genome_gen, harness, trace_reduce
from gpubench.conftest import MINI_TRAFFIC, ROOT, add_cell, copy_bench
from gpubench.reference import Reference

CELL = "hite-32mbp.dmel"


def composition(codes, truth: dict) -> dict:
    """The seed-independent shape of a planted genome."""
    fams = truth["families"]
    return {
        "families": sorted((n, f["class"], len(f["seq"]))
                           for n, f in fams.items()),
        "spans": sorted((e - s, k, n) for s, e, k, n in truth["spans"]),
        "full_copies": sorted((e - s, n) for s, e, n in truth["full_copies"]),
        "bases": np.bincount(codes, minlength=4).tolist(),
    }


def _traffic(name):
    with open(os.path.join(ROOT, "gpubench", "traffic", name + ".json")) as fh:
        return json.load(fh)


def test_generator_same_seed_same_genome():
    t = _traffic("dmel")
    a, ta = genome_gen.build(2_000_000, 1, t, 2**31 + 12345)
    b, tb = genome_gen.build(2_000_000, 1, t, 2**31 + 12345)
    assert np.array_equal(a, b)
    assert ta["spans"] == tb["spans"]
    assert np.array_equal(ta["boundaries"], tb["boundaries"])


def test_generator_composition_fixed_across_seeds():
    t = _traffic("dmel")
    comps, genomes = [], []
    for seed in (1, 987654321, 2**33 + 5):
        codes, truth = genome_gen.build(2_000_000, 1, t, seed)
        comps.append(composition(codes, truth))
        genomes.append(codes)
        assert len(codes) == 2_000_000 and codes.max() <= 3
    assert comps[0] == comps[1] == comps[2]
    assert not np.array_equal(genomes[0], genomes[1])
    # per 8 Mbp: 3.356 LTR, 1.849 LINE, 1.096 TIR families, rounded
    klasses = [f[1] for f in comps[0]["families"]]
    assert [klasses.count(k) for k in ("LTR", "LINE", "TIR")] == [3, 2, 1]
    # LTR 3+7, 5+9, 6+12; LINE 6+10, 6+12; TIR 8+16 copies
    assert len(comps[0]["spans"]) == 42 + 34 + 24
    assert len(comps[0]["full_copies"]) == 14 + 12 + 8


def test_generator_places_fixed_across_seeds():
    """The seed orders the copies; the places they fill do not move."""
    laid = []
    for seed in (3, 2**31 + 77):
        lay = genome_gen._Layout(np.random.default_rng(0))
        for f in range(4):
            te = np.full(100, f, np.uint8)
            lay.plant(te, 3, 0.0, spans=((0, 100, "TIR", f"f{f}"),))
        codes, spans, _b, _f = lay.lay_out(
            50_000, np.random.default_rng(1), np.random.default_rng(seed),
            200)
        laid.append(spans)
    assert [s[:2] for s in laid[0]] == [s[:2] for s in laid[1]]
    assert [s[3] for s in laid[0]] != [s[3] for s in laid[1]]


def test_generator_hard_cases_fixed_across_seeds():
    t = {**MINI_TRAFFIC, "hard": {
        "truncated_tir": {"copies": 3, "cut_shares": [0.4, 0.6]},
        "solo_ltr": {"copies": 3},
        "nested_tir_in_ltr": {"copies": 2, "at_interior_bp": 700},
        "tandem_tir": {"arrays": 2, "units": [3]}}}
    comps = [composition(*genome_gen.build(400_000, 1, t, seed))
             for seed in (3, 2**32 + 1)]
    assert comps[0] == comps[1]
    # 8 + 8 + 4 whole copies; 3 + 3 truncated TIRs, 3 solo LTRs, 2 nested
    # LTRs of three spans each, 2 tandem arrays
    assert len(comps[0]["spans"]) == 20 + 6 + 3 + 6 + 2
    # the nested TIRs and the tandem units are full copies too
    assert len(comps[0]["full_copies"]) == 20 + 2 + 6


def test_generator_at_the_cells_scale():
    t = _traffic("dmel")
    _codes, truth = genome_gen.build(32_000_000, 4, t, 2**31 + 9)
    klasses = [f["class"] for f in truth["families"].values()]
    assert [klasses.count(k) for k in ("LTR", "LINE", "TIR")] == [13, 7, 4]
    assert len(truth["spans"]) == 400
    te_bp = sum(e - s for s, e, _k, _n in truth["spans"])
    assert 0.03 < te_bp / 32e6 < 0.04


def test_generator_planted_copies_carry_their_family():
    t = _traffic("dmel")
    codes, truth = genome_gen.build(2_000_000, 1, t, 77)
    for s, e, name in truth["full_copies"]:
        fam = truth["families"][name]["seq"]
        assert e - s == len(fam)
        assert np.mean(codes[s:e] == fam) > 0.9
    full = {(s, e) for s, e, _n in truth["full_copies"]}
    partial = [(s, e, k, n) for s, e, k, n in truth["spans"]
               if (s, e) not in full]
    assert len(partial) == 66
    for s, e, klass, name in partial:
        fam = truth["families"][name]
        seq, n = fam["seq"], e - s
        assert n < len(seq)
        if klass == "LINE":          # 5' truncated: the 3' end and polyA
            ends = [seq[-n:]]
        elif klass == "LTR":         # a solo LTR
            ends = [seq[: fam["bounds"][1]]]
        else:                        # a TIR element cut at one end
            ends = [seq[:n], seq[-n:]]
        assert max(np.mean(codes[s:e] == x) for x in ends
                   if len(x) == n) > 0.9


def test_family_miss_counts_families_no_library_entry_carries():
    codes, truth = genome_gen.build(240_000, 1, MINI_TRAFFIC, 5)
    ref = Reference(codes, truth)
    assert ref.numbers(ref.answers())["family_miss"] == 0.0
    ctl = ref.controls()
    assert ref.numbers(ctl["half_families"])["family_miss"] == \
        pytest.approx(1 / 3)
    out = ref.answers()
    out.library = {k: v for k, v in out.library.items()
                   if not k.startswith("LTR")}
    assert ref.numbers(out)["family_miss"] == pytest.approx(1 / 3)
    assert ref.seen["families_missed"] == ["LTR_0"]


def test_copy_miss_reads_nothing_owed_as_no_miss():
    codes, truth = genome_gen.build(240_000, 1, MINI_TRAFFIC, 5)
    ref = Reference(codes, truth)
    out = ref.answers()
    assert ref.numbers(out)["copy_miss"] == 0.0
    assert ref.seen["copies_owed"] > 0
    assert ref.numbers(ref.controls()["half_copies"])["copy_miss"] > 0.3
    # no accepted family with two copies or more: nothing to judge
    out.copy_counts = [1] * len(out.copy_counts)
    assert ref.numbers(out)["copy_miss"] == 0.0
    assert ref.seen["copies_owed"] == 0


def test_window_counts_whole_passes_with_the_crossing_one():
    now = [0.0]

    def clock():
        return now[0]

    def next_pass(i):
        now[0] += 3.0
        return {"i": i}, None

    outputs, pass_s, window_s = harness.run_window(next_pass, 10.0, clock)
    assert len(outputs) == 4            # 3, 6, 9, then 12 crosses 10
    assert pass_s == [3.0] * 4
    assert window_s == 12.0
    mbp = len(outputs) * 32.0
    assert mbp / window_s == pytest.approx(32.0 / 3.0)


def test_window_takes_a_pass_own_time_when_given():
    now = [0.0]

    def next_pass(i):
        now[0] += 5.0
        return i, (4.0 if i == 0 else None)

    _o, pass_s, window_s = harness.run_window(next_pass, 6.0, lambda: now[0])
    assert pass_s == [4.0, 5.0] and window_s == 10.0


def test_idle_is_the_complement_of_the_union_of_overlapping_kernels():
    ev = [("a", 10, 30), ("b", 20, 40), ("c", 35, 50), ("d", 70, 80),
          ("e", 95, 130)]
    lines = [(0, "stage pipeline.modules: start"),
             (55, "stage tir.ba_analyze: start"),
             (65, "stage tir.ba_analyze: done in 0.00s"),
             (100, "stage pipeline.modules: done in 0.00s")]
    s = trace_reduce.summarise(ev, 0, 100, lines)
    # busy: [10, 50) + [70, 80) + [95, 100) = 55 of 100
    assert s["busy_s"] == pytest.approx(55e-9)
    assert s["window_s"] == pytest.approx(100e-9)
    idle = dict(s["idle_gaps"])
    # gaps [0,10) [80,95) under modules, [50,70) mid 60 under ba_analyze
    assert idle["tir.ba_analyze"] == pytest.approx(20e-9)
    assert idle["pipeline.modules"] == pytest.approx(25e-9)
    ops = dict(s["device_ops"])
    assert ops["e"] == pytest.approx(35e-9)


def test_idle_outside_every_stage_is_labelled_so():
    s = trace_reduce.summarise([("k", 40, 60)], 0, 100, [])
    assert dict(s["idle_gaps"]) == {trace_reduce.OUTSIDE:
                                    pytest.approx(80e-9)}


def test_measured_path_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as exc:
        harness.main(["--workload", CELL, "--seed", "1",
                      "--seconds", "1", "--trace", "0"])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_run_refuses_in_a_directory_with_only_the_benchmark(tmp_path):
    root = copy_bench(str(tmp_path))
    r = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", CELL,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_files_dropped_into_a_copy_are_found_by_name(tmp_path):
    root = copy_bench(str(tmp_path))
    before = {p: open(os.path.join(root, "gpubench", p), "rb").read()
              for p in ("harness.py", "reference.py", "genome_gen.py")}
    cell = add_cell(root)
    with open(os.path.join(root, "gpubench", "metrics",
                           "passes_seen.py"), "w") as fh:
        fh.write("UNIT = 'passes'\n\n\ndef read(ctx):\n"
                 "    return len(ctx['pass_s']) or None\n")
    spec = harness.load_spec(root, cell)
    assert spec["config"]["genome_bp"] == 240_000
    assert spec["traffic"]["families"][0]["class"] == "TIR"
    assert set(spec["limits"]) == {"candidate_miss", "copy_miss",
                                   "end_off_share", "annot_f1_gap",
                                   "family_miss"}
    got = harness.read_metrics(
        ["passes_seen", "device_idle_pct"], spec["metrics_dir"],
        {"pass_s": [1.0, 2.0], "trace": None})
    assert got == {"passes_seen": {"value": 2.0, "unit": "passes"}}
    for p, blob in before.items():
        assert open(os.path.join(root, "gpubench", p), "rb").read() == blob


def test_nothing_the_benchmark_runs_imports_jax_or_the_reference_package():
    code = (
        "import sys, glob, os, importlib.util\n"
        "sys.path.insert(0, %r)\n"
        "from gpubench import harness, reference, control, trace_reduce\n"
        "from gpubench import genome_gen, layers\n"
        "import hite_tpu_torch.pipeline.run, hite_tpu_torch.kernels\n"
        "import torch.profiler\n"
        "for p in glob.glob(os.path.join(%r, 'gpubench/metrics/*.py')):\n"
        "    s = importlib.util.spec_from_file_location('m', p)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "print(','.join(harness.forbidden_modules()))\n") % (ROOT, ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hite_tpu_torch_like", sys)
    assert "hite_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hite_tpu.fake", sys)
    assert "hite_tpu" in harness.forbidden_modules()
