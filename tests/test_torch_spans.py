"""The port's stage spans and counters as the benchmark reads them.

One `run_pipeline` of `tests/test_golden.py`'s 60 kbp genome with stage
snapshots on (annotation and the CNNs off, for time), its stage lines stamped with `time.time_ns()` as
`gpubench/harness.py` stamps them.  The boundary engine's `.ba_prep` and
`.ba_batch` spans nest inside their `.ba_analyze`; the modules stage's
own spans and the snapshots' nest inside their pipeline stage;
`gpubench/trace_reduce.stage_intervals` parses every line; the names the
benchmark's layers (`gpubench/layers.py`) sum are the ones the port
emitted before these spans; finished families never outnumber analysed
items; and the readers of the new spans and counters give their
values on hand-made contexts.
"""

import dataclasses
import logging
import os
import re
import sys
import time

import pytest
import torch

from test_torch_cli import _golden_genome

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gpubench.harness import read_metrics  # noqa: E402
from gpubench.layers import LAYERS  # noqa: E402
from gpubench.trace_reduce import stage_intervals  # noqa: E402

torch.set_num_threads(2)

# The stage names the layers' rules matched on this run before the
# boundary engine, modules and snapshot spans were added.
PARENT_LAYER_NAMES = {
    "pipeline.tandem_mask", "pipeline.coarse", "pipeline.gindex",
    "pipeline.modules", "pipeline.low_copy_rescue", "pipeline.ltr",
    "pipeline.library", "pipeline.write_outputs", "modules.copies",
    "tir.ba_fetch",
}
NEW_SUFFIXES = (".ba_prep", ".ba_batch", ".gate", ".detect", ".plans",
                ".snapshot_load", ".snapshot_save")
METRICS_DIR = os.path.join(ROOT, "gpubench", "metrics")


def _layer_matched(name):
    return any(name in exact or (suffixes and name.endswith(suffixes))
               for exact, suffixes in LAYERS.values())


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("stage "):
            self.lines.append((time.time_ns(), msg))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from hite_tpu_torch.config import AlignConfig, PipelineConfig
    from hite_tpu_torch.pipeline.coarse import CoarseParams
    from hite_tpu_torch.pipeline.run import run_pipeline
    from hite_tpu_torch.utils import log

    cfg = PipelineConfig(annotate=False, recover=True,
                         align=AlignConfig(fixed_extend_base_threshold=2000))
    cfg = dataclasses.replace(
        cfg, ltr=dataclasses.replace(cfg.ltr, use_deep_cnn=False),
        classify=dataclasses.replace(cfg.classify, use_neural=False))
    handler = _Lines()
    log.logger.addHandler(handler)
    log.STAGE_TIMES.clear()
    log.COUNTERS.clear()
    try:
        run_pipeline(_golden_genome(), cfg,
                     out_dir=str(tmp_path_factory.mktemp("spans")),
                     coarse_params=CoarseParams(seg_len=16_384))
    finally:
        log.logger.removeHandler(handler)
    return (handler.lines, stage_intervals(handler.lines),
            dict(log.STAGE_TIMES), dict(log.COUNTERS))


def _inside(child, parents):
    s, e, _ = child
    return any(ps <= s and e <= pe for ps, pe, _ in parents)


def test_stage_intervals_parse_every_line(run):
    lines, ivs, times, _ = run
    starts = [m for _, m in lines if m.endswith(": start")]
    assert len(ivs) == len(starts) == len(lines) // 2
    assert {n for _, _, n in ivs} == set(times)
    done, n = {}, {}
    for _, m in lines:
        hit = re.match(r"^stage (\S+): done in ([0-9.]+)s$", m)
        if hit:
            done[hit.group(1)] = done.get(hit.group(1), 0.0) + float(
                hit.group(2))
            n[hit.group(1)] = n.get(hit.group(1), 0) + 1
    for name, secs in times.items():
        # each line prints its seconds to two places
        assert done[name] == pytest.approx(secs, abs=0.005 * n[name] + 1e-9)
    assert all(s <= e for s, e, _ in ivs)


@pytest.mark.parametrize("module", ["tir", "helitron"])
def test_engine_spans_nest_in_their_analysis(run, module):
    _, ivs, times, _ = run
    parents = [iv for iv in ivs if iv[2] == f"{module}.ba_analyze"]
    kids = [iv for iv in ivs
            if iv[2] in (f"{module}.ba_prep", f"{module}.ba_batch")]
    assert parents and len(kids) == 2 * len(parents)
    assert all(_inside(k, parents) for k in kids)
    for ps, pe, _ in parents:
        inner = sum(e - s for s, e, _ in kids if ps <= s and e <= pe)
        assert inner <= pe - ps
    assert (times[f"{module}.ba_prep"] + times[f"{module}.ba_batch"]
            <= times[f"{module}.ba_analyze"])


@pytest.mark.parametrize("span,parent", [
    ("tir.gate", "pipeline.modules"),
    ("helitron.gate", "pipeline.modules"),
    ("non_ltr.gate", "pipeline.modules"),
    ("modules.plans", "pipeline.modules"),
    ("tir.detect", "pipeline.modules"),
    ("helitron.detect", "pipeline.modules"),
    ("tir.ba_analyze", "tir.detect"),
    ("tir.ba_score", "tir.ba_prep"),
    ("helitron.ba_score", "helitron.ba_prep"),
    ("modules.sketch", "modules.plans"),
    ("modules.snapshot_load", "pipeline.modules"),
    ("modules.snapshot_save", "pipeline.modules"),
    ("coarse.snapshot_save", "pipeline.coarse"),
    ("ltr.snapshot_save", "pipeline.ltr"),
    ("library.snapshot_save", "pipeline.library"),
])
def test_stage_spans_nest(run, span, parent):
    _, ivs, _, _ = run
    kids = [iv for iv in ivs if iv[2] == span]
    parents = [iv for iv in ivs if iv[2] == parent]
    assert kids and all(_inside(k, parents) for k in kids)


def test_snapshot_spans_for_every_stage(run):
    _, _, times, _ = run
    for stage in ("other", "coarse", "modules", "ltr", "library"):
        assert f"{stage}.snapshot_load" in times
        assert f"{stage}.snapshot_save" in times


def test_layers_sum_the_parents_names(run):
    _, _, times, _ = run
    matched = {n for n in times if _layer_matched(n)}
    assert matched <= PARENT_LAYER_NAMES, matched - PARENT_LAYER_NAMES
    new = [n for n in times if n.endswith(NEW_SUFFIXES)]
    assert len(new) >= 20
    assert not any(_layer_matched(n) for n in new)


def test_done_never_exceeds_analysed(run):
    _, _, _, counters = run
    modules = [k.split(".")[0] for k in counters
               if k.endswith(".ba_analyze_items")]
    assert set(modules) >= {"tir", "helitron"}
    for m in modules:
        done = counters[f"{m}.ba_done_items"]
        assert 0 <= done <= counters[f"{m}.ba_analyze_items"]
    assert counters["tir.ba_done_items"] >= 1
    assert not any(k.startswith("boundary.") for k in counters)


def test_scored_items_and_sketches_counted(run):
    """The batched k-mer sets' counters: items whose copies were
    flank-scored (at most the items analysed) and sequences sketched."""
    _, _, times, counters = run
    for m in ("tir", "helitron"):
        assert 0 <= counters[f"{m}.ba_scored_items"] \
            <= counters[f"{m}.ba_analyze_items"]
    assert counters["kmer.sketch_items"] > 0
    assert times["modules.sketch"] <= times["modules.plans"]


def _ctx(stage_times=None, counters=None, mbp=2.0):
    return {"stage_times": stage_times or {}, "counters": counters or {},
            "mbp": mbp, "pass_s": [], "trace": None, "launch_shapes": {}}


@pytest.mark.parametrize("ctx,want", [
    (_ctx({"tir.ba_prep": 1.0, "helitron.ba_prep": 0.5,
           "tir.ba_batch": 3.0, "tir.ba_analyze": 5.0}),
     {"ba_prep_s_per_mbp": 0.75, "ba_batch_s_per_mbp": 1.5}),
    (_ctx({"ltr.ba_batch": 0.4, "pipeline.modules": 9.0}, mbp=4.0),
     {"ba_batch_s_per_mbp": 0.1}),
    (_ctx(counters={"tir.ba_analyze_items": 30, "tir.ba_done_items": 3,
                    "helitron.ba_analyze_items": 10,
                    "helitron.ba_done_items": 0,
                    "tir.ba_fetch_items": 7}),
     {"boundary_yield_pct": 7.5}),
    (_ctx(counters={"helitron.ba_analyze_items": 445,
                    "helitron.ba_done_items": 0}),
     {"boundary_yield_pct": 0.0}),
    # the parent: analysed items, no finished-family counter, no spans
    (_ctx({"tir.ba_analyze": 5.0},
          counters={"tir.ba_analyze_items": 30}), {}),
    (_ctx(counters={"tir.ba_done_items": 0}), {}),
    (_ctx({"tir.ba_prep": 1.0}, mbp=0.0), {}),
    # the chunked paths' spans (a 100 Mbp genome's), and the copy join's
    (_ctx({"coarse.chunked_selfjoin": 3.0, "coarse.selfjoin": 2.5,
           "ltr.chunked_candidates": 1.0, "copies.join_pairs": 0.5,
           "copies.join_scan": 0.25, "copies.join_chain": 1.5,
           "modules.copies": 4.0}, mbp=2.0),
     {"chunked_selfjoin_s_per_mbp": 1.5,
      "ltr_chunked_candidates_s_per_mbp": 0.5,
      "copy_join_device_s_per_mbp": 0.375,
      "copy_join_host_s_per_mbp": 0.75}),
    # a genome under every cap: the copy join's spans alone
    (_ctx({"coarse.selfjoin": 2.5, "copies.join_scan": 0.5}, mbp=0.5),
     {"copy_join_device_s_per_mbp": 1.0}),
    # the parent: the copy join's layer without its new spans
    (_ctx({"modules.copies": 4.0, "pipeline.gindex": 0.1}), {}),
    (_ctx({"copies.join_chain": 1.0, "coarse.chunked_selfjoin": 1.0},
          mbp=0.0), {}),
])
def test_readers(ctx, want):
    names = ["ba_prep_s_per_mbp", "ba_batch_s_per_mbp",
             "boundary_yield_pct", "chunked_selfjoin_s_per_mbp",
             "ltr_chunked_candidates_s_per_mbp",
             "copy_join_device_s_per_mbp", "copy_join_host_s_per_mbp"]
    got = read_metrics(names, METRICS_DIR, ctx)
    assert {k: v["value"] for k, v in got.items()} == pytest.approx(want)
    units = {"ba_prep_s_per_mbp": "s/Mbp", "ba_batch_s_per_mbp": "s/Mbp",
             "boundary_yield_pct": "%"}
    units.update((n, "s/Mbp") for n in names[3:])
    assert all(v["unit"] == units[k] for k, v in got.items())
