"""One run of one benchmark cell: set-up, the measured window, the check.

    python gpubench/run.py --workload CELL --seed N --seconds S --trace 0|1

Every file is found by its name in `BENCHMARK.json`: the cell's
configuration `configs/<config>.json`, its traffic `traffic/<traffic>.json`,
its limits and the family classes it judges `cells/<cell>.json` and each per-layer metric's reader
`metrics/<metric>.py`.

Set-up builds the planted genome from the seed, builds or loads the
program's compiled code (in the checkout's `hite_tpu_torch/_build/`) and
runs one whole pass of the cell's own genome.  The window then runs
`run_pipeline` pass after pass, each on a fresh `Genome` of the same
codes with its files written to one directory under TMPDIR (emptied
before each pass, so no pass resumes another's snapshots), until
`--seconds` have passed; the pass in flight then finishes and counts.
With `--trace 1` the window's first pass runs under the profiler.  Once
the window has closed, the plain reference (`reference.py`) judges every
pass's outputs; the last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import logging
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hite_tpu")
CONTIG = "chr1"          # the planted genome is one contig


class Refused(SystemExit):
    """A run that prints no result."""


def process_start_s() -> float:
    """Seconds on the perf_counter clock at which this process started."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return time.perf_counter() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


# ------------------------------------------------------------------ spec
def load_spec(root: str, workload: str) -> dict:
    """The cell, its configuration, traffic and limits, by name."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"unknown workload {workload!r}")
    cell = cells[workload]
    here = os.path.join(root, "gpubench")

    def load(*parts):
        with open(os.path.join(here, *parts)) as fh:
            return json.load(fh)

    judged = load("cells", workload + ".json")
    return {
        "bench": bench,
        "cell": cell,
        "config": load("configs", cell["config"] + ".json"),
        "traffic": load("traffic", cell["traffic"] + ".json"),
        "limits": judged["limits"],
        "family_classes": judged.get("family_classes"),
        "metrics_dir": os.path.join(here, "metrics"),
    }


def set_threads(n_wanted: int) -> int:
    """Pin the host's thread pools before torch is imported."""
    n = max(1, min(int(n_wanted), len(os.sched_getaffinity(0))))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(n)
    return n


def pipeline_settings(config: dict):
    """(PipelineConfig, CoarseParams) from the configuration's data."""
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.pipeline.coarse import CoarseParams

    cfg = PipelineConfig()
    for key, val in config["pipeline"].items():
        if isinstance(val, dict):
            val = dataclasses.replace(getattr(cfg, key), **val)
        cfg = dataclasses.replace(cfg, **{key: val})
    return cfg, CoarseParams(**config["coarse"])


# ------------------------------------------------------------ stage lines
class StageLines(logging.Handler):
    """Keeps the program's stage lines in memory, stamped in ns."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: List[tuple] = []
        self.keep = False

    def emit(self, record):
        if self.keep:
            msg = record.getMessage()
            if msg.startswith("stage "):
                self.lines.append((time.time_ns(), msg))


def capture_logger() -> StageLines:
    from hite_tpu_torch.utils.log import logger

    handler = StageLines()
    logger.handlers[:] = [handler]
    logger.propagate = False
    return handler


# ------------------------------------------------------------------ a pass
def make_pass(codes: np.ndarray, config: dict, device, out_dir: str
              ) -> Callable[[], dict]:
    """The timed unit: one whole pipeline run of the genome; returns what
    the reference judges, copied out of the program's results and files."""
    import torch

    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.pipeline.run import run_pipeline

    cfg, params = pipeline_settings(config)

    def one_pass() -> dict:
        # the cyclic collector runs once, after the pass, rather than at
        # whatever allocation trips it mid-pass; its time still counts
        gc.disable()
        try:
            shutil.rmtree(out_dir, ignore_errors=True)
            genome = Genome.from_dict({CONTIG: codes}, device=device)
            res = run_pipeline(genome, cfg, out_dir=out_dir,
                               coarse_params=params)
            if genome.device.type == "cuda":
                torch.cuda.synchronize(genome.device)
            return collect(res, out_dir)
        finally:
            gc.enable()
            gc.collect()

    return one_pass


def collect(res, out_dir: str) -> dict:
    """The pass's outputs: the modules' accepted elements and copy counts,
    the intact LTR records, and the bytes of the library, the GFF and the
    coarse candidates' snapshot."""
    acc, counts = [], []
    for mod in (res.tir, res.helitron, res.non_ltr):
        if mod is not None:
            acc.extend(map(tuple, np.asarray(mod.accepted.intervals)))
            counts.extend(int(c) for c in mod.copy_counts)
    ltr = [(r.start, r.lltr_end, r.rltr_start, r.end)
           for r in (res.ltr.records if res.ltr is not None else [])]

    def read(*parts) -> bytes:
        p = os.path.join(out_dir, *parts)
        if not os.path.exists(p):
            return b""
        with open(p, "rb") as fh:
            return fh.read()

    snaps = os.path.join(out_dir, ".checkpoints")
    coarse = next((f for f in sorted(os.listdir(snaps))
                   if f.startswith("coarse.") and f.endswith(".pkl")),
                  None) if os.path.isdir(snaps) else None
    return {
        "accepted": np.array(acc, np.int64).reshape(-1, 2),
        "copy_counts": counts,
        "ltr": np.array(ltr, np.int64).reshape(-1, 4),
        "library": read("confident_TE.cons.fa"),
        "gff": read("genome.gff"),
        "coarse": read(".checkpoints", coarse) if coarse else b"",
        "out_bytes": sum(os.path.getsize(os.path.join(d, f))
                         for d, _s, fs in os.walk(out_dir) for f in fs),
    }


def to_outputs(p: dict, contig_starts: Dict[str, int]):
    from gpubench.reference import (
        Outputs, load_candidates, parse_fasta, parse_gff,
    )

    return Outputs(candidates=load_candidates(p["coarse"]),
                   accepted=p["accepted"], copy_counts=p["copy_counts"],
                   ltr=p["ltr"],
                   library=parse_fasta(p["library"].decode()),
                   annotation=parse_gff(p["gff"].decode(), contig_starts))


# --------------------------------------------------------------- metrics
def read_metrics(names: List[str], metrics_dir: str, ctx: dict) -> dict:
    """Each per-layer metric from its own reader; a reader that finds
    nothing returns None and the metric is left out."""
    out = {}
    for m in names:
        spec = importlib.util.spec_from_file_location(
            f"gpubench_metric_{m}", os.path.join(metrics_dir, m + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        val = mod.read(ctx)
        if val is not None:
            out[m] = {"value": float(val), "unit": mod.UNIT}
    return out


def forbidden_modules() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


# ------------------------------------------------------------------- main
def main(argv: Optional[List[str]] = None, *, t_start: Optional[float] = None,
         root: str = ROOT, device: Optional[str] = None) -> int:
    """One run.  `device` (the tests' "cpu") skips the look for a card."""
    t_start = process_start_s() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_spec(root, args.workload)
    cell, config = spec["cell"], spec["config"]
    threads = set_threads(config["threads"])

    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: this benchmark measures the card")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{cell['chips']} cards asked for, "
                          f"{torch.cuda.device_count()} present")
        device = "cuda:0"
    on_card = torch.device(device).type == "cuda"
    torch.set_num_threads(threads)
    try:
        torch.set_num_interop_threads(threads)
    except RuntimeError:
        pass        # set once a process: a second run in one (the tests)

    from hite_tpu_torch import kernels
    from hite_tpu_torch.utils import log as hlog

    stage_lines = capture_logger()
    from gpubench.genome_gen import build

    codes, truth = build(config["genome_bp"], config["scale"],
                         spec["traffic"], args.seed)
    kernels.build(None if on_card else list(kernels.HOST_SOURCES))
    out_dir = os.path.join(tempfile.gettempdir(),
                           f"gpubench-{args.workload}")
    one_pass = make_pass(codes, config, device, out_dir)
    one_pass()                                   # the warm pass
    gc.collect()
    gc.freeze()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    hlog.STAGE_TIMES.clear()
    hlog.COUNTERS.clear()
    kernels.reset_launches()
    stage_lines.keep = bool(args.trace)

    # ------------------------------------------------------------ window
    traced: dict = {}

    def next_pass(i: int):
        if args.trace and i == 0:
            out = traced_pass(one_pass, on_card, stage_lines)
            traced["summary"] = out.pop("trace")
            traced["shapes"] = {k: dict(v)
                                for k, v in kernels.LAUNCH_SHAPES.items()}
            stage_lines.keep = False
            return out, traced["summary"]["window_s"]
        return one_pass(), None

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    outputs, pass_s, window_s = run_window(next_pass, args.seconds)
    trace_summary = traced.get("summary")
    launch_shapes = traced.get("shapes")
    mbp = len(outputs) * len(codes) / 1e6
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    stage_times = dict(hlog.STAGE_TIMES)
    counters = dict(hlog.COUNTERS)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    from gpubench.reference import NUMBERS, Reference, judge

    ref = Reference(codes, truth, spec["family_classes"])
    contig_starts = {CONTIG: 0}
    worst = {k: 0.0 for k in NUMBERS}
    failed = 0
    seen: dict = {}
    for p in outputs:
        nums = ref.numbers(to_outputs(p, contig_starts))
        seen = ref.seen
        failed += not judge(nums, spec["limits"])
        for k in NUMBERS:
            worst[k] = max(worst[k], nums[k])
    correct = failed == 0 and len(outputs) > 0

    # ------------------------------------------------------------ result
    ctx = {"stage_times": stage_times, "mbp": mbp, "pass_s": pass_s,
           "counters": counters, "trace": trace_summary,
           "launch_shapes": launch_shapes or {}}
    if args.trace:
        names = [m["name"] for m in spec["bench"]["per_layer"]
                 if args.workload in m.get("workloads", [args.workload])]
        metrics = read_metrics(names, spec["metrics_dir"], ctx)
    else:
        metrics = {
            "mbp_per_s": {"value": mbp / window_s, "unit": "Mbp/s"},
            "peak_device_gib": {"value": peak / 2**30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if trace_summary is not None:
        dev["busy_s"] = trace_summary["busy_s"]
        dev["window_s"] = trace_summary["window_s"]
    compared = {k: {"value": worst[k], "limit": spec["limits"][k]}
                for k in NUMBERS}
    report(ctx, outputs, window_s, setup_s, bool(args.trace))
    print("seen: " + json.dumps(seen), file=sys.stderr)
    result = {"correct": bool(correct), "attempted": len(outputs),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace_summary is not None:
        result["breakdown"] = {"device_ops": trace_summary["device_ops"],
                               "idle_gaps": trace_summary["idle_gaps"]}
    result["compared"] = compared
    # last, once every reader and report() have imported what they need
    bad = forbidden_modules()
    if bad:
        raise Refused("modules of the reference package or JAX loaded: "
                      + ", ".join(bad))
    for k in NUMBERS:
        print(f"compared {k}: {worst[k]!r} limit {spec['limits'][k]!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def run_window(next_pass: Callable, seconds: float,
               clock: Callable[[], float] = time.perf_counter):
    """Passes back to back until `seconds` have passed since the first
    began; the pass in flight then finishes and counts, so the window is
    whole passes.  `next_pass(i)` returns (outputs, its own seconds or
    None).  Returns (outputs, seconds of each pass, window seconds)."""
    outputs, pass_s = [], []
    t0 = clock()
    while True:
        tp = clock()
        out, own = next_pass(len(outputs))
        outputs.append(out)
        pass_s.append(clock() - tp if own is None else own)
        if clock() - t0 >= seconds:
            break
    return outputs, pass_s, clock() - t0


def traced_pass(one_pass, on_card: bool, stage_lines: StageLines) -> dict:
    """One pass under the profiler's device activity; the pass's outputs
    with its trace summary under "trace"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpubench.trace_reduce import device_events, summarise

    acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        if on_card:
            torch.cuda.synchronize()
        lo = time.time_ns()
        out = one_pass()
        hi = time.time_ns()
    events = device_events(prof) if on_card else []
    out["trace"] = summarise(events, lo, hi, stage_lines.lines)
    return out


def report(ctx: dict, outputs: list, window_s: float, setup_s: float,
           traced: bool):
    """Earlier lines on standard error: passes, the stages by layer with
    what no listed stage covers as `other`, and the path taken.  In a
    traced run the first pass's time is its own, without the profiler's
    teardown."""
    from gpubench.layers import TOP_LEVEL, stage_seconds

    st = ctx["stage_times"]
    total = sum(ctx["pass_s"])
    parts = {name: stage_seconds(st, name) for name in TOP_LEVEL}
    parts["other"] = total - sum(parts.values())
    print(f"passes {len(outputs)}: " + " ".join(
        f"{s:.3f}" for s in ctx["pass_s"])
        + f" s; window {window_s:.3f} s; setup {setup_s:.3f} s; "
        f"files a pass {outputs[-1]['out_bytes'] if outputs else 0} bytes",
        file=sys.stderr)
    print("stages s: " + json.dumps({k: round(v, 4)
                                     for k, v in parts.items()}),
          file=sys.stderr)
    c = ctx["counters"]
    path = {"passes": len(outputs), "traced": traced}
    path.update((k, v) for k, v in sorted(c.items())
                if k.endswith(("chunks", "_items", "_waves")))
    p = outputs[-1] if outputs else None
    if p is not None:
        path["accepted_elements"] = int(len(p["accepted"]))
        path["ltr_records"] = int(len(p["ltr"]))
        path["library_entries"] = p["library"].count(b">")
        path["annotation_lines"] = max(p["gff"].count(b"\n") - 1, 0)
        from gpubench.reference import load_candidates
        path["candidates"] = int(len(load_candidates(p["coarse"])))
    print("path: " + json.dumps(path), file=sys.stderr)
