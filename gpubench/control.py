"""The readings that a cell's limits are set from: the program's numbers
over many seeds, and the controls' numbers on the same genomes.

    python3 gpubench/control.py --workload CELL --seeds N [N ...]
        [--out FILE.jsonl] [--dump DIR]

For each seed, in one process: the planted genome, one pass of the timed
path (the benchmark's own `one_pass`), and the reference's comparison of
its outputs; then the same comparison of each control (`Reference.
controls`: the reference's own answers with one stated guarantee broken)
and of the reference's own answers.  One JSON line a seed.  The
benchmark's runs never run this; the limits in `cells/<cell>.json` lie
between the program's largest reading and the controls' smallest.  With
`--dump DIR` each seed's pass outputs are pickled to DIR/<cell>.<seed>.pkl
for a look at what the program missed.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
import time
from typing import List, Optional

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from gpubench import harness  # noqa: E402


def readings(workload: str, seeds: List[int], out: Optional[str] = None,
             root: str = harness.ROOT, device: Optional[str] = None,
             dump: Optional[str] = None) -> list:
    spec = harness.load_spec(root, workload)
    config = spec["config"]
    harness.set_threads(config["threads"])
    import torch

    from hite_tpu_torch import kernels

    from gpubench.genome_gen import build
    from gpubench.reference import Reference

    if device is None:
        if not torch.cuda.is_available():
            raise harness.Refused("no CUDA device")
        device = "cuda:0"
    on_card = torch.device(device).type == "cuda"
    harness.capture_logger()
    kernels.build(None if on_card else list(kernels.HOST_SOURCES))
    out_dir = os.path.join(tempfile.gettempdir(), f"gpubench-{workload}")
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        codes, truth = build(config["genome_bp"], config["scale"],
                             spec["traffic"], seed)
        one_pass = harness.make_pass(codes, config, device, out_dir)
        t1 = time.perf_counter()
        p = one_pass()
        t2 = time.perf_counter()
        ref = Reference(codes, truth, spec["family_classes"])
        row = {"workload": workload, "seed": seed,
               "program": ref.numbers(harness.to_outputs(
                   p, {harness.CONTIG: 0}))}
        row["seen"] = ref.seen
        row["reference"] = ref.numbers(ref.answers())
        for name, outs in ref.controls().items():
            row[name] = ref.numbers(outs)
        row["pass_s"] = t2 - t1
        row["build_s"] = t1 - t0
        row["path"] = {"accepted": int(len(p["accepted"])),
                       "ltr": int(len(p["ltr"])),
                       "library": p["library"].count(b">")}
        rows.append(row)
        if dump:
            os.makedirs(dump, exist_ok=True)
            with open(os.path.join(dump, f"{workload}.{seed}.pkl"),
                      "wb") as fh:
                pickle.dump(p, fh)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            with open(out, "a") as fh:
                fh.write(line + "\n")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    readings(args.workload, args.seeds, args.out, dump=args.dump)
    return 0


if __name__ == "__main__":
    sys.exit(main())
