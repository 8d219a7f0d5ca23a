"""Wall of the sharded family analysis at mesh sizes 1, 2, 4 and 8 (the
port's counterpart of the repo's `scripts/mesh_scaling.py`).

The workload is that script's: a 2 Mbp random genome with 64 planted
families of 24 copies (~700 bp, 3% mutated), all 64 analysed by
`analyze_families_batched(..., mesh=...)`, one warm-up call and the mean
of `--reps` warm calls a mesh size; every result is checked equal to the
unsharded call's.  A mesh of n takes n distinct cards when the machine
has them, else n shards of one device (`--repeat_device`, default the
first card): a repeated-device mesh measures what the sharding costs,
not a multi-card speedup.

    python -m hite_tpu_torch.scripts.mesh_scaling [--sizes 1 2 4 8] \
        [--reps 3] [--repeat_device cuda:0] [--device cpu]

Prints the card's name and power limit, the card count, then one JSON
line a mesh size and a summary line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hite_tpu_torch.config import MSAConfig
from hite_tpu_torch.device import resolve_device
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.parallel.mesh import make_mesh
from hite_tpu_torch.pipeline.boundary_adjust import analyze_families_batched
from hite_tpu_torch.pipeline.copies import CopyHit
from hite_tpu_torch.scripts.pan_run import card_line


def workload(length: int = 2_000_000, families: int = 64,
             copies: int = 24, device=None
             ) -> Tuple[Genome, List[Tuple[Tuple[int, int], List[CopyHit]]]]:
    """The genome and the (interval, copies) items of `scripts/
    mesh_scaling.py` (seed 3); smaller sizes for the tests."""
    rng = np.random.default_rng(3)
    bg = rng.integers(0, 4, length).astype(np.uint8)
    items = []
    pos = 1_000
    for _f in range(families):
        te = rng.integers(0, 4, 700).astype(np.uint8)
        hits: List[CopyHit] = []
        for _c in range(copies):
            copy = te.copy()
            muts = rng.random(len(copy)) < 0.03
            copy[muts] = (copy[muts] + rng.integers(1, 4, muts.sum())) % 4
            bg[pos : pos + len(copy)] = copy
            hits.append(CopyHit(start=pos, end=pos + len(copy), strand=0,
                                nseeds=100))
            pos += len(copy) + 400
        items.append(((hits[0].start, hits[0].end), hits))
    return Genome.from_dict({"chr1": bg}, device=device), items


def same_analyses(a, b) -> bool:
    return all(
        np.array_equal(x.M, y.M) and np.array_equal(x.homo, y.homo)
        and np.array_equal(x.cons, y.cons)
        and (x.left_found, x.left_pos, x.right_found, x.right_pos, cx)
        == (y.left_found, y.left_pos, y.right_found, y.right_pos, cy)
        for (x, cx), (y, cy) in zip(a, b)) and len(a) == len(b)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run(sizes: Sequence[int] = (1, 2, 4, 8), reps: int = 3,
        repeat_device: Optional[str] = None, device=None) -> Dict:
    dev = resolve_device(device)
    genome, items = workload(device=dev)
    cfg = MSAConfig()
    ref = analyze_families_batched(genome, items, cfg)
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    out: Dict = {"families": len(items), "cards": n_cards, "by_mesh": {}}
    for n in sizes:
        if repeat_device is None and n_cards >= n:
            mesh = make_mesh(n_devices=n)
        else:
            mesh = make_mesh(devices=[repeat_device or dev] * n)
        got = analyze_families_batched(genome, items, cfg, mesh=mesh)
        if not same_analyses(got, ref):
            raise AssertionError(f"mesh of {n}: analyses differ from the "
                                 "unsharded call's")
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            analyze_families_batched(genome, items, cfg, mesh=mesh)
        _sync(dev)
        wall = (time.perf_counter() - t0) / reps
        row = {"mesh_devices": n, "mesh": mesh.shape,
               "distinct": mesh.distinct,
               "devices": sorted({str(d) for d in mesh.devices.reshape(-1)}),
               "warm_wall_s": wall}
        out["by_mesh"][n] = row
        print(json.dumps(row), flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m hite_tpu_torch.scripts.mesh_scaling",
        description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", nargs="+", type=int, default=[1, 2, 4, 8])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--repeat_device", default=None,
                    help="mesh shards all on this device")
    ap.add_argument("--device", default=None,
                    help="the genome's device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(card_line(), flush=True)
    out = run(args.sizes, args.reps, args.repeat_device, dev)
    print(json.dumps({"metric": "family_analysis_mesh_scaling",
                      "cards": out["cards"],
                      "warm_wall_s_by_mesh": {
                          n: r["warm_wall_s"]
                          for n, r in out["by_mesh"].items()},
                      "distinct_by_mesh": {
                          n: r["distinct"]
                          for n, r in out["by_mesh"].items()}}), flush=True)


if __name__ == "__main__":
    main()
