"""Committed digests of the JAX package's output files, and the check that
holds a run of the port to them.

`hite_tpu_torch/data/reference/NAME.json` records one `run_pipeline` run
of the JAX package on the CPU: the sha256 of its input codes, every
`PipelineConfig` / `CoarseParams` field it set away from the default, and
the sha256 and byte size of every output file but `stage_times.json`.  The
file is written by

    python tests/test_torch_reference_files.py write NAME

(NAME one of `main8`, `hard8`, `diverged`).  `compare(NAME, contigs,
out_dir)` reads only the JSON, so the port and `chip_smoke.py` use it
without the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List

import numpy as np

REFERENCE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "reference")
# files that vary from run to run (wall times), and so are not held
UNHELD = ("stage_times.json",)


def codes_sha256(contigs: Dict[str, np.ndarray]) -> str:
    """sha256 over each contig in order: its name, a NUL, its length as 8
    little-endian bytes, its uint8 codes."""
    h = hashlib.sha256()
    for name, codes in contigs.items():
        codes = np.ascontiguousarray(np.asarray(codes, np.uint8))
        h.update(name.encode() + b"\0" + len(codes).to_bytes(8, "little"))
        h.update(codes.tobytes())
    return h.hexdigest()


def file_digests(out_dir: str) -> Dict[str, Dict[str, object]]:
    """{file: {"sha256", "bytes"}} of every output file in `out_dir` but
    UNHELD and hidden ones (snapshots)."""
    out = {}
    for name in sorted(os.listdir(out_dir)):
        path = os.path.join(out_dir, name)
        if name in UNHELD or name.startswith(".") or not os.path.isfile(path):
            continue
        with open(path, "rb") as fh:
            data = fh.read()
        out[name] = {"sha256": hashlib.sha256(data).hexdigest(),
                     "bytes": len(data)}
    return out


def path(name: str) -> str:
    return os.path.join(REFERENCE_DIR, f"{name}.json")


def load(name: str) -> dict:
    with open(path(name)) as fh:
        return json.load(fh)


def compare(name: str, contigs: Dict[str, np.ndarray], out_dir: str) -> dict:
    """A run's input and files against reference NAME: {"input_equal",
    "files" (the reference's names), "differ", "missing", "extra"}."""
    ref = load(name)
    got = file_digests(out_dir)
    files: List[str] = sorted(ref["files"])
    return {"input_equal": codes_sha256(contigs) == ref["input_sha256"],
            "files": files,
            "differ": [f for f in files if f in got
                       and got[f] != ref["files"][f]],
            "missing": [f for f in files if f not in got],
            "extra": sorted(set(got) - set(files))}
