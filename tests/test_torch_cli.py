"""hite_tpu_torch's pipeline without a JAX run: the golden snapshot, the
CLI's `main` with `--recover`, and the CLI's GPU default.

`run_pipeline` on `tests/test_golden.py`'s 60 kbp genome and config must
reproduce `tests/golden/pipeline.json` through that file's `_snapshot`.
`main([...], device="cpu")` runs the CLI in process: a plain run, a
`--recover 1` run (which writes a snapshot per stage) and a second one
(which loads every stage) write the same files.  `python -m
hite_tpu_torch` with no device raises when no GPU is present.
"""

import filecmp
import json
import logging
import os
import subprocess
import sys

import numpy as np
import torch

from test_golden import GOLDEN, _snapshot

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("other", "coarse", "modules", "ltr", "library")


def _golden_genome():
    """tests/test_golden.py's genome, from the port's synthetic_genome (the
    same numpy draws)."""
    from hite_tpu_torch.genome import synthetic_genome

    rng = np.random.default_rng(21)
    tir_t = rng.integers(0, 4, 20).astype(np.uint8)
    while tir_t[0] == 3 and tir_t[1] == 2:
        tir_t = rng.integers(0, 4, 20).astype(np.uint8)
    tir_te = np.concatenate([tir_t, rng.integers(0, 4, 360).astype(np.uint8),
                             (3 - tir_t)[::-1]])
    tes = ["".join("ACGT"[c] for c in tir_te),
           "".join("ACGT"[c] for c in rng.integers(0, 4, 900))]
    genome, _ = synthetic_genome(60_000, tes, [6, 4], seed=13,
                                 mutation_rate=0.02, tsd_lens=[5, 0],
                                 device="cpu")
    return genome


def test_pipeline_golden(tmp_path):
    from hite_tpu_torch.config import AlignConfig, PipelineConfig
    from hite_tpu_torch.pipeline.coarse import CoarseParams
    from hite_tpu_torch.pipeline.run import run_pipeline

    cfg = PipelineConfig(annotate=True,
                         align=AlignConfig(fixed_extend_base_threshold=2000))
    out = str(tmp_path / "out")
    res = run_pipeline(_golden_genome(), cfg, out_dir=out,
                       coarse_params=CoarseParams(seg_len=16_384))
    with open(GOLDEN) as fh:
        want = json.load(fh)
    assert _snapshot(out) == want
    assert res.metrics["annotation_hits"] == len(want["gff"])


def _outputs(d):
    return sorted(f for f in os.listdir(d)
                  if f != "stage_times.json" and not f.startswith("."))


def test_main_and_recover(tmp_path, caplog):
    from hite_tpu_torch.io.fasta import write_fasta
    from hite_tpu_torch.pipeline.run import main

    g = _golden_genome()
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, {"chr1": g.flat[: g.size]})
    argv = ["--genome", fa, "--annotate", "1", "--BM_HiTE", "1",
            "--chrom_seg_length", "16384"]
    plain = str(tmp_path / "plain")
    main(argv + ["--out_dir", plain], device="cpu")
    rec = str(tmp_path / "rec")
    resumed = []
    for _ in range(2):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="hite_tpu_torch"):
            res = main(argv + ["--out_dir", rec, "--recover", "1"],
                       device="cpu")
        resumed.append([r.getMessage() for r in caplog.records
                        if "checkpoint: resumed stage" in r.getMessage()])
    assert resumed[0] == []
    assert resumed[1] == [f"checkpoint: resumed stage {s}" for s in STAGES]
    snaps = os.listdir(os.path.join(rec, ".checkpoints"))
    assert sorted(s.split(".")[0] for s in snaps) == sorted(STAGES)
    assert _outputs(plain) == _outputs(rec)
    for f in _outputs(plain):
        assert filecmp.cmp(os.path.join(plain, f), os.path.join(rec, f),
                           shallow=False), f
    assert "benchmark.json" in _outputs(rec) and "genome.gff" in _outputs(rec)
    assert res.metrics["annotation_hits"] > 0


def test_cli_raises_without_gpu(tmp_path):
    """`python -m hite_tpu_torch` runs on the card by default: with CUDA
    unavailable it exits non-zero before reading the genome, and writes
    nothing."""
    fa = str(tmp_path / "g.fa")
    with open(fa, "w") as fh:
        fh.write(">chr1\n" + "ACGT" * 500 + "\n")
    out = str(tmp_path / "out")
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "hite_tpu_torch", "--genome", fa,
         "--out_dir", out], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=300)
    assert proc.returncode != 0
    assert "runs on the GPU by default" in proc.stderr
    assert not os.path.exists(out)
