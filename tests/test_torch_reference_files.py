"""The JAX package's output files as committed digests, and the port held
to them.

`hite_tpu_torch/data/reference/{main8,hard8,diverged}.json` record one
`hite_tpu.pipeline.run.run_pipeline` run each on the CPU (the input codes'
sha256, the config, every output file's sha256 and size); the port's runs
are held to them here on the CPU and by `chip_smoke.py` on the card.
Targets:

- `main8`: the seed-7 bench substrate at 8 Mbp, `PipelineConfig(
  annotate=True)` with the default `CoarseParams()` (chip_smoke's main
  path);
- `hard8`: the hard bench substrate at 8 Mbp with bench.py's config
  (chip_smoke's hard phase);
- `diverged`: `pan_run.diverged_genome_codes()`, families of every class
  the main path judges at 5-20% per-copy divergence and copy counts that
  straddle the boundary engine's homology tiers, with the small
  CoarseParams of the 160 kbp parity genome.

Both packages run the diverged genome once here (a module fixture) and
every output file must be byte-equal; the 8 Mbp targets take 20-40 min
each in the JAX package on the CPU, so they are written once, by

    python tests/test_torch_reference_files.py write NAME
"""

import dataclasses
import filecmp
import json
import os
import sys
import time

import numpy as np
import pytest
import torch
from test_torch_pipeline import _run
from test_torch_tir_path import _substrate, compile_cache  # noqa: F401

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGETS = ("main8", "hard8", "diverged")
BENCH_KW = dict(seg_len=262_144, pair_batch=64, stride=4, max_hits=4)
# every file run_pipeline writes with annotate=True but stage_times.json
FILES = ["confident_tir.fa", "confident_helitron.fa", "confident_non_ltr.fa",
         "confident_other.fa", "confident_ltr_cut.fa.cons",
         "confident_TE.cons.fa", "low_confident_TE.fa", "intact_LTR.list",
         "ltr_insert_time.tsv", "genome.gff", "genome.out", "genome.tbl",
         "genome.full_length.gff"]


def _target(name):
    """(contigs, PipelineConfig kwargs, AlignConfig kwargs, CoarseParams
    kwargs) of a reference target; the codes from the port's builders."""
    from hite_tpu_torch.scripts import pan_run

    if name == "diverged":
        contigs, params_kw, align_kw = _substrate("diverged")
        return contigs, {"annotate": True}, align_kw, params_kw
    g, _truth = pan_run.build_bench_genome(8_000_000, hard=name == "hard8",
                                           device="cpu")
    contigs = {"chr1": np.asarray(g.flat[: g.size]).copy()}
    if name == "main8":
        return contigs, {"annotate": True}, {}, {}
    return (contigs, {"annotate": True},
            dict(fixed_extend_base_threshold=2000), dict(BENCH_KW))


# ---- the diverged genome through both packages (the heaviest fixture)

@pytest.fixture(scope="module")
def diverged_runs(tmp_path_factory):
    """{port: (RunResult, out_dir)} of both packages' run_pipeline on the
    diverged target."""
    contigs, cfg_kw, align_kw, params_kw = _target("diverged")
    out = {}
    for port in (False, True):
        d = str(tmp_path_factory.mktemp("port" if port else "jax"))
        out[port] = (_run(port, contigs, params_kw, cfg_kw, align_kw, d), d)
    return out


def test_diverged_same_files(diverged_runs):
    names = [sorted(os.listdir(diverged_runs[p][1])) for p in (False, True)]
    assert names[0] == names[1] == sorted(FILES + ["stage_times.json"])


@pytest.mark.parametrize("name", FILES)
def test_diverged_file_byte_equal(diverged_runs, name):
    a, b = (os.path.join(diverged_runs[p][1], name) for p in (False, True))
    assert filecmp.cmp(a, b, shallow=False), name


def test_diverged_reaches_the_tiers(diverged_runs):
    """In the JAX package's run some planted diverged family is accepted
    within 10 bp of its planted ends, and some other is rejected or
    re-bounded by more than 10 bp: the genome sits at the homology tiers
    and does not pass them all.  The port's calls are the same."""
    from hite_tpu_torch.scripts import pan_run

    _codes, truth = pan_run.diverged_genome_codes()
    calls = {p: pan_run.diverged_calls(diverged_runs[p][0], truth)
             for p in (False, True)}
    assert calls[True] == calls[False]
    jax_calls = calls[False]
    assert any(v is not None and v <= 10 for v in jax_calls.values()), \
        jax_calls
    assert any(v is None or v > 10 for v in jax_calls.values()), jax_calls


def test_diverged_matches_reference(diverged_runs):
    """Both runs meet the committed diverged.json: the same input codes,
    every file's digest equal."""
    from hite_tpu_torch.scripts import reference

    contigs = _target("diverged")[0]
    for port in (False, True):
        got = reference.compare("diverged", contigs, diverged_runs[port][1])
        assert got["input_equal"], port
        assert got["files"] == sorted(FILES), got
        assert not (got["differ"] or got["missing"] or got["extra"]), \
            (port, got)


# ---- the committed references stay in step with their inputs

@pytest.mark.parametrize("name", TARGETS)
def test_reference_input_current(name):
    """The port's builders still give the codes each reference was made
    from."""
    from hite_tpu_torch.scripts import reference

    ref = reference.load(name)
    contigs = _target(name)[0]
    assert reference.codes_sha256(contigs) == ref["input_sha256"]
    assert sum(len(v) for v in contigs.values()) == ref["input_bp"]
    assert ref["target"] == name and sorted(ref["files"]) == sorted(FILES)


@pytest.mark.parametrize("name", TARGETS)
def test_reference_config_current(name):
    """Each reference's recorded config is the one its target runs, read
    off the port's config classes (field for field the JAX package's)."""
    from hite_tpu_torch.config import AlignConfig, PipelineConfig
    from hite_tpu_torch.pipeline.coarse import CoarseParams
    from hite_tpu_torch.scripts import reference

    _contigs, cfg_kw, align_kw, params_kw = _target(name)
    cfg = PipelineConfig(align=AlignConfig(**align_kw), **cfg_kw)
    want = {"PipelineConfig": _changed(cfg, PipelineConfig()),
            "CoarseParams": _changed(CoarseParams(**params_kw),
                                     CoarseParams())}
    assert reference.load(name)["config"] == json.loads(json.dumps(want))


def test_verify_rejects_misaligned_copy_sets():
    """`verify_families` raises when the injected copy sets do not line up
    with the plan's fetch list, instead of truncating the pairing."""
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.pipeline.verify import (
        VerifyPlan, verify_families,
    )

    rng = np.random.default_rng(3)
    g = Genome.from_dict({"chr1": rng.integers(0, 4, 20_000).astype(
        np.uint8)}, device="cpu")
    cfg = PipelineConfig().with_genome_size(g.size)
    gated = np.array([[1_000, 1_500], [5_000, 5_600]], np.int64)
    seqs = [g.extract(s, e) for s, e in gated]
    plan = VerifyPlan(gated=gated, seqs=seqs, sim_groups=[0, 1],
                      group_members={0: [0], 1: [1]}, rep_idx=[0, 1],
                      prefetch_idx=[0, 1])
    with pytest.raises(ValueError, match="1 injected copy sets for 2"):
        verify_families(g, gated, cfg, lambda fa: (False, 0, 0),
                        min_copies=2, stage="tir", plan=plan,
                        rep_copy_sets=[[]])


def _changed(obj, default, prefix=""):
    """{dotted field: value} of every dataclass field of `obj` that differs
    from `default`'s."""
    out = {}
    for f in dataclasses.fields(obj):
        a, b = getattr(obj, f.name), getattr(default, f.name)
        if dataclasses.is_dataclass(a):
            out.update(_changed(a, b, f"{prefix}{f.name}."))
        elif a != b:
            out[prefix + f.name] = list(a) if isinstance(a, tuple) else a
    return out


def write_reference(name, out_dir):
    """Run the JAX package's run_pipeline on target NAME on the CPU and
    write hite_tpu_torch/data/reference/NAME.json."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from hite_tpu.config import AlignConfig, PipelineConfig
    from hite_tpu.pipeline.coarse import CoarseParams
    from hite_tpu_torch.scripts import reference

    contigs, cfg_kw, align_kw, params_kw = _target(name)
    if name != "diverged":
        # the JAX package's own builder: the same numpy draws
        from bench import build_bench_genome

        jg, _ = build_bench_genome(8_000_000, hard=name == "hard8")
        jcontigs = {k: np.asarray(v).copy() for k, v in jg.to_dict().items()}
        assert reference.codes_sha256(jcontigs) == \
            reference.codes_sha256(contigs), "the builders drifted apart"
        contigs = jcontigs
    t0 = time.perf_counter()
    _run(False, contigs, params_kw, cfg_kw, align_kw, out_dir)
    wall = time.perf_counter() - t0
    cfg = PipelineConfig(align=AlignConfig(**align_kw), **cfg_kw)
    rec = {"target": name,
           "input_sha256": reference.codes_sha256(contigs),
           "input_bp": int(sum(len(v) for v in contigs.values())),
           "config": {"PipelineConfig": _changed(cfg, PipelineConfig()),
                      "CoarseParams": _changed(CoarseParams(**params_kw),
                                               CoarseParams())},
           "made_by": "hite_tpu.pipeline.run.run_pipeline, JAX on the CPU",
           "jax_cpu_wall_s": round(wall, 1),
           "files": reference.file_digests(out_dir)}
    os.makedirs(reference.REFERENCE_DIR, exist_ok=True)
    with open(reference.path(name), "w") as fh:
        json.dump(rec, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(json.dumps({k: rec[k] for k in ("target", "input_sha256",
                                          "jax_cpu_wall_s")}))
    return rec


if __name__ == "__main__":
    # python tests/test_torch_reference_files.py write NAME [OUT_DIR]
    sys.path.insert(0, ROOT)
    assert sys.argv[1] == "write" and sys.argv[2] in TARGETS, sys.argv
    import tempfile

    out = sys.argv[3] if len(sys.argv) > 3 else tempfile.mkdtemp()
    write_reference(sys.argv[2], out)
