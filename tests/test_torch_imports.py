"""hite_tpu_torch stands alone: no JAX, no hite_tpu, GPU by default."""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "hite_tpu_torch")

MODULES = [
    "hite_tpu_torch", "hite_tpu_torch.config", "hite_tpu_torch.device",
    "hite_tpu_torch.genome", "hite_tpu_torch.kernels",
    "hite_tpu_torch.io.fasta", "hite_tpu_torch.utils.log",
    "hite_tpu_torch.utils.intervals", "hite_tpu_torch.native.runtime",
    "hite_tpu_torch.ops.encode", "hite_tpu_torch.ops.terminal",
    "hite_tpu_torch.ops.tandem", "hite_tpu_torch.ops.tsd",
    "hite_tpu_torch.ops.selfjoin", "hite_tpu_torch.ops.kmer",
    "hite_tpu_torch.ops.libjoin", "hite_tpu_torch.ops.msa",
    "hite_tpu_torch.ops.boundary", "hite_tpu_torch.ops.chain",
    "hite_tpu_torch.ops.protein", "hite_tpu_torch.ops.seedext",
    "hite_tpu_torch.ops.lcv", "hite_tpu_torch.ops.tail",
    "hite_tpu_torch.pipeline.candidates", "hite_tpu_torch.pipeline.coarse",
    "hite_tpu_torch.pipeline.copies", "hite_tpu_torch.pipeline.cluster",
    "hite_tpu_torch.pipeline.boundary_adjust",
    "hite_tpu_torch.pipeline.verify", "hite_tpu_torch.pipeline.tir",
    "hite_tpu_torch.pipeline.domain", "hite_tpu_torch.pipeline.helitron",
    "hite_tpu_torch.pipeline.non_ltr", "hite_tpu_torch.pipeline.run",
    "hite_tpu_torch.models", "hite_tpu_torch.models.convert",
    "hite_tpu_torch.models.features", "hite_tpu_torch.models.classifier",
    "hite_tpu_torch.models.ltr_filter", "hite_tpu_torch.models.trainer",
    "hite_tpu_torch.pipeline.ltr", "hite_tpu_torch.pipeline.ltr_deep",
    "hite_tpu_torch.pipeline.libcluster", "hite_tpu_torch.pipeline.library",
    "hite_tpu_torch.io.gff", "hite_tpu_torch.pipeline.annotate",
    "hite_tpu_torch.pipeline.checkpoint", "hite_tpu_torch.pipeline.other",
    "hite_tpu_torch.pipeline.clean", "hite_tpu_torch.pipeline.benchmark",
    "hite_tpu_torch.pipeline.ltr_legacy",
]


def _py_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_import_loads_neither_jax_nor_hite_tpu():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'hite_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=300)


@pytest.mark.parametrize("path", _py_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_hite_tpu_import(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "hite_tpu"), \
                f"{path}: imports {n}"


def test_entry_points_raise_without_gpu(monkeypatch):
    import numpy as np

    from hite_tpu_torch.genome import Genome, synthetic_genome

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seqs = {"chr1": np.zeros(100, np.uint8)}
    with pytest.raises(RuntimeError):
        Genome.from_dict(seqs)
    with pytest.raises(RuntimeError):
        synthetic_genome(5000, ["ACGT" * 50], [2])
    with pytest.raises(RuntimeError):
        Genome.from_dict(seqs, device="cuda")
    assert Genome.from_dict(seqs, device="cpu").device.type == "cpu"

    from hite_tpu_torch.pipeline.domain import DomainScanner, rt_motif_present

    lib = {"P": np.arange(20, dtype=np.uint8)}
    with pytest.raises(RuntimeError):
        DomainScanner(lib)
    with pytest.raises(RuntimeError):
        rt_motif_present([np.zeros(300, np.uint8)])
    assert DomainScanner(lib, device="cpu").index.codes.device.type == "cpu"

    from hite_tpu_torch.config import AlignConfig, PipelineConfig
    from hite_tpu_torch.models import bundled_model_path
    from hite_tpu_torch.models.classifier import SuperfamilyCNN
    from hite_tpu_torch.models.convert import load_model
    from hite_tpu_torch.models.trainer import build_features
    from hite_tpu_torch.pipeline.libcluster import (
        cluster_seqs, subcluster_members,
    )
    from hite_tpu_torch.pipeline.library import library_feature_evidence
    from hite_tpu_torch.pipeline.ltr_deep import cnn_inputs

    seq = [np.zeros(300, np.uint8), np.ones(300, np.uint8)]
    frame = np.zeros((4, 400), np.uint8)
    path = bundled_model_path("superfamily_cnn.pkl")
    calls = [lambda d: build_features(seq, device=d),
             lambda d: cluster_seqs(seq, AlignConfig(), device=d),
             lambda d: subcluster_members(seq, device=d),
             lambda d: library_feature_evidence(seq, PipelineConfig(),
                                                device=d),
             lambda d: load_model(SuperfamilyCNN, path, d),
             lambda d: cnn_inputs(frame, d)]
    from hite_tpu_torch.pipeline.annotate import rescore_hit_identities
    from hite_tpu_torch.pipeline.benchmark import family_level_metrics
    from hite_tpu_torch.pipeline.clean import clean_genome

    calls += [lambda d: rescore_hit_identities([(seq[0], seq[1])], device=d),
              lambda d: family_level_metrics({}, {"g": seq[0]},
                                             PipelineConfig(), device=d),
              lambda d: clean_genome({"c1": seq[0]}, PipelineConfig(),
                                     device=d)]
    for call in calls:
        with pytest.raises(RuntimeError):
            call(None)
        call("cpu")


def test_main_raises_without_gpu(monkeypatch, tmp_path):
    """The CLI's `main` reads the genome onto the card unless told "cpu"."""
    from hite_tpu_torch.pipeline.run import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa = tmp_path / "g.fa"
    fa.write_text(">chr1\n" + "ACGT" * 100 + "\n")
    with pytest.raises(RuntimeError, match="GPU"):
        main(["--genome", str(fa), "--out_dir", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def test_kernel_wrapper_needs_cuda_tensors_off_cpu():
    from hite_tpu_torch.ops.terminal import batched_local_align_auto

    a = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        batched_local_align_auto(a, a)
    with pytest.raises(TypeError):
        batched_local_align_auto(torch.zeros((2, 8), dtype=torch.int32),
                                 torch.zeros((2, 8), dtype=torch.int32))


def test_config_defaults_identical():
    from hite_tpu.config import PipelineConfig as JaxConfig
    from hite_tpu_torch.config import PipelineConfig as TorchConfig

    assert dataclasses.asdict(JaxConfig()) == dataclasses.asdict(TorchConfig())
    assert (dataclasses.asdict(JaxConfig().with_genome_size(10**9))
            == dataclasses.asdict(TorchConfig().with_genome_size(10**9)))


def test_coarse_params_identical():
    from hite_tpu.pipeline.coarse import CoarseParams as JaxParams
    from hite_tpu_torch.pipeline.coarse import CoarseParams as TorchParams

    assert dataclasses.asdict(JaxParams()) == dataclasses.asdict(TorchParams())


def test_native_chain_matches_oracle():
    import numpy as np

    from hite_tpu_torch.native import runtime
    from hite_tpu_torch.ops.chain import chain_hsps_host, chain_hsps_host_py

    rng = np.random.default_rng(3)
    qs = rng.integers(0, 20_000, 400)
    qe = qs + rng.integers(30, 300, 400)
    ss = rng.integers(0, 20_000, 400)
    se = ss + rng.integers(30, 300, 400)
    for dt in (0, 150):
        ref = chain_hsps_host_py(qs, qe, ss, se, extend_threshold=500,
                                 min_len=50, diag_tol=dt)
        got = chain_hsps_host(qs, qe, ss, se, extend_threshold=500,
                              min_len=50, diag_tol=dt)
        assert np.array_equal(ref, got)
    assert runtime.available()
