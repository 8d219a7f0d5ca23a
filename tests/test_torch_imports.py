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
    "hite_tpu_torch.ops.kmerset",
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
    "hite_tpu_torch.pipeline.ltr_legacy", "hite_tpu_torch.ops.eahelitron",
    "hite_tpu_torch.parallel.multihost", "hite_tpu_torch.pipeline.rnaseq",
    "hite_tpu_torch.pipeline.pan", "hite_tpu_torch.scripts.pan_run",
    "hite_tpu_torch.ops.pack2", "hite_tpu_torch.scripts.scale_run",
    "hite_tpu_torch.models.train", "hite_tpu_torch.models.synthetic",
    "hite_tpu_torch.models.weak_labels", "hite_tpu_torch.models.pretrain",
    "hite_tpu_torch.scripts.ltr_seeds", "hite_tpu_torch.parallel.mesh",
    "hite_tpu_torch.parallel.dispatch",
    "hite_tpu_torch.scripts.dryrun_multichip",
    "hite_tpu_torch.scripts.mesh_scaling", "hite_tpu_torch.scripts.sw_compare",
    "hite_tpu_torch.scripts.reference",
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


JAX_PKG = os.path.join(ROOT, "hite_tpu")
# JAX modules and functions with no port counterpart, each for a reason:
# the Pallas kernel became csrc/sw.cu, and the rest is JAX's own compile
# machinery (jit caches, the compile cache, compile-time listeners)
NO_COUNTERPART = {
    "ops/terminal_pallas.py": "the Pallas SW kernel, ported as csrc/sw.cu",
    "utils/jitcache.py": "JAX's ahead-of-time compile cache",
    "models/trainer.py:jit_apply": "a cache of jax.jit-compiled applies",
    "utils/log.py:install_compile_listener": "JAX's compile-time events",
}


def _jax_modules():
    out = []
    for d, _, files in os.walk(JAX_PKG):
        out += [os.path.relpath(os.path.join(d, f), JAX_PKG)
                for f in files if f.endswith(".py")]
    return sorted(out)


def _top_level(path, defs_only):
    names = set()
    for node in ast.parse(open(path).read(), path).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif defs_only:
            continue
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {a.asname or a.name for a in node.names}
    return names


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_function_has_a_counterpart(rel):
    """Each public top-level function or class of a hite_tpu module is
    defined (or bound) at the top of the port's module of the same path;
    private `_*` helpers and NO_COUNTERPART are exempt."""
    if rel in NO_COUNTERPART:
        return
    public = {n for n in _top_level(os.path.join(JAX_PKG, rel), True)
              if not n.startswith("_")
              and f"{rel}:{n}" not in NO_COUNTERPART}
    port = os.path.join(PKG, rel)
    assert os.path.exists(port) or not public, f"no port module for {rel}"
    if public:
        missing = public - _top_level(port, False)
        assert not missing, f"hite_tpu_torch/{rel} lacks {sorted(missing)}"


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
    from hite_tpu_torch.models.features import FEATURE_DIM
    from hite_tpu_torch.models.ltr_filter import LTRFilterCNN
    from hite_tpu_torch.models.train import create_state
    from hite_tpu_torch.models.trainer import make_dataset, train_classifier
    from hite_tpu_torch.models.weak_labels import mine_weak_labels

    X = np.zeros((2, FEATURE_DIM), np.float32)
    calls += [lambda d: make_dataset({"a#DNA/hAT": seq[0]}, device=d),
              lambda d: train_classifier(X, np.zeros(2, np.int32), epochs=1,
                                         device=d),
              lambda d: create_state(LTRFilterCNN(), device=d),
              lambda d: mine_weak_labels([], device=d)]
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


def test_pan_main_raises_without_gpu(monkeypatch, tmp_path):
    """The pan CLI reads its genomes onto the card unless told "cpu"."""
    from hite_tpu_torch.pipeline.pan import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "g").mkdir()
    (tmp_path / "g" / "a.fa").write_text(">chr1\n" + "ACGT" * 100 + "\n")
    with pytest.raises(RuntimeError, match="GPU"):
        main(["--pan_genomes_dir", str(tmp_path / "g"), "--out_dir",
              str(tmp_path / "o"), "--skip_analyze", "1"])
    assert not (tmp_path / "o").exists()


def test_pretrain_raises_without_gpu(monkeypatch, tmp_path):
    """Pretraining runs on the card unless told "cpu": every entry point
    refuses before it builds a dataset or writes a checkpoint."""
    import numpy as np

    from hite_tpu_torch.models import pretrain

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "m.pkl")
    z = np.zeros((2, 4, 4, 3), np.float32)
    for call in (lambda: pretrain.pretrain_superfamily(out=out),
                 lambda: pretrain.pretrain_ltr_filter(out=out),
                 lambda: pretrain.train_ltr_filter(z, z, np.zeros(2)),
                 lambda: pretrain.main(["--out_dir", str(tmp_path / "d")])):
        with pytest.raises(RuntimeError, match="GPU"):
            call()
    assert not os.listdir(tmp_path)


def test_ltr_seeds_raises_without_gpu(monkeypatch, capsys):
    """The LTR seed sweep retrains on the card unless told "cpu"."""
    from hite_tpu_torch.scripts.ltr_seeds import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        main(["--seeds", "0", "0"])
    assert capsys.readouterr().out == ""


def test_sw_compare_refuses_without_gpu(monkeypatch, capsys, tmp_path):
    """The two-checkout kernel comparison runs on the card only: without
    one it exits non-zero before building anything."""
    from hite_tpu_torch.scripts.sw_compare import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([str(tmp_path)]) == 2
    assert capsys.readouterr().out == ""
    assert main([]) == 2


def test_scale_run_raises_without_gpu(monkeypatch, tmp_path):
    """scale_run builds its genome on the card unless told "cpu"."""
    from hite_tpu_torch.scripts.scale_run import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        main(["--mbp", "1", "--build-only", "--out", str(tmp_path / "o")])


def test_native_sources_build_with_the_kernels():
    """The host libraries (chaining, the FASTA reader) are built by
    kernels.build beside the CUDA sources, into the package's _build/."""
    from hite_tpu_torch import kernels

    assert set(kernels.HOST_SOURCES) == {"chain", "fasta"}
    assert all(os.path.exists(p) for p in kernels.HOST_SOURCES.values())
    kernels.build(list(kernels.HOST_SOURCES))
    assert all(os.path.exists(kernels._lib_path(n))
               for n in kernels.HOST_SOURCES)
    assert os.path.dirname(kernels._lib_path("fasta")) == kernels.BUILD_DIR


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
