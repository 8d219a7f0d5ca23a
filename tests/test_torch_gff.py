"""The annotation writers, the SW identity rescore, the BM_RM2 family
count, checkpointing and the CLI's config of hite_tpu_torch vs hite_tpu.

The same seeded inputs go through both packages on the CPU (SW through
the JAX package's XLA path and the port's plain version); everything must
be equal: the four writers' files byte for byte, overlap resolution hit
for hit, identities as float64, configs and config hashes field for
field.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

CONTIGS = ("chr1", "Chr2", "scaffold_000123_long_name")
CLASSES = ("DNA/hAT", "DNA/Mutator", "LTR/Gypsy", "RC/Helitron", "SINE",
           "Unknown")


def _hit_tuples(n=60, seed=5):
    """(contig, start, end, strand, family, class, identity, full_length)
    with overlaps, on several contigs."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        c = CONTIGS[int(rng.integers(0, len(CONTIGS)))]
        s = int(rng.integers(1, 50_000))
        e = s + int(rng.integers(30, 4_000))
        out.append((c, s, e, "+" if rng.random() < 0.5 else "-",
                    f"fam_{int(rng.integers(0, 12))}",
                    CLASSES[int(rng.integers(0, len(CLASSES)))],
                    float(rng.random() ** 0.3), bool(rng.random() < 0.4)))
    return out


def _hits(port, tuples):
    if port:
        from hite_tpu_torch.io.gff import AnnotationHit
    else:
        from hite_tpu.io.gff import AnnotationHit
    return [AnnotationHit(*t) for t in tuples]


@pytest.mark.parametrize("writer", ["write_gff", "write_rm_out", "write_tbl",
                                    "write_full_length_gff"])
def test_writers_byte_equal(tmp_path, writer):
    from hite_tpu.io import gff as jgff
    from hite_tpu_torch.io import gff as tgff

    tuples = _hit_tuples()
    files = []
    for mod, port in ((jgff, False), (tgff, True)):
        path = str(tmp_path / f"{'port' if port else 'jax'}" / "genome.x")
        args = (path, _hits(port, tuples))
        if writer == "write_tbl":
            args += (250_000,)
        getattr(mod, writer)(*args)
        files.append(open(path, "rb").read())
    assert files[0] == files[1]
    assert len(files[1]) > 100


def test_resolve_overlaps_same_list():
    from hite_tpu.pipeline.annotate import resolve_overlaps as jres
    from hite_tpu_torch.pipeline.annotate import resolve_overlaps as tres

    tuples = _hit_tuples(200, seed=7)
    ref = [dataclasses.astuple(h) for h in jres(_hits(False, tuples))]
    got = [dataclasses.astuple(h) for h in tres(_hits(True, tuples))]
    assert got == ref
    assert len(got) < len(tuples)


def _rescore_pairs():
    """128 pairs in the 64- and 1024-wide buckets, then two past 4096 that
    the centre clip cuts; diverged copies, reverse halves and N blocks."""
    rng = np.random.default_rng(11)
    lens = ([int(x) for x in rng.integers(30, 200, 64)]
            + [int(x) for x in rng.integers(200, 1000, 64)] + [4600, 5000])
    pairs = []
    for i, n in enumerate(lens):
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = a.copy()
        mut = rng.random(n) < rng.uniform(0.0, 0.3)
        b[mut] = (b[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        b = b[int(rng.integers(0, n // 4 + 1)):]
        if i % 5 == 0:
            b = np.concatenate([b, rng.integers(0, 4, 40).astype(np.uint8)])
        if i % 7 == 0:
            a = a.copy()
            a[n // 3 : n // 3 + 20] = 4
        if i % 11 == 0:
            b = np.full(len(b), 4, np.uint8)
        pairs.append((a, b))
    return pairs


def test_rescore_identities_equal():
    import jax.numpy as jnp  # noqa: F401  (the JAX side's SW backend)

    from hite_tpu.pipeline.annotate import rescore_hit_identities as jres
    from hite_tpu_torch.pipeline.annotate import (
        rescore_hit_identities as tres,
    )

    pairs = _rescore_pairs()
    ref = jres(pairs)
    got = tres(pairs, device="cpu")
    assert got.dtype == np.float64
    assert np.array_equal(got, ref)
    assert (got == 0).any() and (got > 0.9).any()


def test_family_level_metrics_equal():
    """BM_RM2 with fragments in several width buckets, one past 4096."""
    from hite_tpu.config import PipelineConfig as JaxConfig
    from hite_tpu.pipeline.benchmark import family_level_metrics as jfam
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.pipeline.benchmark import family_level_metrics

    rng = np.random.default_rng(17)
    gold = {f"g{i}#DNA": rng.integers(0, 4, n).astype(np.uint8)
            for i, n in enumerate((300, 800, 1500, 4300, 600))}
    test = {}
    for i, (name, seq) in enumerate(gold.items()):
        if i == 4:
            continue                      # a missing family
        s = seq.copy()
        mut = rng.random(len(s)) < (0.02, 0.1, 0.01, 0.03)[i]
        s[mut] = (s[mut] + 1) % 4
        test[f"t{i}"] = s if i != 2 else s[200:900]   # a fragment
    test["chimera"] = np.concatenate([gold["g0#DNA"], gold["g1#DNA"][:400]])
    ref = jfam(test, gold, JaxConfig())
    got = family_level_metrics(test, gold, PipelineConfig(), device="cpu")
    assert got == ref
    assert got["present"] >= 2 and got["missing"] >= 1


def test_config_hash_equal_to_jax():
    from hite_tpu.config import PipelineConfig as JaxConfig
    from hite_tpu.pipeline.checkpoint import config_hash as jhash
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.pipeline.checkpoint import config_hash

    for kw in ({}, {"annotate": True, "recover": True}, {"te_type": "tir"}):
        a, b = PipelineConfig(**kw), JaxConfig(**kw)
        assert config_hash(a) == jhash(b)
        assert (config_hash(a.with_genome_size(3_000_000))
                == jhash(b.with_genome_size(3_000_000)))
    base = PipelineConfig()
    assert config_hash(base) != config_hash(base.replace(plant=False))
    assert config_hash(base) != config_hash(base.replace(
        ltr=dataclasses.replace(base.ltr, use_filtr=False)))


def test_checkpointer_roundtrip(tmp_path):
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.pipeline.checkpoint import Checkpointer

    cfg = PipelineConfig(recover=True)
    ck = Checkpointer(str(tmp_path), cfg)
    calls = []

    def compute():
        calls.append(1)
        return {"x": np.arange(5), "t": torch.arange(3)}

    r1 = ck.run("stage1", compute)
    r2 = ck.run("stage1", compute)
    assert len(calls) == 1
    assert (r1["x"] == r2["x"]).all() and torch.equal(r1["t"], r2["t"])
    assert r2["t"].device.type == "cpu"
    ck2 = Checkpointer(str(tmp_path), cfg)
    assert (ck2.run("stage1", compute)["x"] == r1["x"]).all()
    assert len(calls) == 1
    Checkpointer(str(tmp_path), cfg.replace(plant=False)).run("stage1",
                                                              compute)
    assert len(calls) == 2
    ck.clean()
    ck.run("stage1", compute)
    assert len(calls) == 3
    assert os.listdir(tmp_path / ".checkpoints")


def test_checkpointer_disabled(tmp_path):
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.pipeline.checkpoint import Checkpointer

    cfg = PipelineConfig(recover=False)
    ck = Checkpointer(str(tmp_path), cfg, enabled=cfg.recover)
    calls = []
    ck.run("s", lambda: calls.append(1))
    ck.run("s", lambda: calls.append(1))
    assert len(calls) == 2
    assert not os.path.exists(tmp_path / ".checkpoints")


def test_checkpointer_async_save_is_a_snapshot(tmp_path):
    """load() drains the background write, and the snapshot holds the data
    as it was when saved, whatever the caller changes afterwards."""
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.pipeline.checkpoint import Checkpointer

    cfg = PipelineConfig()
    ck = Checkpointer(str(tmp_path), cfg, enabled=True)
    big = {"x": list(range(100_000))}
    ck.save("stage_a", big)
    want = {"x": list(range(100_000))}
    big["x"].append(-1)
    assert ck.load("stage_a") == want
    assert Checkpointer(str(tmp_path), cfg, enabled=True).load(
        "stage_a") == want


ARGVS = [
    [],
    ["--use_HybridLTR", "0", "--te_type", "ltr"],
    ["--use_FiLTR", "0", "--annotate", "1", "--recover", "1"],
    ["--species", "test", "--BM_HiTE", "1", "--BM_RM2", "1"],
    ["--min_TE_len", "100", "--is_wicker", "1", "--out_dir", "o",
     "--miu", "3e-9", "--species", "lib.fa", "--clean_genome", "0",
     "--plant", "0", "--domain", "1", "--BM_EDTA", "1", "--curated_lib",
     "c.fa", "--remove_nested", "0", "--is_denovo_nonltr", "0",
     "--chrom_seg_length", "65536"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_config_from_argv_equal(argv):
    from hite_tpu.pipeline.run import config_from_argv as jparse
    from hite_tpu_torch.pipeline.run import config_from_argv

    argv = ["--genome", "g.fa"] + argv
    cfg, args = config_from_argv(argv)
    jcfg, jargs = jparse(argv)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert vars(args) == vars(jargs)
