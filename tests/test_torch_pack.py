"""The packed host genome: `ops/pack2.py` and the packed `Genome` tier held
against the JAX package (codec bytes, read / mask semantics, device
unpack, the genome's consumers, `from_fasta`, `run_pipeline`)."""

import filecmp
import os

import numpy as np
import pytest
import torch
from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(2)

from hite_tpu import genome as jax_genome_mod
from hite_tpu.genome import Genome as JaxGenome
from hite_tpu.ops import pack2 as jax_pack2
from hite_tpu_torch import genome as genome_mod
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.ops import pack2


def _codes(n, seed):
    """Random codes with N runs and single Ns."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, n).astype(np.uint8)
    for s in rng.integers(0, max(1, n - 50), 4):
        c[s : s + rng.integers(1, 40)] = 4
    c[rng.integers(0, n, max(1, n // 50))] = 4
    return c


@pytest.mark.parametrize("n", [1, 7, 8, 13, 1023, 10_001])
def test_codec_bytes_equal_jax(n):
    c = _codes(n, seed=n)
    ref = jax_pack2.pack_codes(c)
    got = pack2.pack_codes(c)
    assert got[2] == ref[2] == n
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    assert np.array_equal(pack2.unpack_codes(*got), c)
    assert np.array_equal(pack2.unpack_codes(*got),
                          jax_pack2.unpack_codes(*ref))
    pf = pack2.PackedFlat.from_uint8(c)
    assert np.array_equal(pf.packed, ref[0]) and np.array_equal(pf.nmask,
                                                                ref[1])


def test_reads_and_mask_writes_match_jax():
    codes = _codes(10_001, seed=5)
    pf, jf = (m.PackedFlat.from_uint8(codes) for m in (pack2, jax_pack2))
    assert len(pf) == len(codes) and pf.nbytes == jf.nbytes
    assert pf.nbytes < 0.4 * codes.nbytes
    assert np.array_equal(pf.unpack_all(), codes)
    for s, e in [(0, 7), (3, 3), (13, 997), (9990, 10_001), (0, 10_001),
                 (-20, None), (50, 10)]:
        assert np.array_equal(pf[s:e], jf[s:e]), (s, e)
        assert np.array_equal(pf[s:e], codes[s:e]), (s, e)
    for i in (0, 17, 10_000, -1, np.int64(33)):
        assert pf[i] == jf[i] == codes[i]
    rng = np.random.default_rng(6)
    ref = codes.copy()
    for s, e in [(5, 6), (100, 103), (1000, 1200), (9990, 10_001), (7, 7),
                 (16, 32), (3, 9)]:
        ref[s:e] = 4
        pf[s:e] = 4
        jf[s:e] = 4
    pos = rng.integers(0, len(codes), 50)
    ref[pos] = 4
    pf[pos] = 4
    jf[pos] = 4
    sel = np.zeros(len(codes), bool)
    sel[rng.integers(0, len(codes), 30)] = True
    ref[sel] = 4
    pf[sel] = 4
    jf[sel] = 4
    assert np.array_equal(pf.unpack_all(), ref)
    assert np.array_equal(pf.nmask, jf.nmask)
    assert np.array_equal(pf.packed, jf.packed)
    cp = pf.copy()
    cp[0:4] = 4
    assert not np.array_equal(cp.nmask, pf.nmask)
    for bad in ((slice(0, 4), 1), (np.array([1, 2]), 0)):
        for f in (pf, jf):
            with pytest.raises(ValueError):
                f[bad[0]] = bad[1]
    for bad in (slice(0, 10, 2), np.array([len(codes)]), np.zeros(5, bool)):
        for f in (pf, jf):
            with pytest.raises(IndexError):
                f[bad] = 4
    for f in (pf, jf):
        with pytest.raises(IndexError):
            f[0:10:2]
        with pytest.raises(IndexError):
            f[[1, 2]]


@pytest.mark.parametrize("n", [4096, 10_240, 65_536 + 1024])
def test_device_unpack_equals_jax(n):
    c = _codes(n, seed=n + 1)
    packed, nmask, _ = pack2.pack_codes(c)
    ref = np.asarray(jax_pack2.unpack_device(packed, nmask))
    got = pack2.unpack_device(torch.from_numpy(packed),
                              torch.from_numpy(nmask))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(got.numpy()[:n], c)
    # the chunked upload gives the same bytes at any 8-aligned chunk
    for chunk in (1024, 4096, 1 << 27):
        out = pack2.unpack_device_chunked(packed, nmask, "cpu",
                                          chunk_out=chunk)
        assert np.array_equal(out.numpy(), ref), chunk
    assert np.array_equal(
        np.asarray(jax_pack2.unpack_device_chunked(packed, nmask,
                                                   chunk_out=4096)), ref)


def _pair(seed=11, n=40_000):
    rng = np.random.default_rng(seed)
    seqs = {"chr1": rng.integers(0, 4, n).astype(np.uint8),
            "chr2": rng.integers(0, 5, n // 2).astype(np.uint8)}
    g8 = Genome.from_dict({k: v.copy() for k, v in seqs.items()},
                          device="cpu")
    gp = Genome.from_dict({k: v.copy() for k, v in seqs.items()},
                          device="cpu")
    gp.pack_host()
    jp = JaxGenome.from_dict({k: v.copy() for k, v in seqs.items()})
    jp.pack_host()
    return g8, gp, jp


def test_pack_host_keeps_every_consumer_equal():
    g8, gp, jp = _pair()
    assert isinstance(gp.flat, pack2.PackedFlat)
    assert len(gp.flat) == len(g8.flat) == len(jp.flat)
    for s, e, f in ((100, 900, 50), (39_990, 40_100, 200), (40_064, 40_070, 0)):
        assert np.array_equal(gp.extract(s, e, f), g8.extract(s, e, f))
        assert np.array_equal(gp.extract(s, e, f), jp.extract(s, e, f))
    assert all(np.array_equal(a, b) for a, b in zip(
        gp.to_dict().values(), g8.to_dict().values()))
    assert np.array_equal(gp.segment_view(8192), g8.segment_view(8192))
    assert np.array_equal(gp.segment_view(8192), jp.segment_view(8192))
    d8, L8 = g8.device_flat_padded()
    dp, Lp = gp.device_flat_padded()
    assert L8 == Lp and torch.equal(d8, dp)
    assert np.array_equal(dp.numpy(), np.asarray(jp.device_flat_padded()[0]))

    for g in (g8, gp, jp):
        g.mask_intervals([(500, 1500), (40_100, 40_130)])
        g.masked[np.array([7, 9, 11])] = 4
    assert isinstance(gp.masked, pack2.PackedFlat)
    assert np.array_equal(gp.segment_view(8192, use_masked=True),
                          g8.segment_view(8192, use_masked=True))
    for (b0, a), (c0, b), (j0, c) in zip(
            gp.segment_batches(8192, 3, use_masked=True),
            g8.segment_batches(8192, 3, use_masked=True),
            jp.segment_batches(8192, 3, use_masked=True)):
        assert b0 == c0 == j0
        assert np.array_equal(a, b) and np.array_equal(a, c)
    d8m, _ = g8.device_flat_padded(use_masked=True)
    dpm, _ = gp.device_flat_padded(use_masked=True)
    assert torch.equal(d8m, dpm)
    assert np.array_equal(
        dpm.numpy(), np.asarray(jp.device_flat_padded(use_masked=True)[0]))


def test_from_fasta_packed_flag_and_threshold(tmp_path, monkeypatch):
    from hite_tpu_torch.io.fasta import write_fasta

    seq = _codes(5000, seed=8)
    path = str(tmp_path / "g.fa")
    write_fasta(path, {"c": seq})
    g = Genome.from_fasta(path, packed=True, device="cpu")
    assert isinstance(g.flat, pack2.PackedFlat)
    assert np.array_equal(g.extract(0, 5000), seq)
    assert isinstance(Genome.from_fasta(path, device="cpu").flat, np.ndarray)
    assert isinstance(Genome.from_fasta(path, packed=False,
                                        device="cpu").flat, np.ndarray)
    assert genome_mod.HOST_PACK_THRESHOLD == \
        jax_genome_mod.HOST_PACK_THRESHOLD
    monkeypatch.setattr(genome_mod, "HOST_PACK_THRESHOLD", 4096)
    monkeypatch.setattr(jax_genome_mod, "HOST_PACK_THRESHOLD", 4096)
    auto = Genome.from_fasta(path, device="cpu")
    jauto = JaxGenome.from_fasta(path)
    assert isinstance(auto.flat, pack2.PackedFlat)
    assert isinstance(jauto.flat, jax_pack2.PackedFlat)
    assert np.array_equal(auto.flat.packed, jauto.flat.packed)
    assert isinstance(Genome.from_fasta(path, packed=False,
                                        device="cpu").flat, np.ndarray)


def _tir_genome():
    """tests/test_pack_host.py's 80 kbp genome: 4 copies of one TIR."""
    rng = np.random.default_rng(13)
    t = rng.integers(0, 4, 20).astype(np.uint8)
    while t[0] == 3 and t[1] == 2:
        t = rng.integers(0, 4, 20).astype(np.uint8)
    te = np.concatenate([t, rng.integers(0, 4, 460).astype(np.uint8),
                         (3 - t)[::-1]])
    bg = rng.integers(0, 4, 80_000).astype(np.uint8)
    for pos in (10_000, 30_000, 50_000, 70_000):
        copy = te.copy()
        muts = rng.random(len(copy)) < 0.02
        copy[muts] = (copy[muts] + rng.integers(1, 4, muts.sum())) % 4
        tsd = rng.integers(0, 4, 5).astype(np.uint8)
        bg[pos - 5 : pos] = tsd
        bg[pos + len(copy) : pos + len(copy) + 5] = tsd
        bg[pos : pos + len(copy)] = copy
    return bg, te


def _same_dirs(a, b):
    names = sorted(f for f in os.listdir(a) if f != "stage_times.json")
    assert names == sorted(f for f in os.listdir(b)
                           if f != "stage_times.json")
    bad = [f for f in names if not filecmp.cmp(os.path.join(a, f),
                                               os.path.join(b, f),
                                               shallow=False)]
    assert not bad, bad
    return names


def _run_both(seqs, tmp_path, cfg_kw, params_kw):
    """run_pipeline of the port on the uint8 and the packed genome and of
    the JAX package on the packed genome; every file compared."""
    from hite_tpu.config import AlignConfig as JA, PipelineConfig as JC
    from hite_tpu.pipeline.coarse import CoarseParams as JP
    from hite_tpu.pipeline.run import run_pipeline as jax_run
    from hite_tpu_torch.config import AlignConfig, PipelineConfig
    from hite_tpu_torch.pipeline.coarse import CoarseParams
    from hite_tpu_torch.pipeline.run import run_pipeline

    align = dict(fixed_extend_base_threshold=2000)
    cfg = PipelineConfig(align=AlignConfig(**align), **cfg_kw)
    dirs = {k: str(tmp_path / k) for k in ("u8", "packed", "jax")}
    run_pipeline(Genome.from_dict({k: v.copy() for k, v in seqs.items()},
                                  device="cpu"), cfg, out_dir=dirs["u8"],
                 coarse_params=CoarseParams(**params_kw))
    gp = Genome.from_dict({k: v.copy() for k, v in seqs.items()},
                          device="cpu")
    gp.pack_host()
    res = run_pipeline(gp, cfg, out_dir=dirs["packed"],
                       coarse_params=CoarseParams(**params_kw))
    jp = JaxGenome.from_dict({k: v.copy() for k, v in seqs.items()})
    jp.pack_host()
    jax_run(jp, JC(align=JA(**align), **cfg_kw), out_dir=dirs["jax"],
            coarse_params=JP(**params_kw))
    names = _same_dirs(dirs["u8"], dirs["packed"])
    assert _same_dirs(dirs["packed"], dirs["jax"]) == names
    return res, names


def test_pipeline_on_packed_genome_matches_jax(tmp_path):
    bg, _te = _tir_genome()
    res, names = _run_both({"chr1": bg}, tmp_path,
                           dict(te_type="tir", annotate=True),
                           dict(seg_len=16_384))
    assert len(res.libs["merged"]) >= 1
    assert "genome.gff" in names and "confident_TE.cons.fa" in names


def test_clean_genome_repacks(tmp_path, monkeypatch):
    """Two contigs, the second a near copy of part of the first:
    clean_genome drops it and renames the survivor, and the genome stays
    packed for the stages after it."""
    from hite_tpu_torch.pipeline import run as run_mod

    bg, te = _tir_genome()
    rng = np.random.default_rng(3)
    dup = bg[20_000:26_000].copy()
    dup[rng.integers(0, len(dup), 30)] = rng.integers(0, 4, 30)
    seqs = {"ctgA": bg, "ctgB": dup,
            "ctgC": np.concatenate([rng.integers(0, 4, 9000).astype(np.uint8),
                                    te, rng.integers(0, 4, 9000)
                                    .astype(np.uint8)])}
    seen = []
    orig = run_mod._mask_tandem_regions

    def watch(genome, *a, **k):
        seen.append((type(genome.flat), type(genome.masked), genome.names))
        return orig(genome, *a, **k)

    monkeypatch.setattr(run_mod, "_mask_tandem_regions", watch)
    _res, names = _run_both(seqs, tmp_path, dict(te_type="tir"),
                            dict(seg_len=16_384))
    assert "contig_name.map" in names
    packed_run = seen[1]
    assert packed_run[0] is pack2.PackedFlat
    assert packed_run[1] is pack2.PackedFlat
    assert len(packed_run[2]) < len(seqs)
