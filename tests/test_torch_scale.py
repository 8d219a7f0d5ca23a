"""The scale run's pieces held against the JAX package: the chunk grids
at the 100 Mbp geometry, the LTR chunk grid at a shrunk cap against a
replay of the JAX loop, the bench substrate builder at scale > 1 and with
the hard cases, and `scale_run --build-only` in a subprocess."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat_len(bp, pad_to=1024, spacer=64):
    return -(-(bp + spacer) // pad_to) * pad_to


def test_chunk_grids_at_100_mbp():
    """The selfjoin (2^26, halo 30 kbp), LTR (2^26, halo 2 x max LTR +
    max interior) and copy-join (2^24) grids of a 100 Mbp genome padded
    to 2^27 equal the JAX package's."""
    from hite_tpu.pipeline.coarse import _chunk_grid as jax_grid
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.pipeline.coarse import CoarseParams, _chunk_grid
    from hite_tpu_torch.pipeline.copies import join_chunk_starts
    from hite_tpu_torch.pipeline.ltr import LTR_CHUNK_BP

    L = _flat_len(100_000_000)
    Lp = 1 << (L - 1).bit_length()
    assert Lp == 1 << 27
    lcfg = PipelineConfig().ltr
    C = CoarseParams().max_selfjoin_bp
    assert C == LTR_CHUNK_BP == 1 << 26 < Lp
    for halo in (30_000, 2 * lcfg.max_ltr_len + lcfg.max_interior):
        got = _chunk_grid(L, C, halo)
        assert got == jax_grid(L, C, halo)
        assert got[0] == 0 and got[-1] == L - C and len(got) == 2
        assert all(b - a <= C - 2 * halo for a, b in zip(got, got[1:]))

    def jax_join_starts(Lp, C, max_len):
        # hite_tpu/pipeline/copies.py's inline loop of the chunked join
        halo = int(min(C // 4, max(65_536, 2 * max_len)))
        out = []
        for c0 in range(0, max(1, Lp - 2 * halo), C - 2 * halo):
            c0 = min(c0, Lp - C)
            out.append(c0)
            if c0 == Lp - C:
                break
        return out

    for max_len in (400, 3000, 40_000, 1 << 20):
        got = join_chunk_starts(Lp, 1 << 24, max_len)
        assert got == jax_join_starts(Lp, 1 << 24, max_len)
        assert got[-1] == Lp - (1 << 24)
    assert len(join_chunk_starts(Lp, 1 << 24, 3000)) == 9


CAP = 1 << 16


def _ltr_cfgs():
    from hite_tpu.config import PipelineConfig as JaxConfig
    from hite_tpu_torch.config import PipelineConfig

    kw = dict(max_ltr_len=1000, max_interior=4000)
    out = []
    for C in (PipelineConfig, JaxConfig):
        c = C()
        out.append(c.replace(ltr=dataclasses.replace(c.ltr, **kw)))
    return out


def _seam_genome():
    """360 kbp with two LTR families (3 copies each); a copy straddles
    the end of each chunk of the shrunk grid."""
    from hite_tpu.pipeline.coarse import _chunk_grid as jax_grid

    cfg = _ltr_cfgs()[0]
    halo = 2 * cfg.ltr.max_ltr_len + cfg.ltr.max_interior
    rng = np.random.default_rng(41)
    length = 360_000
    bg = rng.integers(0, 4, length).astype(np.uint8)
    tes = []
    for ltr_len in (250, 400):
        t = rng.integers(0, 4, ltr_len).astype(np.uint8)
        t[0], t[1], t[-2], t[-1] = 3, 2, 1, 0
        tes.append(np.concatenate(
            [t, rng.integers(0, 4, 2200).astype(np.uint8), t]))
    starts = [c0 + CAP - 1200 for c0 in jax_grid(_flat_len(length), CAP,
                                                 halo)]
    starts = [s for s in starts if s + 3500 < length - 1000]
    assert len(starts) >= 6
    for i, pos in enumerate(starts):
        te = tes[i % 2]
        copy = te.copy()
        muts = rng.random(len(copy)) < 0.01
        copy[muts] = (copy[muts] + rng.integers(1, 4, muts.sum())) % 4
        tsd = rng.integers(0, 4, 5).astype(np.uint8)
        bg[pos - 5 : pos] = tsd
        bg[pos + len(copy) : pos + len(copy) + 5] = tsd
        bg[pos : pos + len(copy)] = copy
    return bg, starts


def _jax_ltr_pairs(genome, cfg, cap):
    """hite_tpu/pipeline/ltr.py:125-188 (`ltr_pair_candidates`) replayed
    from the JAX package's own functions with the chunk cap as an
    argument (a local literal there)."""
    import jax.numpy as jnp

    from hite_tpu.ops.chain import chain_hsps_host
    from hite_tpu.ops.selfjoin import selfjoin_scan_packed, selfjoin_sorted
    from hite_tpu.pipeline.coarse import _chunk_grid
    from hite_tpu.pipeline.copies import _chunk_slicer

    lcfg, acfg = cfg.ltr, cfg.align
    flat_d, L = genome.device_flat_padded(True)
    Lp = int(flat_d.shape[0])
    halo = 2 * lcfg.max_ltr_len + lcfg.max_interior
    out, seen = [], set()

    def one_chunk(chunk_d, off, Cl):
        s_dbin, s_qpos, s_spos, n_pairs_d = selfjoin_sorted(
            chunk_d, k=acfg.kmer_size, window=4, diag_band=32)
        need = -(-max(int(n_pairs_d), 1) // (1 << 20))
        slices = min(1 if need <= 1 else 1 << (need - 1).bit_length(), 64)
        packed = np.asarray(selfjoin_scan_packed(
            s_dbin, s_qpos, s_spos, n_pairs_d, k=acfg.kmer_size,
            run_gap=96, min_seeds=4, min_hsp_len=30, max_hsps=32_768,
            max_seed_pairs=1 << 20, budget_slices=slices))
        qs, qe, ss, se = (packed[i].astype(np.int64) for i in range(4))
        valid = packed[4].astype(bool)
        m = valid & (ss < Cl) & (ss > qs)
        offd = ss - qs
        m &= (offd >= lcfg.min_ltr_len + lcfg.min_interior - 400)
        m &= offd <= halo
        if not m.any():
            return
        ch = chain_hsps_host(qs[m], qe[m], ss[m], se[m],
                             extend_threshold=200, min_len=lcfg.min_ltr_len)
        for a, b_, c, d in ch:
            gap = c - b_
            ltr_len = min(b_ - a, d - c)
            if not (lcfg.min_ltr_len <= ltr_len <= lcfg.max_ltr_len):
                continue
            if not (lcfg.min_interior - 200 <= gap <= lcfg.max_interior):
                continue
            if b_ > c:
                continue
            key = tuple(int(x) // 10 for x in
                        (off + a, off + b_, off + c, off + d))
            if key in seen:
                continue
            seen.add(key)
            out.append((off + int(a), off + int(b_), off + int(c),
                        off + int(d)))

    assert Lp > cap
    sl = _chunk_slicer(cap)
    grid = _chunk_grid(L, cap, halo)
    for c0 in grid:
        one_chunk(sl(flat_d, jnp.int32(c0)), c0, cap)
    return out, len(grid)


def test_ltr_chunk_grid_matches_jax_replay(monkeypatch):
    from hite_tpu.genome import Genome as JaxGenome
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.pipeline import ltr
    from hite_tpu_torch.utils.log import COUNTERS

    bg, starts = _seam_genome()
    cfg, jcfg = _ltr_cfgs()
    jg = JaxGenome.from_dict({"chr1": bg.copy()})
    jg.init_mask()
    ref, n_chunks = _jax_ltr_pairs(jg, jcfg, CAP)

    monkeypatch.setattr(ltr, "LTR_CHUNK_BP", CAP)
    g = Genome.from_dict({"chr1": bg.copy()}, device="cpu")
    g.init_mask()
    COUNTERS.pop("ltr.candidates.chunks", None)
    got = ltr.ltr_pair_candidates(g, cfg)
    assert COUNTERS["ltr.candidates.chunks"] == n_chunks >= 5
    assert got == ref
    # every planted copy (each straddling a chunk end) is found whole
    for pos in starts:
        assert any(abs(a - pos) <= 50 and b - a >= 200 for a, b, _c, _d
                   in got), pos


@pytest.mark.parametrize("length,scale,hard", [(2_000_000, 3, False),
                                               (2_000_000, 1, True)])
def test_bench_builder_equals_bench(length, scale, hard):
    sys.path.insert(0, ROOT)
    from bench import build_bench_genome as ref_build
    from hite_tpu_torch.scripts.pan_run import build_bench_genome

    ref_g, ref_t = ref_build(length, scale=scale, hard=hard)
    g, t = build_bench_genome(length, scale=scale, hard=hard, device="cpu")
    assert g.flat.tobytes() == ref_g.flat.tobytes()
    assert g.names == ref_g.names
    assert t["intervals"].tobytes() == ref_t["intervals"].tobytes()
    assert t["classes"] == ref_t["classes"]
    assert list(t["families"]) == list(ref_t["families"])
    assert all(t["families"][k].tobytes() == ref_t["families"][k].tobytes()
               for k in ref_t["families"])
    # the extra "names" column: one family a planted span, of its class
    assert len(t["names"]) == len(t["classes"])
    prefix = {"TIR": "TIR", "Helitron": "HEL", "SINE": "SINE", "LTR": "LTR"}
    assert all(n.rsplit("_", 1)[0] == prefix[c] and n in t["families"]
               for n, c in zip(t["names"], t["classes"]))


def test_scale_run_build_only_subprocess():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "hite_tpu_torch.scripts.scale_run",
         "--build-only", "--mbp", "8", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
        check=True).stdout
    assert "built 8 Mbp genome, 117 planted copies, packed=False" in out


def test_scale_run_config_is_the_jax_scripts():
    """scale_run's config and coarse parameters are the JAX script's."""
    from hite_tpu.config import AlignConfig, PipelineConfig
    from hite_tpu.pipeline.coarse import CoarseParams
    from hite_tpu_torch.scripts.scale_run import build, run_config

    cfg, params = run_config()
    ref = PipelineConfig(annotate=True, recover=True,
                         align=AlignConfig(fixed_extend_base_threshold=2000))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(params) == dataclasses.asdict(CoarseParams(
        seg_len=262_144, pair_batch=64, stride=4, max_hits=4))
    from hite_tpu_torch.ops.pack2 import PackedFlat

    g, truth, packed = build(1, pack=True, device="cpu")
    assert packed and isinstance(g.flat, PackedFlat)
    assert len(truth["families"]) == 11


def hard_substrate_parity(mbp: int, out_dir: str) -> dict:
    """Both packages' run_pipeline on the hard bench substrate at `mbp`
    Mbp with bench.py's config, on the CPU: every output file compared,
    and each package's accuracy against the planted truth.  Too slow for
    the suite (about 10 min at 2 Mbp); run it as

        JAX_PLATFORMS=cpu python tests/test_torch_scale.py hard 2 OUT_DIR
    """
    import filecmp
    import json

    sys.path.insert(0, ROOT)
    from bench import accuracy_metrics as jax_accuracy
    from bench import build_bench_genome as jax_build
    from hite_tpu.config import AlignConfig as JA, PipelineConfig as JC
    from hite_tpu.pipeline.coarse import CoarseParams as JP
    from hite_tpu.pipeline.run import run_pipeline as jax_run
    from hite_tpu_torch.pipeline.run import run_pipeline
    from hite_tpu_torch.scripts import pan_run

    cfg, params = pan_run.pan_config()
    jcfg = JC(annotate=True, align=JA(fixed_extend_base_threshold=2000))
    jparams = JP(seg_len=262_144, pair_batch=64, stride=4, max_hits=4)
    g, truth = pan_run.build_bench_genome(mbp * 1_000_000, hard=True,
                                          device="cpu")
    jg, jtruth = jax_build(mbp * 1_000_000, hard=True)
    dirs = {k: os.path.join(out_dir, k) for k in ("torch", "jax")}
    res = run_pipeline(g, cfg, out_dir=dirs["torch"], coarse_params=params)
    jres = jax_run(jg, jcfg, out_dir=dirs["jax"], coarse_params=jparams)
    names = sorted(f for f in os.listdir(dirs["jax"])
                   if f != "stage_times.json" and not f.startswith("."))
    differ = [f for f in names if not filecmp.cmp(
        os.path.join(dirs["torch"], f), os.path.join(dirs["jax"], f),
        shallow=False)]
    acc = pan_run.accuracy_metrics(g, res, truth, cfg)
    jacc = jax_accuracy(jg, jres, jtruth, jcfg)
    out = dict(mbp=mbp, files=names, differ=differ, torch=acc, jax=jacc)
    print(json.dumps(out, default=int))
    return out


def helitron_families_parity(mbp: int, n_families: int) -> dict:
    """`n_families` Helitron families of the bench template (the shared
    TCTCTACTA head and CTAGT tail; interiors of 700 / 1200 bp) x 8 copies
    on an `mbp` Mbp genome, through both packages' run_pipeline with
    te_type="helitron" and bench.py's coarse parameters on the CPU: which
    families each accepts (the 100 Mbp scale run plants 24 of them).
    Run it as

        JAX_PLATFORMS=cpu python tests/test_torch_scale.py helitrons 4 24
    """
    import json

    from hite_tpu.config import AlignConfig as JA, PipelineConfig as JC
    from hite_tpu.genome import Genome as JaxGenome
    from hite_tpu.pipeline.coarse import CoarseParams as JP
    from hite_tpu.pipeline.run import run_pipeline as jax_run
    from hite_tpu_torch.config import AlignConfig, PipelineConfig
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.io.fasta import encode_seq
    from hite_tpu_torch.pipeline.coarse import CoarseParams
    from hite_tpu_torch.pipeline.run import run_pipeline

    L = mbp * 1_000_000
    rng = np.random.default_rng(7)
    bg = rng.integers(0, 4, L).astype(np.uint8)
    placed = []
    for f in range(n_families):
        te = np.concatenate([
            encode_seq("TCTCTACTA"),
            rng.integers(0, 4, (700, 1200)[f % 2]).astype(np.uint8),
            encode_seq("CAATGAACG" + "ACGTACGTA" + "CTAGT")])
        n = 0
        while n < 8:
            pos = int(rng.integers(1000, L - len(te) - 1000))
            if any(pos < e + 200 and pos + len(te) + 200 > s
                   for s, e, _ in placed):
                continue
            c = te.copy()
            m = rng.random(len(c)) < 0.02
            c[m] = (c[m] + rng.integers(1, 4, m.sum())) % 4
            bg[pos - 1], bg[pos + len(c)] = 0, 3
            bg[pos : pos + len(c)] = c
            placed.append((pos, pos + len(c), f))
            n += 1

    def found(acc):
        return [f for f in range(n_families) if any(
            a < e and b > s for a, b in acc for s, e, g in placed if g == f)]

    kw = dict(seg_len=262_144, pair_batch=64, stride=4, max_hits=4)
    res = run_pipeline(
        Genome.from_dict({"chr1": bg.copy()}, device="cpu"),
        PipelineConfig(te_type="helitron",
                       align=AlignConfig(fixed_extend_base_threshold=2000)),
        coarse_params=CoarseParams(**kw))
    jres = jax_run(
        JaxGenome.from_dict({"chr1": bg.copy()}),
        JC(te_type="helitron", align=JA(fixed_extend_base_threshold=2000)),
        coarse_params=JP(**kw))
    acc = res.helitron.accepted.intervals.tolist()
    jacc = jres.helitron.accepted.intervals.tolist()
    out = dict(mbp=mbp, families=n_families, torch_found=found(acc),
               jax_found=found(jacc), accepted_equal=acc == jacc)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    if sys.argv[1] == "helitrons":
        helitron_families_parity(int(sys.argv[2]), int(sys.argv[3]))
    else:
        hard_substrate_parity(int(sys.argv[2]), sys.argv[3])
