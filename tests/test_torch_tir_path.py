"""The TIR discovery path of hite_tpu_torch vs hite_tpu, stage by stage.

Both sides replay `run_pipeline`'s stages for `te_type="tir"` up to the
TIR module's verified families — tandem mask, selfjoin coarse discovery,
genome index, TIR gate, `prepare_families`, the shared copy join and
`run_tir_detection` — on the CPU, and every stage must agree exactly: the
JAX side with its package's functions one by one, the port side through
its `run.modules_stage` with each intermediate recorded.  Substrates: the
160 kbp `pipeline_parity` genome (its CoarseParams chunk the selfjoin),
the same cut into two contigs, and the 2 Mbp bench substrate with
defaults.
"""

import contextlib
import copy
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


@contextlib.contextmanager
def jax_compile_cache():
    """JAX's persistent compilation cache in the checkout's .jax_cache/
    (gitignored) while the block runs, then the settings it found.  The
    parity files replay the JAX package on the same substrates in separate
    xdist processes, and so a process loads what another one compiled; the
    JAX package's own tests, in the same processes, run without it."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    new = {"jax_compilation_cache_dir": os.path.join(
               os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
               ".jax_cache"),
           "jax_persistent_cache_min_compile_time_secs": 0.2}
    old = {k: getattr(jax.config, k) for k in new}
    for k, v in new.items():
        jax.config.update(k, v)
    cc.reset_cache()
    try:
        yield
    finally:
        for k, v in old.items():
            jax.config.update(k, v)
        cc.reset_cache()


@pytest.fixture(scope="module", autouse=True)
def compile_cache():
    """`jax_compile_cache` around a parity module (import it to use it)."""
    with jax_compile_cache():
        yield


SUBSTRATES = ("parity_160k", "two_contigs", "bench_2mbp")


def _parity_genome() -> np.ndarray:
    """The 160 kbp parity genome (`pan_run.parity_genome_codes`)."""
    from hite_tpu_torch.scripts import pan_run

    return pan_run.parity_genome_codes()


def _substrate(name):
    """({contig: codes}, CoarseParams kwargs, AlignConfig kwargs)."""
    from hite_tpu_torch.scripts import pan_run

    small = dict(pan_run.SMALL_COARSE)
    if name == "parity_160k":
        return ({"chr1": _parity_genome()}, small,
                dict(fixed_extend_base_threshold=2000))
    if name == "diverged":
        # families at 5-20% per-copy divergence, copy counts across the
        # boundary engine's homology tiers (the port's builder, which
        # `chip_smoke.py` runs on the card too)
        codes, _truth = pan_run.diverged_genome_codes()
        return ({"chr1": codes}, small,
                dict(fixed_extend_base_threshold=2000))
    if name == "two_contigs":
        # the same sequence cut into two contigs (spacer, contig-bounded
        # extraction and the contig key of the copy chaining)
        bg = _parity_genome()
        return ({"chrA": bg[:85_000], "chrB": bg[85_000:]},
                dict(small, max_selfjoin_bp=1 << 26),
                dict(fixed_extend_base_threshold=2000))
    from bench import build_bench_genome

    g, _ = build_bench_genome(2_000_000)
    return {"chr1": g.flat[: g.size].copy()}, {}, {}


def _modules(port: bool):
    if port:
        from hite_tpu_torch import config, genome
        from hite_tpu_torch.pipeline import coarse, copies, run, tir, verify
    else:
        from hite_tpu import config, genome
        from hite_tpu.pipeline import coarse, copies, run, tir, verify
    return config, genome, coarse, copies, run, tir, verify


class _Recorded:
    """What the port's `run.modules_stage` computed on its way: each gate's
    intervals, each module's plan and the shared join's copy sets, recorded
    by wrapping the functions it calls (in `pipeline.run`'s namespace)
    for the length of the `with` block."""

    NAMES = ("gate_tir", "gate_helitron", "gate_non_ltr",
             "prepare_families", "CopyFinder")

    def __init__(self, run):
        self.run = run
        self.gates, self.plans, self.sets = {}, [], None

    def __enter__(self):
        self.saved = {n: getattr(self.run, n) for n in self.NAMES}
        rec = self

        def gate(key, fn):
            def wrapped(*a, **kw):
                out = fn(*a, **kw)
                rec.gates[key] = out.copy()
                return out
            return wrapped

        def prepare(*a, **kw):
            out = self.saved["prepare_families"](*a, **kw)
            rec.plans.append(copy.deepcopy(out))
            return out

        class Finder(self.saved["CopyFinder"]):
            def find_copies(self, *a, **kw):
                out = super().find_copies(*a, **kw)
                if rec.sets is None:
                    rec.sets = copy.deepcopy(out)
                return out

        for key in ("tir", "helitron", "non_ltr"):
            setattr(self.run, f"gate_{key}", gate(key,
                                                  self.saved[f"gate_{key}"]))
        self.run.prepare_families = prepare
        self.run.CopyFinder = Finder
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.run, n, fn)

    def plans_by_module(self):
        keys = [k for k, g in self.gates.items() if len(g)]
        assert len(keys) == len(self.plans)
        return dict(zip(keys, self.plans))


def _replay(port: bool, contigs, params_kw, align_kw):
    config, genome_m, coarse_m, copies_m, run_m, tir_m, verify_m = \
        _modules(port)
    dev = {"device": "cpu"} if port else {}
    g = genome_m.Genome.from_dict(contigs, **dev)
    cfg = config.PipelineConfig(
        te_type="tir", align=config.AlignConfig(**align_kw)
    ).with_genome_size(g.size)
    params = coarse_m.CoarseParams(**params_kw)
    g.init_mask()
    run_m._mask_tandem_regions(g)
    coarse = coarse_m.coarse_discover(g, cfg.align, params)
    gindex = copies_m.GenomeIndex(g, cfg.align, seg_len=params.seg_len)
    mods = None
    if port:
        # the port's stage 2 as run_pipeline runs it (`run.modules_stage`),
        # its gate, plan and join recorded on the way; the JAX side replays
        # the closure body of its run_pipeline step by step
        with _Recorded(run_m) as rec:
            mods = run_m.modules_stage(g, coarse, cfg, gindex)
        gated, (plan,), sets = rec.gates["tir"], rec.plans, rec.sets
        seqs = [plan.seqs[i] for i in plan.prefetch_idx]
        result = mods["tir"]
    else:
        gated = tir_m.gate_tir(g, coarse, cfg)
        plan = verify_m.prepare_families(g, gated, cfg)
        seqs = [plan.seqs[i] for i in plan.prefetch_idx]
        sets = copies_m.CopyFinder(gindex).find_copies(
            seqs, min_coverage=0.9, max_copies=cfg.msa.max_copies)
        result = tir_m.run_tir_detection(g, coarse, cfg, gindex, gated=gated,
                                         plan=plan, rep_copy_sets=sets)
    return dict(genome=g, cfg=cfg, params=params, coarse=coarse,
                gindex=gindex, gated=gated, plan=plan, seqs=seqs, sets=sets,
                result=result, mods=mods)


@pytest.fixture(scope="module", params=SUBSTRATES)
def runs(request):
    contigs, params_kw, align_kw = _substrate(request.param)
    return (request.param, _replay(False, contigs, params_kw, align_kw),
            _replay(True, contigs, params_kw, align_kw))


def _hits(sets):
    return [[(h.start, h.end, h.strand, h.nseeds) for h in s] for s in sets]


def _same_result(a, b):
    assert np.array_equal(a.accepted.intervals, b.accepted.intervals)
    assert a.copy_counts == b.copy_counts
    assert len(a.consensus) == len(b.consensus)
    for x, y in zip(a.consensus, b.consensus):
        assert np.array_equal(x, y)
    assert np.array_equal(a.low_copy.intervals, b.low_copy.intervals)


def test_tandem_masked_genome(runs):
    _, ref, got = runs
    assert np.array_equal(ref["genome"].masked, got["genome"].masked)


def test_coarse_intervals(runs):
    _, ref, got = runs
    assert ref["coarse"].shape == got["coarse"].shape
    assert np.array_equal(ref["coarse"], got["coarse"])
    assert len(got["coarse"]) > 0


def test_gated_intervals(runs):
    _, ref, got = runs
    assert np.array_equal(ref["gated"], got["gated"])
    assert len(got["gated"]) > 0


def test_verify_plan(runs):
    _, ref, got = runs
    a, b = ref["plan"], got["plan"]
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "seqs":
            assert len(x) == len(y)
            assert all(np.array_equal(p, q) for p, q in zip(x, y))
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def test_copy_hits(runs):
    _, ref, got = runs
    assert _hits(ref["sets"]) == _hits(got["sets"])
    assert sum(map(len, got["sets"])) > 0


def test_module_result(runs):
    name, ref, got = runs
    _same_result(ref["result"], got["result"])
    if name == "bench_2mbp":
        # the 3 planted TIR families, with their copy counts
        assert got["result"].copy_counts == [20, 15, 10]


def test_modules_stage_equals_replay(runs):
    """`run.modules_stage` (the closure body of `run_pipeline`) runs
    exactly the replayed gate -> plan -> shared join -> TIR module: the
    port side of the checks above is its run, with its gate, plan and join
    recorded; it runs the TIR module alone, and its families equal the JAX
    replay's."""
    _, ref, got = runs
    assert list(got["mods"]) == ["tir"]
    _same_result(ref["result"], got["mods"]["tir"])


def _chunked_hits(Finder, side, Lp, modes):
    """{min_abs_len: hits} of `Finder` on the side's genome index and
    candidates with `max_libjoin_bp` at Lp / 2 (3 overlapping chunks)."""
    finder = Finder(side["gindex"])
    finder.max_libjoin_bp = Lp // 2
    return {m: _hits(finder.find_copies(side["seqs"], min_coverage=0.9,
                                        max_copies=100, min_abs_len=m))
            for m in modes}


def _chunked_modes(name):
    # fragment hits (the tight-diagonal second chaining pass) too, on the
    # small genomes
    return [0] if name == "bench_2mbp" else [0, 80]


def test_chunked_libjoin(runs):
    """CopyFinder past `max_libjoin_bp`: the chunked `libjoin_pairs` path,
    equal in both packages and to the JAX package's committed hits
    (`data/reference/chunked_join.json`, which `chip_smoke.py` holds the
    card's chunked joins to)."""
    from hite_tpu.pipeline.copies import CopyFinder as JaxFinder
    from hite_tpu_torch.pipeline.copies import CopyFinder as TorchFinder
    from hite_tpu_torch.scripts import reference

    name, ref, got = runs
    Lp = got["genome"].device_flat_padded()[0].shape[0]
    modes = _chunked_modes(name)
    jax_hits = _chunked_hits(JaxFinder, ref, Lp, modes)
    port_hits = _chunked_hits(TorchFinder, got, Lp, modes)
    committed = reference.load("chunked_join")["substrates"][name]
    for m in modes:
        assert jax_hits[m] == port_hits[m]
        assert sum(map(len, port_hits[m])) > 0
        assert [list(map(list, h)) for h in jax_hits[m]] == \
            committed["hits"][str(m)]
    assert committed["lp"] == Lp
    assert committed["seqs"] == ["".join("ACGTN"[c] for c in q)
                                 for q in ref["seqs"]]


def _jax_helitron_stage(genome, coarse, cfg, gindex):
    """The JAX `run_pipeline` closure `_modules_stage` for te_type
    "helitron": the gate, one prefetch join, the verified module."""
    from hite_tpu.pipeline.copies import CopyFinder
    from hite_tpu.pipeline.helitron import (
        gate_helitron, run_helitron_detection,
    )
    from hite_tpu.pipeline.verify import prepare_families

    gated = gate_helitron(genome, coarse, cfg)
    plan = prepare_families(genome, gated, cfg) if len(gated) else None
    sets = None
    if plan is not None and plan.prefetch_idx:
        sets = CopyFinder(gindex).find_copies(
            [plan.seqs[i] for i in plan.prefetch_idx], min_coverage=0.9,
            max_copies=cfg.msa.max_copies)
    return {"helitron": run_helitron_detection(
        genome, coarse, cfg, gindex, gated=gated, plan=plan,
        rep_copy_sets=sets)}


def test_modules_stage_rejects_eahelitron(runs):
    """`modules_stage` with the EAHelitron union on
    (`cfg.helitron.use_eahelitron`, te_type "helitron"): once refused by
    the port, it now runs and equals the JAX package's stage, accepted
    families, consensus, copy counts and low-copy set alike."""
    from hite_tpu_torch.pipeline.run import modules_stage

    _, ref, got = runs
    out = []
    for side, fn in ((ref, _jax_helitron_stage), (got, modules_stage)):
        cfg = side["cfg"].replace(
            te_type="helitron",
            helitron=dataclasses.replace(side["cfg"].helitron,
                                         use_eahelitron=True))
        out.append(fn(side["genome"], side["coarse"], cfg, side["gindex"]))
    assert list(out[0]) == list(out[1]) == ["helitron"]
    _same_result(out[0]["helitron"], out[1]["helitron"])


def test_chip_smoke_substrate_is_the_bench_substrate():
    """chip_smoke.py's own copy of the bench planting code builds the same
    genome, the same planted TIR, Helitron, SINE and LTR copies and the
    same family sequences (BM_RM2's gold library) as bench.py."""
    import chip_smoke
    from bench import build_bench_genome

    g, truth = build_bench_genome(2_000_000)
    codes, fams, seqs = chip_smoke.build_bench_genome(2_000_000)
    assert np.array_equal(codes, g.flat[: g.size])
    assert list(seqs) == list(truth["families"])
    assert all(np.array_equal(seqs[n], truth["families"][n]) for n in seqs)
    n_fams = {"TIR": 3, "Helitron": 2, "SINE": 2, "LTR": 4}
    assert set(fams) == set(n_fams)
    for cls, n in n_fams.items():
        want = [tuple(iv) for iv, k in zip(truth["intervals"].tolist(),
                                           truth["classes"]) if k == cls]
        got = [c for f in sorted(fams[cls]) for c in fams[cls][f]]
        assert got == want, cls
        assert len(fams[cls]) == n


def test_genome_layout_identical():
    """Genome.from_dict: the same flat layout, contig table and mask."""
    from hite_tpu.genome import Genome as JaxGenome
    from hite_tpu.genome import synthetic_genome as jax_synth
    from hite_tpu_torch.genome import Genome, synthetic_genome

    rng = np.random.default_rng(2)
    seqs = {"a": rng.integers(0, 5, 3000).astype(np.uint8),
            "b": rng.integers(0, 4, 10).astype(np.uint8),
            "c": rng.integers(0, 4, 2100).astype(np.uint8)}
    ref, got = JaxGenome.from_dict(seqs), Genome.from_dict(seqs, device="cpu")
    assert np.array_equal(ref.flat, got.flat)
    assert ref.names == got.names
    assert np.array_equal(ref.starts, got.starts)
    assert np.array_equal(ref.lengths, got.lengths)
    for g in (ref, got):
        g.init_mask()
        g.mask_intervals([(10, 50), (3070, 3090), (5000, 9999)])
    assert np.array_equal(ref.masked, got.masked)
    pos = np.array([0, 2999, 3000, 3063, 3064, 3100, 5300])
    for r, t in zip(ref.contig_of(pos), got.contig_of(pos)):
        assert np.array_equal(r, t)
    assert np.array_equal(ref.in_contig(pos, pos + 40),
                          got.in_contig(pos, pos + 40))
    for s, e, f in ((5, 60, 0), (2990, 3010, 30), (3064, 3074, 100)):
        assert np.array_equal(ref.extract(s, e, f), got.extract(s, e, f))
        assert ref.extract_str(s, e, f) == got.extract_str(s, e, f)
        assert ref.location_str(s, e, "-") == got.location_str(s, e, "-")
    assert [ref.to_flat(n, 7) for n in seqs] == \
        [got.to_flat(n, 7) for n in seqs]
    rd, gd = ref.to_dict(), got.to_dict()
    assert list(rd) == list(gd)
    assert all(np.array_equal(rd[n], gd[n]) for n in rd)
    tes = ["ACGTTGCA" * 40, "GATTACA" * 30]
    (rg, ri), (tg, ti) = (jax_synth(20_000, tes, [3, 2], seed=4,
                                    tsd_lens=[5, 0]),
                          synthetic_genome(20_000, tes, [3, 2], seed=4,
                                           tsd_lens=[5, 0], device="cpu"))
    assert np.array_equal(rg.flat, tg.flat) and ri == ti


def test_device_cache_dropped_by_masking():
    """Masked-stream device buffers are dropped when masking changes the
    genome; unmasked ones stay (the JAX package's key rule)."""
    from hite_tpu_torch.genome import Genome

    g = Genome.from_dict({"c": np.zeros(5000, np.uint8)}, device="cpu")
    g.init_mask()
    flat_u, _ = g.device_flat_padded(False)
    flat_m, _ = g.device_flat_padded(True)
    g._device_cache[("join_sorted", True, 12, None)] = (flat_m,)
    assert g.mask_intervals([(100, 200)]) == 100
    assert set(g._device_cache) == {("flat_pow2", False)}
    assert g.device_flat_padded(False)[0] is flat_u
    assert int((g.device_flat_padded(True)[0][:5000] == 4).sum()) == 100


def write_chunked_reference():
    """Write `data/reference/chunked_join.json`: for each substrate the
    JAX package's forced-chunked CopyFinder hits (`_chunked_hits`), the
    candidates, the padded length, the input codes' digest and the
    settings the card needs to rebuild the genome index."""
    import json

    from hite_tpu.pipeline.copies import CopyFinder as JaxFinder
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.scripts import reference

    out = {}
    with jax_compile_cache():
        for name in SUBSTRATES:
            contigs, params_kw, align_kw = _substrate(name)
            ref = _replay(False, contigs, params_kw, align_kw)
            Lp = int(Genome.from_dict(contigs, device="cpu")
                     .device_flat_padded()[0].shape[0])
            hits = _chunked_hits(JaxFinder, ref, Lp, _chunked_modes(name))
            out[name] = {
                "input_sha256": reference.codes_sha256(contigs),
                "contigs": list(contigs), "coarse": params_kw,
                "align": align_kw, "lp": Lp,
                "seqs": ["".join("ACGTN"[c] for c in q)
                         for q in ref["seqs"]],
                "hits": {str(m): [list(map(list, h)) for h in v]
                         for m, v in hits.items()}}
            print(name, Lp, len(ref["seqs"]),
                  {m: sum(map(len, v)) for m, v in hits.items()})
    with open(reference.path("chunked_join"), "w") as fh:
        json.dump({"what": "hite_tpu CopyFinder hits with max_libjoin_bp "
                           "= lp / 2 (tests/test_torch_tir_path.py "
                           "write-chunked)", "substrates": out}, fh)
        fh.write("\n")


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if sys.argv[1:] == ["write-chunked"]:
        write_chunked_reference()
    else:
        sys.exit("usage: python tests/test_torch_tir_path.py write-chunked")
