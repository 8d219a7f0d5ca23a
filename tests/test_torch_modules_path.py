"""The copy-verified modules and the low-copy rescue of hite_tpu_torch vs
hite_tpu, stage by stage.

Both sides replay `run_pipeline`'s stages 1-2b for the default
`te_type="all"`: tandem mask, selfjoin coarse discovery, genome index, the
TIR, Helitron and non-LTR gates, `prepare_families`, ONE shared copy join,
each module's verification, and `_rescue_low_copy` (structural TIR branch
and the TIRPeps / HelitronPeps domain scans), with their own package's
functions, on the CPU; every stage must agree exactly.  The port's
stage 2 is its `run.modules_stage`, with the gates, plans and shared join
it computes recorded on the way.  Then stages 3-5 (the FiLTR LTR stage,
library assembly, annotation) on both packages from the JAX package's
stage 1-2b results: LTR records, cross-class pools, every library dict
and every annotation hit equal.  Substrates: the 160 kbp
`pipeline_parity` genome and the 2 Mbp bench substrate (117 planted
copies of 11 families in all four classes); one JAX replay of each serves
every check.  This file runs the 2 Mbp substrate, and also the Helitron /
non-LTR scanners (LCV banks and scores, tail scan) alone and both
scenarios of `tests/test_rescue.py`; `test_torch_modules_path_160k.py`
runs the same checks on the 160 kbp genome in another process.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_tir_path import (  # noqa: F401  (autouse)
    _Recorded, _substrate, compile_cache,
)

torch.set_num_threads(2)

MODS = ("tir", "helitron", "non_ltr")


def _modules(port: bool):
    if port:
        from hite_tpu_torch import config, genome
        from hite_tpu_torch.pipeline import (
            coarse, copies, helitron, non_ltr, run, tir, verify,
        )
    else:
        from hite_tpu import config, genome
        from hite_tpu.pipeline import (
            coarse, copies, helitron, non_ltr, run, tir, verify,
        )
    return dict(config=config, genome=genome, coarse=coarse, copies=copies,
                helitron=helitron, non_ltr=non_ltr, run=run, tir=tir,
                verify=verify)


def _replay(port: bool, contigs, params_kw, align_kw):
    m = _modules(port)
    dev = {"device": "cpu"} if port else {}
    g = m["genome"].Genome.from_dict(contigs, **dev)
    cfg = m["config"].PipelineConfig(
        align=m["config"].AlignConfig(**align_kw)).with_genome_size(g.size)
    assert cfg.te_type == "all"
    params = m["coarse"].CoarseParams(**params_kw)
    g.init_mask()
    m["run"]._mask_tandem_regions(g)
    coarse = m["coarse"].coarse_discover(g, cfg.align, params)
    gindex = m["copies"].GenomeIndex(g, cfg.align, seg_len=params.seg_len)
    if port:
        # the port's stage 2 as run_pipeline runs it, its gates, plans and
        # shared join recorded on the way; the JAX side replays the
        # closure body of its run_pipeline step by step
        with _Recorded(m["run"]) as rec:
            mods = m["run"].modules_stage(g, coarse, cfg, gindex)
        gates, plans, sets = rec.gates, rec.plans_by_module(), rec.sets
    else:
        gates = {"tir": m["tir"].gate_tir(g, coarse, cfg),
                 "helitron": m["helitron"].gate_helitron(g, coarse, cfg),
                 "non_ltr": m["non_ltr"].gate_non_ltr(g, coarse, cfg)}
        plans = {k: m["verify"].prepare_families(g, v, cfg)
                 for k, v in gates.items() if len(v)}
        union = [(k, i) for k, pl in plans.items() for i in pl.prefetch_idx]
        sets = m["copies"].CopyFinder(gindex).find_copies(
            [plans[k].seqs[i] for k, i in union], min_coverage=0.9,
            max_copies=cfg.msa.max_copies)
        per_mod = {k: [] for k in plans}
        for (k, _i), cs in zip(union, sets):
            per_mod[k].append(cs)
        runners = {"tir": m["tir"].run_tir_detection,
                   "helitron": m["helitron"].run_helitron_detection,
                   "non_ltr": m["non_ltr"].run_non_ltr_detection}
        mods = {k: runners[k](g, coarse, cfg, gindex, gated=v,
                              plan=plans.get(k), rep_copy_sets=per_mod.get(k))
                for k, v in gates.items()}
    verified = {k: _snapshot(r) for k, r in mods.items()}
    low_copy = {k: r.low_copy.intervals.copy() for k, r in mods.items()}
    rescued = m["run"]._rescue_low_copy(g, cfg, **mods)
    return dict(genome=g, cfg=cfg, coarse=coarse, gindex=gindex, gates=gates,
                plans=plans, sets=sets, verified=verified, low_copy=low_copy,
                mods=mods, rescued=rescued)


def _snapshot(r):
    """A deep copy of a ModuleResult's fields (the rescue mutates it)."""
    return dict(accepted=r.accepted.intervals.copy(),
                meta={k: v.copy() for k, v in r.accepted.meta.items()},
                consensus=[c.copy() for c in r.consensus],
                copy_counts=list(r.copy_counts),
                low_copy=r.low_copy.intervals.copy())


def _same(a, b):
    assert np.array_equal(a["accepted"], b["accepted"])
    assert a["meta"].keys() == b["meta"].keys()
    for k in a["meta"]:
        assert np.array_equal(a["meta"][k], b["meta"][k]), k
    assert a["copy_counts"] == b["copy_counts"]
    assert len(a["consensus"]) == len(b["consensus"])
    assert all(np.array_equal(x, y)
               for x, y in zip(a["consensus"], b["consensus"]))
    assert np.array_equal(a["low_copy"], b["low_copy"])


@pytest.fixture(scope="module", params=("bench_2mbp",))
def runs(request):
    contigs, params_kw, align_kw = _substrate(request.param)
    return (request.param, _replay(False, contigs, params_kw, align_kw),
            _replay(True, contigs, params_kw, align_kw))


def test_gates_all_modules(runs):
    name, ref, got = runs
    assert np.array_equal(ref["coarse"], got["coarse"])
    for k in MODS:
        assert np.array_equal(ref["gates"][k], got["gates"][k]), k
    if name == "bench_2mbp":
        assert all(len(got["gates"][k]) for k in MODS)


def test_shared_join_and_plans(runs):
    _, ref, got = runs
    assert list(ref["plans"]) == list(got["plans"])
    for k in ref["plans"]:
        assert ref["plans"][k].prefetch_idx == got["plans"][k].prefetch_idx
        assert ref["plans"][k].rep_idx == got["plans"][k].rep_idx
    hits = lambda sets: [[(h.start, h.end, h.strand, h.nseeds) for h in s]
                         for s in sets]
    assert hits(ref["sets"]) == hits(got["sets"])


@pytest.mark.parametrize("mod", MODS)
def test_verified_module(runs, mod):
    name, ref, got = runs
    _same(ref["verified"][mod], got["verified"][mod])
    assert np.array_equal(ref["low_copy"][mod], got["low_copy"][mod])
    if name == "bench_2mbp" and mod != "tir":
        # the 2 planted Helitron and the 2 SINE families are accepted
        assert len(got["verified"][mod]["accepted"]) >= 2


def test_low_copy_rescue(runs):
    name, ref, got = runs
    assert ref["rescued"] == got["rescued"]
    for k in MODS:
        _same(_snapshot(ref["mods"][k]), _snapshot(got["mods"][k]))
    if name == "bench_2mbp":
        assert sum(len(v) for v in got["low_copy"].values()) > 0
    if name == "parity_160k":
        # the SINE family is labelled by length
        assert set(got["mods"]["non_ltr"].accepted.meta["te_type"]) == {"SINE"}


def test_modules_stage_equals_replay(runs):
    """The port's `run.modules_stage` gives, in the gate order tir,
    helitron, non_ltr, what the JAX replay of gates -> plans -> shared
    join -> three modules gives for te_type='all'."""
    _, ref, got = runs
    assert list(got["verified"]) == list(ref["verified"]) == list(MODS)
    for k in MODS:
        _same(ref["verified"][k], got["verified"][k])


# ---- stages 3-5 from the same stage 1-2b results

def _port_module(m):
    """A port ModuleResult holding the same families as a JAX one."""
    from hite_tpu_torch.pipeline.candidates import CandidateSet
    from hite_tpu_torch.pipeline.verify import ModuleResult

    return ModuleResult(
        accepted=CandidateSet(
            intervals=m.accepted.intervals.copy(),
            meta={k: v.copy() for k, v in m.accepted.meta.items()}),
        consensus=[c.copy() for c in m.consensus],
        low_copy=CandidateSet(intervals=m.low_copy.intervals.copy()),
        copy_counts=list(m.copy_counts))


def _jax_stages_3_4(rep, found):
    """The JAX run_pipeline's stage 3 closure body and stage 4."""
    from hite_tpu.models import bundled_model_path
    from hite_tpu.models.trainer import load_params
    from hite_tpu.pipeline.library import build_library
    from hite_tpu.pipeline.ltr import (
        LTRResult, classify_ltr_records, run_ltr_detection,
    )
    from hite_tpu.pipeline.ltr_deep import (
        cross_class_filter, deep_filter_records,
    )

    g, cfg, gindex = rep["genome"], rep["cfg"], rep["gindex"]
    g.mask_intervals((int(s), int(e)) for arr in found for s, e in arr)
    res = run_ltr_detection(g, cfg, gindex, seg_len=gindex.seg_len)
    kept = deep_filter_records(
        g, res.records, cfg, gindex,
        cnn_params=load_params(bundled_model_path("ltr_filter_cnn.pkl")))
    kept, pools = cross_class_filter(g, kept, cfg, gindex)
    ltr = LTRResult(records=kept, cross_class=pools)
    if ltr.records:
        classify_ltr_records(g, ltr.records, cfg)
    libs = build_library(g, cfg, ltr=ltr, **rep["mods"])
    return g.masked.copy(), ltr, libs


def _annotate(port, g, libs, cfg, gindex):
    """Stage 5 as run_pipeline runs it: the merged library on the genome's
    unmasked join."""
    if port:
        from hite_tpu_torch.pipeline.annotate import annotate_genome
    else:
        from hite_tpu.pipeline.annotate import annotate_genome
    return annotate_genome(g, libs["merged"], cfg, gindex)


def run_stages_3_5(name, rep):
    """Stages 3-5 on both packages from the JAX replay `rep` of stages
    1-2b: (JAX (masked, ltr, libs, hits), port (masked, ltr, libs, hits),
    launches).  The JAX side runs the body of its `run_pipeline`'s stage 3
    (masking with the families accepted before the rescue,
    `run_ltr_detection`, `deep_filter_records` with the bundled CNN,
    `cross_class_filter`, `classify_ltr_records`), stage 4
    (`build_library`) and stage 5 (`annotate_genome` with the merged
    library); the port runs `run.ltr_stage`, `run.library_stage` and
    `annotate.annotate_genome` from the tandem-masked genome and the JAX
    package's module families."""
    from hite_tpu_torch import kernels
    from hite_tpu_torch.config import AlignConfig, PipelineConfig
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.pipeline.copies import GenomeIndex
    from hite_tpu_torch.pipeline.run import library_stage, ltr_stage

    contigs, _params_kw, align_kw = _substrate(name)
    # run_pipeline masks with the families accepted BEFORE the rescue
    found = [rep["verified"][k]["accepted"] for k in MODS]
    masked = rep["genome"].masked.copy()
    mods = {k: _port_module(m) for k, m in rep["mods"].items()}
    ref = _jax_stages_3_4(rep, found)
    ref += (_annotate(False, rep["genome"], ref[2], rep["cfg"],
                      rep["gindex"]),)

    g = Genome.from_dict(contigs, device="cpu")
    g.masked = masked
    tcfg = PipelineConfig(align=AlignConfig(**align_kw)
                          ).with_genome_size(g.size)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(rep["cfg"])
    gindex = GenomeIndex(g, tcfg.align, seg_len=rep["gindex"].seg_len)
    kernels.reset_launches()
    ltr = ltr_stage(g, tcfg, gindex, found, seg_len=gindex.seg_len)
    libs = library_stage(g, tcfg, ltr=ltr, **mods)
    hits = _annotate(True, g, libs, tcfg, gindex)
    return ref, (g.masked.copy(), ltr, libs, hits), dict(kernels.LAUNCHES)


@pytest.fixture(scope="module")
def stages(runs):
    """Stages 3-5 after the stage 1-2b checks of the same substrate (the
    JAX side masks the replayed genome)."""
    name, ref, _got = runs
    return (name,) + run_stages_3_5(name, ref)


def test_ltr_stage(stages):
    """Stage 3: the masked genome, every LTR record and cross-class pool
    equal."""
    name, ref, got, _ = stages
    (jm, jltr), (tm, tltr) = ref[:2], got[:2]
    assert np.array_equal(jm, tm)
    assert [dataclasses.asdict(r) for r in jltr.records] == \
        [dataclasses.asdict(r) for r in tltr.records]
    assert list(jltr.cross_class) == list(tltr.cross_class)
    for k in jltr.cross_class:
        assert [v.tolist() for v in jltr.cross_class[k]] == \
            [v.tolist() for v in tltr.cross_class[k]]
    assert len(tltr.records) >= (4 if name == "bench_2mbp" else 1)


def test_library_stage(stages):
    """Stage 4: every library dict equal, name for name and base for
    base; the merged library holds the planted families' classes (the
    DNA, RC/Helitron, SINE and LTR ones on the bench substrate); the SW
    ran on the CPU's plain versions."""
    name, ref, got, launches = stages
    jl, tl = ref[2], got[2]
    assert list(jl) == list(tl)
    for key in jl:
        assert list(jl[key]) == list(tl[key]), key
        for n in jl[key]:
            assert np.array_equal(jl[key][n], tl[key][n]), n
    labels = {n.partition("#")[2].split("/")[0] for n in tl["merged"]}
    want = {"DNA", "SINE", "LTR"} | ({"RC"} if name == "bench_2mbp" else set())
    assert want <= labels
    assert launches == {"sw": 0, "sw_protein": 0,
                        "libjoin_fill": 0}     # CPU: plain versions


def test_annotation(stages):
    """Stage 5 on the merged library: every hit equal in every field;
    identities (float64 ratios of the SW rescore's exact counts) compared
    exactly; the planted copies are annotated."""
    name, ref, got, _ = stages
    assert [dataclasses.asdict(h) for h in ref[3]] == \
        [dataclasses.asdict(h) for h in got[3]]
    if name == "bench_2mbp":
        assert len(got[3]) >= 100
    else:
        assert len(got[3]) >= 10
        assert any(h.full_length for h in got[3])


# ---- the Helitron and non-LTR scanners alone

def test_lcv_banks_identical():
    from hite_tpu.ops import lcv as jlcv
    from hite_tpu_torch.ops import lcv as tlcv

    for a, b in zip(jlcv.default_banks(), tlcv.default_banks()):
        for f in a._fields:
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    head, tail = tlcv.default_banks()
    assert (len(head.width), len(tail.width)) == (745, 1002)
    for a, b in zip(jlcv._pad_patterns(jlcv.default_banks()[1]),
                    tlcv._pad_patterns(tail)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("B,L,tile", [(4, 300, 128), (3, 1000, 2048),
                                      (8, 257, 64)])
def test_lcv_scores(B, L, tile):
    """Per-position scores and widths, N rows and several tiles; planted
    bench Helitron termini score."""
    import jax.numpy as jnp

    from hite_tpu.io.fasta import encode_seq
    from hite_tpu.ops import lcv as jlcv
    from hite_tpu_torch.ops import lcv as tlcv

    rng = np.random.default_rng(B * L)
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    head = encode_seq("TCTCTACTA")
    tail = encode_seq("CAATGAACGACGTACGTACTAGT")
    seqs[0, 20 : 20 + len(head)] = head
    seqs[0, L - 60 : L - 60 + len(tail)] = tail
    seqs[1, 40:90] = 4
    seqs[-1] = 4
    for jb, tb in zip(jlcv.default_banks(), tlcv.default_banks()):
        ref = jlcv.lcv_scores(jnp.asarray(seqs), jb, tile=tile)
        got = tlcv.lcv_scores(torch.from_numpy(seqs), tb, tile=tile)
        for r, g in zip(ref, got):
            assert np.array_equal(np.asarray(r), g.numpy())
        assert int(got[0][0].max()) > 0


def test_lcv_scores_budget_tiles(monkeypatch):
    """A budget smaller than one tile cuts positions into smaller tiles
    and changes no score."""
    from hite_tpu_torch.ops import lcv as tlcv

    rng = np.random.default_rng(3)
    seqs = torch.from_numpy(rng.integers(0, 5, (2, 500)).astype(np.uint8))
    bank = tlcv.default_banks()[0]
    ref = tlcv.lcv_scores(seqs, bank, tile=512)
    monkeypatch.setattr(tlcv, "TILE_BUDGET_BYTES", 2 * 1200 * 4 * 37)
    got = tlcv.lcv_scores(seqs, bank, tile=512)
    for r, g in zip(ref, got):
        assert torch.equal(r, g)


def test_tail_scan():
    import jax.numpy as jnp

    from hite_tpu.ops.tail import tail_scan as jax_tail
    from hite_tpu_torch.ops.tail import tail_scan

    rng = np.random.default_rng(12)
    B, L = 16, 200
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = rng.integers(20, L + 1, B).astype(np.int32)
    for r in range(B):
        e = lens[r]
        kind = r % 4
        if kind == 0:
            seqs[r, e - 14 : e] = 0
        elif kind == 1:
            seqs[r, e - 12 : e - 3] = 3
        elif kind == 2:
            seqs[r, e - 18 : e] = np.tile(np.array([0, 2, 1], np.uint8), 6)
    seqs[5, 150:] = 4
    lens[6] = 0
    ref = jax_tail(jnp.asarray(seqs), jnp.asarray(lens))
    got = tail_scan(torch.from_numpy(seqs), torch.from_numpy(lens))
    for f in ref._fields:
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              getattr(got, f).numpy()), f


@pytest.fixture(scope="module")
def small_genomes():
    """A 60 kbp genome with planted Helitron and SINE copies (bench
    construction), on both packages."""
    from hite_tpu.genome import Genome as JaxGenome
    from hite_tpu.io.fasta import encode_seq
    from hite_tpu_torch.genome import Genome

    rng = np.random.default_rng(9)
    bg = rng.integers(0, 4, 60_000).astype(np.uint8)
    hel = np.concatenate([encode_seq("TCTCTACTA"),
                          rng.integers(0, 4, 700).astype(np.uint8),
                          encode_seq("CAATGAACGACGTACGTACTAGT")])
    sine = np.concatenate([rng.integers(0, 4, 280).astype(np.uint8),
                           np.zeros(14, np.uint8)])
    ivs = []
    for pos in (3_000, 13_000, 23_000):
        bg[pos - 1], bg[pos + len(hel)] = 0, 3
        bg[pos : pos + len(hel)] = hel
        ivs.append((pos - 30, pos + len(hel) + 30))
    for pos in (33_000, 43_000, 53_000):
        t = rng.integers(0, 4, 12).astype(np.uint8)
        bg[pos - 12 : pos] = t
        bg[pos + len(sine) : pos + len(sine) + 12] = t
        bg[pos : pos + len(sine)] = sine
        ivs.append((pos, pos + len(sine)))
    ivs.append((40_000, 41_000))
    ivs = np.array(ivs, np.int64)
    return (JaxGenome.from_dict({"chr1": bg}),
            Genome.from_dict({"chr1": bg}, device="cpu"), ivs)


def test_lcv_gate_and_tail_gate(small_genomes):
    from hite_tpu.config import PipelineConfig as JaxConfig
    from hite_tpu.pipeline import helitron as jh, non_ltr as jn
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.pipeline import helitron as th, non_ltr as tn

    jg, tg, ivs = small_genomes
    jc, tc = JaxConfig(), PipelineConfig()
    ref = jh.lcv_gate(jg, ivs, jc)
    got = th.lcv_gate(tg, ivs, tc)
    assert np.array_equal(ref, got) and len(got) >= 3
    ref = jn.tail_gate(jg, ivs, jc)
    got = tn.tail_gate(tg, ivs, tc)
    assert np.array_equal(ref, got) and len(got) >= 3
    assert np.array_equal(jh.gate_helitron(jg, ivs, jc),
                          th.gate_helitron(tg, ivs, tc))
    assert np.array_equal(jn.gate_non_ltr(jg, ivs, jc),
                          tn.gate_non_ltr(tg, ivs, tc))


def test_gate_helitron_rejects_eahelitron(small_genomes):
    """The EAHelitron union (`cfg.helitron.use_eahelitron`): once refused
    by the port, it now runs and gates exactly as the JAX package does."""
    import dataclasses

    from hite_tpu.config import PipelineConfig as JaxConfig
    from hite_tpu.pipeline import helitron as jh
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.pipeline import helitron as th

    jg, tg, ivs = small_genomes
    jc, tc = JaxConfig(), PipelineConfig()
    jc = jc.replace(helitron=dataclasses.replace(jc.helitron,
                                                 use_eahelitron=True))
    tc = tc.replace(helitron=dataclasses.replace(tc.helitron,
                                                 use_eahelitron=True))
    assert np.array_equal(jh.gate_helitron(jg, ivs, jc),
                          th.gate_helitron(tg, ivs, tc))


# ---- the two scenarios of tests/test_rescue.py, on both packages

CODON = {"A": "GCA", "R": "CGA", "N": "AAC", "D": "GAC", "C": "TGC",
         "Q": "CAA", "E": "GAA", "G": "GGA", "H": "CAC", "I": "ATC",
         "L": "CTA", "K": "AAA", "M": "ATG", "F": "TTC", "P": "CCA",
         "S": "TCA", "T": "ACA", "W": "TGG", "Y": "TAC", "V": "GTA", "X": "GCA"}


def _rescue_scenario(name):
    """(background, low-copy intervals) of a test_rescue.py scenario."""
    from hite_tpu_torch.io.fasta import encode_seq
    from hite_tpu_torch.ops.protein import decode_protein
    from hite_tpu_torch.pipeline.domain import read_protein_fasta
    from hite_tpu_torch.pipeline.run import DATA_DIR

    if name == "domain":
        lib = read_protein_fasta(os.path.join(DATA_DIR, "protein",
                                              "TIRPeps.lib"))
        _n, codes = min(lib.items(), key=lambda kv: abs(len(kv[1]) - 160))
        nt = "".join(CODON.get(a, "GCA") for a in decode_protein(codes))
        bg = np.random.default_rng(0).integers(0, 4, 20_000).astype(np.uint8)
        dom = encode_seq(nt)
        bg[5_000 : 5_000 + len(dom)] = dom
        return bg, np.array([[4_900, 5_000 + len(dom) + 100],
                             [12_000, 12_600]])
    rng = np.random.default_rng(11)
    bg = rng.integers(0, 4, 30_000).astype(np.uint8)
    t = rng.integers(0, 4, 20).astype(np.uint8)
    te = np.concatenate([t, rng.integers(0, 4, 500).astype(np.uint8),
                         (3 - t)[::-1]])
    pos = 5_000
    tsd = rng.integers(0, 4, 5).astype(np.uint8)
    bg[pos - 5 : pos] = tsd
    bg[pos + len(te) : pos + len(te) + 5] = tsd
    bg[pos : pos + len(te)] = te
    unit = rng.integers(0, 4, 6).astype(np.uint8)
    bg[12_000:12_600] = np.tile(unit, 100)
    return bg, np.array([[pos, pos + len(te)], [12_000, 12_600],
                         [20_000, 20_600]])


@pytest.mark.parametrize("scenario", ["domain", "structure"])
def test_rescue_scenarios(scenario):
    from hite_tpu_torch import kernels

    bg, low = _rescue_scenario(scenario)
    out = {}
    for port in (False, True):
        m = _modules(port)
        g = m["genome"].Genome.from_dict({"chr1": bg},
                                         **({"device": "cpu"} if port else {}))
        cs = __import__(f"{m['run'].__name__.split('.')[0]}.pipeline."
                        "candidates", fromlist=["x"]).CandidateSet
        mod = m["verify"].ModuleResult(
            accepted=cs(intervals=np.zeros((0, 2), np.int64)), consensus=[],
            low_copy=cs(intervals=low.copy()), copy_counts=[])
        n = m["run"]._rescue_low_copy(g, m["config"].PipelineConfig(),
                                      tir=mod)
        out[port] = (n, _snapshot(mod))
    assert out[False][0] == out[True][0] == 1
    _same(out[False][1], out[True][1])
    assert out[True][1]["accepted"][0, 0] == low[0, 0]
    assert kernels.LAUNCHES["sw_protein"] == 0   # CPU: the plain version
