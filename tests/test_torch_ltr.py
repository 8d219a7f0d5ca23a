"""The FiLTR LTR stage of hite_tpu_torch vs hite_tpu, function by function.

Both sides run, with their own package's functions on the CPU, the LTR
chain on a tandem-masked genome: self-join pair candidates, SW terminal
refinement, the recombination and dirty-record pre-filters,
`run_ltr_detection` (copy counts), `deep_filter_records` with the bundled
LTR CNN, `cross_class_filter` and `classify_ltr_records`; every record
must agree in every field.  Substrate: the 160 kbp `pipeline_parity`
genome (3 LTR copies at 130-150 kbp); `test_torch_ltr_cnn.py` runs the
same chain on a genome whose LTR family has 7 copies, so that the CNN
confirm runs.  Also the frame pipeline on real frames of that genome, the
FiLTR filter scenarios of `tests/test_ltr_filters.py`, and one refinement
at SW width 8192.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

# the 7-copy LTR genome, the one chip_smoke.py also runs on the card
from chip_smoke import ltr6_genome
from test_torch_tir_path import (  # noqa: F401  (autouse)
    _parity_genome, compile_cache,
)

torch.set_num_threads(2)


def _pkg(port: bool):
    if port:
        import hite_tpu_torch as pkg
        from hite_tpu_torch import config, genome
        from hite_tpu_torch.models.convert import load_model
        from hite_tpu_torch.models.ltr_filter import LTRFilterCNN
        from hite_tpu_torch.pipeline import copies, ltr, ltr_deep, run

        def cnn(path):
            return dict(cnn_model=load_model(LTRFilterCNN, path, "cpu"))
    else:
        import hite_tpu as pkg
        from hite_tpu import config, genome
        from hite_tpu.models.trainer import load_params
        from hite_tpu.pipeline import copies, ltr, ltr_deep, run

        def cnn(path):
            return dict(cnn_params=load_params(path))
    return dict(config=config, genome=genome, copies=copies, ltr=ltr,
                deep=ltr_deep, run=run, cnn=cnn,
                models=os.path.join(os.path.dirname(pkg.__file__), "data",
                                    "models"))


def _records(recs):
    return [dataclasses.asdict(r) for r in recs]


def _chain(port: bool, contigs, align_kw, mp):
    """The LTR chain of one package on the tandem-masked genome, recording
    what each step of `run_ltr_detection` returns (its steps wrapped
    through `mp`, a MonkeyPatch), then the deep filter with the bundled
    CNN, the cross-class filter and the superfamily labels."""
    m = _pkg(port)
    g = m["genome"].Genome.from_dict(contigs,
                                     **({"device": "cpu"} if port else {}))
    cfg = m["config"].PipelineConfig(
        align=m["config"].AlignConfig(**align_kw)).with_genome_size(g.size)
    g.init_mask()
    m["run"]._mask_tandem_regions(g)
    gindex = m["copies"].GenomeIndex(g, cfg.align)
    L, D = m["ltr"], m["deep"]
    out = {}

    def record(name, key, as_records=True):
        fn = getattr(L, name)

        def wrapped(*a, **kw):
            res = fn(*a, **kw)
            out[key] = _records(res) if as_records else list(res)
            return res
        mp.setattr(L, name, wrapped)

    record("ltr_pair_candidates", "pairs", as_records=False)
    record("refine_and_filter", "refined")
    record("recombination_filter", "recomb")
    record("remove_dirty_records", "clean")
    res = L.run_ltr_detection(g, cfg, gindex)
    out["detected"] = _records(res.records)
    kept = D.deep_filter_records(
        g, res.records, cfg, gindex,
        **m["cnn"](os.path.join(m["models"], "ltr_filter_cnn.pkl")))
    out["deep"] = _records(kept)
    kept, pools = D.cross_class_filter(g, kept, cfg, gindex)
    out["cross"] = (_records(kept),
                    {k: [v.tolist() for v in vs] for k, vs in pools.items()})
    out["classified"] = _records(L.classify_ltr_records(g, kept, cfg))
    out["state"] = (g, cfg, L.LTRResult(records=kept, cross_class=pools))
    return out


STAGES = ["pairs", "refined", "recomb", "clean", "detected", "deep",
          "cross", "classified"]


def run_chains(contigs, align_kw):
    """(JAX chain, port chain, LTR CNN forwards {"jax", "port"})."""
    import hite_tpu.models.trainer as jtrainer
    from hite_tpu_torch.models.ltr_filter import LTRFilterCNN

    calls = {"jax": 0, "port": 0}
    orig = jtrainer.jit_apply

    def spy(model, params, *xs):
        calls["jax"] += type(model).__name__ == "LTRFilterCNN"
        return orig(model, params, *xs)

    def hook(module, _inp, _out):
        calls["port"] += isinstance(module, LTRFilterCNN)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "jit_apply", spy)
        handle = torch.nn.modules.module.register_module_forward_hook(hook)
        try:
            ref = _chain(False, contigs, align_kw, mp)
            got = _chain(True, contigs, align_kw, mp)
        finally:
            handle.remove()
    return ref, got, calls


@pytest.fixture(scope="module")
def chains():
    return run_chains({"chr1": _parity_genome()},
                      dict(fixed_extend_base_threshold=2000))


@pytest.mark.parametrize("stage", STAGES)
def test_ltr_chain_stage(chains, stage):
    ref, got, _calls = chains
    assert ref[stage] == got[stage], stage


def test_ltr_chain_160k_outcome(chains):
    """The 3 planted copies (130-150 kbp, 3 copies each) never reach the
    CNN (it confirms records of more than 5 copies); labels agree."""
    ref, got, calls = chains
    assert calls["jax"] == calls["port"] == 0
    assert len(got["refined"]) >= 1 and len(got["pairs"]) >= 1
    assert [r["superfamily"] for r in got["classified"]] == \
        [r["superfamily"] for r in ref["classified"]]


# ---- the frame pipeline on real frames

@pytest.fixture(scope="module")
def frames():
    """Both packages' genomes of the 7-copy substrate, the copies of each
    planted element and one record per element."""
    from hite_tpu.config import PipelineConfig as JC
    from hite_tpu.genome import Genome as JG
    from hite_tpu.pipeline.copies import CopyFinder, GenomeIndex
    from hite_tpu.pipeline.ltr import LTRRecord as JR
    from hite_tpu_torch.genome import Genome as TG
    from hite_tpu_torch.pipeline.ltr import LTRRecord as TR

    bg, truth = ltr6_genome()
    jg, tg = JG.from_dict({"chr1": bg}), TG.from_dict({"chr1": bg},
                                                      device="cpu")
    cfg = JC()
    copy_sets = CopyFinder(GenomeIndex(jg, cfg.align)).find_copies(
        [jg.extract(s, e) for s, e in truth[:4]], min_coverage=0.8)
    recs = [(JR(s, e, s, s + 300, e - 300, e, 0.99, 0.0),
             TR(s, e, s, s + 300, e - 300, e, 0.99, 0.0))
            for s, e in truth[:4]]
    return jg, tg, copy_sets, recs


def test_frame_judge_core(frames):
    """Projection, flank statistics and rule of a padded record bucket
    (three records and an all-padding slot), and the CNN inputs of each
    frame."""
    import jax.numpy as jnp

    from hite_tpu.pipeline import ltr_deep as jd
    from hite_tpu_torch.pipeline import ltr_deep as td

    jg, tg, copy_sets, recs = frames
    width2 = 2 * (td.FRAME_FLANK + td.FRAME_CORE)
    Bp, rb = 4, 8
    centers = np.full((Bp, width2), 4, np.uint8)
    mats = np.full((Bp, rb, width2), 4, np.uint8)
    lens = np.zeros((Bp, rb), np.int32)
    for b, ((jr, tr), cs) in enumerate(zip(recs[:3], copy_sets)):
        ji, ti = jd._frame_inputs(jg, jr, cs), td._frame_inputs(tg, tr, cs)
        assert np.array_equal(ji[0], ti[0])
        assert all(np.array_equal(x, y) for x, y in zip(ji[1], ti[1]))
        centers[b] = ti[0]
        m, l = td.pad_seqs(ti[1], width2, n_rows=rb)
        mats[b], lens[b] = m, l
    ref = [np.asarray(x) for x in jd._frame_judge_batch(
        jnp.asarray(centers), jnp.asarray(mats), jnp.asarray(lens))]
    got = [x.numpy() for x in td._frame_judge_core(
        torch.from_numpy(centers), torch.from_numpy(mats),
        torch.from_numpy(lens))]
    for r, g in zip(ref, got):
        assert np.array_equal(r, g)
    assert got[2][:3].all() and not got[2][3]
    for b in range(3):
        for x, y in zip(jd.cnn_inputs(ref[0][b]), td.cnn_inputs(got[0][b],
                                                                "cpu")):
            assert np.array_equal(x, y)


def _frame(rows):
    from hite_tpu_torch.pipeline.ltr_deep import FRAME_CORE, FRAME_FLANK

    M = np.full((len(rows), 2 * (FRAME_FLANK + FRAME_CORE)), 4, np.uint8)
    for i, (lflank, rflank) in enumerate(rows):
        M[i, :FRAME_FLANK] = lflank
        M[i, FRAME_FLANK:-FRAME_FLANK] = 0
        M[i, -FRAME_FLANK:] = rflank
    return M


def _homogeneity_case(name):
    """The flank-homogeneity scenarios of tests/test_ltr_filters.py."""
    rnd = lambda rng: rng.integers(0, 4, 100)
    if name == "random":
        rng = np.random.default_rng(5)
        return _frame([(rnd(rng), rnd(rng)) for _ in range(8)]), True
    if name == "one_side":
        rng = np.random.default_rng(6)
        shared = rnd(rng)
        return _frame([(shared.copy(), rnd(rng)) for _ in range(8)]), False
    if name == "joined":
        rng = np.random.default_rng(7)
        rows = []
        for _ in range(2):
            lf, rf = rnd(rng), rnd(rng)
            rows += [(lf, rf), (lf.copy(), rf.copy())]
        rows += [(rnd(rng), rnd(rng)) for _ in range(2)]
        return _frame(rows), False
    rng = np.random.default_rng(8)
    return _frame([(rnd(rng), rnd(rng))]), False


@pytest.mark.parametrize("case", ["random", "one_side", "joined", "single"])
def test_flank_homogeneity(case):
    """The port's flank statistics and verdict against the JAX package's
    `flank_homogeneity_ok` of one frame."""
    from hite_tpu.pipeline.ltr_deep import flank_homogeneity_ok as jok
    from hite_tpu_torch.pipeline.ltr_deep import (
        _flank_homo_core, _homogeneity_ok,
    )

    M, want = _homogeneity_case(case)
    stats = _flank_homo_core(torch.from_numpy(M)).tolist()
    assert jok(M) == _homogeneity_ok(*stats) == want


# ---- the FiLTR filter scenarios of tests/test_ltr_filters.py

def _rec(cls, s, e, ls, le, rs, re, tsd=0):
    return cls(start=s, end=e, lltr_start=ls, lltr_end=le, rltr_start=rs,
               rltr_end=re, identity=0.95, insert_time=0.0, tsd_len=tsd)


def test_remove_dirty_records():
    from hite_tpu.pipeline import ltr as jl
    from hite_tpu_torch.pipeline import ltr as tl

    spans = [(1000, 12_000, 1000, 1500, 11_500, 12_000),
             (3000, 8000, 3000, 3400, 7600, 8000),
             (20_000, 26_000, 20_000, 20_400, 25_600, 26_000)]
    ref = jl.remove_dirty_records([_rec(jl.LTRRecord, *s) for s in spans])
    got = tl.remove_dirty_records([_rec(tl.LTRRecord, *s) for s in spans])
    assert _records(ref) == _records(got)
    assert [r.start for r in got] == [3000, 20_000]


def test_recombination_filter():
    from hite_tpu.config import PipelineConfig as JC
    from hite_tpu.genome import Genome as JG
    from hite_tpu.pipeline import ltr as jl
    from hite_tpu_torch.config import PipelineConfig as TC
    from hite_tpu_torch.genome import Genome as TG
    from hite_tpu_torch.pipeline import ltr as tl

    rng = np.random.default_rng(3)
    bg = rng.integers(0, 4, 40_000).astype(np.uint8)
    term = rng.integers(0, 4, 300).astype(np.uint8)
    bg[2000:2300] = bg[4000:4300] = bg[9000:9300] = term
    term2 = rng.integers(0, 4, 300).astype(np.uint8)
    bg[20_000:20_300] = bg[27_000:27_300] = term2
    spans = [(2000, 9300, 2000, 2300, 9000, 9300),
             (20_000, 27_300, 20_000, 20_300, 27_000, 27_300)]
    ref = jl.recombination_filter(JG.from_dict({"chr1": bg}),
                                  [_rec(jl.LTRRecord, *s) for s in spans],
                                  JC())
    got = tl.recombination_filter(TG.from_dict({"chr1": bg}, device="cpu"),
                                  [_rec(tl.LTRRecord, *s) for s in spans],
                                  TC())
    assert _records(ref) == _records(got)
    assert [r.start for r in got] == [20_000]


def test_single_copy_gate():
    """TSD + RT motif kept; no TSD, an intact TIRPeps transposase inside,
    or TSD without protein dropped; multi-copy records untouched.  The
    TIRPeps scan confirms with the BLOSUM62 SW (the plain version here)."""
    from test_torch_modules_path import CODON

    from hite_tpu.config import PipelineConfig as JC
    from hite_tpu.genome import Genome as JG
    from hite_tpu.pipeline import ltr as jl
    from hite_tpu.pipeline.ltr_deep import single_copy_gate as jgate
    from hite_tpu_torch.config import PipelineConfig as TC
    from hite_tpu_torch.genome import Genome as TG
    from hite_tpu_torch.io.fasta import encode_seq
    from hite_tpu_torch.ops.protein import decode_protein
    from hite_tpu_torch.pipeline import ltr as tl
    from hite_tpu_torch.pipeline.domain import read_protein_fasta
    from hite_tpu_torch.pipeline.ltr_deep import single_copy_gate
    from hite_tpu_torch.pipeline.run import DATA_DIR

    rng = np.random.default_rng(9)
    bg = rng.integers(0, 4, 30_000).astype(np.uint8)
    lib = read_protein_fasta(os.path.join(DATA_DIR, "protein",
                                          "TIRPeps.lib"))
    _n, prot = min(lib.items(), key=lambda kv: abs(len(kv[1]) - 160))
    nt = encode_seq("".join(CODON.get(a, "GCA")
                            for a in decode_protein(prot)))
    bg[6_000 : 6_000 + len(nt)] = nt
    rt_pep = "MA" + "LPQG" + "KTDSWPEARLVING" * 3 + "YVDD" + "ILAT"
    rt_nt = encode_seq("".join(CODON.get(a, "GCA") for a in rt_pep))
    bg[2_000 : 2_000 + len(rt_nt)] = rt_nt
    spans = [(1000, 4000, 1000, 1300, 3700, 4000, 5),
             (11_000, 14_000, 11_000, 11_300, 13_700, 14_000, 0),
             (5_500, 9_000, 5_500, 5_800, 8_700, 9_000, 5),
             (21_000, 24_000, 21_000, 21_300, 23_700, 24_000, 0),
             (15_000, 18_000, 15_000, 15_300, 17_700, 18_000, 5)]
    counts = [1, 1, 1, 4, 1]
    ref = jgate(JG.from_dict({"chr1": bg}),
                [_rec(jl.LTRRecord, *s) for s in spans], counts, JC())
    got = single_copy_gate(TG.from_dict({"chr1": bg}, device="cpu"),
                           [_rec(tl.LTRRecord, *s) for s in spans], counts,
                           TC())
    assert ref == got == [True, False, False, True, False]


def test_refine_at_width_8192():
    """One LTR pair of 4100 bp terminals: the refinement SW runs at width
    8192 (the widest the LTR stage sends); records equal."""
    from hite_tpu.config import PipelineConfig as JC
    from hite_tpu.genome import Genome as JG
    from hite_tpu.pipeline import ltr as jl
    from hite_tpu_torch.config import PipelineConfig as TC
    from hite_tpu_torch.genome import Genome as TG
    from hite_tpu_torch.pipeline import ltr as tl

    rng = np.random.default_rng(17)
    bg = rng.integers(0, 4, 30_000).astype(np.uint8)
    lt = rng.integers(0, 4, 4100).astype(np.uint8)
    lt[0], lt[1], lt[-2], lt[-1] = 3, 2, 1, 0
    s, e = 5_000, 5_000 + 4100 + 2000 + 4100
    bg[s : s + 4100] = lt
    right = lt.copy()
    muts = rng.random(4100) < 0.02
    right[muts] = (right[muts] + 1) % 4
    bg[e - 4100 : e] = right
    bg[s - 5 : s] = bg[e : e + 5] = rng.integers(0, 4, 5)
    pairs = [(s + 3, s + 4090, e - 4097, e - 8)]
    ref = jl.refine_and_filter(JG.from_dict({"chr1": bg}), pairs, JC())
    got = tl.refine_and_filter(TG.from_dict({"chr1": bg}, device="cpu"),
                               pairs, TC())
    assert _records(ref) == _records(got)
    assert len(got) == 1 and got[0].start == s and abs(got[0].end - e) <= 10
    assert got[0].tsd_len == 5


def test_jukes_cantor_time():
    from hite_tpu.pipeline.ltr import jukes_cantor_time as j
    from hite_tpu_torch.pipeline.ltr import jukes_cantor_time as t

    for ident in (1.0, 0.99, 0.95, 0.9, 0.5, 0.2, 0.0):
        assert j(ident, 1.3e-8) == t(ident, 1.3e-8)
