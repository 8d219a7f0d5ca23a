"""The device mesh of hite_tpu_torch (`parallel/mesh.py`, `dispatch.py`
and every `mesh=` path) on the CPU.

Meshes are built from repeated CPU devices (`make_mesh(devices=[cpu] *
n)`), the counterpart of the JAX package's 8 virtual CPU devices
(`tests/conftest.py`), at the shapes 1x1, 2x1, 8x1, 2x4 and 4x2.  Each
sharded port function must equal its unsharded self bit for bit, batch
sizes that do not divide the mesh included, and the JAX package's mesh
path (`hite_tpu.parallel.mesh.make_mesh(n_devices=8)`) on the same numpy
inputs, the self-join's 64-slice cap included (ROADMAP queue 3, quirk
12).  The sharded training step is float arithmetic: against the port's
unsharded step within `dryrun_multichip.TRAIN_TOL`, against JAX's
`shard_train` within `test_torch_train.py`'s 3-step tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)
from test_torch_train import LOSS_TOL, LTR_TOL

torch.set_num_threads(2)

SHAPES = [(1, 1), (2, 1), (8, 1), (2, 4), (4, 2)]
IDS = [f"{dp}x{tp}" for dp, tp in SHAPES]


def _mesh(shape):
    from hite_tpu_torch.parallel.mesh import make_mesh

    dp, tp = shape
    return make_mesh(devices=[torch.device("cpu")] * (dp * tp), dp=dp,
                     tp=tp)


def _jax_mesh():
    from hite_tpu.parallel.mesh import make_mesh

    assert len(jax.devices()) >= 8
    return make_mesh(n_devices=8)


def _jax_genome(genome):
    from hite_tpu.genome import Genome

    return Genome.from_dict({n: genome.flat[s : s + n_]
                             for n, s, n_ in zip(genome.names, genome.starts,
                                                 genome.lengths)})


# ---- the sharded training step (heaviest: JAX's shard_train compiles)

def _ltr_inputs(B, seed):
    from hite_tpu_torch.scripts.dryrun_multichip import ltr_batch

    return ltr_batch(B, seed)


def test_shard_train_matches_jax():
    """3 steps of JAX's `shard_train` on its 8-device (2 x 4) mesh and of
    the port's on a 2 x 4 mesh, B = 2 x dp, from the same flax init: each
    step's loss within LOSS_TOL, then the held batch's logits within
    LTR_TOL with every decision equal."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hite_tpu.models.ltr_filter import LTRFilterCNN as JaxLTR
    from hite_tpu.models.train import create_state
    from hite_tpu.models.train import shard_train as jax_shard_train
    from hite_tpu_torch.models import convert
    from hite_tpu_torch.models.ltr_filter import LTRFilterCNN
    from hite_tpu_torch.models.train import adamw, shard_train

    jmesh = _jax_mesh()
    dp = jmesh.shape["dp"]
    B = 2 * dp
    img0, km0, _ = _ltr_inputs(B, 0)
    jm = JaxLTR()
    params, opt_state, tx = create_state(
        jm, jax.random.key(1), (jnp.asarray(img0), jnp.asarray(km0)),
        lr=1e-3)
    model = convert.load_flax_params(LTRFilterCNN(), params)
    step, s_params, s_opt = jax_shard_train(jmesh, jm, tx, params,
                                            opt_state)
    mine = shard_train(_mesh((dp, jmesh.shape["tp"])), model,
                       adamw(model, 1e-3))
    data = NamedSharding(jmesh, P("dp"))
    for seed in range(3):
        img, km, y = _ltr_inputs(B, seed)
        s_params, s_opt, jloss = step(s_params, s_opt, {
            "inputs": (jax.device_put(img, data), jax.device_put(km, data)),
            "labels": jax.device_put(y, data)})
        loss = mine({"inputs": (torch.from_numpy(img), torch.from_numpy(km)),
                     "labels": torch.from_numpy(y)})
        assert abs(float(jloss) - float(loss)) <= LOSS_TOL
    img, km, _ = _ltr_inputs(B, 9)
    ref = np.asarray(jm.apply(s_params, jnp.asarray(img), jnp.asarray(km)))
    with torch.no_grad():
        got = mine.unshard(model).eval()(torch.from_numpy(img),
                                          torch.from_numpy(km)).numpy()
    assert np.abs(ref - got).max() <= LTR_TOL
    assert np.array_equal(ref.argmax(-1), got.argmax(-1))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_shard_train_matches_unsharded(shape):
    """One sharded LTR-filter step (B = 2 x dp, the dryrun's 32 x 64
    frames) against the unsharded step from the same parameters: loss,
    gradients and parameters within TRAIN_TOL; a single dp row is the
    unsharded step exactly."""
    from hite_tpu_torch.scripts.dryrun_multichip import (
        TRAIN_TOL, train_step_check,
    )

    got = train_step_check(_mesh(shape), "cpu")
    assert got["loss_rel"] <= TRAIN_TOL["loss_rel"]
    assert got["tp_sharded"] == (0 if shape[1] == 1 else 64)
    if shape[0] == 1:
        assert got["loss_rel"] == got["grad_rel_l2"] == 0.0
        assert got["max_param_diff"] == 0.0


def test_train_step_uneven_batch_and_moments():
    """A batch that does not divide dp (5 rows over 2) and an optimizer
    that already holds moments: two sharded steps track two unsharded
    ones within the tolerance, and the moments are cut like their
    parameters."""
    from hite_tpu_torch.models.convert import reset_parameters
    from hite_tpu_torch.models.ltr_filter import LTRFilterCNN
    from hite_tpu_torch.models.train import (
        adamw, make_train_step, shard_train,
    )
    from hite_tpu_torch.scripts.dryrun_multichip import TRAIN_TOL

    mk = lambda: reset_parameters(LTRFilterCNN(),
                                  torch.Generator().manual_seed(3))
    a, b = mk(), mk()
    oa, ob = adamw(a), adamw(b)
    batches = []
    for seed in range(3):
        img, km, y = _ltr_inputs(5, seed)
        batches.append({"inputs": (torch.from_numpy(img),
                                   torch.from_numpy(km)),
                        "labels": torch.from_numpy(y)})
    step_a, step_b = make_train_step(a, oa), make_train_step(b, ob)
    step_a(batches[0])
    step_b(batches[0])                 # b's optimizer now holds moments
    sharded = shard_train(_mesh((2, 4)), b, ob)
    for name, parts in sharded.slices.items():
        st = sharded.optimizer.state[parts[0]]
        assert int(st["step"]) == 1
        assert st["exp_avg"].shape == parts[0].shape
    for i, batch in enumerate(batches[1:]):
        la = float(step_a(batch))
        lb = float(sharded(batch))
        # the first sharded step starts from the same parameters
        assert abs(la - lb) <= (TRAIN_TOL["loss_rel"] * abs(la) if i == 0
                                else LOSS_TOL)
    worst = max(float((sharded.full(n) - p.detach()).abs().max())
                for n, p in a.named_parameters())
    assert worst <= 0.01


# ---- the self-join's chunk batch over "dp"

@pytest.fixture(scope="module")
def dryrun300():
    """The 300 kbp dryrun genome through both packages' single paths."""
    from hite_tpu.config import AlignConfig as JaxAlign
    from hite_tpu.genome import synthetic_genome as jax_synth
    from hite_tpu_torch.config import AlignConfig
    from hite_tpu_torch.pipeline.coarse import CoarseParams, coarse_discover
    from hite_tpu_torch.scripts.dryrun_multichip import dryrun_genome

    genome, tes = dryrun_genome("cpu")
    jg, _ = jax_synth(300_000, tes, [16, 10], seed=11, mutation_rate=0.02)
    assert np.array_equal(np.asarray(jg.flat), genome.flat)
    single = coarse_discover(genome, AlignConfig(
        fixed_extend_base_threshold=2000), CoarseParams(
            max_selfjoin_bp=1 << 17), max_repeat_len=5_000)
    assert len(single) > 0
    return genome, tes, jg, single, JaxAlign


@pytest.mark.parametrize("capped", [False, True], ids=["default", "cap"])
def test_selfjoin_mesh_matches_jax_mesh(dryrun300, capped):
    """The chunked mesh self-join (`max_selfjoin_bp` 2^17: 5 chunks over
    dp 8) in both packages, and with `max_seed_pairs` 64 and
    `hard_budget_slices` 4096, where the budget needs 256 slices and both
    mesh paths cap it at 64 and drop seed pairs the single path keeps
    (quirk 12): equal candidates either way."""
    from hite_tpu.pipeline.coarse import CoarseParams as JaxParams
    from hite_tpu.pipeline.coarse import coarse_discover as jax_coarse
    from hite_tpu_torch.config import AlignConfig
    from hite_tpu_torch.pipeline.coarse import CoarseParams, coarse_discover

    genome, _tes, jg, single, JaxAlign = dryrun300
    kw = dict(max_selfjoin_bp=1 << 17)
    if capped:
        kw.update(max_seed_pairs=64, hard_budget_slices=4096)
    ref = jax_coarse(jg, JaxAlign(fixed_extend_base_threshold=2000),
                     JaxParams(**kw), max_repeat_len=5_000,
                     mesh=_jax_mesh())
    got = coarse_discover(genome, AlignConfig(
        fixed_extend_base_threshold=2000), CoarseParams(**kw),
        max_repeat_len=5_000, mesh=_mesh((8, 1)))
    assert np.array_equal(got, ref) and len(got) > 0
    if capped:
        alone = coarse_discover(genome, AlignConfig(
            fixed_extend_base_threshold=2000), CoarseParams(**kw),
            max_repeat_len=5_000)
        assert len(alone) > len(got)       # the cap's dropped candidates


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_selfjoin_mesh_matches_single(dryrun300, shape):
    from hite_tpu_torch.config import AlignConfig
    from hite_tpu_torch.pipeline.coarse import CoarseParams, coarse_discover

    genome, _tes, _jg, single, _ = dryrun300
    got = coarse_discover(genome, AlignConfig(
        fixed_extend_base_threshold=2000), CoarseParams(
            max_selfjoin_bp=1 << 17), max_repeat_len=5_000,
        mesh=_mesh(shape))
    assert np.array_equal(got, single)


def test_selfjoin_mesh_packed_and_unchunked(dryrun300):
    """A packed host genome (`PackedFlat`) and a genome that fits one
    chunk (the default `max_selfjoin_bp`) take the mesh path to the
    single path's candidates."""
    from hite_tpu_torch.config import AlignConfig
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.pipeline.coarse import CoarseParams, coarse_discover

    genome, _tes, _jg, single, _ = dryrun300
    acfg = AlignConfig(fixed_extend_base_threshold=2000)
    packed = Genome.from_dict(genome.to_dict(), device="cpu")
    packed.pack_host()
    got = coarse_discover(packed, acfg, CoarseParams(
        max_selfjoin_bp=1 << 17), max_repeat_len=5_000, mesh=_mesh((2, 4)))
    assert np.array_equal(got, single)
    whole = coarse_discover(genome, acfg, CoarseParams(),
                            max_repeat_len=5_000)
    got = coarse_discover(genome, acfg, CoarseParams(),
                          max_repeat_len=5_000, mesh=_mesh((4, 2)))
    assert np.array_equal(got, whole)


# ---- the pair grid (parallel/dispatch.py)

@pytest.fixture(scope="module")
def pair_grid():
    from hite_tpu_torch.config import AlignConfig
    from hite_tpu_torch.genome import synthetic_genome
    from hite_tpu_torch.pipeline.coarse import CoarseParams, coarse_discover

    rng = np.random.default_rng(0)
    tes = ["".join("ACGT"[c] for c in rng.integers(0, 4, 600))]
    genome, _ = synthetic_genome(60_000, tes, [6], seed=5,
                                 mutation_rate=0.02, device="cpu")
    params = CoarseParams(seg_len=16_384, pair_batch=8, strategy="pairs")
    single = coarse_discover(genome, AlignConfig(), params)
    assert len(single) > 0
    return genome, params, single


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_coarse_discover_sharded(pair_grid, shape):
    """`coarse_discover_sharded` (10 live pairs in batches rounded to the
    device count, the last padded with its last pair) equals the single
    "pairs" strategy."""
    from hite_tpu_torch.config import AlignConfig
    from hite_tpu_torch.parallel.dispatch import coarse_discover_sharded

    genome, params, single = pair_grid
    got = coarse_discover_sharded(genome, AlignConfig(), _mesh(shape),
                                  params)
    assert np.array_equal(got, single)


def test_coarse_discover_sharded_matches_jax(pair_grid):
    from hite_tpu.config import AlignConfig as JaxAlign
    from hite_tpu.parallel.dispatch import coarse_discover_sharded as jcds
    from hite_tpu.pipeline.coarse import CoarseParams as JaxParams

    genome, _params, single = pair_grid
    ref = jcds(_jax_genome(genome), JaxAlign(), _jax_mesh(), JaxParams(
        seg_len=16_384, pair_batch=8, strategy="pairs"))
    assert np.array_equal(np.sort(ref, axis=0), np.sort(single, axis=0))


# ---- the family analysis over the family axis

@pytest.fixture(scope="module")
def families():
    """`scripts/mesh_scaling.py`'s workload cut to 400 kbp and 13 families
    of 6 copies (13 divides no mesh size but 1), with its unsharded
    analyses."""
    from hite_tpu_torch.config import MSAConfig
    from hite_tpu_torch.pipeline.boundary_adjust import (
        analyze_families_batched,
    )
    from hite_tpu_torch.scripts.mesh_scaling import workload

    genome, items = workload(400_000, 13, 6, device="cpu")
    return genome, items, analyze_families_batched(genome, items,
                                                   MSAConfig())


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_family_analysis_sharded(families, shape):
    from hite_tpu_torch.config import MSAConfig
    from hite_tpu_torch.pipeline.boundary_adjust import (
        analyze_families_batched,
    )
    from hite_tpu_torch.scripts.mesh_scaling import same_analyses

    genome, items, ref = families
    got = analyze_families_batched(genome, items, MSAConfig(),
                                   mesh=_mesh(shape))
    assert same_analyses(got, ref)
    assert any(fa.left_found and fa.right_found for fa, _c in got)


def test_family_analysis_matches_jax_mesh(families):
    from hite_tpu.config import MSAConfig as JaxMSA
    from hite_tpu.pipeline.boundary_adjust import (
        analyze_families_batched as jax_analyze,
    )
    from hite_tpu.pipeline.copies import CopyHit as JaxHit
    from hite_tpu_torch.config import MSAConfig
    from hite_tpu_torch.pipeline.boundary_adjust import (
        analyze_families_batched,
    )
    from hite_tpu_torch.scripts.mesh_scaling import same_analyses

    genome, items, _ref = families
    jitems = [(iv, [JaxHit(**dataclasses.asdict(h)) for h in hits])
              for iv, hits in items]
    ref = jax_analyze(_jax_genome(genome), jitems, JaxMSA(),
                      mesh=_jax_mesh())
    got = analyze_families_batched(genome, items, MSAConfig(),
                                   mesh=_mesh((2, 4)))
    assert same_analyses(got, ref)


# ---- the LTR frame judge over the record axis

def _frames(B, R=8, seed=0):
    """B record frames: a random center of the frame width and R copies
    of it with 2-15% mutations and random flanks; row lengths vary and a
    record's last rows are empty."""
    from hite_tpu_torch.pipeline.ltr_deep import FRAME_CORE, FRAME_FLANK

    W2 = 2 * (FRAME_FLANK + FRAME_CORE)
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 4, (B, W2)).astype(np.uint8)
    mats = np.full((B, R, W2), 4, np.uint8)
    lens = np.zeros((B, R), np.int32)
    for b in range(B):
        for r in range(R - b % 3):
            row = centers[b].copy()
            m = rng.random(W2) < rng.uniform(0.02, 0.15)
            row[m] = (row[m] + rng.integers(1, 4, m.sum())) % 4
            flank = rng.random(W2) < 0.5
            edge = (np.arange(W2) < FRAME_FLANK) | \
                (np.arange(W2) >= W2 - FRAME_FLANK)
            row[flank & edge] = rng.integers(0, 4, (flank & edge).sum())
            n = W2 - int(rng.integers(0, 40))
            mats[b, r, :n] = row[:n]
            lens[b, r] = n
    return centers, mats, lens


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_frame_judge_sharded(shape):
    from hite_tpu_torch.parallel.mesh import run_sharded
    from hite_tpu_torch.pipeline.ltr_deep import _frame_judge_core

    centers, mats, lens = _frames(5)
    ref = _frame_judge_core(*map(torch.from_numpy, (centers, mats, lens)))
    got = run_sharded(_mesh(shape), _frame_judge_core, centers, mats, lens)
    for r, g in zip(ref, got):
        assert torch.equal(r, g)
    assert (ref[1][:, 0] > 0).all()


def test_frame_judge_matches_jax_mesh():
    """The JAX package's sharded frame judge needs the record axis padded
    to the mesh size (8, as `deep_filter_records` pads it, with code 4
    and zero lengths); the port's equals it on the same 8 rows."""
    from hite_tpu.pipeline.ltr_deep import _frame_judge_batch_sharded
    from hite_tpu_torch.parallel.mesh import run_sharded
    from hite_tpu_torch.pipeline.ltr_deep import _frame_judge_core

    centers, mats, lens = _frames(5, seed=1)
    pad = lambda a, v: np.concatenate(
        [a, np.full((3,) + a.shape[1:], v, a.dtype)])
    centers, mats, lens = pad(centers, 4), pad(mats, 4), pad(lens, 0)
    ref = _frame_judge_batch_sharded(_jax_mesh())(
        jnp.asarray(centers), jnp.asarray(mats), jnp.asarray(lens))
    got = run_sharded(_mesh((2, 4)), _frame_judge_core, centers, mats, lens)
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy())


# ---- the copy finders and annotation

@pytest.fixture(scope="module")
def planted():
    """`tests/test_torch_strategies.py`'s genome (200 kbp, 6 + 8 copies)
    and 3 candidates (the two elements, the first reverse-complemented),
    with each strategy's unsharded hits."""
    from hite_tpu.io.fasta import decode_seq, encode_seq
    from hite_tpu_torch.config import AlignConfig
    from hite_tpu_torch.genome import synthetic_genome
    from hite_tpu_torch.pipeline.copies import CopyFinder, GenomeIndex

    rng = np.random.default_rng(7)
    tes = [decode_seq(rng.integers(0, 4, size=L).astype(np.uint8))
           for L in (900, 420)]
    g, _ = synthetic_genome(200_000, tes, [6, 8], seed=3,
                            mutation_rate=0.01, device="cpu")
    cands = [encode_seq(t) for t in tes]
    cands.append((3 - cands[0])[::-1].astype(np.uint8))
    gi = GenomeIndex(g, AlignConfig())
    ref = {s: CopyFinder(gi, strategy=s).find_copies(cands, min_coverage=0.9)
           for s in ("join", "segments")}
    return g, gi, tes, cands, ref


def _hits(sets):
    return [[dataclasses.astuple(h) for h in hits] for hits in sets]


@pytest.mark.parametrize("strategy", ["join", "segments"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_copy_finder_sharded(planted, shape, strategy):
    from hite_tpu_torch.pipeline.copies import CopyFinder

    _g, gi, _tes, cands, ref = planted
    mesh = _mesh(shape)
    got = CopyFinder(gi, strategy=strategy, mesh=mesh).find_copies(
        cands, min_coverage=0.9)
    assert _hits(got) == _hits(ref[strategy])
    assert [len(h) for h in got[:2]] == [6, 8]


def test_copy_finder_mesh_matches_jax_mesh(planted):
    """The segments mapper under a mesh in both packages (the JAX package
    walks segments one at a time there, the port keeps its blocks):
    the same hits on this genome; and the port's join, whose sorted
    stream is built on the genome's device under any mesh, keeps one
    cached stream per (masked, k) where the JAX package keys it by the
    mesh's sharding too."""
    from hite_tpu.config import AlignConfig as JaxAlign
    from hite_tpu.pipeline.copies import CopyFinder as JaxFinder
    from hite_tpu.pipeline.copies import GenomeIndex as JaxIndex
    from hite_tpu_torch.pipeline.copies import CopyFinder

    g, gi, _tes, cands, ref = planted
    jmesh = _jax_mesh()
    jaxed = JaxFinder(JaxIndex(_jax_genome(g), JaxAlign()),
                      strategy="segments", mesh=jmesh).find_copies(
                          cands, min_coverage=0.9)
    assert _hits(jaxed) == _hits(ref["segments"])
    mesh = _mesh((8, 1))
    CopyFinder(gi, mesh=mesh).find_copies(cands, min_coverage=0.9)
    keys = [k for k in g._device_cache if k[0] == "join_sorted"]
    assert keys and all(len(k) == 3 for k in keys), keys


def test_join_cache_shared_across_meshes(planted, tmp_path):
    """Two distinct 8-shard meshes, one after the other, annotating one
    Genome: the indexed join's cache holds one sorted stream per (masked,
    k), reused by the second mesh, and both runs write byte-equal
    annotation files."""
    import filecmp

    from hite_tpu_torch.config import AlignConfig, PipelineConfig
    from hite_tpu_torch.pipeline.annotate import (
        annotate_genome, write_annotation,
    )

    g, gi, _tes, cands, _ref = planted
    lib = {f"TE_{i}#Unknown": c for i, c in enumerate(cands[:2])}
    cfg = PipelineConfig(align=AlignConfig())
    streams = []
    for i, shape in enumerate(((8, 1), (2, 4))):
        hits = annotate_genome(g, lib, cfg, gi, mesh=_mesh(shape))
        write_annotation(str(tmp_path / f"run{i}"), hits, g)
        streams.append({k: v for k, v in g._device_cache.items()
                        if k[0] == "join_sorted"})
    keys = list(streams[1])
    assert keys and all(len(k) == 3 for k in keys), keys
    assert streams[0].keys() == streams[1].keys()
    assert all(streams[0][k] is streams[1][k] for k in keys)
    assert len(hits) >= 14
    for ext in (".gff", ".out", ".tbl", ".full_length.gff"):
        assert filecmp.cmp(str(tmp_path / f"run0{ext}"),
                           str(tmp_path / f"run1{ext}"), shallow=False), ext


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_annotate_sharded(planted, shape):
    from hite_tpu_torch.config import AlignConfig, PipelineConfig
    from hite_tpu_torch.pipeline.annotate import annotate_genome

    g, gi, tes, cands, _ref = planted
    lib = {f"TE_{i}#Unknown": c for i, c in enumerate(cands[:2])}
    cfg = PipelineConfig(align=AlignConfig())
    key = lambda hits: [dataclasses.astuple(h) for h in hits]
    ref = annotate_genome(g, lib, cfg, gi)
    got = annotate_genome(g, lib, cfg, gi, mesh=_mesh(shape))
    assert key(got) == key(ref) and len(ref) >= 14


# ---- the mesh object

def test_param_sharding_places_slices():
    """The tp rule is taken on the flax shape: every Conv weight [out, in,
    kh, kw] of the LTR filter is cut along dim 0 (its flax last axis),
    never along the kernel width, and Dense_2's 2 outputs (< 2 tp) stay
    whole; each slice lies on its tp device with out / tp rows."""
    from hite_tpu_torch.models.ltr_filter import LTRFilterCNN
    from hite_tpu_torch.models.train import adamw, shard_train
    from hite_tpu_torch.parallel.mesh import param_sharding

    model = LTRFilterCNN()
    mesh = _mesh((2, 4))
    dims = param_sharding(mesh, model)
    assert set(dims) == {n for n, _ in model.named_parameters()}
    assert dims["image_branch.ResBlock_0.Conv_0.weight"] == 0
    assert dims["Dense_0.weight"] == 0 and dims["Dense_1.bias"] == 0
    assert dims["Dense_2.weight"] is None and dims["Dense_2.bias"] is None
    assert dims["kmer_branch.ResBlock_2.GroupNorm_1.weight"] == 0
    assert all(d is None for d in param_sharding(_mesh((8, 1)),
                                                 model).values())
    st = shard_train(mesh, model, adamw(model))
    for name, p in model.named_parameters():
        parts = st.slices[name]
        if dims[name] is None:
            assert len(parts) == 1 and parts[0].shape == p.shape
            assert parts[0].device == mesh.devices[0, 0]
            continue
        assert len(parts) == 4
        for t, part in enumerate(parts):
            assert part.device == mesh.devices[0, t]
            assert part.shape == (p.shape[0] // 4,) + p.shape[1:]
        assert torch.equal(st.full(name), p.detach())


def test_make_mesh_needs_a_gpu_or_a_device_list(monkeypatch):
    from hite_tpu_torch.parallel import mesh as pm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        pm.make_mesh()
    with pytest.raises(RuntimeError):
        pm.make_mesh(n_devices=8)
    with pytest.raises(RuntimeError):
        pm.make_mesh(devices=["cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError):
        pm.make_mesh(n_devices=8)           # 2 cards, no device list
    with pytest.raises(RuntimeError):
        pm.make_mesh(devices=["cuda:3"])
    with pytest.raises(RuntimeError):
        pm.make_mesh(n_devices=8, devices=["cpu"] * 4)
    mesh = pm.make_mesh(n_devices=2)
    assert [str(d) for d in mesh.devices.reshape(-1)] == ["cuda:0",
                                                          "cuda:1"]
    assert mesh.distinct and mesh.shape == {"dp": 1, "tp": 2}


def test_mesh_shapes_and_shards():
    from hite_tpu_torch.parallel.mesh import factor_devices, shard_rows

    assert [factor_devices(n) for n in (1, 2, 3, 4, 6, 8)] == [
        (1, 1), (1, 2), (3, 1), (1, 4), (3, 2), (2, 4)]
    mesh = _mesh((2, 4))
    assert mesh.shape == {"dp": 2, "tp": 4} and mesh.size == 8
    assert mesh.shape.get("sp", 1) == 1 and not mesh.distinct
    with pytest.raises(ValueError):
        _mesh((3, 2)).shard_devices(("tp",))
    x = np.arange(10 * 3).reshape(10, 3)
    parts = shard_rows(mesh, x, axes=("dp",))
    assert [p[0].shape[0] for _d, p in parts] == [5, 5]
    parts = shard_rows(mesh, x)
    assert [p[0].shape[0] for _d, p in parts] == [2] * 8
    assert parts[-1][1][0].tolist() == [x[-1].tolist()] * 2  # last row
    with pytest.raises(ValueError):
        shard_rows(mesh, x[:0])


INIT_WORKER = r"""
import sys
from hite_tpu_torch.parallel import multihost as mh
from hite_tpu_torch.parallel.mesh import initialize_multihost

coord, rank = sys.argv[1], int(sys.argv[2])
initialize_multihost(coord, num_processes=2, process_id=rank, device="cpu")
assert (mh.process_count(), mh.process_index()) == (2, rank)
got = mh.allgather_obj({"rank": rank})
assert [o["rank"] for o in got] == [0, 1], got
import torch.distributed as dist
dist.destroy_process_group()
print("INIT_OK", rank, flush=True)
"""


def test_initialize_multihost_two_processes():
    """`initialize_multihost("host:port", 2, rank, device="cpu")` joins a
    gloo group that `parallel/multihost.py` then gathers over."""
    import os
    import socket
    import subprocess
    import sys

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", INIT_WORKER, f"localhost:{port}", str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=root,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"INIT_OK {r}" in out, out
