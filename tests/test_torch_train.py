"""Training in hite_tpu_torch vs hite_tpu: the corpora, the datasets, the
init, the train steps, the loops, the metrics and the checkpoints.

The synthetic corpora, `make_dataset`, `curated_dataset`,
`make_training_frames` and `mine_weak_labels` must equal the JAX
package's exactly.  Training is float arithmetic in bf16 on both sides
(flax/XLA and PyTorch round at slightly different points), and Adam's
step is +-lr wherever |g| >> eps, so a few steps spread the difference
over every parameter: losses and logits are compared, never parameters.
Tolerances (largest differences measured over seeds 0-2, 3 AdamW steps
from the same flax-initialised parameters, SuperfamilyCNN batches of 8,
LTRFilterCNN batches of 4):

* LOSS_TOL = 0.01 on each step's loss (measured: SuperfamilyCNN 0.00026,
  LTRFilterCNN 0.0054);
* the held batch's logits after training within the CNN tolerances of
  `test_torch_models.py`, SF_TOL = 0.02 (measured 0.0010 at |logits| <=
  0.54) and LTR_TOL = 0.08 (measured 0.031 at |logits| <= 0.43), with
  every argmax equal;
* GRAD_COS = 0.98, the cosine of one LTRFilterCNN gradient with flax's
  on every leaf but the conv biases (measured >= 0.9968), and BIAS_GAP =
  0.01 on the port's own shortcut / GroupNorm bias gradients (measured
  <= 0.0018; see `test_ltr_gradients_match_flax`).

The init is flax's `lecun_normal`; its check allows 10% on each kernel's
sample standard deviation (kernels of fewer than 500 weights are pooled,
their sampling error being larger).
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hite_tpu.models import classifier as jcls
from hite_tpu.models import ltr_filter as jltr
from hite_tpu.models import trainer as jtrainer
from hite_tpu_torch.models import classifier as tcls
from hite_tpu_torch.models import convert
from hite_tpu_torch.models import ltr_filter as tltr
from hite_tpu_torch.models import trainer as ttrainer
from hite_tpu_torch.models.features import FEATURE_DIM
from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(2)

LOSS_TOL = 0.01
SF_TOL = 0.02
LTR_TOL = 0.08
GRAD_COS = 0.98
BIAS_GAP = 0.01
SEEDS = (0, 1)
# the JAX package's LTRFilterCNN init for seed 0, bundled with the port
LTR_INIT = "ltr_filter_init_seed0.pkl"
LTR_INIT_SHAPES = ((1, 100, 400, 3), (1, 16, 16, 2))


def _same_lib(a, b):
    assert list(a) == list(b)
    for n in a:
        assert np.array_equal(a[n], b[n]), n


# ---- the corpora

@pytest.mark.parametrize("seed", SEEDS)
def test_synthetic_training_set_equal(seed):
    from hite_tpu.models import synthetic as js
    from hite_tpu_torch.models import synthetic as ts

    ref = js.synthetic_training_set(n_per_class=3, seed=seed)
    got = ts.synthetic_training_set(n_per_class=3, seed=seed)
    _same_lib(ref[0], got[0])
    assert ref[1] == got[1] and ref[2] == got[2]
    sub = ["hAT", "Copia", "Helitron"]
    _same_lib(js.synthetic_library(2, seed + 5, sub),
              ts.synthetic_library(2, seed + 5, sub))
    assert js.load_protein_pools() == ts.load_protein_pools()


@pytest.mark.parametrize("seed", SEEDS)
def test_synthetic_frames_equal(seed):
    from hite_tpu.models.synthetic import synthetic_frames as jframes
    from hite_tpu_torch.models.synthetic import synthetic_frames

    ref, got = jframes(n=12, seed=seed), synthetic_frames(n=12, seed=seed)
    assert got[0].shape == (12, 100, 400)
    assert all(np.array_equal(r, g) for r, g in zip(ref, got))


# ---- the datasets

def test_make_dataset_equal():
    """Located termini, the TSD block and the domain block, exactly;
    unmapped labels dropped."""
    from hite_tpu_torch.models.synthetic import synthetic_training_set

    lib, tsds, doms = synthetic_training_set(n_per_class=1, seed=4)
    lib["unmapped_0#Unknown/Thing"] = np.zeros(500, np.uint8)
    for kw in ({}, dict(tsds=tsds, domains=doms)):
        ref = jtrainer.make_dataset(lib, **kw)
        got = ttrainer.make_dataset(lib, device="cpu", **kw)
        assert got[0].shape == (28, FEATURE_DIM)
        assert np.array_equal(ref[0], got[0])
        assert np.array_equal(ref[1], got[1]) and ref[2] == got[2]


def test_curated_dataset_eval_fold_equal():
    """The curated eval fold's features with the domain evidence (both
    libraries scanned, BLOSUM62 confirms), labels and names."""
    ref = jtrainer.curated_dataset("eval")
    got = ttrainer.curated_dataset("eval", device="cpu")
    assert len(got[2]) == 27
    assert np.array_equal(ref[0], got[0])
    assert np.array_equal(ref[1], got[1]) and ref[2] == got[2]
    assert ttrainer.curated_names("train") == sorted(
        set(ttrainer.curated_names()) - set(got[2]))


# ---- the init

def _kernels(model):
    from hite_tpu_torch.models.convert import Conv, Dense, GroupNorm

    for name, mod in model.named_modules():
        if isinstance(mod, (Conv, Dense)):
            fan_in = mod.weight[0].numel()
            yield name, mod, fan_in
        if isinstance(mod, GroupNorm):
            assert torch.all(mod.weight == 1) and torch.all(mod.bias == 0)


@pytest.mark.parametrize("cls", [tcls.SuperfamilyCNN, tltr.LTRFilterCNN])
def test_flax_default_init(cls):
    """lecun_normal kernels (a normal truncated at +-2 sigma, standard
    deviation sqrt(1 / fan_in)), zero biases, GroupNorm scale 1; the same
    draw on every device for a seed."""
    from hite_tpu_torch.models.train import create_state

    model, _ = create_state(cls(), seed=3, device="cpu")
    pooled = []
    for name, mod, fan_in in _kernels(model):
        sigma = (1 / fan_in) ** 0.5
        w = mod.weight.detach().double()
        assert torch.all(mod.bias == 0), name
        assert float(w.abs().max()) <= 2 * sigma / convert.TRUNC_STD, name
        if w.numel() >= 500:
            assert abs(float(w.std()) / sigma - 1) < 0.1, name
        else:
            pooled.append((w / sigma).flatten())
    z = torch.cat(pooled)
    assert abs(float(z.std()) - 1) < 0.1, len(z)
    again, _ = create_state(cls(), seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  again.parameters()))


# ---- training steps from the same parameters

def _sf_batches(seed, B=8, steps=3):
    rng = np.random.default_rng(seed)
    X = rng.random((B * (steps + 1), FEATURE_DIM)).astype(np.float32)
    X[:, :1024] /= 512
    X[:, 1024:1664] /= 30
    y = rng.integers(0, 28, len(X)).astype(np.int32)
    return [((X[i * B:(i + 1) * B],), y[i * B:(i + 1) * B])
            for i in range(steps + 1)]


def _ltr_batches(seed, B=8, steps=3, width=400):
    rng = np.random.default_rng(seed)
    n = B * (steps + 1)
    M = rng.integers(0, 6, (n, 100, width))
    img = np.stack([M >= 4, rng.random(M.shape) < 0.5,
                    np.where(M < 4, (M + 1) / 4, 0)], -1).astype(np.float32)
    f = rng.random((n, 512)).astype(np.float32)
    f /= f.sum(1, keepdims=True) / 2
    km = f.reshape(n, 2, 16, 16).transpose(0, 2, 3, 1).copy()
    y = rng.integers(0, 2, n).astype(np.int32)
    return [((img[i * B:(i + 1) * B], km[i * B:(i + 1) * B]),
             y[i * B:(i + 1) * B]) for i in range(steps + 1)]


def _flax_pair(kind, seed, batch):
    """(flax model, its init params, the port model filled from them)."""
    if kind == "sf":
        jm, tm = jcls.SuperfamilyCNN(dropout=0.0), \
            tcls.SuperfamilyCNN(dropout=0.0)
    else:
        jm, tm = jltr.LTRFilterCNN(), tltr.LTRFilterCNN()
    params = jm.init(jax.random.key(seed), *map(jnp.asarray, batch))
    return jm, params, convert.load_flax_params(tm, params)


@pytest.mark.parametrize("kind,seed", [("sf", 0), ("sf", 1), ("ltr", 1)])
def test_train_steps_match_flax(kind, seed):
    """3 steps of the JAX `make_train_step` (optax.adamw) and the port's
    (torch AdamW with optax's settings) on the same batches: each step's
    loss, then the held batch's logits and decisions."""
    from hite_tpu.models.train import make_train_step as jstep
    from hite_tpu_torch.models.train import adamw, make_train_step

    batches = (_sf_batches(seed) if kind == "sf"
               else _ltr_batches(seed, B=4))
    jm, params, tm = _flax_pair(kind, seed, [a[:1] for a in batches[0][0]])
    tx = optax.adamw(1e-3)
    opt_state = tx.init(params)
    jit_step = jax.jit(jstep(jm, tx))
    step = make_train_step(tm, adamw(tm, 1e-3))
    for inputs, labels in batches[:-1]:
        params, opt_state, jloss = jit_step(params, opt_state, {
            "inputs": tuple(map(jnp.asarray, inputs)),
            "labels": jnp.asarray(labels)})
        tloss = step({"inputs": tuple(map(torch.from_numpy, inputs)),
                      "labels": torch.from_numpy(labels)})
        assert abs(float(jloss) - float(tloss)) <= LOSS_TOL
    held = batches[-1][0]
    ref = np.asarray(jm.apply(params, *map(jnp.asarray, held)))
    with torch.no_grad():
        got = tm.eval()(*map(torch.from_numpy, held)).numpy()
    assert np.abs(ref - got).max() <= (SF_TOL if kind == "sf" else LTR_TOL)
    assert np.array_equal(ref.argmax(-1), got.argmax(-1))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v).ravel()


def _ltr_grads(seed):
    """({leaf: flax's gradient}, {leaf: the port's}) of the cross-entropy
    of one 4-frame batch, from the JAX package's seed-`seed` init."""
    from hite_tpu.models.train import cross_entropy as jce
    from hite_tpu_torch.models.train import cross_entropy

    inputs, labels = _ltr_batches(seed, B=4, steps=0)[0]
    jm, params, tm = _flax_pair("ltr", seed, [a[:1] for a in inputs])
    g = jax.grad(lambda p: jce(jm.apply(p, *map(jnp.asarray, inputs)),
                               jnp.asarray(labels)))(params)
    cross_entropy(tm(*map(torch.from_numpy, inputs)),
                  torch.from_numpy(labels).long()).backward()
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(p.grad)
    return tuple({k: v.astype(np.float64) for k, v in _leaves(t)}
                 for t in (jax.tree.map(np.asarray, g),
                           convert.to_flax_params(tm)))


def _shortcut_bias_gaps(grads):
    """{ResBlock: |d Conv_2.bias - d GroupNorm_1.bias| / |d GroupNorm_1.bias|}:
    both biases add per channel ahead of the block's last ReLU, so their
    true gradients are equal."""
    blocks = {k.rsplit("/", 2)[0] for k in grads if "/Conv_2/" in k}
    return {b: float(np.linalg.norm(grads[f"{b}/Conv_2/bias"]
                                    - grads[f"{b}/GroupNorm_1/bias"])
                     / np.linalg.norm(grads[f"{b}/GroupNorm_1/bias"]))
            for b in sorted(blocks)}


@pytest.mark.parametrize("seed", [1, 2])
def test_ltr_gradients_match_flax(seed):
    """One LTRFilterCNN gradient from the same parameters and batch.  Every
    leaf but the conv biases within cosine GRAD_COS of flax's (measured
    >= 0.9968, a k-mer conv kernel).  The conv biases are where the two
    differ: XLA's CPU sums the gradient of a bf16 bias add in bf16, the
    port in float32, so the port's shortcut bias gradient equals its
    GroupNorm_1 bias gradient (the same true gradient) within bf16
    rounding (BIAS_GAP; measured <= 0.0018), where flax's differ by
    0.014-1.43 (`python tests/test_torch_train.py grad-gap 1 2`).  That
    is why the LTR filter's losses drift further from flax's in
    `test_train_steps_match_flax` than the superfamily CNN's."""
    ref, got = _ltr_grads(seed)
    assert set(ref) == set(got)
    for k in ref:
        if "/Conv_" in k and k.endswith("/bias"):
            continue
        cos = ref[k] @ got[k] / (np.linalg.norm(ref[k])
                                 * np.linalg.norm(got[k]))
        assert cos >= GRAD_COS, (k, cos)
    gaps = _shortcut_bias_gaps(got)
    assert len(gaps) == 6 and max(gaps.values()) <= BIAS_GAP, gaps


@pytest.mark.parametrize("n,batch,epochs", [(50, 16, 1), (10, 16, 3)])
def test_train_classifier_loop_matches_jax(n, batch, epochs):
    """The JAX `train_classifier` loop and the port's from the same
    parameters with dropout 0, 3 steps: the same permutations and batches
    (whole batches only: 3 steps an epoch at n 50; one whole-set step an
    epoch at n 10), each epoch's mean loss, then the logits."""
    rng = np.random.default_rng(n)
    X = rng.random((n + 8, FEATURE_DIM)).astype(np.float32)
    X[:, :1024] /= 512
    y = rng.integers(0, 5, n + 8).astype(np.int32)
    jm, params, tm = _flax_pair("sf", 2, [X[:1]])
    # the JAX loop inits from key(seed): hand it the same draw
    jax_model = jcls.SuperfamilyCNN(dropout=0.0)
    assert jax.tree.all(jax.tree.map(
        jnp.array_equal, params,
        jax_model.init(jax.random.key(2), jnp.asarray(X[:1]), train=False)))
    _m, jparams, jhist = jtrainer.train_classifier(
        X[:n], y[:n], epochs=epochs, batch_size=batch, seed=2,
        model=jax_model)
    model, hist = ttrainer.train_classifier(
        X[:n], y[:n], epochs=epochs, batch_size=batch, seed=2, model=tm,
        device="cpu")
    assert model is tm and len(hist) == len(jhist) == epochs
    assert np.abs(np.array(hist) - np.array(jhist)).max() <= LOSS_TOL
    ref = np.asarray(jax_model.apply(jparams, jnp.asarray(X[n:])))
    got = ttrainer.predict_logits(model, X[n:])
    assert np.abs(ref - got).max() <= SF_TOL
    assert np.array_equal(ref.argmax(-1), got.argmax(-1))


def _two_family_lib(rng, n_per=24):
    """`tests/test_trainer.py`'s problem: two families of very different
    terminal and k-mer composition."""
    lib = {}
    a = rng.integers(0, 2, 600).astype(np.uint8)
    b = (rng.integers(0, 2, 600) + 2).astype(np.uint8)
    for i in range(n_per):
        for cons, label, tag in ((a, "DNA/hAT", "a"), (b, "LTR/Gypsy", "b")):
            copy = cons.copy()
            muts = rng.random(len(copy)) < 0.05
            copy[muts] = rng.integers(0, 4, muts.sum())
            lib[f"{tag}{i}#{label}"] = copy
    return lib


def test_train_classifier_with_dropout_learns():
    """Dropout 0.5 from the port's init: the loss falls, held-out accuracy
    above 0.85 (the JAX package's own test of its loop)."""
    X, y, _ = ttrainer.make_dataset(_two_family_lib(
        np.random.default_rng(0)), device="cpu")
    order = np.random.default_rng(1).permutation(len(X))
    tr, te = order[: int(0.8 * len(X))], order[int(0.8 * len(X)):]
    model, hist = ttrainer.train_classifier(X[tr], y[tr], epochs=25, seed=0,
                                            device="cpu")
    assert model.dropout == 0.5 and not model.training
    assert hist[-1] < hist[0]
    assert ttrainer.evaluate(model, X[te], y[te])["accuracy"] > 0.85


def test_dropout_follows_flax():
    """Training mode drops with the generator's draws and scales kept
    features by 1 / (1 - rate); eval mode and rate 0 change nothing."""
    x = torch.from_numpy(np.random.default_rng(5).random(
        (4, FEATURE_DIM)).astype(np.float32))
    model = convert.reset_parameters(tcls.SuperfamilyCNN(dropout=0.5),
                                     torch.Generator().manual_seed(0))
    with torch.no_grad():
        ev = model.eval()(x)
        model.train()
        a = model(x, torch.Generator().manual_seed(1))
        b = model(x, torch.Generator().manual_seed(1))
        c = model(x, torch.Generator().manual_seed(2))
        off = tcls.SuperfamilyCNN(dropout=0.0)
        off.load_state_dict(model.state_dict())
        assert torch.equal(off.train()(x), ev)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, ev)
    # the mask itself: kept features doubled in bf16, the rest zero
    feats = []
    hook = model.Dense_0.register_forward_pre_hook(
        lambda m, inp: feats.append(inp[0]))
    with torch.no_grad():
        model.eval()(x)
        model.train()(x, torch.Generator().manual_seed(1))
    hook.remove()
    full, dropped = feats
    kept = dropped != 0
    assert full.dtype == dropped.dtype == torch.bfloat16
    assert 0.4 < float(kept.sum() / (full != 0).sum()) < 0.6
    assert torch.equal(dropped[kept], full[kept] * 2)


# ---- metrics

def test_evaluate_and_folds_equal(monkeypatch):
    """`evaluate`, `evaluate_per_class` and `cross_validate`'s folds equal
    the JAX package's, given the same predictions."""
    rng = np.random.default_rng(8)
    y = rng.integers(0, 6, 40).astype(np.int32)
    logits = rng.random((40, 28)).astype(np.float32)
    logits[np.arange(40) % 3 == 0, y[np.arange(40) % 3 == 0]] += 2
    monkeypatch.setattr(jtrainer, "predict_logits", lambda m, p, X: logits)
    monkeypatch.setattr(ttrainer, "predict_logits", lambda m, X: logits)
    X = np.zeros((40, 3), np.float32)
    assert jtrainer.evaluate(None, None, X, y) == ttrainer.evaluate(None, X, y)
    assert jtrainer.evaluate_per_class(None, None, X, y) == \
        ttrainer.evaluate_per_class(None, X, y)

    seen = {"jax": [], "port": []}

    def record(side):
        def train(Xt, yt, **kw):
            seen[side].append((Xt[:, 0].tolist(), kw["seed"]))
            return (None, None, None) if side == "jax" else (None, None)
        return train

    def ev(side):
        def evaluate(*args):
            seen[side].append(args[-2][:, 0].tolist())
            return {"f1": 0.0}
        return evaluate

    Xi = np.arange(23, dtype=np.float32)[:, None]
    yi = np.zeros(23, np.int32)
    for side, mod in (("jax", jtrainer), ("port", ttrainer)):
        monkeypatch.setattr(mod, "train_classifier", record(side))
        monkeypatch.setattr(mod, "evaluate", ev(side))
        mod.cross_validate(Xi, yi, folds=4, epochs=1, seed=3)
    assert seen["jax"] == seen["port"] and len(seen["port"]) == 8


# ---- checkpoints across the packages

@pytest.mark.parametrize("kind", ["sf", "ltr"])
def test_checkpoints_cross_packages(kind, tmp_path):
    """A port-initialised model saved by the port (float32 and float16)
    goes through the JAX `load_params` + flax `apply` and the port's
    `load_model`; a flax-initialised model saved by the JAX package goes
    through the port's `load_model`; logits within the CNN tolerance,
    decisions equal.  The converter round-trips both ways exactly."""
    from hite_tpu_torch.models.train import create_state

    tol = SF_TOL if kind == "sf" else LTR_TOL
    batches = (_sf_batches if kind == "sf" else _ltr_batches)(4, B=4,
                                                              steps=1)
    held = batches[-1][0]
    jm, params, _ = _flax_pair(kind, 4, [a[:1] for a in held])
    tcls_ = tcls.SuperfamilyCNN if kind == "sf" else tltr.LTRFilterCNN
    model, _ = create_state(tcls_(), seed=4, device="cpu")
    for dtype in (np.float32, np.float16):
        path = str(tmp_path / f"port_{np.dtype(dtype).name}.pkl")
        ttrainer.save_params(path, model, dtype)
        tree = jtrainer.load_params(path)
        assert {str(a.dtype) for a in jax.tree.leaves(tree)} == \
            {np.dtype(dtype).name}
        loaded = convert.load_model(tcls_, path, "cpu")
        if dtype == np.float32:
            assert all(torch.equal(a, b) for a, b in
                       zip(model.parameters(), loaded.parameters()))
        ref = np.asarray(jm.apply(tree, *map(jnp.asarray, held)))
        with torch.no_grad():
            got = loaded(*map(torch.from_numpy, held)).numpy()
        assert np.abs(ref - got).max() <= tol
        assert np.array_equal(ref.argmax(-1), got.argmax(-1))

    path = str(tmp_path / "jax.pkl")
    jtrainer.save_params(path, params)
    loaded = convert.load_model(tcls_, path, "cpu")
    assert not loaded.training
    assert not any(p.requires_grad for p in loaded.parameters())
    ref = np.asarray(jm.apply(params, *map(jnp.asarray, held)))
    with torch.no_grad():
        got = loaded(*map(torch.from_numpy, held)).numpy()
    assert np.abs(ref - got).max() <= tol
    assert np.array_equal(ref.argmax(-1), got.argmax(-1))
    with open(path, "rb") as fh:
        raw = pickle.load(fh)
    back = convert.to_flax_params(loaded)
    assert jax.tree.structure(back) == jax.tree.structure(raw)
    assert all(np.array_equal(a, np.asarray(b, np.float32)) for a, b in
               zip(jax.tree.leaves(back), jax.tree.leaves(raw)))


# ---- LTR training frames and weak labels

def test_make_training_frames_equal():
    """The 7-copy LTR genome: the planted copies as positives, random
    intervals as negatives; images, k-mer planes and labels exactly."""
    from chip_smoke import ltr6_genome
    from hite_tpu.config import PipelineConfig as JaxConfig
    from hite_tpu.genome import Genome as JaxGenome
    from hite_tpu.pipeline.ltr import LTRRecord as JaxRecord
    from hite_tpu.pipeline.ltr_deep import make_training_frames as jframes
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.pipeline.ltr import LTRRecord
    from hite_tpu_torch.pipeline.ltr_deep import make_training_frames

    bg, truth = ltr6_genome()
    rng = np.random.default_rng(6)
    neg = [(int(s), int(s) + 2600) for s in rng.integers(1000, 110_000, 4)]
    neg.append(truth[0])   # a planted copy as a negative: labels follow
    rec = lambda cls, s, e: cls(start=s, end=e, lltr_start=s, lltr_end=s + 300,
                                rltr_start=e - 300, rltr_end=e, identity=0.99,
                                insert_time=0.0)
    ref = jframes(JaxGenome.from_dict({"chr1": bg}),
                  [rec(JaxRecord, s, e) for s, e in truth[:4]], neg,
                  JaxConfig().with_genome_size(len(bg)))
    got = make_training_frames(Genome.from_dict({"chr1": bg}, device="cpu"),
                               [rec(LTRRecord, s, e) for s, e in truth[:4]],
                               neg, PipelineConfig().with_genome_size(len(bg)))
    assert got[0].shape[1:] == (100, 400, 3) and got[1].shape[1:] == (16, 16, 2)
    assert got[2].tolist()[:4] == [1, 1, 1, 1] and 0 in got[2]
    for r, g in zip(ref, got):
        assert np.array_equal(r, g)


CODON = {"A": "GCA", "R": "CGA", "N": "AAC", "D": "GAC", "C": "TGC",
         "Q": "CAA", "E": "GAA", "G": "GGA", "H": "CAC", "I": "ATC",
         "L": "CTA", "K": "AAA", "M": "ATG", "F": "TTC", "P": "CCA",
         "S": "TCA", "T": "ACA", "W": "TGG", "Y": "TAC", "V": "GTA"}


def _nt(protein):
    return "".join(CODON.get(a, "GCA") for a in protein)


def _weak_label_dir(root):
    """A finished run's confident_* files: a TIR entry carrying a
    reverse-translated TIRPeps protein (domain-labelled), a TIR entry
    without one (skipped) and a short one; two Helitron entries; LTR
    internals in Gypsy (RT then INT) and Copia order (INT then RT), one
    without a call, and an LTR terminal (not an internal)."""
    from hite_tpu_torch.io.fasta import write_fasta
    from hite_tpu_torch.ops.protein import decode_protein
    from hite_tpu_torch.pipeline.domain import read_protein_fasta
    from hite_tpu_torch.pipeline.run import DATA_DIR

    rng = np.random.default_rng(12)
    rand = lambda n: "".join("ACGT"[i] for i in rng.integers(0, 4, n))
    pep = read_protein_fasta(os.path.join(DATA_DIR, "protein", "TIRPeps.lib"))
    _n, codes = min(pep.items(), key=lambda kv: abs(len(kv[1]) - 160))
    filler = lambda n: "".join(rng.choice(list("ADEGKLNQRSTV"), n))
    rt = "LPQG" + filler(20) + "YADD"
    integrase = "H" + filler(4) + "H" + filler(28) + "C" + filler(2) + "C"
    os.makedirs(root, exist_ok=True)
    write_fasta(os.path.join(root, "confident_tir.fa"), {
        "TIR_1#DNA": rand(60) + _nt(decode_protein(codes)) + rand(60),
        "TIR_2#DNA": rand(700), "TIR_3#DNA": rand(60)})
    write_fasta(os.path.join(root, "confident_helitron.fa"), {
        "Helitron_1#RC/Helitron": rand(900), "Helitron_2#RC": rand(50)})
    write_fasta(os.path.join(root, "confident_TE.cons.fa"), {
        "ltr_1-I#LTR": _nt(filler(40) + rt + filler(60) + integrase
                           + filler(30)),
        "ltr_2-I#LTR": _nt(filler(30) + integrase + filler(50) + rt
                           + filler(40)),
        "ltr_3-I#LTR": rand(900), "ltr_1-LTR#LTR": rand(400),
        "TIR_1#DNA": rand(500)})


def test_mine_weak_labels_equal(tmp_path):
    from hite_tpu.models.weak_labels import mine_weak_labels as jmine
    from hite_tpu_torch import kernels
    from hite_tpu_torch.models.weak_labels import mine_weak_labels

    dirs = [str(tmp_path / "run0"), str(tmp_path / "run1")]
    for d in dirs:
        _weak_label_dir(d)
    ref = jmine(dirs)
    kernels.reset_launches()
    got = mine_weak_labels(dirs, device="cpu")
    _same_lib(ref[0], got[0])
    assert ref[1] == got[1]
    assert kernels.LAUNCHES["sw_protein"] == 0   # CPU: the plain version
    labels = {k.partition("_")[2]: v for k, v in got[1].items()
              if k.startswith("mined0_")}
    assert labels["Helitron_1"] == "Helitron"
    assert labels["ltr_1-I"] == "Gypsy" and labels["ltr_2-I"] == "Copia"
    assert "TIR_1" in labels and "TIR_2" not in labels
    assert not {"TIR_3", "Helitron_2", "ltr_3-I", "ltr_1-LTR"} & set(labels)
    assert len(got[0]) == 2 * len(labels)


# ---- pretraining

def test_pretrain_superfamily_checkpoint_loads_in_both(tmp_path):
    """`pretrain_superfamily` at a tiny size on the CPU writes a float16
    flax-layout pickle that the JAX package applies and the port loads,
    with the same logits within SF_TOL (float16 storage: 0.02 more)."""
    from hite_tpu_torch.models.pretrain import pretrain_superfamily

    out = str(tmp_path / "sf.pkl")
    metrics, hist = pretrain_superfamily(n_per_class=2, epochs=1,
                                         device="cpu", out=out)
    assert len(hist) == 1 and np.isfinite(hist[0])
    assert {"accuracy", "f1", "curated_accuracy", "curated_f1",
            "curated_per_class"} <= set(metrics)
    X = _sf_batches(9, B=6, steps=0)[0][0][0]
    tree = jtrainer.load_params(out)
    assert {str(a.dtype) for a in jax.tree.leaves(tree)} == {"float16"}
    ref = np.asarray(jcls.SuperfamilyCNN().apply(tree, jnp.asarray(X)))
    got = ttrainer.predict_logits(
        convert.load_model(tcls.SuperfamilyCNN, out, "cpu"), X)
    assert np.abs(ref - got).max() <= SF_TOL
    assert np.array_equal(ref.argmax(-1), got.argmax(-1))


def test_pretrain_ltr_filter_checkpoint_loads_in_both(tmp_path):
    """`pretrain_ltr_filter` at a tiny size on the CPU: its float16 pickle
    applies in flax and loads in the port, logits within LTR_TOL."""
    from hite_tpu_torch.models.pretrain import pretrain_ltr_filter

    out = str(tmp_path / "ltr.pkl")
    metrics, hist = pretrain_ltr_filter(n=16, epochs=1, device="cpu", out=out)
    assert len(hist) == 1 and 0.0 <= metrics["accuracy"] <= 1.0
    img, km = _ltr_batches(2, B=4, steps=0)[0][0]
    ref = np.asarray(jltr.LTRFilterCNN().apply(
        jtrainer.load_params(out), jnp.asarray(img), jnp.asarray(km)))
    with torch.no_grad():
        got = convert.load_model(tltr.LTRFilterCNN, out, "cpu")(
            torch.from_numpy(img), torch.from_numpy(km)).numpy()
    assert np.abs(ref - got).max() <= LTR_TOL
    assert np.array_equal(ref.argmax(-1), got.argmax(-1))


def test_ltr_init_file_is_jax_init():
    """The bundled `ltr_filter_init_seed0.pkl` is the JAX package's
    `train_ltr_filter` init for seed 0, leaf for leaf, and the port's
    `train_ltr_filter(init=...)` starts from it."""
    from hite_tpu_torch.models import bundled_model_path
    from hite_tpu_torch.models.pretrain import train_ltr_filter

    tree = convert.load_params(bundled_model_path(LTR_INIT))
    ref = dict(_leaves(jax.tree.map(np.asarray, jltr.LTRFilterCNN().init(
        jax.random.key(0), *(jnp.zeros(s, jnp.float32)
                             for s in LTR_INIT_SHAPES)))))
    assert {k: v.dtype for k, v in _leaves(tree)} == \
        {k: np.dtype(np.float32) for k in ref}
    assert all(np.array_equal(ref[k], v) for k, v in _leaves(tree))
    (img, km), y = _ltr_batches(0, B=2, steps=0)[0]
    model, hist = train_ltr_filter(img, km, y, epochs=0, init=tree,
                                   device="cpu")
    assert hist == []
    assert all(np.array_equal(ref[k], v)
               for k, v in _leaves(convert.to_flax_params(model)))


def test_pretrain_main_writes_both(monkeypatch, tmp_path):
    """`main --device cpu --out_dir D` trains both checkpoints into D."""
    from hite_tpu_torch.models import pretrain

    calls = []
    monkeypatch.setattr(pretrain, "pretrain_superfamily",
                        lambda **kw: calls.append(("sf", kw)) or ({}, [1.0]))
    monkeypatch.setattr(pretrain, "pretrain_ltr_filter",
                        lambda **kw: calls.append(("ltr", kw)) or ({}, [1.0]))
    pretrain.main(["--device", "cpu", "--out_dir", str(tmp_path / "m")])
    assert [(k, os.path.basename(kw["out"]), str(kw["device"]))
            for k, kw in calls] == [("sf", "superfamily_cnn.pkl", "cpu"),
                                    ("ltr", "ltr_filter_cnn.pkl", "cpu")]
    assert os.path.dirname(calls[0][1]["out"]) == str(tmp_path / "m")


def jax_ltr_seed_sweep(first: int, last: int) -> None:
    """The JAX package's `pretrain_ltr_filter` at its defaults for seeds
    first..last on the CPU, one JSON line a seed (accuracy on its own 80
    eval frames, loss by epoch): the spread `chip_smoke.py`'s seed sweep
    of the port's retrain is read against (~12 min a seed)."""
    import json

    from hite_tpu.models.pretrain import pretrain_ltr_filter

    for seed in range(first, last + 1):
        metrics, hist = pretrain_ltr_filter(seed=seed)
        print(json.dumps(dict(seed=seed, accuracy=metrics["accuracy"],
                              loss=[round(x, 4) for x in hist])), flush=True)


def jax_ltr_inits(first: int, last: int, out_dir: str) -> None:
    """The JAX package's LTRFilterCNN init for seeds first..last, as its
    `train_ltr_filter` draws it (`model.init(key(seed), ...)`), written as
    float32 flax trees `out_dir/ltr_filter_init_seed{s}.pkl`: seed 0 is
    the bundled LTR_INIT, and `hite_tpu_torch.scripts.ltr_seeds
    --init_dir` starts the port's retrain from the others."""
    for seed in range(first, last + 1):
        params = jltr.LTRFilterCNN().init(
            jax.random.key(seed), *(jnp.zeros(s, jnp.float32)
                                    for s in LTR_INIT_SHAPES))
        jtrainer.save_params(
            os.path.join(out_dir, f"ltr_filter_init_seed{seed}.pkl"),
            params)


def grad_gaps(seeds) -> None:
    """`_shortcut_bias_gaps` of flax's and the port's gradients, one JSON
    line a seed (`test_ltr_gradients_match_flax`'s measured values)."""
    import json

    for seed in seeds:
        ref, got = _ltr_grads(seed)
        print(json.dumps(dict(seed=seed, flax=_shortcut_bias_gaps(ref),
                              port=_shortcut_bias_gaps(got))))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_train.py ltr-seeds 0 7
    # JAX_PLATFORMS=cpu python tests/test_torch_train.py ltr-inits 0 31 DIR
    # JAX_PLATFORMS=cpu python tests/test_torch_train.py grad-gap 1 2
    import sys

    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "ltr-inits":
        jax_ltr_inits(int(args[0]), int(args[1]), args[2])
    elif mode == "grad-gap":
        grad_gaps(map(int, args))
    else:
        assert mode == "ltr-seeds", sys.argv
        jax_ltr_seed_sweep(int(args[0]), int(args[1]))
