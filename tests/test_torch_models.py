"""The port's neural models and their features vs hite_tpu's.

The converter on the bundled pickles and on flax-initialised trees; both
CNNs' logits against flax `apply` on seeded numpy inputs; flax's SAME
padding at stride 2 on even and odd widths; every feature function and
`build_features` mode bit-exact; `predict_labels` ties and `restrict`;
`label_to_class`.

Tolerances: the CNNs are bf16 arithmetic on both sides (bf16 inputs and
weights, float32 accumulation, bf16 activations; flax/XLA and PyTorch
round at slightly different points), so logits are compared within
LTR_TOL = 0.08 (largest difference measured over 6 seeds x 16 frames:
0.047, at |logits| <= 3.7) and SF_TOL = 0.02 (measured: 0.003 at
|logits| <= 22); every decision (argmax, p >= 0.5) must be identical.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hite_tpu.models import classifier as jcls
from hite_tpu.models import features as jfeat
from hite_tpu.models import ltr_filter as jltr
from hite_tpu.models import trainer as jtrain
from hite_tpu_torch.models import classifier as tcls
from hite_tpu_torch.models import convert
from hite_tpu_torch.models import features as tfeat
from hite_tpu_torch.models import ltr_filter as tltr
from hite_tpu_torch.models import trainer as ttrain
from hite_tpu_torch.models import bundled_model_path
from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(2)

LTR_TOL = 0.08
SF_TOL = 0.02
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("ltr_filter_cnn.pkl", "superfamily_cnn.pkl")


def _t(x):
    return torch.from_numpy(np.array(x))


def _ltr_inputs(seed, B=8, width=400):
    """Frame-like images (gap / support / base channels) and k-mer planes."""
    rng = np.random.default_rng(seed)
    M = rng.integers(0, 6, (B, 100, width))
    img = np.stack([M >= 4, rng.random(M.shape) < 0.5,
                    np.where(M < 4, (M + 1) / 4, 0)], -1).astype(np.float32)
    f = rng.random((B, 512)).astype(np.float32)
    f /= f.sum(1, keepdims=True) / 2
    km = f.reshape(B, 2, 16, 16).transpose(0, 2, 3, 1).copy()
    return img, km


def _sf_inputs(seed, B=16):
    rng = np.random.default_rng(seed)
    X = rng.random((B, tfeat.FEATURE_DIM)).astype(np.float32)
    X[:, :1024] /= 512
    X[:, 1024:1664] /= 30
    return X


def _both(name, tree):
    """(flax apply fn, port module) of a model filled from `tree`."""
    if name.startswith("ltr"):
        fn = jax.jit(lambda p, a, b: jltr.LTRFilterCNN().apply(p, a, b))
        return fn, convert.load_flax_params(tltr.LTRFilterCNN(), tree)
    fn = jax.jit(lambda p, x: jcls.SuperfamilyCNN().apply(p, x))
    # eval mode: flax applies without train=True, so without dropout
    return fn, convert.load_flax_params(tcls.SuperfamilyCNN(), tree).eval()


# ---- the converter

@pytest.mark.parametrize("name", MODELS)
def test_bundled_pickles_are_copies(name):
    path = bundled_model_path(name)
    assert path and path.startswith(os.path.join(ROOT, "hite_tpu_torch"))
    with open(path, "rb") as a, open(os.path.join(
            ROOT, "hite_tpu", "data", "models", name), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", MODELS)
def test_converter_maps_every_leaf(name):
    """Each flax leaf lands in its parameter, transposed as stated:
    conv HWIO -> OIHW / WIO -> OIW, Dense (in, out) -> (out, in),
    GroupNorm scale -> weight; the parameter counts agree."""
    tree = convert.load_params(bundled_model_path(name))
    _fn, model = _both(name, tree)
    params = dict(model.named_parameters())
    n_leaves = 0

    def walk(sub, path):
        nonlocal n_leaves
        for k, v in sub.items():
            if isinstance(v, dict):
                walk(v, path + [k])
                continue
            n_leaves += 1
            pname = ".".join(path + [{"kernel": "weight",
                                      "scale": "weight"}.get(k, k)])
            got = params[pname].detach().numpy()
            want = np.asarray(v, np.float32)
            if k == "kernel" and want.ndim >= 3:
                want = np.moveaxis(want, (-1, -2), (0, 1))
            elif k == "kernel":
                want = want.T
            assert np.array_equal(got, want), pname

    walk(tree["params"], [])
    assert n_leaves == len(params)
    bad = {"params": dict(tree["params"], extra={})}
    with pytest.raises(KeyError):
        convert.load_flax_params(_both(name, tree)[1], bad)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("seed", [0, 1])
def test_logits_bundled(name, seed):
    """Bundled (float16) parameters: logits within tolerance, decisions
    identical."""
    tree = convert.load_params(bundled_model_path(name))
    fn, model = _both(name, tree)
    jp = jtrain.load_params(os.path.join(ROOT, "hite_tpu", "data", "models",
                                         name))
    with torch.no_grad():
        if name.startswith("ltr"):
            img, km = _ltr_inputs(seed)
            ref = np.asarray(fn(jp, jnp.asarray(img), jnp.asarray(km)))
            got = model(_t(img), _t(km)).numpy()
            tol = LTR_TOL
            p = lambda z: np.exp(z[:, 1]) / np.exp(z).sum(1)
            assert np.array_equal(p(ref) >= 0.5, p(got) >= 0.5)
        else:
            X = _sf_inputs(seed)
            ref = np.asarray(fn(jp, jnp.asarray(X)))
            got = model(_t(X)).numpy()
            tol = SF_TOL
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(ref - got).max() <= tol
    assert np.array_equal(ref.argmax(1), got.argmax(1))


@pytest.mark.parametrize("name", MODELS)
def test_logits_flax_initialised(name):
    """A flax-initialised float32 tree converts and agrees as well."""
    if name.startswith("ltr"):
        img, km = _ltr_inputs(3, B=4)
        init = jltr.LTRFilterCNN().init(jax.random.key(3),
                                        jnp.asarray(img[:1]),
                                        jnp.asarray(km[:1]))
        ref = np.asarray(jax.jit(jltr.LTRFilterCNN().apply)(
            init, jnp.asarray(img), jnp.asarray(km)))
        model = convert.load_flax_params(tltr.LTRFilterCNN(),
                                         jax.tree.map(np.asarray, init))
        with torch.no_grad():
            got = model(_t(img), _t(km)).numpy()
        tol = LTR_TOL
    else:
        X = _sf_inputs(3, B=8)
        init = jcls.SuperfamilyCNN().init(jax.random.key(3),
                                          jnp.asarray(X[:1]))
        ref = np.asarray(jax.jit(jcls.SuperfamilyCNN().apply)(
            init, jnp.asarray(X)))
        model = convert.load_flax_params(tcls.SuperfamilyCNN(),
                                         jax.tree.map(np.asarray, init))
        with torch.no_grad():
            got = model.eval()(_t(X)).numpy()
        tol = SF_TOL
    assert np.abs(ref - got).max() <= tol
    assert np.array_equal(ref.argmax(1), got.argmax(1))


def test_load_model_cached_per_device():
    path = bundled_model_path("superfamily_cnn.pkl")
    a = convert.load_model(tcls.SuperfamilyCNN, path, "cpu")
    assert convert.load_model(tcls.SuperfamilyCNN, path, "cpu") is a
    assert not a.training
    assert all(p.device.type == "cpu" for p in a.parameters())


@pytest.mark.parametrize("n,k,s,want", [(200, 3, 2, (0, 1)),
                                        (25, 3, 2, (1, 1)),
                                        (16, 1, 2, (0, 0)),
                                        (1773, 7, 1, (3, 3)),
                                        (8, 3, 1, (1, 1))])
def test_same_pads(n, k, s, want):
    assert convert.same_pads(n, k, s) == want


@pytest.mark.parametrize("hw", [(16, 16), (25, 25), (10, 7)])
def test_resblock_stride2_padding(hw):
    """A stride-2 ResBlock (3x3 SAME + 1x1 shortcut) on even and odd
    inputs: same shape and values as flax within the bf16 tolerance."""
    rng = np.random.default_rng(sum(hw))
    x = rng.random((2,) + hw + (8,)).astype(np.float32)
    block = jltr.ResBlock(16, stride=2)
    init = block.init(jax.random.key(5), jnp.asarray(x))
    ref = np.asarray(block.apply(init, jnp.asarray(x)).astype(jnp.float32))
    ours = convert.load_flax_params(tltr.ResBlock(8, 16, stride=2),
                                    jax.tree.map(np.asarray, init))
    with torch.no_grad():
        got = ours(_t(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, -(-hw[0] // 2), -(-hw[1] // 2), 16)
    assert np.abs(ref - got).max() <= LTR_TOL


# ---- features, bit-exact

def _seqs(seed, B=6, L=300, n_frac=0.05):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 4, (B, L)).astype(np.uint8)
    s[rng.random((B, L)) < n_frac] = 4
    lens = rng.integers(60, L + 1, B).astype(np.int32)
    lens[0] = L
    for r in range(B):
        s[r, lens[r]:] = 4
    return s, lens


@pytest.mark.parametrize("k", [3, 4, 5])
def test_kmer_frequencies(k):
    s, lens = _seqs(k)
    ref = jfeat.kmer_frequencies(jnp.asarray(s), jnp.asarray(lens), k)
    got = tfeat.kmer_frequencies(_t(s), _t(lens), k)
    assert np.array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("given", [False, True])
def test_terminal_kmer_features(given):
    s, lens = _seqs(7)
    term = (np.array([3, 7, 20, 50, 80, 45], np.int32) if given else None)
    ref = jfeat.terminal_kmer_features(
        jnp.asarray(s), jnp.asarray(lens),
        term_lens=None if term is None else jnp.asarray(term))
    got = tfeat.terminal_kmer_features(
        _t(s), _t(lens), term_lens=None if term is None else _t(term))
    assert np.array_equal(np.asarray(ref), got.numpy())


def _termini_case():
    """Rows with a direct 60 bp terminal repeat, a 12 bp inverted one, and
    neither."""
    rng = np.random.default_rng(11)
    s = rng.integers(0, 4, (8, 400)).astype(np.uint8)
    lens = np.full(8, 400, np.int32)
    t = rng.integers(0, 4, 60).astype(np.uint8)
    s[0, :60] = t
    s[0, 340:400] = t
    i = rng.integers(0, 4, 12).astype(np.uint8)
    s[1, :12] = i
    s[1, 388:400] = (3 - i)[::-1]
    lens[2] = 150
    s[2, 150:] = 4
    return s, lens


def test_locate_termini():
    s, lens = _termini_case()
    ref = np.asarray(jfeat.locate_termini(jnp.asarray(s), jnp.asarray(lens)))
    got = tfeat.locate_termini(_t(s), _t(lens)).numpy()
    assert np.array_equal(ref, got)
    assert got[0] >= 50 and 7 <= got[1] < 50


def test_tsd_and_classifier_features():
    s, lens = _seqs(13, B=5)
    tsd = np.random.default_rng(1).integers(0, 5, (5, 20)).astype(np.int32)
    tl = np.array([0, 3, 5, 16, 20], np.int32)
    ref_t = jfeat.tsd_feature(jnp.asarray(tsd), jnp.asarray(tl))
    got_t = tfeat.tsd_feature(_t(tsd), _t(tl))
    assert np.array_equal(np.asarray(ref_t), got_t.numpy())
    dom = jax.nn.one_hot(jnp.asarray([0, 28, 5, 27, 28]), 29)
    term = np.array([50, 7, 12, 30, 100], np.int32)
    ref = jfeat.classifier_features(jnp.asarray(s), jnp.asarray(lens),
                                    term_lens=jnp.asarray(term),
                                    tsd_onehot=ref_t, domain_onehot=dom)
    got = tfeat.classifier_features(_t(s), _t(lens), term_lens=_t(term),
                                    tsd_onehot=got_t,
                                    domain_onehot=_t(np.asarray(dom)))
    assert got.shape == (5, tfeat.FEATURE_DIM)
    assert np.array_equal(np.asarray(ref), got.numpy())
    ref0 = jfeat.classifier_features(jnp.asarray(s), jnp.asarray(lens))
    got0 = tfeat.classifier_features(_t(s), _t(lens))
    assert np.array_equal(np.asarray(ref0), got0.numpy())


@pytest.mark.parametrize("R", [20, 150])
def test_frame_image(R):
    """Codes 0-5, rows fewer and more than 100, and majority ties (the
    first code wins on both sides)."""
    rng = np.random.default_rng(R)
    M = rng.integers(0, 6, (R, 400)).astype(np.uint8)
    M[:, 0] = np.arange(R) % 2            # tie between A and C
    M[:, 1] = 3 - np.arange(R) % 2        # tie between T and G
    M[:, 2] = 5
    ref = np.asarray(jfeat.frame_image(jnp.asarray(M), n_rows=100))
    got = tfeat.frame_image(_t(M), n_rows=100).numpy()
    assert np.array_equal(ref, got)
    assert got.shape == (100, 400, 3)
    assert got[0, 0, 1] == 1.0 and got[1, 0, 1] == 0.0    # majority A
    assert got[0, 1, 1] == 0.0 and got[1, 1, 1] == 1.0    # majority G


def test_kmer_channels():
    rng = np.random.default_rng(2)
    f3 = rng.random((3, 64)).astype(np.float32)
    f4 = rng.random((3, 256)).astype(np.float32)
    ref = jltr.kmer_channels(jnp.asarray(f3), jnp.asarray(f4))
    got = tltr.kmer_channels(_t(f3), _t(f4))
    assert np.array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("mode", ["locate", "fixed", "given"])
def test_build_features(mode):
    """The three terminal modes, with TSD and domain evidence for some
    rows, over two row batches."""
    s, lens = _termini_case()
    seqs = [s[i, : lens[i]] for i in range(len(s))]
    seqs += [np.random.default_rng(5).integers(0, 4, 900).astype(np.uint8)]
    n = len(seqs)
    tsd = [None, np.array([0, 1, 2, 3, 0]), None, np.arange(20) % 4,
           None, None, np.array([2, 2]), None, None]
    dom = [None, 3, None, None, 27, 0, None, None, 12]
    kw = dict(tsd_seqs=tsd, domain_classes=dom, batch=4)
    if mode == "fixed":
        kw["locate"] = False
    if mode == "given":
        kw["term_lens"] = np.arange(n, dtype=np.int32) * 9
    ref = jtrain.build_features(seqs, **kw)
    got = ttrain.build_features(seqs, device="cpu", **kw)
    assert got.shape == (n, tfeat.FEATURE_DIM)
    assert np.array_equal(ref, got)


def test_predict_labels_ties_and_restrict():
    logits = np.zeros((4, 28), np.float32)
    logits[0, [3, 9]] = 5.0                     # tie: the first class
    logits[1, 0] = 9.0                          # Copia, unrestricted
    logits[1, 17] = 2.0                         # hAT, within DNA
    logits[2, 5] = logits[2, 16] = 1.0          # tie inside the restriction
    for wicker in (True, False):
        for restrict in (None, tcls.DNA_SUPERFAMILIES,
                         tcls.LTR_SUPERFAMILIES):
            ref = jcls.predict_labels(logits, is_wicker=wicker,
                                      restrict=restrict)
            got = tcls.predict_labels(logits, is_wicker=wicker,
                                      restrict=restrict)
            assert ref == got
    assert tcls.predict_labels(logits)[0] == "Retrovirus"
    assert tcls.predict_labels(logits, restrict=tcls.DNA_SUPERFAMILIES
                               )[1:3] == ["hAT", "Tc1-Mariner"]
    assert tcls.WICKER_CLASSES == jcls.WICKER_CLASSES
    assert tcls.WICKER_TO_RM == jcls.WICKER_TO_RM
    for a in ("LTR", "DNA", "NONLTR"):
        assert getattr(tcls, f"{a}_SUPERFAMILIES") == \
            getattr(jcls, f"{a}_SUPERFAMILIES")


def test_label_to_class():
    labels = (list(jcls.WICKER_CLASSES) + list(jcls.WICKER_TO_RM.values())
              + list(jtrain.RM_TO_WICKER) + ["DNA/hAT-Ac-x", "LTR/ERVK-y",
                                             "Unknown", "", "DNA", "LINE",
                                             "RC/Helitron", "Satellite/x"])
    assert ttrain.RM_TO_WICKER == jtrain.RM_TO_WICKER
    assert [ttrain.label_to_class(x) for x in labels] == \
        [jtrain.label_to_class(x) for x in labels]
    assert ttrain.label_to_class("Unknown") is None


def test_predict_logits_matches_flax():
    """`predict_logits` (eval forward, no grad) on features from
    `build_features`, against the JAX package's jitted apply."""
    s, lens = _termini_case()
    seqs = [s[i, : lens[i]] for i in range(len(s))]
    X = ttrain.build_features(seqs, device="cpu")
    model = convert.load_model(tcls.SuperfamilyCNN,
                               bundled_model_path("superfamily_cnn.pkl"),
                               "cpu")
    got = ttrain.predict_logits(model, X)
    jm = jcls.SuperfamilyCNN()
    jp = jtrain.load_params(os.path.join(ROOT, "hite_tpu", "data", "models",
                                         "superfamily_cnn.pkl"))
    ref = jtrain.predict_logits(jm, jp, X)
    assert np.abs(ref - got).max() <= SF_TOL
    assert np.array_equal(ref.argmax(1), got.argmax(1))
    assert ttrain.predict_logits(model, X[:0]).shape == (0, 28)
