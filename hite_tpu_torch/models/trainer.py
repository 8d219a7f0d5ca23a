"""Training and evaluation of the TE superfamily classifier (counterpart
of the JAX package's `models/trainer.py`, NeuralTE's `Trainer.py`,
`CrossValidator.py` and `evaluate_util.py`).

`build_features` assembles the NeuralTE-equivalent feature matrix for
every inference site and for training (located termini, TSD block, domain
block) in row batches padded to a power of two, as the JAX package does;
`make_dataset` / `curated_dataset` turn labeled libraries (headers
`>name#Class/Subclass`) into (X, y, names); `train_classifier` is the JAX
loop step for step (the same permutations and batches; only the dropout
stream is the port's own); `predict_logits` is one `eval()` forward under
`torch.no_grad()`; `evaluate` / `evaluate_per_class` / `cross_validate`
report accuracy and macro precision / recall / F1; `save_params` /
`load_params` read and write the flax-layout pickles both packages load.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from hite_tpu_torch.device import resolve_device
from hite_tpu_torch.models.classifier import (
    SuperfamilyCNN, WICKER_CLASSES, WICKER_TO_RM,
)
from hite_tpu_torch.models.convert import Tree, to_flax_params
from hite_tpu_torch.models.convert import load_params  # noqa: F401
from hite_tpu_torch.models.features import (
    N_DOMAIN_CLASSES, classifier_features, locate_termini, one_hot_float,
    tsd_feature,
)
from hite_tpu_torch.pipeline.candidates import pad_rows, pad_seqs
from hite_tpu_torch.utils.log import logger

RM_TO_WICKER = {v: k for k, v in WICKER_TO_RM.items()}
# common RepeatMasker aliases seen in Repbase-style libraries
RM_TO_WICKER.update({
    "DNA/CMC": "CACTA", "DNA/EnSpm": "CACTA", "DNA/CACTA": "CACTA",
    "DNA/hAT-Ac": "hAT", "DNA/hAT-Tip100": "hAT", "DNA/hAT-Charlie": "hAT",
    "DNA/TcMar-Tc1": "Tc1-Mariner", "DNA/TcMar-Mariner": "Tc1-Mariner",
    "DNA/MULE-MuDR": "Mutator", "DNA/MuDR": "Mutator",
    "DNA/PIF": "PIF-Harbinger", "DNA/Harbinger": "PIF-Harbinger",
    "LTR/ERV1": "Retrovirus", "LTR/ERVK": "Retrovirus",
    "LINE/CR1": "Jockey", "LINE/RTE-BovB": "RTE", "SINE/MIR": "tRNA",
    "RC/Helitron": "Helitron", "DNA/Helitron": "Helitron",
})


def label_to_class(label: str) -> Optional[int]:
    """`Class/Subclass` or Wicker name -> class index (None if unmapped)."""
    if label in WICKER_CLASSES:
        return WICKER_CLASSES.index(label)
    if label in RM_TO_WICKER:
        return WICKER_CLASSES.index(RM_TO_WICKER[label])
    head = label.split("-")[0]
    if head in RM_TO_WICKER:
        return WICKER_CLASSES.index(RM_TO_WICKER[head])
    return None


def build_features(
    seqs: Sequence[np.ndarray],
    *,
    tsd_seqs: Optional[Sequence[Optional[np.ndarray]]] = None,
    domain_classes: Optional[Sequence[Optional[int]]] = None,
    locate: bool = True,
    term_lens: Optional[np.ndarray] = None,   # [N] known terminal lengths
    batch: int = 256,
    device=None,
) -> np.ndarray:
    """The feature matrix float32 [N, FEATURE_DIM], computed on `device`
    (None = the card).

    Terminal lengths are `term_lens` when given ("given"), else located
    by the SW scans ("locate") or a fixed window (`locate=False`);
    `tsd_seqs`: per-row TSD codes or None; `domain_classes`: Wicker class
    index or None (= absent)."""
    dev = resolve_device(device)
    n = len(seqs)
    out: List[np.ndarray] = []
    for b0 in range(0, n, batch):
        sub = list(seqs[b0 : b0 + batch])
        mat, lens = pad_seqs(sub, n_rows=pad_rows(len(sub), min_rows=8))
        B = mat.shape[0]
        tmat = np.full((B, 16), 4, np.int32)
        tlens = np.zeros(B, np.int32)
        dom_idx = np.full(B, N_DOMAIN_CLASSES - 1, np.int32)
        for i in range(len(sub)):
            r = tsd_seqs[b0 + i] if tsd_seqs is not None else None
            if r is not None:
                r = np.asarray(r)
                tmat[i, : min(len(r), 16)] = r[:16]
                tlens[i] = min(len(r), 16)
            c = domain_classes[b0 + i] if domain_classes is not None else None
            if c is not None:
                dom_idx[i] = c
        mat_d = torch.from_numpy(mat).to(dev)
        lens_d = torch.from_numpy(lens).to(dev)
        if term_lens is not None:
            tl = np.zeros(B, np.int32)
            tl[: len(sub)] = np.asarray(term_lens[b0 : b0 + batch], np.int32)
            term = torch.from_numpy(tl).to(dev)
        elif locate:
            term = locate_termini(mat_d, lens_d)
        else:
            term = None
        dom = torch.from_numpy(dom_idx).to(dev)
        X = classifier_features(
            mat_d, lens_d, term_lens=term,
            tsd_onehot=tsd_feature(torch.from_numpy(tmat).to(dev),
                                   torch.from_numpy(tlens).to(dev)),
            domain_onehot=one_hot_float(dom, N_DOMAIN_CLASSES))
        out.append(X.cpu().numpy()[: len(sub)])
    return (np.concatenate(out) if out
            else np.zeros((0, 1), np.float32))


@torch.no_grad()
def predict_logits(model: nn.Module, X: np.ndarray) -> np.ndarray:
    """Logits float32 [N, classes] of `model` (in eval mode, on its own
    device) for the feature rows X."""
    if len(X) == 0:
        return np.zeros((0, len(WICKER_CLASSES)), np.float32)
    dev = next(model.parameters()).device
    return model.eval()(torch.from_numpy(np.asarray(X, np.float32)).to(dev)
                        ).cpu().numpy()


def make_dataset(
    lib: Dict[str, np.ndarray],
    max_len: int = 8192,
    tsds: Optional[Dict[str, str]] = None,
    domains: Optional[Dict[str, str]] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Labeled library -> (features float32 [N, F], labels int32 [N], kept
    names), the features built on `device` (None = the card).

    tsds: optional {name: TSD string} (the use_TSD-1 feature block);
    domains: optional {name: Wicker class label} protein-domain evidence."""
    from hite_tpu_torch.io.fasta import encode_seq

    seqs, labels, names = [], [], []
    for name, codes in lib.items():
        cls = label_to_class(name.partition("#")[2])
        if cls is None:
            continue
        seqs.append(codes[:max_len])
        labels.append(cls)
        names.append(name)
    if not seqs:
        return np.zeros((0, 1)), np.zeros(0, np.int32), []
    tsd_seqs = None
    if tsds is not None:
        tsd_seqs = [encode_seq(tsds.get(n) or "") for n in names]
    dom_cls = None
    if domains is not None:
        dom_cls = [label_to_class(domains[n]) if domains.get(n) else None
                   for n in names]
    X = build_features(seqs, tsd_seqs=tsd_seqs, domain_classes=dom_cls,
                       device=device)
    return X, np.array(labels, np.int32), names


TEST_REF = os.path.join(os.path.dirname(__file__), "..", "data", "test.ref")


def curated_names(fold: Optional[str] = None) -> List[str]:
    """The mappable entry names of `data/test.ref`, sorted; fold 'train' /
    'eval' takes alternate entries (a deterministic 50/50 split)."""
    from hite_tpu_torch.io.fasta import read_fasta

    names = sorted(n for n in read_fasta(TEST_REF)
                   if label_to_class(n.partition("#")[2]) is not None)
    if fold == "train":
        return names[::2]
    if fold == "eval":
        return names[1::2]
    return names


def curated_dataset(
    fold: Optional[str] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """The vendored curated library (`data/test.ref`, 78 labeled families
    of the reference's --species test set) as a classifier dataset, with
    the feature evidence the pipeline computes at inference (the protein
    domain scan, which launches `sw_protein`; no genome, so no TSD block),
    on `device` (None = the card).

    fold: None = every mappable entry; 'train' / 'eval' = alternate
    entries of the name-sorted list (`curated_names`)."""
    from hite_tpu_torch.config import DEFAULT
    from hite_tpu_torch.io.fasta import read_fasta
    from hite_tpu_torch.pipeline.library import library_feature_evidence

    lib = read_fasta(TEST_REF)
    names = curated_names(fold)
    seqs = [lib[n][:8192] for n in names]
    _tsd, dom_cls = library_feature_evidence(seqs, DEFAULT, None,
                                             device=device)
    domains = {n: (WICKER_CLASSES[c] if c is not None else None)
               for n, c in zip(names, dom_cls)}
    return make_dataset({n: lib[n] for n in names}, domains=domains,
                        device=device)


def train_classifier(
    X: np.ndarray,
    y: np.ndarray,
    *,
    epochs: int = 30,
    batch_size: int = 32,
    lr: float = 1e-3,
    seed: int = 0,
    model: Optional[nn.Module] = None,
    device=None,
) -> Tuple[nn.Module, List[float]]:
    """The JAX package's single-device loop on `device` (None = the card);
    returns (model, history: each epoch's mean loss).

    `model` (default `SuperfamilyCNN()`) starts from flax's init drawn
    from `seed` unless given.  Each epoch takes its order from
    `np.random.default_rng(seed)`, steps over whole batches only, and takes
    one whole-set step when there are fewer rows than a batch.  Dropout
    draws from one generator seeded with `seed` on the device."""
    from hite_tpu_torch.models.train import (
        adamw, create_state, make_train_step,
    )

    dev = resolve_device(device)
    if model is None:
        model, opt = create_state(SuperfamilyCNN(), seed, lr, dev)
    else:
        model = model.to(dev)
        opt = adamw(model, lr)
    step = make_train_step(model, opt,
                           torch.Generator(device=dev).manual_seed(seed))
    Xd = torch.from_numpy(np.asarray(X, np.float32)).to(dev)
    yd = torch.from_numpy(np.asarray(y, np.int64)).to(dev)
    n = len(X)
    history = []
    np_rng = np.random.default_rng(seed)
    for _epoch in range(epochs):
        order = torch.from_numpy(np_rng.permutation(n)).to(dev)
        losses = []
        for b0 in range(0, n - batch_size + 1, batch_size):
            idx = order[b0 : b0 + batch_size]
            losses.append(step({"inputs": (Xd[idx],), "labels": yd[idx]}))
        if n < batch_size:
            losses.append(step({"inputs": (Xd,), "labels": yd}))
        history.append(float(np.mean(
            torch.stack(losses).cpu().numpy().astype(np.float64))))
    model.eval()
    return model, history


def _prf(pred: np.ndarray, y: np.ndarray, c) -> Tuple[float, float, float]:
    tp = int(((pred == c) & (y == c)).sum())
    fp = int(((pred == c) & (y != c)).sum())
    fn = int(((pred != c) & (y == c)).sum())
    p = tp / (tp + fp) if tp + fp else 0.0
    r = tp / (tp + fn) if tp + fn else 0.0
    return p, r, (2 * p * r / (p + r) if p + r else 0.0)


def evaluate(model: nn.Module, X: np.ndarray,
             y: np.ndarray) -> Dict[str, float]:
    """Accuracy + macro precision / recall / F1 over the classes present
    in y (evaluate_util.get_metrics)."""
    pred = predict_logits(model, np.asarray(X)).argmax(-1)
    acc = float((pred == y).mean()) if len(y) else 0.0
    prf = np.array([_prf(pred, y, c) for c in np.unique(y)]).reshape(-1, 3)
    precision, recall, f1 = (float(np.mean(prf[:, i])) for i in range(3))
    return dict(accuracy=acc, precision=precision, recall=recall, f1=f1)


def evaluate_per_class(model: nn.Module, X: np.ndarray,
                       y: np.ndarray) -> Dict[str, Dict[str, float]]:
    """Per-class precision / recall / F1 / support, keyed by Wicker name
    (the breakdown of sklearn's classification_report that the reference
    prints in CrossValidator.py)."""
    pred = predict_logits(model, np.asarray(X)).argmax(-1)
    out: Dict[str, Dict[str, float]] = {}
    for c in np.unique(y):
        p, r, f = _prf(pred, y, c)
        out[WICKER_CLASSES[int(c)]] = dict(
            precision=round(p, 3), recall=round(r, 3), f1=round(f, 3),
            support=int((y == c).sum()))
    return out


def cross_validate(
    X: np.ndarray, y: np.ndarray, *, folds: int = 5, epochs: int = 20,
    seed: int = 0, device=None,
) -> List[Dict[str, float]]:
    """k-fold CV (NeuralTE CrossValidator.py): every folds-th row of one
    seeded permutation is a test fold; fold f trains with seed
    `seed + f`."""
    order = np.random.default_rng(seed).permutation(len(X))
    fold_metrics = []
    for f in range(folds):
        test_idx = order[f::folds]
        train_idx = np.setdiff1d(order, test_idx)
        model, _ = train_classifier(X[train_idx], y[train_idx],
                                    epochs=epochs, seed=seed + f,
                                    device=device)
        fold_metrics.append(evaluate(model, X[test_idx], y[test_idx]))
        logger.info("cv fold %d: %s", f, fold_metrics[-1])
    return fold_metrics


def save_params(path: str, model: nn.Module, dtype=np.float32) -> None:
    """Pickle `model`'s flax parameter tree (`to_flax_params`), every leaf
    cast to the numpy `dtype`: the file both packages' `load_params`
    read."""
    tree = to_flax_params(model)

    def cast(t: Tree) -> Tree:
        return {k: cast(v) if isinstance(v, dict) else v.astype(dtype)
                for k, v in t.items()}

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        pickle.dump(cast(tree), fh)
