"""Default-checkpoint pretraining of the two neural judges, on the card.

Counterpart of the JAX package's `models/pretrain.py`: the SuperfamilyCNN
on the synthetic corpus (`models.synthetic`) plus the curated train fold
(and, optionally, weak labels mined from finished runs), the LTRFilterCNN
on synthetic both-ends frames.  The checkpoints are float16 pickles of the
flax parameter tree, which both packages load:

    python -m hite_tpu_torch.models.pretrain               # on the card
    python -m hite_tpu_torch.models.pretrain --device cpu  # on the CPU

writes `data/models/superfamily_cnn.pkl` and `ltr_filter_cnn.pkl` (or
under `--out_dir`).  Every function takes `device=None`, the card.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from hite_tpu_torch.device import resolve_device
from hite_tpu_torch.models.convert import Tree
from hite_tpu_torch.utils.log import stage_timer

MODELS_DIR = os.path.join(os.path.dirname(__file__), "..", "data", "models")


def default_model_path(name: str) -> str:
    return os.path.join(MODELS_DIR, name)


def pretrain_superfamily(n_per_class: int = 60, epochs: int = 30,
                         seed: int = 0, out: Optional[str] = None,
                         mined_dirs: Optional[Sequence[str]] = None,
                         device=None) -> Tuple[Dict, List[float]]:
    """Train the SuperfamilyCNN on `device` (None = the card); returns
    (metrics, loss history), and writes the float16 checkpoint to `out`.

    Training rows: the synthetic set (`n_per_class` a class, seed `seed`)
    with its TSD and synthesis-truth domain blocks, the curated train fold
    3x, and, from `mined_dirs` (finished runs' out_dirs), the weak-labeled
    families 2x.  Metrics: the synthetic eval set (seed `seed + 1`), and
    `curated_*` on the curated eval fold with its per-class table."""
    from hite_tpu_torch.models.synthetic import synthetic_training_set
    from hite_tpu_torch.models.trainer import (
        curated_dataset, evaluate, evaluate_per_class, make_dataset,
        save_params, train_classifier,
    )

    dev = resolve_device(device)
    with stage_timer("pretrain.superfamily.features"):
        # the domain labels are synthesis truth: internals of
        # protein-backed classes ARE that superfamily's reverse-translated
        # transposases
        lib, tsds, domains = synthetic_training_set(
            n_per_class=n_per_class, seed=seed)
        X, y, _ = make_dataset(lib, tsds=tsds, domains=domains, device=dev)
        Xc, yc, _ = curated_dataset(fold="train", device=dev)
        if len(Xc):
            X = np.concatenate([X] + [Xc] * 3)
            y = np.concatenate([y] + [yc] * 3)
        if mined_dirs:
            from hite_tpu_torch.models.weak_labels import mine_weak_labels

            mlib, mlabels = mine_weak_labels(mined_dirs, device=dev)
            mlib = {f"{n}#{mlabels[n]}": s for n, s in mlib.items()
                    if mlabels.get(n)}
            if mlib:
                Xm, ym, _ = make_dataset(
                    mlib, domains={n: n.rpartition("#")[2] for n in mlib},
                    device=dev)
                X = np.concatenate([X] + [Xm] * 2)
                y = np.concatenate([y] + [ym] * 2)
    with stage_timer("pretrain.superfamily.train"):
        model, hist = train_classifier(X, y, epochs=epochs, seed=seed,
                                       device=dev)

    with stage_timer("pretrain.superfamily.features"):
        ev = synthetic_training_set(n_per_class=max(8, n_per_class // 5),
                                    seed=seed + 1)
        Xe, ye, _ = make_dataset(ev[0], tsds=ev[1], domains=ev[2],
                                 device=dev)
        Xr, yr, _ = curated_dataset(fold="eval", device=dev)
    metrics = evaluate(model, Xe, ye)
    if len(Xr):
        cur = evaluate(model, Xr, yr)
        metrics.update({f"curated_{k}": v for k, v in cur.items()})
        metrics["curated_per_class"] = evaluate_per_class(model, Xr, yr)
    if out:
        save_params(out, model, np.float16)
    return metrics, hist


def train_ltr_filter(imgs: np.ndarray, kms: np.ndarray, labels: np.ndarray,
                     *, epochs: int = 10, batch_size: int = 16,
                     lr: float = 1e-3, seed: int = 0,
                     init: Optional[Tree] = None,
                     device=None) -> Tuple[nn.Module, List[float]]:
    """Train an LTRFilterCNN (flax's init from `seed`, or the flax
    parameter tree `init`) on (image, k-mer, label) arrays on `device`
    (None = the card); the JAX loop: a seeded permutation an epoch,
    batches from 0 while one still starts before n - batch_size + 1 (at
    least one), each epoch's mean loss."""
    from hite_tpu_torch.models.ltr_filter import LTRFilterCNN
    from hite_tpu_torch.models.train import create_state, make_train_step

    dev = resolve_device(device)
    model, opt = create_state(LTRFilterCNN(), seed, lr, dev, init=init)
    step = make_train_step(model, opt)
    imgs_d = torch.from_numpy(np.asarray(imgs, np.float32)).to(dev)
    kms_d = torch.from_numpy(np.asarray(kms, np.float32)).to(dev)
    y_d = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
    n = len(labels)
    np_rng = np.random.default_rng(seed)
    history = []
    for _epoch in range(epochs):
        order = torch.from_numpy(np_rng.permutation(n)).to(dev)
        losses = []
        for b0 in range(0, max(n - batch_size + 1, 1), batch_size):
            idx = order[b0 : b0 + batch_size]
            losses.append(step({"inputs": (imgs_d[idx], kms_d[idx]),
                                "labels": y_d[idx]}))
        history.append(float(np.mean(
            torch.stack(losses).cpu().numpy().astype(np.float64))))
    model.eval()
    return model, history


def _frame_inputs(frames: np.ndarray,
                  device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(images [N, 100, 400, 3], k-mer planes [N, 16, 16, 2]) of frame
    matrices, computed on `device` (None = the card)."""
    from hite_tpu_torch.pipeline.ltr_deep import cnn_inputs

    dev = resolve_device(device)
    imgs, kms = zip(*(cnn_inputs(M, dev) for M in frames))
    return np.stack(imgs), np.stack(kms)


@torch.no_grad()
def ltr_filter_accuracy(model: nn.Module, imgs: np.ndarray, kms: np.ndarray,
                        labels: np.ndarray) -> float:
    """Share of frames whose argmax class equals the label."""
    dev = next(model.parameters()).device
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    logits = model.eval()(as_t(imgs), as_t(kms))
    return float((logits.argmax(-1).cpu().numpy() == labels).mean())


def pretrain_ltr_filter(n: int = 400, epochs: int = 8, seed: int = 0,
                        out: Optional[str] = None,
                        init: Optional[Tree] = None,
                        device=None) -> Tuple[Dict, List[float]]:
    """Train the LTR filter CNN on `n` synthetic both-ends frames on
    `device` (None = the card), from flax's init drawn from `seed` or from
    the flax parameter tree `init`; returns ({"accuracy": on max(40, n / 5)
    frames of seed `seed + 1`}, loss history), and writes the float16
    checkpoint to `out`."""
    from hite_tpu_torch.models.synthetic import synthetic_frames
    from hite_tpu_torch.models.trainer import save_params

    dev = resolve_device(device)
    with stage_timer("pretrain.ltr_filter.features"):
        frames, labels = synthetic_frames(n=n, seed=seed)
        imgs, kms = _frame_inputs(frames, dev)
        ef, el = synthetic_frames(n=max(40, n // 5), seed=seed + 1)
        eimgs, ekms = _frame_inputs(ef, dev)
    with stage_timer("pretrain.ltr_filter.train"):
        model, hist = train_ltr_filter(imgs, kms, labels, epochs=epochs,
                                       seed=seed, init=init, device=dev)
    acc = ltr_filter_accuracy(model, eimgs, ekms, el)
    if out:
        save_params(out, model, np.float16)
    return dict(accuracy=acc), hist


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m hite_tpu_torch.models.pretrain",
        description="Retrain both default checkpoints.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out_dir", default=MODELS_DIR,
                    help="where superfamily_cnn.pkl and ltr_filter_cnn.pkl "
                         "go (default: the bundled data/models/)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    m1, h1 = pretrain_superfamily(
        out=os.path.join(args.out_dir, "superfamily_cnn.pkl"), device=dev)
    print("superfamily:", m1, "final loss", h1[-1])
    m2, h2 = pretrain_ltr_filter(
        out=os.path.join(args.out_dir, "ltr_filter_cnn.pkl"), device=dev)
    print("ltr_filter:", m2, "final loss", h2[-1])


if __name__ == "__main__":
    main()
