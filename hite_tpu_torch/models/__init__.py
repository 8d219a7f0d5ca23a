"""Neural models (NeuralTE / HybridLTR equivalents) and their training.

Counterpart of the JAX package's `models/`: the superfamily classifier and
the LTR deep filter as `nn.Module`s, their feature extraction, the
converter between them and the flax parameter trees both packages bundle
(`convert`), the training step (`train`), the classifier's training and
evaluation (`trainer`), the synthetic and weak-label corpora (`synthetic`,
`weak_labels`) and the pretraining of the default checkpoints
(`pretrain`, `python -m hite_tpu_torch.models.pretrain`).
"""

from __future__ import annotations

import os

_MODELS_DIR = os.path.join(os.path.dirname(__file__), "..", "data", "models")


def bundled_model_path(name: str) -> str | None:
    """Absolute path of a bundled default checkpoint, or None if absent.

    The port keeps its own copies of the JAX package's bundled pickles
    (`data/models/`): plain nested dicts of float16 numpy arrays in the
    flax layout, read by `models.convert.load_params`.
    """
    path = os.path.abspath(os.path.join(_MODELS_DIR, name))
    return path if os.path.exists(path) else None
