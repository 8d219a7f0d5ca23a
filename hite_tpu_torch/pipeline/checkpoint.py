"""Stage-level checkpoint / resume (counterpart of the JAX package's
`pipeline/checkpoint.py`).

Replaces the reference's recover-file mechanism (`--recover 1` skips any
stage whose output file exists, `main.py:432,451,516,...`): each pipeline
stage pickles its result under `{out_dir}/.checkpoints/{stage}.{hash}.pkl`,
and a resumed run loads every stage whose snapshot is present for the same
config hash.  The port's `PipelineConfig` is field-for-field the JAX one,
so equal configs give the JAX package's hash.

Two differences from the JAX package, both so that a resumed run sees what
the first run computed: a snapshot is pickled when `save` is called (the
caller may change the result afterwards, as the low-copy rescue changes
the modules' results) and only the file write runs on the background
thread; and every tensor in a snapshot is moved to the host, so a run on
another device loads it.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import threading
from typing import Any, Callable, Optional

import torch

from hite_tpu_torch.config import PipelineConfig
from hite_tpu_torch.utils.log import logger


def config_hash(cfg: PipelineConfig) -> str:
    """Stable hash of the config tree (stages invalidate on config change)."""
    blob = json.dumps(_as_jsonable(cfg), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _as_jsonable(obj: Any):
    import dataclasses

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _as_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_as_jsonable(o) for o in obj]
    if isinstance(obj, dict):
        return {str(k): _as_jsonable(v) for k, v in obj.items()}
    return obj


def _same(x):
    return x


class _HostPickler(pickle.Pickler):
    """Pickles a tensor on any device as its host copy."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            return _same, (obj.detach().cpu(),)
        return NotImplemented


class Checkpointer:
    """Per-stage snapshot store; disabled when dir is None."""

    def __init__(self, out_dir: Optional[str], cfg: PipelineConfig,
                 enabled: bool = True):
        self.dir = (os.path.join(out_dir, ".checkpoints")
                    if (out_dir and enabled) else None)
        self.tag = config_hash(cfg)
        self._pending: list = []
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)

    def _path(self, stage: str) -> str:
        return os.path.join(self.dir, f"{stage}.{self.tag}.pkl")

    def load(self, stage: str) -> Optional[Any]:
        if not self.dir:
            return None
        self.wait()
        p = self._path(stage)
        if not os.path.exists(p):
            return None
        try:
            with open(p, "rb") as fh:
                data = pickle.load(fh)
            logger.info("checkpoint: resumed stage %s", stage)
            return data
        except Exception as e:  # corrupted snapshot -> recompute
            logger.warning("checkpoint: failed to load %s (%s)", stage, e)
            return None

    def save(self, stage: str, data: Any) -> None:
        """Atomic snapshot of `data` as it is now: pickled here, written on
        a background thread (tmp file + rename) so the pipeline does not
        wait on the file system."""
        if not self.dir:
            return
        path = self._path(stage)
        tmp = path + ".tmp"
        buf = io.BytesIO()
        _HostPickler(buf).dump(data)
        blob = buf.getvalue()

        def _write():
            try:
                with open(tmp, "wb") as fh:
                    fh.write(blob)
                os.replace(tmp, path)
            except Exception as e:  # a failed snapshot only costs recompute
                logger.warning("checkpoint: async save of %s failed (%s)",
                               stage, e)

        t = threading.Thread(target=_write, name=f"ckpt-{stage}",
                             daemon=True)
        self._pending.append(t)
        t.start()

    def wait(self) -> None:
        """Drain in-flight snapshot writes (before the process exits, and
        in load() so a stage never reads its own half-written snapshot)."""
        for t in self._pending:
            t.join()
        self._pending.clear()

    def run(self, stage: str, fn: Callable[[], Any]) -> Any:
        """Load the stage snapshot or compute + save it."""
        cached = self.load(stage)
        if cached is not None:
            return cached
        result = fn()
        self.save(stage, result)
        return result

    def clean(self) -> None:
        """Drop all snapshots (the reference's clean_lib equivalent for
        recovery state)."""
        self.wait()
        if not self.dir or not os.path.isdir(self.dir):
            return
        for f in os.listdir(self.dir):
            try:
                os.unlink(os.path.join(self.dir, f))
            except FileNotFoundError:
                # another Checkpointer's in-flight tmp->rename can remove
                # a listed file between listdir and unlink; wait() only
                # drains THIS instance's writes
                pass
