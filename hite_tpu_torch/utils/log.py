"""Structured logging + per-stage timing.

Same contract as the JAX package's `utils/log.py`: one module-level logger
and a `stage_timer` context manager that records wall-clock into a run-wide
metrics dict under the same stage names.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict

logger = logging.getLogger("hite_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

STAGE_TIMES: Dict[str, float] = {}
COUNTERS: Dict[str, int] = {}


@contextlib.contextmanager
def stage_timer(name: str):
    t0 = time.perf_counter()
    logger.info("stage %s: start", name)
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        STAGE_TIMES[name] = STAGE_TIMES.get(name, 0.0) + dt
        logger.info("stage %s: done in %.2fs", name, dt)


def count(name: str, inc: int = 1) -> None:
    COUNTERS[name] = COUNTERS.get(name, 0) + inc
