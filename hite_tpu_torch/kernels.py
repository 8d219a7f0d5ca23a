"""Build and load the port's compiled code: CUDA kernels and host libraries.

Sources live in the package: `csrc/*.cu` (kernels for the card, `sm_90a`)
and `native/*.cc` (host FMEA chaining, the FASTA reader and interval
merge).  Each compiles at first use into `_build/` beside them (listed in
.gitignore): `nvcc` for the CUDA sources, `g++` for the host libraries,
all started together so the slowest one sets the build time.  Both expose plain C interfaces loaded with ctypes;
no source includes PyTorch's headers, so a build takes seconds.

`LAUNCHES` counts kernel launches, one per launch, bumped only by the
wrapper at the launch site; `chip_smoke.py` zeroes it before driving the
main path and reads it after.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> launches since the last reset_launches(), and the input
# shapes they were launched at (shape tuple -> launches)
LAUNCHES: Dict[str, int] = {"sw": 0, "sw_protein": 0, "libjoin_fill": 0}
LAUNCH_SHAPES: Dict[str, Dict[tuple, int]] = {k: {} for k in LAUNCHES}

_CUDA_SOURCES = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
                 for name in ("sw", "libjoin")}
HOST_SOURCES = {name: os.path.join(_PKG, "native", f"{name}.cc")
                 for name in ("chain", "fasta")}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_SHAPES[k] = {}


def count_launch(name: str, shape: tuple) -> None:
    """Called by a wrapper right after it launched kernel `name`."""
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[name][shape] = LAUNCH_SHAPES[name].get(shape, 0) + 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _fresh(out: str, src: str) -> bool:
    return (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(src))


def _command(name: str, tmp: str) -> List[str]:
    if name in HOST_SOURCES:
        cxx = os.environ.get("CXX", "g++")
        return [cxx, "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp,
                HOST_SOURCES[name]]
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", tmp, _CUDA_SOURCES[name]]


def _source(name: str) -> str:
    return HOST_SOURCES.get(name) or _CUDA_SOURCES[name]


def build(names: Optional[List[str]] = None, force: bool = False
          ) -> Dict[str, float]:
    """Compile the named libraries (default: every CUDA kernel and host
    library),
    all compilers running at once.  Returns {name: seconds}; the
    compilers' output (ptxas register/spill report) lands in BUILD_LOG.
    Raises if any compile fails."""
    names = list(names or (list(_CUDA_SOURCES) + list(HOST_SOURCES)))
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs: List[Tuple[str, str, subprocess.Popen, float]] = []
    for name in names:
        out = _lib_path(name)
        if not force and _fresh(out, _source(name)):
            continue
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        procs.append((name, tmp, subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), time.perf_counter()))
    secs: Dict[str, float] = {}
    failed = []
    for name, tmp, p, t0 in procs:
        log, _ = p.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if p.returncode != 0:
            failed.append(f"{name} (rc {p.returncode}):\n{log}")
            continue
        # atomic rename: processes building at once never load a torn file
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building it first if stale or missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not _fresh(_lib_path(name), _source(name)):
                build([name])
            lib = ctypes.CDLL(_lib_path(name))
            _LIBS[name] = lib
        return lib
