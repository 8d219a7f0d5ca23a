"""hite_tpu_torch's multi-process helpers against hite_tpu's.

`partition` and `merge_dicts` equal the JAX package's on every split; the
single-process gather is the identity; and a real two-process gloo group
(subprocesses on this machine) gathers uneven payloads in rank order.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from hite_tpu.parallel import multihost as jmh
from hite_tpu_torch.parallel import multihost as tmh
from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys
import numpy as np
import torch.distributed as dist
from hite_tpu_torch.parallel import multihost as mh

addr, nproc, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method=addr, world_size=nproc,
                        rank=rank)
assert mh.process_count() == nproc and mh.process_index() == rank
mine = mh.partition(list(range(7)))
assert mine == [i for i in range(7) if i % nproc == rank]
# uneven payloads: rank r sends 100 * (r + 1) bytes and a dict of arrays
local = {f"genome_{i}": np.arange(i + 1 + rank * 10) for i in mine}
merged = mh.merge_dicts(mh.allgather_obj(local))
assert sorted(merged) == [f"genome_{i}" for i in range(7)], sorted(merged)
for i in range(7):
    assert merged[f"genome_{i}"].tolist() == \
        list(range(i + 1 + (i % nproc) * 10))
objs = mh.allgather_obj({"rank": rank, "data": b"x" * (100 * (rank + 1))})
assert [o["rank"] for o in objs] == list(range(nproc)), objs
assert [len(o["data"]) for o in objs] == [100 * (r + 1)
                                           for r in range(nproc)]
raw = mh.allgather_bytes(b"" if rank == 0 else bytes(range(rank * 3)))
assert raw == [b""] + [bytes(range(r * 3)) for r in range(1, nproc)], raw
dist.destroy_process_group()
print("MULTIHOST_OK", rank, flush=True)
"""


@pytest.mark.parametrize("nproc", [1, 2, 3, 4])
def test_partition(nproc):
    items = list("abcdefghijk")
    for pid in range(nproc):
        assert tmh.partition(items, pid=pid, nproc=nproc) == \
            jmh.partition(items, pid=pid, nproc=nproc)
    assert tmh.partition(items) == items   # no process group: everything


def test_merge_dicts():
    ds = [{"a": 1, "b": 2}, {}, {"c": 3, "a": 4}, {"b": 5}]
    assert tmh.merge_dicts(ds) == jmh.merge_dicts(ds) == \
        {"a": 4, "b": 5, "c": 3}
    assert list(tmh.merge_dicts(ds)) == list(jmh.merge_dicts(ds))


def test_single_process():
    assert (tmh.process_count(), tmh.process_index()) == (1, 0)
    obj = {"x": np.arange(3), "y": b"\x00\x01"}
    got = tmh.allgather_obj(obj)
    want = jmh.allgather_obj(obj)
    assert len(got) == len(want) == 1
    assert got[0]["x"].tolist() == want[0]["x"].tolist() == [0, 1, 2]
    assert got[0]["y"] == want[0]["y"]
    assert tmh.allgather_bytes(b"abc") == [b"abc"]
    assert tmh.init_from_env("cpu") is False   # no WORLD_SIZE: no group


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_allgather():
    addr = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, addr, "2", str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
        text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=60)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"MULTIHOST_OK {rank}" in out, out
