"""The native FASTA reader and interval helpers (`native/fasta.cc`) held
against the port's Python reader and the JAX package's reader and
library, on edge-case files."""

import ctypes
import time

import numpy as np
import pytest

from hite_tpu.io import fasta as jax_fasta
from hite_tpu.native import runtime as jax_rt
from hite_tpu_torch.io import fasta
from hite_tpu_torch.native import runtime
from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)

CASES = {
    "crlf": b">c1 first contig\r\nACGTNACGT\r\nacgtn\r\n>c2\r\nGGGG\r\n",
    "lower_iupac": b">x\nacgtRYKMSWBDHVNacgt\nuuUU..--**\n>y\nNNNNacgt\n",
    "blank_lines": b"\n\n>a\n\nACGT\n\n\nTTTT\n\n>b\n\n\nGG\n\n",
    "descriptions": b">chr1 Homo sapiens\tchromosome 1\nACGT\n>chr2\tx y\nCC\n",
    "empty_record": b">e1\n>full\nACGTACGT\n>e2\n>e3 desc\n",
    "no_final_newline": b">a\nACGT\nAC",
    "long_line": b">long\n" + (b"ACGTTGCAacgtNN" * 40_000) + b"\n>s\nA\n",
    "empty_file": b"",
}


def _readers():
    return (("native", runtime.read_fasta), ("python", fasta.read_fasta_py),
            ("jax", jax_fasta.read_fasta))


@pytest.mark.parametrize("case", sorted(CASES))
def test_readers_agree(case, tmp_path):
    path = str(tmp_path / f"{case}.fa")
    with open(path, "wb") as fh:
        fh.write(CASES[case])
    got = {name: fn(path) for name, fn in _readers()}
    ref = got["python"]
    for name, seqs in got.items():
        assert list(seqs) == list(ref), name
        for k in ref:
            assert seqs[k].dtype == np.uint8
            assert np.array_equal(seqs[k], ref[k]), (name, k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_iter_fasta_and_read_fasta_str(case, tmp_path):
    """The streaming reader yields the JAX package's (name, codes) pairs
    in order, duplicates and empty records included, and the string
    reader its {name: ASCII} dict."""
    path = str(tmp_path / f"{case}.fa")
    with open(path, "wb") as fh:
        fh.write(CASES[case])
    ref = list(jax_fasta.iter_fasta(path))
    got = list(fasta.iter_fasta(path))
    assert [n for n, _ in got] == [n for n, _ in ref]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(got, ref))
    assert fasta.read_fasta_str(path) == jax_fasta.read_fasta_str(path)


def test_io_fasta_takes_the_native_reader(tmp_path):
    path = str(tmp_path / "g.fa")
    rng = np.random.default_rng(3)
    seqs = {"a": rng.integers(0, 5, 1000).astype(np.uint8),
            "b": rng.integers(0, 4, 77).astype(np.uint8)}
    fasta.write_fasta(path, seqs)
    assert runtime.available("fasta")
    n0 = runtime.CALLS["read_fasta"]
    out = fasta.read_fasta(path)
    assert runtime.CALLS["read_fasta"] == n0 + 1
    assert list(out) == list(seqs)
    assert all(np.array_equal(out[k], seqs[k]) for k in seqs)


def test_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        runtime.read_fasta(str(tmp_path / "absent.fa"))


def _jax_covered_bp(t, c):
    lib = jax_rt._load()
    p = ctypes.POINTER(ctypes.c_int64)
    lib.intervals_covered_bp.argtypes = [p, p, ctypes.c_int64,
                                         p, p, ctypes.c_int64]
    lib.intervals_covered_bp.restype = ctypes.c_int64
    cols = [np.ascontiguousarray(a[:, i], dtype=np.int64)
            for a in (t, c) for i in (0, 1)]
    ptrs = [a.ctypes.data_as(p) for a in cols]
    return int(lib.intervals_covered_bp(ptrs[0], ptrs[1], len(t),
                                        ptrs[2], ptrs[3], len(c)))


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's native library.  Its loader runs `make -B` where
    the .so is missing and gives up for the rest of the process if that
    build or the load fails, as it does while another test process
    rebuilds the same file; so try again, for up to a minute, once that
    build has written it."""
    for _ in range(60):
        if jax_rt._load() is not None:
            return jax_rt._LIB
        time.sleep(1)
        jax_rt._TRIED = False
    pytest.fail("the JAX package's native library does not load")


@pytest.mark.parametrize("seed", range(4))
def test_interval_helpers_match_jax(seed, jax_lib):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60))
    s = rng.integers(0, 5000, n)
    iv = np.stack([s, s + rng.integers(0, 300, n)], axis=1)
    for gap in (0, 5, 50):
        got = runtime.merge_intervals(iv, gap)
        assert np.array_equal(got, jax_rt.merge_intervals(iv, gap))
        assert got.dtype == np.int64
    assert runtime.merge_intervals(np.zeros((0, 2))).shape == (0, 2)
    cover = runtime.merge_intervals(iv)
    t0 = np.sort(rng.integers(0, 5000, 20))
    targets = np.stack([t0, t0 + rng.integers(1, 400, 20)], axis=1)
    assert runtime.covered_bp(targets, cover) == _jax_covered_bp(targets,
                                                                 cover)
    assert runtime.covered_bp(targets, cover[:0]) == 0
