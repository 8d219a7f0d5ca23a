"""Plain Smith-Waterman of hite_tpu_torch vs the JAX package, bit-exact.

The CUDA kernel (hite_tpu_torch/csrc/sw.cu) runs only on the card, where
chip_smoke.py holds it against this plain version; here the plain version
is held against `hite_tpu.ops.terminal.batched_local_align` and the Pallas
kernel in interpret mode, on all 7 outputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hite_tpu.ops.terminal import batched_local_align as jax_sw
from hite_tpu.ops.terminal import find_terminal_repeat as jax_ftr
from hite_tpu.ops.terminal_pallas import batched_local_align_pallas
from hite_tpu_torch.ops.terminal import (
    LocalAlign, batched_local_align, batched_local_align_auto,
    find_terminal_repeat,
)

torch.set_num_threads(2)


def _assert_same(ref, got):
    for f in LocalAlign._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, f)), getattr(got, f).numpy(), err_msg=f)


def _both(a, b):
    ref = jax_sw(jnp.asarray(a), jnp.asarray(b))
    got = batched_local_align(torch.from_numpy(a), torch.from_numpy(b))
    _assert_same(ref, got)
    return got


def _planted(seed, B, La, Lb, core=25):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, (B, La)).astype(np.uint8)
    b = rng.integers(0, 4, (B, Lb)).astype(np.uint8)
    for r in range(0, B, 2):
        c = rng.integers(0, 4, core).astype(np.uint8)
        a[r, 10 : 10 + core] = c
        b[r, Lb - core - 5 : Lb - 5] = c
    return a, b


@pytest.mark.parametrize("seed", range(4))
def test_sw_matches_jax_pallas_test_seeds(seed):
    rng = np.random.default_rng(seed)
    B, La, Lb = 4, 60, 70
    a = rng.integers(0, 4, (B, La)).astype(np.uint8)
    b = rng.integers(0, 4, (B, Lb)).astype(np.uint8)
    for r in range(0, B, 2):
        core = rng.integers(0, 4, 25).astype(np.uint8)
        a[r, 10:35] = core
        b[r, 30:55] = core
    _both(a, b)


@pytest.mark.parametrize("La,Lb", [(33, 71), (90, 17), (1, 5), (7, 1)])
def test_sw_unequal_lengths(La, Lb):
    _both(*_planted(La * 100 + Lb, 6, La, Lb, core=min(La, Lb) // 2))


def test_sw_n_blocks_and_all_n_rows():
    a, b = _planted(11, 8, 50, 50)
    a[0, 15:25] = 4
    b[2, 5:40] = 4
    a[4] = 4          # all-N row
    b[5] = 4
    a[6] = 4
    b[6] = 4
    got = _both(a, b)
    # the zero alignment reports row 1, column 1 and score 0
    for r in (4, 5, 6):
        assert [int(getattr(got, f)[r]) for f in LocalAlign._fields] == \
            [0, 1, 1, 1, 1, 0, 0]


def test_sw_tie_heavy_low_complexity():
    rng = np.random.default_rng(5)
    a = np.tile(np.array([0, 1], np.uint8), (8, 24))
    b = np.tile(np.array([0, 1, 0], np.uint8), (8, 17))
    a[1] = 0
    b[1] = 0
    a[2, ::3] = 2
    a[3] = rng.integers(0, 2, 48)
    b[3] = rng.integers(0, 2, 51)
    _both(a, b)


def test_sw_gate_shape():
    _both(*_planted(21, 64, 40, 40, core=12))


def test_sw_long():
    a, b = _planted(31, 2, 1024, 1024, core=300)
    _both(a, b)


def test_sw_matches_pallas_interpret():
    a, b = _planted(41, 4, 40, 40, core=15)
    ref = batched_local_align_pallas(jnp.asarray(a), jnp.asarray(b),
                                     interpret=True)
    got = batched_local_align_auto(torch.from_numpy(a), torch.from_numpy(b))
    _assert_same(ref, got)


@pytest.mark.parametrize("inverted", [True, False])
def test_find_terminal_repeat(inverted):
    rng = np.random.default_rng(7 + inverted)
    B, L = 16, 300
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = rng.integers(120, L + 1, B).astype(np.int32)
    for r in range(0, B, 2):
        t = seqs[r, :20]
        end = lens[r]
        seqs[r, end - 20 : end] = ((3 - t)[::-1] if inverted else t)
    seqs[3, 50:] = 4
    ref = jax_ftr(jnp.asarray(seqs), jnp.asarray(lens), inverted=inverted,
                  window=40, min_identity=0.7, min_len=7)
    got = find_terminal_repeat(torch.from_numpy(seqs),
                               torch.from_numpy(lens), inverted=inverted,
                               window=40, min_identity=0.7, min_len=7)
    for f in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    assert np.asarray(ref.found).any()


def _kernel_schedule(a, b, R, max_t, match=2, mismatch=-3, gap=4, inv=4):
    """Python model of csrc/sw.cu's schedule for one alignment: T threads
    in lockstep, thread t on column s - t at step s over R-row strips, the
    cell above a strip taken from thread t-1's previous step, bands of
    T*R rows handed over through a scratch row, one best per thread
    reduced by (score desc, row asc, column asc)."""
    La, Lb = len(a), len(b)
    T = max(1, min(max_t, -(-La // R)))
    best = (-(10**9), 0, 0, 0, 0, 0, 0)
    scratch = {}
    for r0 in range(0, La, T * R):
        tops = [r0 + t * R + 1 for t in range(T)]
        nrows = [max(0, min(R, La - top + 1)) for top in tops]
        cols = [[(0, top + q, 0, 0, 0) for q in range(R)] for top in tops]
        above_prev = [(0, top - 1, 0, 0, 0) for top in tops]
        out = [None] * T
        for s in range(Lb + T):
            prev_out = list(out)
            for t in range(T):
                j = s - t
                if not (1 <= j <= Lb and nrows[t]):
                    continue
                above = (prev_out[t - 1] if t else (0, 0, j, 0, 0) if r0 == 0
                         else scratch[j])
                diag, up = above_prev[t], above
                for q in range(nrows[t]):
                    i, left = tops[t] + q, cols[t][q]
                    im = int(b[j - 1] < inv and a[i - 1] == b[j - 1])
                    cd = diag[0] + (match if im else mismatch)
                    h = max(cd, 0, up[0] - gap, left[0] - gap)
                    if h == 0:
                        c = (0, i, j, 0, 0)
                    elif cd == h:
                        c = (h, diag[1], diag[2], diag[3] + im, diag[4] + 1)
                    elif up[0] - gap == h:
                        c = (h, up[1], up[2], up[3], up[4] + 1)
                    else:
                        c = (h, left[1], left[2], left[3], left[4] + 1)
                    if (h, -i, -j) > (best[0], -best[1], -best[2]):
                        best = (h, i, j) + c[1:]
                    diag, up, cols[t][q] = left, c, c
                above_prev[t], out[t] = above, up
                if t == T - 1 and r0 + T * R < La:
                    scratch[j] = up
    h, i, j, si, sj, m, l = best
    return [max(h, 0), si, i, sj, j, m, l]


@pytest.mark.parametrize("R,max_t", [(8, 512), (2, 3), (1, 4), (3, 2)])
def test_kernel_schedule_matches_plain(R, max_t):
    """The CUDA kernel's wavefront/band schedule (modelled in Python, with
    small strips and blocks so several bands run) computes what the plain
    version computes."""
    rng = np.random.default_rng(R * 10 + max_t)
    for _ in range(12):
        La, Lb = (int(x) for x in rng.integers(1, 30, 2))
        a = rng.integers(0, 5, La).astype(np.uint8)
        b = rng.integers(0, 5, Lb).astype(np.uint8)
        n = min(La, Lb)
        b[: n // 2] = a[La - n // 2 :]
        ref = batched_local_align(torch.from_numpy(a[None]),
                                  torch.from_numpy(b[None]))
        assert _kernel_schedule(a, b, R, max_t) == [int(f[0]) for f in ref]


def test_sw_protein_mode_submatrix():
    """Protein mode (scores from a substitution table, padding code never
    scores) of the plain version, to be folded into the kernel later."""
    rng = np.random.default_rng(61)
    sub = rng.integers(-4, 12, (20, 20)).astype(np.int32)
    sub = (sub + sub.T) // 2
    a = rng.integers(0, 20, (6, 45)).astype(np.uint8)
    b = rng.integers(0, 20, (6, 38)).astype(np.uint8)
    b[::2, 5:30] = a[::2, 10:35]
    a[1, 30:] = 20                       # padding code
    kw = dict(gap=11, mismatch=-4, invalid_code=20)
    ref = jax_sw(jnp.asarray(a), jnp.asarray(b), submatrix=jnp.asarray(sub),
                 **kw)
    got = batched_local_align(torch.from_numpy(a), torch.from_numpy(b),
                              submatrix=torch.from_numpy(sub), **kw)
    _assert_same(ref, got)
