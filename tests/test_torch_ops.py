"""hite_tpu_torch ops vs their hite_tpu counterparts on the same inputs.

Every output on the TIR path is an integer, a code, a boolean or a
float32 ratio of exact counts, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hite_tpu.ops import boundary as jb
from hite_tpu.ops import encode as je
from hite_tpu.ops import kmer as jk
from hite_tpu.ops import libjoin as jl
from hite_tpu.ops import msa as jm
from hite_tpu.ops import selfjoin as js
from hite_tpu.ops import tandem as jt
from hite_tpu.ops import tsd as jtsd
from hite_tpu_torch.ops import boundary as tb
from hite_tpu_torch.ops import encode as te
from hite_tpu_torch.ops import kmer as tk
from hite_tpu_torch.ops import libjoin as tl
from hite_tpu_torch.ops import msa as tm
from hite_tpu_torch.ops import selfjoin as ts
from hite_tpu_torch.ops import tandem as tt
from hite_tpu_torch.ops import tsd as ttsd
from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(2)


def eq(ref, got, msg=""):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (msg, ref.shape, got.shape)
    np.testing.assert_array_equal(ref, got, err_msg=msg)


def T(x):
    return torch.from_numpy(np.array(x))


def repeat_genome(seed, L=20_000, n_rep=6, rep_len=400, tandem=True):
    """Random codes with planted near-identical repeats (both strands),
    an N block and a short tandem array."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, L).astype(np.uint8)
    rep = rng.integers(0, 4, rep_len).astype(np.uint8)
    for i in range(n_rep):
        pos = 500 + i * (L - 1000) // n_rep
        c = rep if i % 2 == 0 else (3 - rep)[::-1]
        c = c.copy()
        m = rng.random(rep_len) < 0.02
        c[m] = (c[m] + 1) % 4
        g[pos : pos + rep_len] = c
    g[3000:3100] = 4
    if tandem:
        g[7000:7300] = np.tile(rng.integers(0, 4, 6).astype(np.uint8), 50)
    return g


# ------------------------------------------------------------------ encode
def test_encode():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 6, (3, 50)).astype(np.uint8)    # gap 5 and N 4 too
    eq(je.revcomp(jnp.asarray(c)), te.revcomp(T(c)), "revcomp")
    eq(je.complement(jnp.asarray(c)), te.complement(T(c)), "complement")
    eq(je.n_mask(jnp.asarray(c)), te.n_mask(T(c)), "n_mask")
    eq(np.asarray(je.one_hot(jnp.asarray(c), dtype=jnp.float32)),
       te.one_hot(T(c), dtype=torch.float32), "one_hot")
    c4 = np.minimum(c, 4)
    for k in (3, 8, 12):
        eq(je.kmer_codes(jnp.asarray(c4), k), te.kmer_codes(T(c4), k), k)


# ------------------------------------------------------------------ tandem
def test_tandem_masks():
    g = np.stack([repeat_genome(1, L=8192), repeat_genome(2, L=8192)])
    g[1, 100:160] = np.tile(np.array([0, 1], np.uint8), 30)
    eq(jt.tandem_mask(jnp.asarray(g)), tt.tandem_mask(T(g)), "short")
    eq(jt.long_tandem_mask(jnp.asarray(g)), tt.long_tandem_mask(T(g)), "long")
    eq(jt.long_tandem_mask(jnp.asarray(g[0])), tt.long_tandem_mask(T(g[0])),
       "long 1-d")
    assert tt.tandem_mask(T(g)).any()


def test_tandem_fraction():
    rng = np.random.default_rng(4)
    seqs = rng.integers(0, 4, (8, 256)).astype(np.uint8)
    lens = rng.integers(20, 257, 8).astype(np.int32)
    seqs[1, :200] = np.tile(np.array([2, 3], np.uint8), 100)
    seqs[2, :120] = np.tile(np.array([0, 1, 1], np.uint8), 40)
    # a fraction of exactly 19/20 must compare as float32 in both
    seqs[3, :] = np.tile(np.array([0, 3], np.uint8), 128)
    lens[3] = 200
    ref = np.asarray(jt.tandem_fraction(jnp.asarray(seqs), jnp.asarray(lens)))
    got = tt.tandem_fraction(T(seqs), T(lens))
    assert got.dtype == torch.float32
    eq(ref, got, "fraction")
    assert ((ref < 0.5) == (got.numpy() < 0.5)).all()


# --------------------------------------------------------------------- tsd
@pytest.mark.parametrize("plant", [True, False])
def test_tsd_search(plant):
    rng = np.random.default_rng(9 + plant)
    B, R = 16, 70
    left = rng.integers(0, 4, (B, R)).astype(np.uint8)
    right = rng.integers(0, 4, (B, R)).astype(np.uint8)
    for r in range(B):
        s = [2, 3, 4, 5, 6, 8, 9, 10, 11][r % 9]
        t = rng.integers(0, 4, s).astype(np.uint8)
        if r % 3 == 0:
            t[:2] = [3, 0]
        left[r, 50 - s : 50] = t
        right[r, 20 : 20 + s] = t
    left[0, 40:45] = 4
    left[4, 46:50] = [3, 3, 0, 0]
    right[4, 20:24] = [3, 3, 0, 0]
    kw = dict(sizes=(2, 3, 4, 5, 6, 8, 9, 10, 11), plant=plant,
              boundary_l=50, boundary_r=20)
    ref = jtsd.tsd_search(jnp.asarray(left), jnp.asarray(right), **kw)
    got = ttsd.tsd_search(T(left), T(right), **kw)
    for f in ("left_pos", "right_pos", "mismatches", "dist", "found"):
        eq(getattr(ref, f), getattr(got, f), f)


@pytest.mark.parametrize("shape", [(16,), (3, 64), (2, 2, 32)])
def test_pack_2bit(shape):
    """16 codes an int32, N as 0, the last code in the two top bits (the
    sum wraps to a negative int32 in both packages)."""
    rng = np.random.default_rng(sum(shape))
    c = rng.integers(0, 6, shape).astype(np.uint8)
    c[..., 15::16] = 3
    got = te.pack_2bit(T(c))
    eq(je.pack_2bit(jnp.asarray(c)), got, "pack_2bit")
    assert got.dtype == torch.int32 and (got < 0).all()


# ---------------------------------------------------------------- selfjoin
def test_selfjoin_sorted_and_scan():
    g = np.concatenate([repeat_genome(5), np.full(12_768, 4, np.uint8)])
    ref = js.selfjoin_sorted(jnp.asarray(g), k=12, window=4, diag_band=32)
    got = ts.selfjoin_sorted(T(g), k=12, window=4, diag_band=32)
    for name, r, t in zip(("dbin", "qpos", "spos", "n_pairs"), ref, got):
        eq(r, t, name)
    assert int(got[3]) > 0
    for slices, budget in ((1, 1 << 20), (4, 512), (2, 256)):
        kw = dict(k=12, run_gap=96, min_seeds=4, min_hsp_len=30,
                  max_hsps=1024, max_seed_pairs=budget, budget_slices=slices)
        eq(js.selfjoin_scan_packed(*ref, **kw),
           ts.selfjoin_scan_packed(*got, **kw), f"scan K={slices}")


@pytest.mark.parametrize("slices,budget", [(1, 1 << 20), (4, 512)])
def test_selfjoin_hsps(slices, budget):
    """The stage-1 + stage-2 wrapper, field by field."""
    g = np.concatenate([repeat_genome(5), np.full(12_768, 4, np.uint8)])
    kw = dict(k=12, window=4, diag_band=32, run_gap=96, min_seeds=4,
              min_hsp_len=30, max_hsps=1024, max_seed_pairs=budget,
              budget_slices=slices)
    ref = js.selfjoin_hsps(jnp.asarray(g), **kw)
    got = ts.selfjoin_hsps(T(g), **kw)
    for f in ref._fields:
        eq(getattr(ref, f), getattr(got, f), f)
    assert bool(got.valid.any())


# ------------------------------------------------------------------- kmer
def test_kmer_index_and_lookup():
    rng = np.random.default_rng(12)
    seq = rng.integers(0, 4, 3000).astype(np.uint8)
    seq[100:110] = 4
    seq[500:600] = seq[1000:1100]
    for k in (8, 10):
        ri = jk.build_index(jnp.asarray(seq), k)
        gi = tk.build_index(T(seq), k)
        eq(ri.codes, gi.codes, "codes")
        eq(ri.pos, gi.pos, "pos")
        q = np.asarray(je.kmer_codes(jnp.asarray(seq[400:1200]), k))
        rs, rv = jk.lookup(ri, jnp.asarray(q), 4)
        gs, gv = tk.lookup(gi, T(q), 4)
        eq(rs, gs, "spos")
        eq(rv, gv, "valid")


# ---------------------------------------------------------------- libjoin
def _cands(g, rng):
    seqs = [g[500:900].copy(), g[5000:5300].copy(),
            rng.integers(0, 4, 250).astype(np.uint8), g[500:880].copy()]
    lens = np.array([len(s) for s in seqs])
    starts = np.concatenate([[0], np.cumsum(lens[:-1] + 1)])
    P = 2048
    flat = np.full(P, 4, np.uint8)
    cid = np.zeros(P, np.int32)
    for i, s in enumerate(seqs):
        flat[starts[i] : starts[i] + lens[i]] = s
        cid[starts[i] : starts[i] + lens[i]] = i
    return flat, cid


@pytest.mark.parametrize(
    "slice_size,quota,fill_w",
    [(1 << 20, 1 << 19, 8), (4096, 64, 4), (8192, 512, 1)])
def test_libjoin_pairs_and_scan(slice_size, quota, fill_w):
    rng = np.random.default_rng(13)
    g = np.concatenate([repeat_genome(6, L=16_000),
                        np.full(384, 4, np.uint8)])
    cf, cid = _cands(g, rng)
    kw = dict(k=12, diag_band=32, fill_w=fill_w, max_occ=3,
              slice_size=slice_size, slice_quota=quota)
    ref = jl.libjoin_pairs(jnp.asarray(g), jnp.asarray(cf), jnp.asarray(cid),
                           **kw)
    got = tl.libjoin_pairs(T(g), T(cf), T(cid), **kw)
    for name, r, t in zip(("cand", "dbin", "qpos", "spos", "counts"),
                          ref, got):
        eq(r, t, name)
    gs_r = jl.libjoin_genome_sorted(jnp.asarray(g), k=12)
    gs_t = tl.libjoin_genome_sorted(T(g), k=12)
    for name, r, t in zip(("code", "pos", "ord"), gs_r, gs_t):
        eq(r, t, name)
    ref_i = jl.libjoin_pairs_indexed(*gs_r, jnp.asarray(cf),
                                     jnp.asarray(cid), **kw)
    got_i = tl.libjoin_pairs_indexed(*gs_t, T(cf), T(cid), **kw)
    for name, r, t in zip(("cand", "dbin", "qpos", "spos", "counts"),
                          ref_i, got_i):
        eq(r, t, "indexed " + name)
    assert int(got_i[4][0]) > 0
    for slices, budget in ((1, 1 << 20), (4, 256)):
        skw = dict(k=12, run_gap=96, min_seeds=4, min_hsp_len=30,
                   max_hsps=512, max_seed_pairs=budget, budget_slices=slices)
        eq(jl.libjoin_scan_packed(*ref_i[:4], **skw),
           tl.libjoin_scan_packed(*got_i[:4], **skw), f"scan K={slices}")


# -------------------------------------------------------------------- msa
def _family(seed, R=6, Lq=300, indel=True):
    rng = np.random.default_rng(seed)
    center = rng.integers(0, 4, Lq).astype(np.uint8)
    Lc = 512
    copies = np.full((R, Lc), 4, np.uint8)
    lens = np.zeros(R, np.int32)
    for r in range(R - 1):
        c = center.copy()
        m = rng.random(Lq) < 0.05
        c[m] = (c[m] + 1) % 4
        if indel and r % 2:
            c = np.concatenate([c[:120], rng.integers(0, 4, 10).astype(
                np.uint8), c[120:]])
        if r == 2:
            c = np.concatenate([c[:200], c[215:]])
        copies[r, : len(c)] = c
        lens[r] = len(c)
    return center, copies, lens


def test_project_to_center():
    center, copies, lens = _family(3)
    cp = np.full(512, 4, np.uint8)
    cp[: len(center)] = center
    ref = jm.project_to_center(jnp.asarray(cp), jnp.asarray(copies),
                               jnp.asarray(lens))
    got = tm.project_to_center(T(cp), T(copies), T(lens))
    eq(ref, got, "M")
    # batched over families equals one call per family
    c2, cps2, l2 = _family(4)
    cp2 = np.full(512, 4, np.uint8)
    cp2[: len(c2)] = c2
    both = tm.project_to_center(T(np.stack([cp, cp2])),
                                T(np.stack([copies, cps2])),
                                T(np.stack([lens, l2])))
    eq(ref, both[0], "batch 0")
    eq(jm.project_to_center(jnp.asarray(cp2), jnp.asarray(cps2),
                            jnp.asarray(l2)), both[1], "batch 1")


def test_project_to_center_column_collision():
    """A 10 bp insertion in a copy fills the same offset over it, so two
    copy positions land in one center column: the last one wins."""
    rng = np.random.default_rng(17)
    center = rng.integers(0, 4, 240).astype(np.uint8)
    ins = rng.integers(0, 4, 10).astype(np.uint8)
    copy = np.concatenate([center[:100], ins, center[100:]])
    copies = np.full((4, 256), 4, np.uint8)
    lens = np.zeros(4, np.int32)
    for r in range(3):
        copies[r, : len(copy)] = copy
        lens[r] = len(copy)
    cp = np.full(256, 4, np.uint8)
    cp[:240] = center
    ref = np.asarray(jm.project_to_center(jnp.asarray(cp), jnp.asarray(copies),
                                          jnp.asarray(lens)))
    got = tm.project_to_center(T(cp), T(copies), T(lens)).numpy()
    np.testing.assert_array_equal(ref, got)
    # the columns where the insertion collides hold the LATER copy bases
    np.testing.assert_array_equal(got[0, 100:110], copy[110:120])
    np.testing.assert_array_equal(got[0, :100], copy[:100])


# --------------------------------------------------------------- boundary
def _matrix(seed, R=8, L=200, pad_rows=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, L).astype(np.uint8)
    M = np.tile(base, (R, 1))
    M[:, :40] = rng.integers(0, 6, (R, 40))        # unrelated flank
    M[:, 160:] = rng.integers(0, 6, (R, 40))
    noise = rng.random((R, L)) < 0.05
    M[noise] = 5
    M[R - pad_rows:] = 4                          # batch-padding rows
    row_ok = np.arange(R) < R - pad_rows
    return M, row_ok


def test_column_stats_consensus_votes():
    for seed in range(3):
        M, row_ok = _matrix(seed)
        n = int(row_ok.sum())
        jthr = jb.adaptive_threshold(jnp.int32(n))
        tthr = tb.adaptive_threshold(torch.tensor(n))
        eq(jthr, tthr, "threshold")
        rs = jb.column_stats(jnp.asarray(M), jthr, row_ok=jnp.asarray(row_ok))
        gs = tb.column_stats(T(M), tthr, row_ok=T(row_ok))
        for f in ("counts", "present", "valid", "homo", "ratio"):
            eq(getattr(rs, f), getattr(gs, f), f)
        rs0 = jb.column_stats(jnp.asarray(M), 0.9)
        gs0 = tb.column_stats(T(M), 0.9)
        eq(rs0.homo, gs0.homo, "homo unmasked")
        rc, rsup = jb.consensus(jnp.asarray(M), row_ok=jnp.asarray(row_ok))
        gc, gsup = tb.consensus(T(M), row_ok=T(row_ok))
        eq(rc, gc, "cons")
        eq(rsup, gsup, "support")
        for left, right in ((40, 160), (3, 198), (60, 120)):
            eq(jb.row_tsd_votes(jnp.asarray(M), jnp.int32(left),
                                jnp.int32(right)),
               tb.row_tsd_votes(T(M), left, right), "votes")


def test_search_boundary():
    rng = np.random.default_rng(8)
    for trial in range(6):
        L = 300
        homo = np.zeros(L, bool)
        homo[60 + trial : 240 - trial] = True
        homo[rng.random(L) < 0.1] = ~homo[rng.random(L) < 0.1][0]
        if trial == 5:
            homo[:] = True                  # homology continues: FP rule
        for side, anchor in (("left", 62), ("right", 238), ("left", 0)):
            r = jb.search_boundary(jnp.asarray(homo), jnp.int32(anchor),
                                   side=side)
            g = tb.search_boundary(T(homo), anchor, side=side)
            assert bool(r.found) == bool(g.found), (trial, side)
            assert int(r.pos) == int(g.pos), (trial, side)
    # batched over families
    H = np.stack([np.roll(homo, s) for s in (0, 5, 11)])
    A = np.array([60, 66, 70])
    g = tb.search_boundary(T(H), T(A), side="left")
    for i in range(3):
        r = jb.search_boundary(jnp.asarray(H[i]), jnp.int32(A[i]), side="left")
        assert (bool(r.found), int(r.pos)) == (bool(g.found[i]),
                                               int(g.pos[i]))
