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
from hite_tpu.ops.protein import AA_X, BLOSUM62
from hite_tpu_torch.ops import terminal
from hite_tpu_torch.ops.terminal import (
    SW_ROWS, LocalAlign, batched_local_align, batched_local_align_auto,
    find_terminal_repeat, sw_plan, sw_table,
)
from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)

# protein rows padded as the domain confirm pads them, the inputs
# chip_smoke.py holds the kernel to on the card
from chip_smoke import ROW_KINDS, padded_protein

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


NEG = -(10**9)


def _better(x, y):
    """(score desc, then the packed (row, column) key asc)."""
    return x[0] > y[0] or (x[0] == y[0] and x[1] < y[1])


def _row_extent(row, n, G):
    """csrc/sw.cu's row_extent for one group of G lanes: rounds of G codes
    from the row's end backwards, the first valid code found ends it."""
    end = n
    while end > 0:
        valid = [p for p in range(max(end - G, 0), end) if row[p]]
        if valid:
            return max(valid) + 1
        end -= G
    return 0


def _profile_slot(table, aq, code):
    """One lane's profile words of one b code: R int8 scores, byte q of
    word q // 4 (a slot of R bytes), as csrc/sw.cu packs them."""
    words = [0] * -(-len(aq) // 4)
    for q, x in enumerate(aq):
        words[q // 4] |= (int(table[x, code]) & 0xFF) << (8 * (q % 4))
    return words


def _sbyte(word, k):
    v = (word >> (8 * k)) & 0xFF
    return v - 256 if v >= 128 else v


def _kernel_model(A, Bm, R, *, lanes=32, chunk=32, ahead=8, packed=True,
                  seed=0, match=2, mismatch=-3, gap=4, inv=4, table=None):
    """Python model of csrc/sw.cu over a batch A[B, La], Bm[B, Lb].

    `table` (the 32 x 32 `sw_table` of protein mode) scores a cell from
    each lane's int8 query profile (its R rows' table entries for each b
    code, packed into words and read back with sign extension), with an
    invalid a code recoded to 30 and an invalid b code to 31 (otherwise
    0x100 and 0x200: an invalid code equals nothing).  Protein mode with
    mismatch < 0 and gap > 0 computes only each alignment's extents (each
    group finds them as the kernel does); a warp steps to the last
    column of its last lane with rows, a band past La_r neither waits nor
    is waited on and reports no cell, and an empty region answers the
    plain version's all-invalid alignment.

    Warps of `lanes` lanes in lockstep; groups of G lanes, R rows a lane,
    one band (G * R >= La: lanes // G alignments a warp) or bands of
    lanes * R rows (one warp each) that hand their last row over in
    chunks of `chunk` columns behind a progress count, fetched `ahead`
    steps early.  Cells carry (h, st, ml) with (si, sj) and (m, d) packed
    as S-bit halves (d: diagonal moves; the length follows at the end);
    the lane above comes by the kernel's rotating shuffle.  Warps start in ticket order (band-major) and then advance
    in an order drawn from `seed`, each at its own random speed, so a
    band often runs far ahead of the band above it and has to wait."""
    B, La = A.shape
    Lb = Bm.shape[1]
    S = 16 if packed else 32
    LOW = (1 << S) - 1
    n_lanes = -(-max(La, 1) // R)
    G, nb = (n_lanes, 1) if n_lanes <= lanes else (lanes, -(-La // (lanes * R)))
    gpw = lanes // G
    cut = table is not None and mismatch < 0 and gap > 0
    prog, ho, bests = {}, {}, {}

    def warp(units):
        L = []
        for lane in range(lanes):
            grp, g = divmod(lane, G)
            live = grp < min(gpw, len(units))
            aln, band = units[grp] if live else (0, 0)
            La_r, Lb_r = La, Lb
            if cut:
                La_r = _row_extent(A[aln] < inv, La, G) if live else 0
                Lb_r = _row_extent(Bm[aln] < inv, Lb, G) if La_r else 0
                if not (La_r and Lb_r):
                    La_r = Lb_r = 0
            top = band * G * R + g * R + 1
            nrows = max(0, min(R, La_r - top + 1)) if live else 0
            aq = [int(A[aln, top - 1 + q]) if q < nrows else inv
                  for q in range(R)]
            aq = [x if x < inv else (0x100 if table is None else 30)
                  for x in aq]
            L.append(dict(
                grp=grp, g=g, aln=aln, top=top, nrows=nrows, aq=aq,
                La_r=La_r, Lb_r=Lb_r,
                prof=None if table is None else [
                    _profile_slot(table, aq, c) for c in range(32)],
                col=[(0, (top + q) << S, 0) for q in range(R)],
                above_prev=(0, (top - 1) << S, 0), out=(0, 0, 0),
                best=(NEG, 0, 0, 0),
                src=lane - 1 if g > 0 else (lane + G - 1) % lanes))
        aln0, band0 = units[0]
        Lb_r, La_r = L[0]["Lb_r"], L[0]["La_r"]   # one group when banded
        nb_r = -(-La_r // (lanes * R)) if table is not None else nb
        consume = nb > 1 and 0 < band0 < nb_r
        produce = nb > 1 and band0 < nb_r - 1
        stage, pre = [None, None], [None]

        def fetch(c):
            need = min((c + 1) * chunk, Lb_r)
            while prog.get((aln0, band0 - 1), 0) < need:
                yield "wait"
            pre[0] = [ho[(aln0, band0 - 1, j)] for j in
                      range(c * chunk + 1, min((c + 1) * chunk, Lb_r) + 1)]

        if consume:
            yield from fetch(0)
        steps = (max([st["Lb_r"] + st["g"] for st in L if st["nrows"]],
                     default=0) if table is not None else Lb + G - 1)
        for s in range(steps):
            if consume:
                if s < Lb_r and s % chunk == 0:
                    stage[(s // chunk) & 1] = pre[0]
                if s + ahead < Lb_r and (s + ahead) % chunk == 0:
                    yield from fetch((s + ahead) // chunk)
            sends = []
            for st in L:
                send = st["out"]
                if st["g"] == G - 1:
                    jn = s + 1
                    if not consume:
                        send = (0, jn, 0)
                    elif jn <= Lb_r:
                        send = stage[(s // chunk) & 1][s % chunk]
                sends.append(send)
            for st in L:
                above = sends[st["src"]]
                j = s - st["g"] + 1
                if not (1 <= j <= st["Lb_r"] and st["nrows"]):
                    continue
                y = int(Bm[st["aln"], j - 1])
                bc = y if y < inv else (0x200 if table is None else 31)
                words = None if table is None else st["prof"][bc]
                diag, up = st["above_prev"], above
                for q in range(R):   # all R rows; rows past La are junk
                    left = st["col"][q]
                    im = int(st["aq"][q] == bc)
                    cd = diag[0] + (
                        (match if im else mismatch) if table is None
                        else _sbyte(words[q // 4], q % 4))
                    cu = up[0] - gap
                    h = max(max(up[0], left[0]) - gap, cd, 0)
                    key = ((st["top"] + q) << S) | j
                    if h == 0:
                        c = (0, key, 0)
                    elif cd == h:
                        c = (h, diag[1], diag[2] + ((im << S) | 1))
                    elif cu == h:
                        c = (h, up[1], up[2])
                    else:
                        c = (h, left[1], left[2])
                    assert c[2] & LOW < LOW and c[1] & LOW <= Lb
                    if q < st["nrows"] and _better((h, key), st["best"]):
                        st["best"] = (h, key, c[1], c[2])
                    diag, up = left, c
                    st["col"][q] = c
                st["above_prev"], st["out"] = above, up
                if produce and st["g"] == G - 1:
                    ho[(aln0, band0, j)] = up
                    if j % chunk == 0 or j == Lb_r:
                        prog[(aln0, band0)] = j
            yield "step"
        for grp, unit in enumerate(units[:gpw]):
            best = (NEG, 0, 0, 0)
            for st in L:
                if st["grp"] == grp and _better(st["best"], best):
                    best = st["best"]
            bests[unit] = best

    tickets = [(aln, band) for band in range(nb) for aln in range(B)]
    per = gpw if nb == 1 else 1
    warps = [tickets[i : i + per] for i in range(0, len(tickets), per)]
    rng = np.random.default_rng(seed)
    running, speed, started, idle = [], [], 0, 0
    while started < len(warps) or running:
        if started < len(warps) and (not running or rng.random() < 0.3):
            running.append(warp(warps[started]))
            speed.append(rng.random() ** 3 + 1e-3)
            started += 1
            continue
        p = np.asarray(speed) / sum(speed)
        k = int(rng.choice(len(running), p=p))
        try:
            idle = idle + 1 if next(running[k]) == "wait" else 0
        except StopIteration:
            running.pop(k)
            speed.pop(k)
            idle = 0
        assert idle < 200000, "deadlock: every running warp waits"
    out = np.zeros((7, B), np.int64)
    for aln in range(B):
        best = (NEG, 0, 0, 0)
        for band in range(nb):
            if _better(bests[(aln, band)], best):
                best = bests[(aln, band)]
        h, key, st, ml = best
        if h == NEG and table is not None and La and Lb:
            key = st = (1 << S) | 1    # an empty region: cell (1, 1)
            ml = 0
        i, j, si, sj = key >> S, key & LOW, st >> S, st & LOW
        out[:, aln] = [max(h, 0), si, i, sj, j, ml >> S,
                       (i - si) + (j - sj) - (ml & LOW)]
    return out


def _model_inputs(rng, B, La, Lb, n_codes=5):
    a = rng.integers(0, n_codes, (B, La)).astype(np.uint8)
    b = rng.integers(0, n_codes, (B, Lb)).astype(np.uint8)
    for r in range(B):
        n = int(rng.integers(0, min(La, Lb) + 1))
        if n and rng.random() < 0.7:
            qa = int(rng.integers(0, La - n + 1))
            qb = int(rng.integers(0, Lb - n + 1))
            b[r, qb : qb + n] = a[r, qa : qa + n]
            if n > 8 and rng.random() < 0.6:
                # an indel in the copy: the best path takes an up or left
                # move, and ties between them arise
                k = qb + int(rng.integers(3, n - 3))
                row = b[r, qb : qb + n].copy()
                b[r, qb : qb + n] = (np.delete(row, k - qb).tolist()
                                     + [4] if rng.random() < 0.5 else
                                     np.insert(row, k - qb, 2)[:n])
    return a, b


# protein mode as the domain engine calls it
PROTEIN = dict(mismatch=-4, gap=8, invalid_code=AA_X)


def _check_model(a, b, table=False, **kw):
    if table:
        ref = batched_local_align(torch.from_numpy(a), torch.from_numpy(b),
                                  submatrix=torch.from_numpy(BLOSUM62),
                                  **PROTEIN)
        kw.update(table=sw_table(BLOSUM62, PROTEIN["mismatch"], AA_X),
                  mismatch=PROTEIN["mismatch"], gap=PROTEIN["gap"], inv=AA_X)
    else:
        ref = batched_local_align(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(_kernel_model(a, b, **kw),
                                  np.stack([f.numpy() for f in ref]))


# (R, lanes a warp, chunk columns, fetch-ahead steps, packed fields); the
# first four keep the ids of the earlier one-block-per-alignment model
_SCHEDULES = [(8, 512, 32, 8, True), (2, 3, 4, 1, True), (1, 4, 3, 2, False),
              (3, 2, 2, 1, True), (1, 32, 32, 8, True), (2, 4, 8, 3, True),
              (4, 2, 5, 4, False), (1, 3, 1, 1, True), (2, 8, 32, 8, False),
              (4, 32, 32, 8, True), (8, 32, 32, 8, False), (16, 2, 4, 2, True),
              (16, 32, 32, 4, False)]


# protein mode (BLOSUM62 from the kernel's 32 x 32 table): packed fields
# only, the kernel's R 4 and 8, one band and banded
_TABLE_SCHEDULES = [(4, 32, 32, 8, True), (8, 32, 32, 4, True),
                    (4, 2, 5, 4, True), (8, 3, 4, 2, True)]
# protein mode with many thin bands: small warps at R 4 and 8
_THIN_SCHEDULES = [(4, 4, 3, 1, True), (4, 3, 4, 2, True),
                   (8, 2, 3, 1, True)]


@pytest.mark.parametrize(
    "R,lanes,chunk,ahead,packed,table",
    [s + (False,) for s in _SCHEDULES] + [s + (True,)
                                          for s in _TABLE_SCHEDULES],
    ids=[f"{r}-{n}" if i < 4 else f"R{r}-lanes{n}-chunk{c}-ahead{h}-"
         f"{'packed' if p else 'wide'}"
         for i, (r, n, c, h, p) in enumerate(_SCHEDULES)]
    + [f"R{r}-lanes{n}-chunk{c}-ahead{h}-packed-blosum62-table"
       for r, n, c, h, _p in _TABLE_SCHEDULES])
def test_kernel_schedule_matches_plain(R, lanes, chunk, ahead, packed, table):
    """The CUDA kernel's schedule (modelled in Python: lane groups, bands
    handed over in chunks behind progress counts in a random warp order,
    packed fields) computes what the plain version computes, in the
    nucleotide mode and in protein mode (a quarter of the codes invalid).
    Small warps and chunks make several bands and chunks run at small
    sizes."""
    rng = np.random.default_rng(R * 1000 + lanes * 10 + chunk)
    for t in range(6):
        B = int(rng.integers(1, 6))
        La, Lb = (int(x) for x in rng.integers(0 if t == 5 else 1, 34, 2))
        a, b = _model_inputs(rng, B, La, Lb, n_codes=27 if table else 5)
        _check_model(a, b, R=R, lanes=lanes, chunk=chunk, ahead=ahead,
                     packed=packed, seed=int(rng.integers(1 << 30)),
                     table=table)


@pytest.mark.parametrize("R,lanes,chunk", [(1, 4, 3), (2, 4, 5), (2, 3, 2)])
@pytest.mark.parametrize("where", ["band_last_row", "last_column", "both"])
def test_kernel_model_best_on_band_border(R, lanes, chunk, where):
    """A planted best cell on a band's last row, on the last column, or
    on both, across several orders of the warps."""
    H = lanes * R
    La, Lb = 3 * H, 2 * chunk + 3
    rng = np.random.default_rng(H * 7 + chunk)
    a = rng.integers(0, 4, (3, La)).astype(np.uint8)
    b = rng.integers(0, 4, (3, Lb)).astype(np.uint8)
    a[0] = b[0] = 4       # row 0: only the planted core can score
    n = min(H, Lb - 2)
    end_a = H if where != "last_column" else La - 2
    end_b = Lb if where != "band_last_row" else Lb - 2
    for r in range(3):
        core = rng.integers(0, 4, n).astype(np.uint8)
        a[r, end_a - n : end_a] = b[r, end_b - n : end_b] = core
    ref = batched_local_align(torch.from_numpy(a), torch.from_numpy(b))
    assert int(ref.qe[0]) == end_a and int(ref.se[0]) == end_b
    for seed in range(3):
        _check_model(a, b, R=R, lanes=lanes, chunk=chunk,
                     ahead=min(chunk - 1, 2), seed=seed)


def test_kernel_model_tie_across_bands():
    """Equal best scores in the first and last band (and in two columns
    of one band): the first row, then the first column, wins."""
    La, Lb = 40, 20
    a = np.full((2, La), 4, np.uint8)
    b = np.full((2, Lb), 4, np.uint8)
    core = np.array([0, 1, 2, 3, 3, 1], np.uint8)
    a[0, 2:8] = a[0, 30:36] = core
    b[0, 10:16] = core
    a[1, 20:26] = core
    b[1, 1:7] = b[1, 12:18] = core
    ref = batched_local_align(torch.from_numpy(a), torch.from_numpy(b))
    assert ref.qe.tolist() == [8, 26] and ref.se.tolist() == [16, 7]
    for seed in range(3):
        _check_model(a, b, R=2, lanes=4, chunk=4, ahead=2, seed=seed)


def test_padded_protein_covers_every_kind():
    """The inputs reach what they are named for: extents that differ,
    extent 0 on each side, the best cell on the extent border, a zero
    tie with a non-empty region."""
    rng = np.random.default_rng(0)
    a, b = padded_protein(rng, 16, 30, 25)
    la, lb = terminal.sw_extents(torch.from_numpy(a), torch.from_numpy(b),
                                 **PROTEIN)
    ref = batched_local_align(torch.from_numpy(a), torch.from_numpy(b),
                              submatrix=torch.from_numpy(BLOSUM62), **PROTEIN)
    kinds = [ROW_KINDS[r % len(ROW_KINDS)] for r in range(16)]
    for r, kind in enumerate(kinds):
        if kind in ("a_empty", "b_empty"):
            assert la[r] == lb[r] == 0
        if kind == "best_on_border":
            assert int(ref.qe[r]) == la[r] and int(ref.se[r]) == lb[r]
        if kind == "zero_tie":
            assert la[r] == lb[r] == 1 and int(ref.score[r]) == 0
    assert len(set(la.tolist())) > 3 and (la != lb).any()


@pytest.mark.parametrize("seed", range(6))
def test_cut_matrices_equal_the_padded(seed):
    """The exactness of computing only the extents: the plain version on
    each row cut to its La_r x Lb_r region equals the JAX package's
    `batched_local_align` (BLOSUM62, mismatch -4, gap 8, X = 20) on the
    padded batch, and an empty region gives the JAX package's all-invalid
    answer, score 0 at cell (1, 1)."""
    rng = np.random.default_rng(1000 + seed)
    B, La, Lb = 16, int(rng.integers(8, 41)), int(rng.integers(8, 41))
    a, b = padded_protein(rng, B, La, Lb)
    ref = np.stack([np.asarray(f) for f in jax_sw(
        jnp.asarray(a), jnp.asarray(b), submatrix=jnp.asarray(BLOSUM62),
        **PROTEIN)])
    la, lb = terminal.sw_extents(torch.from_numpy(a), torch.from_numpy(b),
                                 **PROTEIN)
    sub = torch.from_numpy(BLOSUM62)
    for r in range(B):
        ea, eb = int(la[r]), int(lb[r])
        if ea == 0:
            assert ref[:, r].tolist() == [0, 1, 1, 1, 1, 0, 0]
            continue
        got = batched_local_align(
            torch.from_numpy(a[r : r + 1, :ea].copy()),
            torch.from_numpy(b[r : r + 1, :eb].copy()), submatrix=sub,
            **PROTEIN)
        np.testing.assert_array_equal(
            ref[:, r], [int(f[0]) for f in got], err_msg=f"row {r}")


def test_extents_are_full_without_the_cut():
    """With mismatch >= 0 or gap <= 0 the cut is not exact, so the
    extents are the full widths."""
    a = np.full((2, 9), AA_X, np.uint8)
    a[0, :3] = 1
    t = torch.from_numpy(a)
    for mm, gap in ((0, 8), (-4, 0), (2, -1)):
        la, lb = terminal.sw_extents(t, t, invalid_code=AA_X, mismatch=mm,
                                     gap=gap)
        assert la.tolist() == lb.tolist() == [9, 9]
    la, _ = terminal.sw_extents(t, t, **PROTEIN)
    assert la.tolist() == [3, 0]


@pytest.mark.parametrize(
    "R,lanes,chunk,ahead,packed", _TABLE_SCHEDULES + _THIN_SCHEDULES,
    ids=[f"R{r}-lanes{n}-chunk{c}-ahead{h}"
         for r, n, c, h, _p in _TABLE_SCHEDULES + _THIN_SCHEDULES])
def test_kernel_model_protein_extents(R, lanes, chunk, ahead, packed):
    """The protein schedule on padded batches (mixed extents, extent 0 on
    either side, X inside, the best on the extent border, zero ties,
    other invalid codes): extents found by each group, the int8 profile,
    warps stepping to their last active lane, bands past La_r."""
    rng = np.random.default_rng(R * 100 + lanes * 10 + chunk)
    for t in range(3):
        B = int(rng.integers(1, 9))
        La, Lb = (int(x) for x in rng.integers(1, 36, 2))
        a, b = padded_protein(rng, B, La, Lb,
                              kinds=tuple(rng.permutation(ROW_KINDS)))
        _check_model(a, b, R=R, lanes=lanes, chunk=chunk, ahead=ahead,
                     packed=packed, seed=int(rng.integers(1 << 30)),
                     table=True)


@pytest.mark.parametrize("seed", range(4))
def test_kernel_model_protein_plan(seed):
    """The protein plan's pick, modelled with the card's 32-lane warps."""
    rng = np.random.default_rng(7000 + seed)
    B = int(rng.integers(1, 33))
    La, Lb = (int(x) for x in rng.integers(1, 41, 2))
    plan = sw_plan(La, Lb, protein=True)
    assert plan.R in SW_ROWS
    a, b = padded_protein(rng, B, La, Lb)
    _check_model(a, b, R=plan.R, lanes=32, chunk=32, ahead=4, seed=seed,
                 table=True)


def test_kernel_model_partly_filled_lane_groups():
    """Short alignments: several per warp, a ragged last warp, a group
    width that does not divide the warp, and idle lanes past the last
    group (G = 5 lanes of 8 rows: 6 alignments a warp, 2 lanes idle)."""
    rng = np.random.default_rng(77)
    a, b = _model_inputs(rng, 13, 37, 29)
    a[4] = 4
    _check_model(a, b, R=8, seed=3)
    _check_model(a, b, R=4, seed=4)


@pytest.mark.parametrize("La,Lb,packed", [
    (65535, 65535, True), (65536, 1, False), (1, 65536, False),
    (40000, 40000, True), (8192, 8192, True), (40, 40, True)])
def test_sw_plan_packs_only_below_the_limit(La, Lb, packed):
    """The wrapper's choice: packed 16-bit fields while La and Lb < 65536,
    the unpacked instantiation at and past it (never the plain version),
    and a forced packed launch past the limit raises."""
    plan = sw_plan(La, Lb)
    assert plan.packed is packed
    assert plan.G * plan.R * plan.nb >= La
    if not packed:
        with pytest.raises(ValueError):
            sw_plan(La, Lb, packed=True)


@pytest.mark.parametrize("B,La,Lb", [
    (4096, 40, 40), (16, 40, 40), (256, 40, 40), (64, 1024, 1024),
    (32, 4096, 4096), (8, 8192, 8192), (2, 16384, 16384), (1001, 37, 53),
    (256, 300, 300), (1, 0, 5), (3, 7, 0)])
def test_sw_plan_covers_and_fills(B, La, Lb):
    """Every plan covers its rows the way csrc/sw.cu checks; short
    alignments share warps, long ones are banded into about a warp an SM
    or more (2 x 16384 rows: 128 bands of 256 rows, which the H100 sweep
    found faster than 256 bands of 128)."""
    p = sw_plan(La, Lb)
    assert p.R in SW_ROWS and 1 <= p.G <= 32
    if p.nb == 1:
        assert p.G * p.R >= La
    else:
        assert p.G == 32 and (p.nb - 1) * 32 * p.R < La <= p.nb * 32 * p.R
    if La >= 4096:
        assert B * p.nb >= 128
    if La <= 64:
        assert p.nb == 1


@pytest.mark.parametrize("B,La,R", [
    (16, 40, 4), (256, 40, 4), (1001, 37, 4), (4096, 40, 4), (16384, 40, 4),
    (64, 128, 4), (64, 129, 8), (256, 300, 8), (32, 4096, 8), (8, 8192, 8)])
def test_sw_plan_rows(B, La, R):
    """R = 4 while an alignment fits one warp at 4 rows a lane (lane
    groups, whatever the batch), else R = 8 (one band to 256 rows, then
    bands of 256 rows)."""
    p = sw_plan(La, 40)
    assert p.R == R and (p.nb == 1) is (La <= 256)


@pytest.mark.parametrize("La,Lb", [
    (1, 1), (64, 64), (256, 256), (512, 512), (1024, 1024), (2048, 2048),
    (4096, 4096), (37, 53), (65, 40), (129, 300), (300, 700), (0, 5),
    (5, 0), (2047, 2048)])
def test_sw_protein_plan_covers(La, Lb):
    """The protein plan covers its rows the way csrc/sw.cu checks, with
    packed fields and the nucleotide plan's R (`sw_rows`)."""
    p = sw_plan(La, Lb, protein=True)
    assert p.R == terminal.sw_rows(La) and 1 <= p.G <= 32 and p.packed
    assert p == sw_plan(La, Lb)
    if p.nb == 1:
        assert p.G * p.R >= La
    else:
        assert p.G == 32 and (p.nb - 1) * 32 * p.R < La <= p.nb * 32 * p.R


# the faster of R 4 and 8 in chip_smoke.py's protein sweep on the H100
# (PERF.md §6): (B, width) -> R
_SWEPT_FASTEST = {(4, 64): 4, (8, 256): 8, (32, 512): 8, (4, 1024): 8,
                  (16, 2048): 8, (128, 512): 8, (256, 1024): 8,
                  (256, 2048): 8, (64, 4096): 8, (1024, 256): 8}


@pytest.mark.parametrize("B,w", sorted(_SWEPT_FASTEST))
def test_sw_protein_plan_picks_the_swept_fastest(B, w):
    """The plan's pick is the R the card ran fastest at each swept shape
    of the domain confirm: R = 4 where an alignment fits one warp, R = 8
    wherever it bands, whatever the batch."""
    assert sw_plan(w, w, protein=True).R == _SWEPT_FASTEST[B, w]


def test_sw_plan_rows_per_mode():
    """Both modes take R 4 and 8 and refuse any other; protein mode
    refuses unpacked fields."""
    for protein in (False, True):
        for R in (2, 16):
            with pytest.raises(ValueError, match="R must be one of"):
                sw_plan(64, 64, R=R, protein=protein)
        assert sw_plan(64, 64, R=8, protein=protein) == (8, 8, 1, True)
    with pytest.raises(ValueError, match="packed fields only"):
        sw_plan(64, 64, packed=False, protein=True)


@pytest.mark.parametrize("entry,mismatch", [(128, -4), (-129, -4), (11, 128),
                                            (11, -200)])
def test_sw_profile_rejects_what_int8_cannot_hold(entry, mismatch):
    """A table entry or mismatch outside int8 raises on every device
    (the kernel's query profile is int8); the edges of int8 pass."""
    sub = BLOSUM62.copy()
    sub[3, 5] = entry
    a = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="int8"):
        sw_table(sub, mismatch, AA_X)
    with pytest.raises(ValueError, match="int8"):
        batched_local_align_auto(a, a, submatrix=sub, mismatch=mismatch,
                                 gap=8, invalid_code=AA_X)
    sub[3, 5], sub[5, 3] = 127, -128
    assert sw_table(sub, -128, AA_X)[3, 5] == 127
    # entries past the invalid code are never read: they may be anything
    sub[AA_X:, :] = 1000
    sw_table(sub, -4, AA_X)


def test_sw_protein_mode_submatrix():
    """Protein mode (scores from a substitution table, padding code never
    scores): the plain version with a random symmetric table, and
    BLOSUM62 as the domain engine calls it through the kernel wrapper on
    the CPU (X-heavy rows, an all-X row, pairs that differ only in
    invalid codes)."""
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

    a = rng.integers(0, 20, (8, 64)).astype(np.uint8)
    b = rng.integers(0, 20, (8, 64)).astype(np.uint8)
    b[:, 10:50] = a[:, 5:45]
    b[::3, 20:24] = 7                    # mismatches inside the copy
    a[1][rng.random(64) < 0.5] = 20      # X-heavy
    a[2] = 20                            # all X
    a[3, 30:] = AA_X
    b[3, 30:] = 25                       # differ only in invalid codes
    a[4, 50:] = 21
    b[4, 50:] = 20
    ref = jax_sw(jnp.asarray(a), jnp.asarray(b),
                 submatrix=jnp.asarray(BLOSUM62), **PROTEIN)
    for table in (BLOSUM62, torch.from_numpy(BLOSUM62)):
        got = batched_local_align_auto(torch.from_numpy(a),
                                       torch.from_numpy(b),
                                       submatrix=table, **PROTEIN)
        _assert_same(ref, got)
    assert int(got.score[2]) == 0 and int(got.matches[0]) >= 30


def test_sw_table_layout():
    """The kernel's table: BLOSUM62 for valid codes, `mismatch` in every
    row and column of an invalid code (30 and 31 included)."""
    tab = sw_table(BLOSUM62, -4, AA_X)
    assert tab.shape == (32, 32) and tab.dtype == np.int32
    np.testing.assert_array_equal(tab[:20, :20], BLOSUM62[:20, :20])
    assert (tab[20:] == -4).all() and (tab[:, 20:] == -4).all()
    # a narrower table is indexed with codes clamped to its shape, as the
    # plain version indexes it
    small = np.arange(9, dtype=np.int32).reshape(3, 3)
    np.testing.assert_array_equal(sw_table(small, -1, 5)[4, :5],
                                  [6, 7, 8, 8, 8])


def test_sw_wrapper_rejects_tables_it_cannot_take():
    """A table wider than 32 codes raises on every device; the unpacked
    variant (widths of 65536 and more, or forced) has no protein mode and
    raises before any launch; so does an invalid code past the table."""
    a = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="at most 32"):
        batched_local_align_auto(a, a, submatrix=np.zeros((33, 33), np.int32))
    with pytest.raises(ValueError, match="at most 32"):
        batched_local_align_auto(a.to("meta"), a.to("meta"),
                                 submatrix=np.zeros((20, 40), np.int32))
    with pytest.raises(ValueError, match="invalid_code"):
        batched_local_align_auto(a, a, submatrix=BLOSUM62, invalid_code=31)
    kw = dict(match=2, **PROTEIN)
    with pytest.raises(ValueError, match="packed fields only"):
        terminal._sw_cuda(a, a, packed=False, submatrix=BLOSUM62, **kw)
    wide = torch.zeros((1, 65536), dtype=torch.uint8)
    with pytest.raises(ValueError, match="packed fields only"):
        terminal._sw_cuda(wide, a[:1], submatrix=BLOSUM62, **kw)
