"""The protein-domain engine of hite_tpu_torch vs hite_tpu, bit-exact.

Protein tables and translation, the amino-acid k-mer index, seed-extend
HSPs (`pair_hsps`, both sort-key branches, several tiles), the device
chaining (`chain_hsps` with groups), `DomainScanner.scan` (every
`DomainHit` field, the reverse-frame coordinate quirk included),
`rescue_by_domain`, `rt_motif_present` and `ltr_domain_order`: the same
seeded numpy inputs through the JAX function and its port, on the CPU,
with tolerance zero.  The BLOSUM62 confirm runs the plain SW here; the
kernel's protein mode is held against it on the card by chip_smoke.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hite_tpu.io.fasta import encode_seq, revcomp
from hite_tpu.ops import chain as jchain
from hite_tpu.ops import kmer as jkmer
from hite_tpu.ops import protein as jprot
from hite_tpu.ops import seedext as jseed
from hite_tpu.pipeline import domain as jdom
from hite_tpu_torch.ops import chain as tchain
from hite_tpu_torch.ops import kmer as tkmer
from hite_tpu_torch.ops import protein as tprot
from hite_tpu_torch.ops import seedext as tseed
from hite_tpu_torch.pipeline import domain as tdom
from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AAS = "ARNDCQEGHILKMFPSTWYV"
SAFE_CODON = {"A": "GCA", "R": "CGA", "N": "AAC", "D": "GAC", "C": "TGC",
              "Q": "CAA", "E": "GAA", "G": "GGA", "H": "CAC", "I": "ATC",
              "L": "CTA", "K": "AAA", "M": "ATG", "F": "TTC", "P": "CCA",
              "S": "TCA", "T": "ACA", "W": "TGG", "Y": "TAC", "V": "GTA",
              "X": "GCA"}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _same_fields(ref, got):
    for f in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f).numpy(), err_msg=f)


# ---- tables, translation, k-mers, the index

def test_protein_tables_identical():
    assert tprot.AA_ORDER == jprot.AA_ORDER and tprot.AA_X == jprot.AA_X
    assert tprot.AA_TO_CODE == jprot.AA_TO_CODE
    np.testing.assert_array_equal(tprot.CODON_TABLE, jprot.CODON_TABLE)
    np.testing.assert_array_equal(tprot.BLOSUM62, jprot.BLOSUM62)
    assert tprot.BLOSUM62.shape == (21, 21)
    s = "MKVLAX*BZacgt"
    np.testing.assert_array_equal(tprot.encode_protein(s),
                                  jprot.encode_protein(s))
    codes = np.arange(25, dtype=np.uint8)
    assert tprot.decode_protein(codes) == jprot.decode_protein(codes)


@pytest.mark.parametrize("B,L", [(5, 301), (3, 96), (2, 1024), (4, 7),
                                 (1, 6)])
def test_translate_frames(B, L):
    """All six frames, N codons, lengths not a multiple of 3, and rows
    padded with N past a shorter length (reverse frames start there)."""
    rng = np.random.default_rng(B * 1000 + L)
    seqs = rng.integers(0, 5, (B, L)).astype(np.uint8)
    seqs[0, L // 2 :] = 4
    ref = np.asarray(jprot.translate_frames(jnp.asarray(seqs)))
    got = tprot.translate_frames(_t(seqs)).numpy()
    assert ref.shape == got.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("k", [3, 4])
def test_aa_kmer_codes(k):
    rng = np.random.default_rng(k)
    aa = rng.integers(0, 21, (3, 2, 200)).astype(np.uint8)
    ref = np.asarray(jprot.aa_kmer_codes(jnp.asarray(aa), k))
    got = tprot.aa_kmer_codes(_t(aa), k).numpy()
    np.testing.assert_array_equal(ref, got)
    assert (got == -1).any() and (got >= 0).any()


@pytest.mark.parametrize("shape", [(5000,), (3, 700)])
def test_build_index_from_kmers(shape):
    """Stable sort of aa k-mer codes, invalid (-1) last; leading dims map."""
    rng = np.random.default_rng(len(shape))
    aa = rng.integers(0, 21, shape).astype(np.uint8)
    aa[..., 10:40] = 3                      # runs of equal codes: ties
    ref = jkmer.build_index_from_kmers(jprot.aa_kmer_codes(jnp.asarray(aa), 4))
    got = tkmer.build_index_from_kmers(tprot.aa_kmer_codes(_t(aa), 4))
    np.testing.assert_array_equal(np.asarray(ref.codes), got.codes.numpy())
    np.testing.assert_array_equal(np.asarray(ref.pos), got.pos.numpy())


# ---- seed-extend HSPs and the device chaining

def _seed_case(rng, n_subj, rows, qlen, n_plant):
    flat = rng.integers(0, 21, n_subj).astype(np.uint8)
    q = rng.integers(0, 21, (rows, qlen)).astype(np.uint8)
    for r in range(rows):
        for p in range(n_plant):
            s0 = int(rng.integers(0, n_subj - 400))
            q0 = int(rng.integers(0, qlen - 200))
            q[r, q0 : q0 + 180] = flat[s0 : s0 + 180]
            q[r, q0 + 60 : q0 + 64] = 20            # an X break in the copy
    return flat, q


def _both_hsps(flat, q, **kw):
    ji = jkmer.build_index_from_kmers(jprot.aa_kmer_codes(jnp.asarray(flat), 4))
    ti = tkmer.build_index_from_kmers(tprot.aa_kmer_codes(_t(flat), 4))
    qk = jprot.aa_kmer_codes(jnp.asarray(q), 4)
    ref = jax.vmap(lambda x: jseed.pair_hsps(x, ji, k=4, **kw))(qk)
    got = tseed.pair_hsps(tprot.aa_kmer_codes(_t(q), 4), ti, k=4, **kw)
    _same_fields(ref, got)
    return ref, got


_HSP_CASES = {
    # the domain engine's parameters, one tile and several tiles
    "domain_one_tile": (6000, 6, 400, 2, dict(
        stride=1, max_hits=8, diag_band=16, run_gap=24, min_seeds=2,
        min_hsp_len=8, max_hsps=128)),
    "domain_tiles": (6000, 6, 400, 3, dict(
        stride=1, max_hits=8, diag_band=16, run_gap=24, min_seeds=2,
        min_hsp_len=8, max_hsps=64, tile_entries=300)),
    "stride2_tiles_few_slots": (4000, 4, 600, 3, dict(
        stride=2, max_hits=4, diag_band=8, run_gap=24, min_seeds=2,
        min_hsp_len=8, max_hsps=16, tile_entries=256)),
    # diag_band 1 against a 1.2 M subject: n_dbins * Q >= 2**31, the
    # unpacked 2-key sort
    "two_key_sort": (1_200_000, 2, 2000, 2, dict(
        stride=1, max_hits=4, diag_band=1, run_gap=24, min_seeds=2,
        min_hsp_len=8, max_hsps=64, tile_entries=2048)),
}


@pytest.mark.parametrize("case", list(_HSP_CASES))
def test_pair_hsps(case):
    n_subj, rows, qlen, n_plant, kw = _HSP_CASES[case]
    rng = np.random.default_rng(len(case))
    flat, q = _seed_case(rng, n_subj, rows, qlen, n_plant)
    qk_len = qlen - 3
    Q = qk_len // kw["stride"]
    packed = ((qk_len + n_subj) // kw["diag_band"] + 2) * Q < 2**31
    assert packed is (case != "two_key_sort")
    _, got = _both_hsps(flat, q, **kw)
    assert int(got.valid.sum()) >= rows


def test_pair_hsps_exclude_self():
    """A self search drops qpos == spos seeds (the segment-pair mode)."""
    rng = np.random.default_rng(8)
    flat = rng.integers(0, 21, 3000).astype(np.uint8)
    flat[2000:2200] = flat[500:700]
    ji = jkmer.build_index_from_kmers(jprot.aa_kmer_codes(jnp.asarray(flat), 4))
    ti = tkmer.build_index_from_kmers(tprot.aa_kmer_codes(_t(flat), 4))
    kw = dict(k=4, stride=1, max_hits=8, diag_band=16, run_gap=24,
              min_seeds=2, min_hsp_len=8, max_hsps=32, exclude_self=True)
    ref = jseed.pair_hsps(jprot.aa_kmer_codes(jnp.asarray(flat), 4), ji, **kw)
    got = tseed.pair_hsps(tprot.aa_kmer_codes(_t(flat[None]), 4), ti, **kw)
    for f in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f).numpy()[0], err_msg=f)
    assert int(got.valid.sum()) >= 2
    s, e = tseed.rc_to_forward(got.ss, got.se, 3000)
    rs, re_ = jseed.rc_to_forward(ref.ss, ref.se, 3000)
    np.testing.assert_array_equal(np.asarray(rs), s.numpy()[0])
    np.testing.assert_array_equal(np.asarray(re_), e.numpy()[0])


@pytest.mark.parametrize("grouped", [True, False])
def test_chain_hsps(grouped):
    """Chains over (group, qs)-sorted HSPs; with groups (the library
    entry each HSP lands in) a chain never crosses an entry border."""
    rng = np.random.default_rng(21)
    flat, q = _seed_case(rng, 6000, 6, 400, 3)
    ref_h, got_h = _both_hsps(flat, q, stride=1, max_hits=8, diag_band=16,
                              run_gap=24, min_seeds=2, min_hsp_len=8,
                              max_hsps=128)
    kw = dict(extend_threshold=60, max_chains=8, min_len=20)
    if grouped:
        starts = np.array([0, 1000, 2500, 2600, 4000])
        jg = jnp.searchsorted(jnp.asarray(starts), ref_h.ss,
                              side="right").astype(jnp.int32)
        tg = torch.searchsorted(_t(starts), got_h.ss.long(),
                                right=True).int()
        ref = jax.vmap(lambda h, g: jchain.chain_hsps(h, group=g, **kw))(
            ref_h, jg)
        got = tchain.chain_hsps(got_h, group=tg, **kw)
    else:
        ref = jax.vmap(lambda h: jchain.chain_hsps(h, **kw))(ref_h)
        got = tchain.chain_hsps(got_h, **kw)
    _same_fields(ref, got)
    assert int(got.valid.sum()) >= 6


def test_chain_hsps_no_valid_hsp():
    z = torch.zeros((3, 5), dtype=torch.int32)
    h = tseed.HSPs(z, z, z, z, z, torch.zeros((3, 5), dtype=torch.bool))
    jz = jnp.zeros(5, jnp.int32)
    ref = jchain.chain_hsps(
        jseed.HSPs(jz, jz, jz, jz, jz, jnp.zeros(5, bool)),
        extend_threshold=60, max_chains=4, min_len=0)
    got = tchain.chain_hsps(h, extend_threshold=60, max_chains=4, min_len=0)
    for f in ref._fields:
        for r in range(3):
            np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                          getattr(got, f).numpy()[r])


# ---- the domain scanner

def _orf(rng, n_aa):
    prot = "".join(rng.choice(list(AAS)) for _ in range(n_aa))
    return prot, "".join(SAFE_CODON[a] for a in prot)


def _hits(hit_sets):
    return [[vars(h) for h in hits] for hits in hit_sets]


def _scan_both(lib, cands, **kw):
    ref = jdom.DomainScanner(lib).scan(cands, **kw)
    got = tdom.DomainScanner(lib, device="cpu").scan(cands, **kw)
    assert _hits(ref) == _hits(got)
    return got


def test_scan_planted_orf_forward():
    """tests/test_domain.py: an ORF between random flanks, two entries."""
    rng = np.random.default_rng(5)
    prot, nt = _orf(rng, 120)
    lib = {"DOM1": jprot.encode_protein(prot),
           "DOM2": jprot.encode_protein(_orf(rng, 150)[0])}
    cand = np.concatenate([rng.integers(0, 4, 77).astype(np.uint8),
                           encode_seq(nt),
                           rng.integers(0, 4, 90).astype(np.uint8)])
    hits = _scan_both(lib, [cand])[0]
    assert hits[0].entry == "DOM1" and hits[0].entry_cov > 0.9


def test_scan_reverse_frame_coordinate_quirk():
    """The reverse-strand ORF of tests/test_domain.py: a 410 bp candidate
    in the 512 bucket.  Reverse frames translate the reverse complement of
    the PADDED row and map back with the row's own length, so the hit that
    covers 50-350 reports 0-248 in both packages (ROADMAP.md queue 3)."""
    rng = np.random.default_rng(6)
    prot, nt = _orf(rng, 100)
    lib = {"DOM1": jprot.encode_protein(prot)}
    cand = np.concatenate([rng.integers(0, 4, 50).astype(np.uint8),
                           revcomp(encode_seq(nt)),
                           rng.integers(0, 4, 60).astype(np.uint8)])
    assert len(cand) == 410
    best = _scan_both(lib, [cand])[0][0]
    assert best.frame >= 3 and best.entry_cov > 0.9
    assert (best.q_start, best.q_end) == (0, 248)


def test_rescue_by_domain():
    rng = np.random.default_rng(7)
    prot, nt = _orf(rng, 110)
    lib = {"DOM1": jprot.encode_protein(prot)}
    cands = [encode_seq(nt), rng.integers(0, 4, 400).astype(np.uint8)]
    ref = jdom.rescue_by_domain(cands, jdom.DomainScanner(lib))
    got = tdom.rescue_by_domain(cands, tdom.DomainScanner(lib, device="cpu"))
    np.testing.assert_array_equal(ref, got)
    assert got.tolist() == [True, False]


@pytest.fixture(scope="module")
def tirpeps():
    path = os.path.join(ROOT, "hite_tpu_torch", "data", "protein",
                        "TIRPeps.lib")
    ref = jdom.DomainScanner.from_fasta(path.replace("hite_tpu_torch",
                                                     "hite_tpu"))
    got = tdom.DomainScanner.from_fasta(path, device="cpu")
    return ref, got


def test_vendored_data_identical():
    """The port's own copies of the protein libraries and LCV banks."""
    for rel in ("protein/TIRPeps.lib", "protein/HelitronPeps.lib",
                "helitron/head.lcvs", "helitron/tail.lcvs"):
        with open(os.path.join(ROOT, "hite_tpu", "data", rel), "rb") as a, \
                open(os.path.join(ROOT, "hite_tpu_torch", "data", rel),
                     "rb") as b:
            assert a.read() == b.read(), rel


def test_tirpeps_index_identical(tirpeps):
    ref, got = tirpeps
    assert ref.names == got.names
    np.testing.assert_array_equal(ref.starts, got.starts)
    np.testing.assert_array_equal(ref.flat, got.flat)
    np.testing.assert_array_equal(np.asarray(ref.index.codes),
                                  got.index.codes.numpy())
    np.testing.assert_array_equal(np.asarray(ref.index.pos),
                                  got.index.pos.numpy())
    assert tdom.DomainScanner.from_fasta(
        os.path.join(ROOT, "hite_tpu_torch", "data", "protein",
                     "TIRPeps.lib"), device="cpu") is got


def test_tirpeps_planted_entries(tirpeps):
    """Whole TIRPeps entries planted forward and reverse (widths 512 to
    4096), a fragment, random candidates: every DomainHit field."""
    ref_s, got_s = tirpeps
    lib = tdom.read_protein_fasta(os.path.join(
        ROOT, "hite_tpu_torch", "data", "protein", "TIRPeps.lib"))
    assert list(lib) == got_s.names
    rng = np.random.default_rng(0)
    names = list(lib)
    picks = [names[5], min(names, key=lambda n: abs(len(lib[n]) - 160)),
             min(names, key=lambda n: abs(len(lib[n]) - 100))]
    cands = []
    for n in picks:
        nt = encode_seq("".join(SAFE_CODON[a] for a in
                                jprot.decode_protein(lib[n])))
        for strand in (nt, revcomp(nt)):
            cands.append(np.concatenate([
                rng.integers(0, 4, 50).astype(np.uint8), strand,
                rng.integers(0, 4, 60).astype(np.uint8)]))
    cands.append(cands[2][: len(cands[2]) // 2].copy())     # a fragment
    cands += [rng.integers(0, 4, n).astype(np.uint8) for n in (500, 90)]
    ref = ref_s.scan(cands)
    got = got_s.scan(cands)
    assert _hits(ref) == _hits(got)
    assert all(got[i] and got[i][0].entry_cov >= 0.95 for i in range(6))
    assert ({h.frame >= 3 for i in range(6) for h in got[i][:1]}
            == {False, True})


def test_scanner_from_fastas_and_domain_table(tmp_path):
    """One scanner over two libraries (names prefixed by source) and the
    TE <-> domain table, written by both packages."""
    rng = np.random.default_rng(12)
    prots = [_orf(rng, 90), _orf(rng, 130), _orf(rng, 70)]
    paths = []
    for i, group in enumerate((prots[:2], prots[2:])):
        p = tmp_path / f"lib{i}.fa"
        p.write_text("".join(f">P{i}_{j} desc\n{pr[:40]}\n{pr[40:]}\n\n"
                             for j, (pr, _nt) in enumerate(group)))
        paths.append(str(p))
    cands = [np.concatenate([rng.integers(0, 4, 30).astype(np.uint8),
                             encode_seq(nt)]) for _pr, nt in prots]
    ref_s = jdom.DomainScanner.from_fastas(paths)
    got_s = tdom.DomainScanner.from_fastas(paths, device="cpu")
    assert ref_s.names == got_s.names == ["0|P0_0", "0|P0_1", "1|P1_0"]
    assert got_s is tdom.DomainScanner.from_fastas(paths, device="cpu")
    ref, got = ref_s.scan(cands), got_s.scan(cands)
    assert _hits(ref) == _hits(got)
    names = [f"te{i}" for i in range(len(cands))]
    jdom.write_domain_table(str(tmp_path / "j" / "dom.tsv"), names, ref)
    tdom.write_domain_table(str(tmp_path / "t" / "dom.tsv"), names, got)
    text = (tmp_path / "t" / "dom.tsv").read_text()
    assert (tmp_path / "j" / "dom.tsv").read_text() == text
    assert len(text.splitlines()) >= 4


# ---- the data-free RT / integrase grammars

def _nt_of(aa: str) -> np.ndarray:
    return encode_seq("".join(SAFE_CODON[a] for a in aa))


def _pol(order: str, rng) -> np.ndarray:
    spacer = "".join("GA"[i % 2] for i in range(60))
    rt = "LPQG" + "A" * 20 + "YADD"
    integrase = "H" + "G" * 5 + "H" + "A" * 28 + "C" + "GG" + "C"
    body = (integrase + spacer + rt if order == "copia"
            else rt + spacer + integrase)
    return np.concatenate([rng.integers(0, 4, 21).astype(np.uint8),
                           _nt_of("M" + spacer + body + spacer)])


def test_rt_motif_and_domain_order():
    """tests/test_domain_order.py's Copia / Gypsy layouts, a reverse-strand
    copy, an RT block only, and random sequence, over several buckets."""
    rng = np.random.default_rng(17)
    copia, gypsy = _pol("copia", rng), _pol("gypsy", rng)
    rt_only = np.concatenate([rng.integers(0, 4, 200).astype(np.uint8),
                              _nt_of("MLPQG" + "S" * 30 + "FVDD"),
                              rng.integers(0, 4, 50).astype(np.uint8)])
    cands = [copia, gypsy, revcomp(gypsy), rt_only,
             rng.integers(0, 4, 900).astype(np.uint8),
             rng.integers(0, 4, 60).astype(np.uint8),
             rng.integers(0, 4, 3000).astype(np.uint8)]
    ref = jdom.rt_motif_present(cands)
    got = tdom.rt_motif_present(cands, device="cpu")
    np.testing.assert_array_equal(ref, got)
    assert got[:4].tolist() == [True, True, True, True]
    for kw in ({}, dict(gap_min=25, gap_max=30)):
        np.testing.assert_array_equal(jdom.rt_motif_present(cands, **kw),
                                      tdom.rt_motif_present(cands, **kw,
                                                            device="cpu"))
    ref = jdom.ltr_domain_order(cands)
    got = tdom.ltr_domain_order(cands, device="cpu")
    np.testing.assert_array_equal(ref, got)
    assert got[:2].tolist() == [1, 2] and got.dtype == np.int8
    assert tdom.ltr_domain_order([], device="cpu").shape == (0,)
