"""The chunked paths' spans and counters, as the benchmark reads them.

A genome padded past each cap takes the path that a 100 Mbp assembly
takes at 2^27: the coarse self-join in chunks (`CoarseParams(
max_selfjoin_bp=...)`), the LTR candidates in chunks (`LTR_CHUNK_BP`
monkeypatched) and the copy join in chunks (`max_libjoin_bp` at Lp / 2).
Each loop opens its span once, each chunk its copy-join spans once, the
stage lines say so, the counters agree with them, and the new names fall
under none of the benchmark's layer rules (`gpubench/layers.py`), so the
layer sums read what they read before.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from test_torch_spans import _layer_matched, _Lines  # noqa: E402

torch.set_num_threads(2)

CAP = 1 << 17            # half the genome's 2^18 padding: 3 chunks
NEW_SPANS = ("coarse.chunked_selfjoin", "ltr.chunked_candidates",
             "copies.join_pairs", "copies.join_scan", "copies.join_chain")


def _starts(lines, name=None):
    """Names of the spans opened, in order (only `name` if given)."""
    got = [m[len("stage "):-len(": start")] for _, m in lines
           if m.startswith("stage ") and m.endswith(": start")]
    return [n for n in got if name is None or n == name]


def _record(fn):
    """(stage lines, counters) of one call, from clean counters."""
    from hite_tpu_torch.utils import log

    handler = _Lines()
    log.logger.addHandler(handler)
    log.STAGE_TIMES.clear()
    log.COUNTERS.clear()
    try:
        fn()
    finally:
        log.logger.removeHandler(handler)
    return handler.lines, dict(log.COUNTERS)


def _ltr_element(rng, ltr_bp, interior_bp):
    t = rng.integers(0, 4, ltr_bp).astype(np.uint8)
    t[0], t[1], t[-2], t[-1] = 3, 2, 1, 0          # TG ... CA
    return np.concatenate([t, rng.integers(0, 4, interior_bp).astype(
        np.uint8), t])


@pytest.fixture(scope="module")
def substrate():
    """220 kbp (padded to 2^18) with two LTR families and one repeat
    family, their copies spread over the whole genome; the repeat
    family's copies as the copy join's candidates."""
    from hite_tpu_torch.genome import Genome

    rng = np.random.default_rng(18)
    length = 220_000
    bg = rng.integers(0, 4, length).astype(np.uint8)
    tes = [_ltr_element(rng, 300, 1500), _ltr_element(rng, 400, 1800),
           rng.integers(0, 4, 1200).astype(np.uint8)]
    copies = []
    for i, pos in enumerate(range(4_000, length - 6_000, 12_000)):
        te = tes[i % 3].copy()
        muts = rng.random(len(te)) < 0.01
        te[muts] = (te[muts] + rng.integers(1, 4, muts.sum())) % 4
        tsd = rng.integers(0, 4, 5).astype(np.uint8)
        bg[pos - 5 : pos] = tsd
        bg[pos + len(te) : pos + len(te) + 5] = tsd
        bg[pos : pos + len(te)] = te
        copies.append((i % 3, pos, pos + len(te)))
    g = Genome.from_dict({"chr1": bg}, device="cpu")
    g.init_mask()
    assert g.device_flat_padded()[0].shape[0] == 1 << 18
    cands = [bg[s:e].copy() for f, s, e in copies if f == 2]
    return g, cands


@pytest.mark.parametrize("cap,chunked", [(CAP, True), (1 << 26, False)])
def test_chunked_selfjoin_span_once_a_loop(substrate, cap, chunked):
    from hite_tpu_torch.config import AlignConfig
    from hite_tpu_torch.pipeline.coarse import CoarseParams, coarse_discover

    g, _ = substrate
    out = {}
    lines, counters = _record(lambda: out.setdefault("iv", coarse_discover(
        g, AlignConfig(), CoarseParams(seg_len=32_768, max_selfjoin_bp=cap))))
    n = counters.get("coarse.selfjoin.chunks", 0)
    names = _starts(lines)
    if chunked:
        assert n == 3
        assert names.count("coarse.chunked_selfjoin") == 1
        # the loop's span holds every chunk's self-join
        i = names.index("coarse.chunked_selfjoin")
        assert names[i + 1:].count("coarse.selfjoin") == n
    else:
        assert n == 0 and "coarse.chunked_selfjoin" not in names
    assert len(out["iv"]) > 0


@pytest.mark.parametrize("chunked", [True, False])
def test_ltr_chunked_candidates_span_once_a_loop(substrate, monkeypatch,
                                                 chunked):
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.pipeline import ltr

    g, _ = substrate
    if chunked:
        monkeypatch.setattr(ltr, "LTR_CHUNK_BP", CAP)
    out = {}
    lines, counters = _record(lambda: out.setdefault(
        "pairs", ltr.ltr_pair_candidates(g, PipelineConfig())))
    n = counters.get("ltr.candidates.chunks", 0)
    spans = _starts(lines, "ltr.chunked_candidates")
    assert (n, len(spans)) == ((3, 1) if chunked else (0, 0))
    assert len(out["pairs"]) > 0


@pytest.fixture(scope="module")
def join_run(substrate):
    """Two joins (the candidates split into two similarity waves), each
    in 3 chunks of Lp / 2."""
    from hite_tpu_torch.config import AlignConfig
    from hite_tpu_torch.pipeline.copies import CopyFinder, GenomeIndex

    g, cands = substrate
    finder = CopyFinder(GenomeIndex(g, AlignConfig()))
    finder.max_libjoin_bp = g.device_flat_padded()[0].shape[0] // 2
    out = {}
    lines, counters = _record(lambda: out.setdefault(
        "hits", finder.find_copies(cands, min_coverage=0.9,
                                   max_copies=100)))
    return lines, counters, out["hits"]


def test_copy_join_spans_once_a_chunk(join_run):
    lines, counters, hits = join_run
    assert counters["copies.join.chunks"] == 3 * counters[
        "copies.join_items"] == 6
    # each chunk: its one pairing attempt (no quota retry at this size),
    # then the scan, then the chaining
    seq = [n for n in _starts(lines) if n.startswith("copies.join_")]
    assert seq == ["copies.join_pairs", "copies.join_scan",
                   "copies.join_chain"] * 6
    # each candidate finds its family's 6 copies once, across the seams
    assert [len(h) for h in hits] == [6] * 6


def test_copy_join_items_count_only_chunked_joins(substrate):
    """The indexed join (a genome under the cap, as the library's own
    joins are) opens the copy join's spans and counts no join item, so
    `copies.join.chunks / copies.join_items` stays chunks a join."""
    from hite_tpu_torch.config import AlignConfig
    from hite_tpu_torch.pipeline.copies import CopyFinder, GenomeIndex

    g, cands = substrate
    finder = CopyFinder(GenomeIndex(g, AlignConfig()))
    lines, counters = _record(lambda: finder.find_copies(cands[:2]))
    assert "copies.join_items" not in counters
    assert "copies.join.chunks" not in counters
    assert _starts(lines, "copies.join_scan") == ["copies.join_scan"]


@pytest.mark.parametrize("name", NEW_SPANS)
def test_new_spans_fall_under_no_layer(name):
    assert not _layer_matched(name)
    assert not name.endswith((".copies", ".alt_copies", ".ba_fetch"))
