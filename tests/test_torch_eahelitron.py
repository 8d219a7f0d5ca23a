"""hite_tpu_torch's EAHelitron scanner and gate against hite_tpu's.

`hel3_scan` at every fuzzy level and `tc5_scan` on random rows, planted
structures and N-heavy rows (boolean planes, equal exactly);
`select_pairs` on random hit planes; `eahelitron_gate` and
`gate_helitron(use_eahelitron=True)` on a small genome with Helitron
structures planted on both strands, which must both contribute.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hite_tpu.ops import eahelitron as jea
from hite_tpu_torch.ops import eahelitron as tea
from test_torch_tir_path import compile_cache  # noqa: F401  (autouse)

torch.set_num_threads(2)

STEM, LOOP, RC = "GCGCAG", "TAT", "CTGCGC"
# 5' ATC, a body, then the 3' structure: lead, hairpin, gap, CTAGT
HEL = ("ATC" + "TGCAGGTTACGATTGCCTAGCGGATCGATT" * 6
       + "ACGTACGTAC" + STEM + LOOP + RC + "ACGT" + "CTAGT")


def _codes(s):
    return np.array(["ACGTN".index(c) for c in s], np.uint8)


def _rows():
    """Random rows, rows with planted 3' structures (each CTRRT variant
    the levels tell apart), and N-heavy rows."""
    rng = np.random.default_rng(5)
    mat = rng.integers(0, 4, (24, 480)).astype(np.uint8)
    for r, tail in enumerate(("CTAGT", "CTGGT", "CTAAT", "CTGAT", "CTAGC",
                              "CTGAC", "CTAGA", "CTCGT")):
        core = _codes("ACGTACGTAC" + STEM + LOOP + RC + "ACGT" + tail)
        for p in (40, 200, 480 - len(core) - 4):
            mat[8 + r, p: p + len(core)] = core
    mat[16:20][rng.random((4, 480)) < 0.3] = 4
    mat[20, 100:140] = 4
    mat[21] = 4
    mat[22, ::3] = 4
    return mat


@pytest.mark.parametrize("level", range(6))
def test_hel3_scan(level):
    mat = _rows()
    want = np.asarray(jea.hel3_scan(jnp.asarray(mat), level))
    got = tea.hel3_scan(torch.from_numpy(mat), level).numpy()
    assert np.array_equal(got, want)
    assert want[8:16].any(), "no planted structure found"


def test_tc5_scan():
    mat = _rows()
    want = np.asarray(jea.tc5_scan(jnp.asarray(mat)))
    got = tea.tc5_scan(torch.from_numpy(mat)).numpy()
    assert np.array_equal(got, want) and want.any()


def test_tables_equal():
    assert tea.STEM_PATTERNS == jea.STEM_PATTERNS
    assert tea.CTRRT_LEVELS == jea.CTRRT_LEVELS
    assert (tea.MAX_LOOP, tea.GAP_MIN, tea.GAP_MAX, tea.LEAD, tea.TRAIL) == \
        (jea.MAX_LOOP, jea.GAP_MIN, jea.GAP_MAX, jea.LEAD, jea.TRAIL)


@pytest.mark.parametrize("seed", range(4))
def test_select_pairs(seed):
    """Dense random planes with many equal distances, so that the tie
    rules (min distance, then the longer span) decide."""
    rng = np.random.default_rng(seed)
    B, L = 16, 900
    hel3 = rng.random((B, L)) < 0.02
    tc5 = rng.random((B, L)) < 0.03
    lens = rng.integers(100, L + 1, B)
    raw_s = rng.integers(0, 300, B)
    raw_e = raw_s + rng.integers(80, 600, B)
    for up, ml in ((20_000, 80), (150, 40), (400, 200)):
        want = jea.select_pairs(hel3, tc5, lens, raw_s, raw_e, upstream=up,
                                min_len=ml)
        got = tea.select_pairs(hel3, tc5, lens, raw_s, raw_e, upstream=up,
                               min_len=ml)
        assert got == want
    assert any(p is not None for p in want)


def _genome_both_strands():
    """20 kbp with the Helitron planted 3 times forward and 3 times
    reverse-complemented; returns (codes, spans, strands)."""
    rng = np.random.default_rng(3)
    bg = rng.integers(0, 4, 20_000).astype(np.uint8)
    te = _codes(HEL)
    spans, strands = [], []
    for k, pos in enumerate(range(1_500, 19_000, 3_000)):
        copy = te if k % 2 == 0 else (3 - te)[::-1]
        bg[pos: pos + len(copy)] = copy
        spans.append((pos, pos + len(copy)))
        strands.append(k % 2)
    return bg, np.array(spans, np.int64), strands


def _cfg(port, **kw):
    if port:
        from hite_tpu_torch.config import PipelineConfig
    else:
        from hite_tpu.config import PipelineConfig
    cfg = PipelineConfig()
    return cfg.replace(helitron=dataclasses.replace(cfg.helitron, **kw))


def _genome(port, bg):
    if port:
        from hite_tpu_torch.genome import Genome
        return Genome.from_dict({"chr1": bg.copy()}, device="cpu")
    from hite_tpu.genome import Genome
    return Genome.from_dict({"chr1": bg.copy()})


@pytest.mark.parametrize("level", [3, 5])
def test_eahelitron_gate_both_strands(level):
    from hite_tpu.pipeline.helitron import eahelitron_gate as jgate
    from hite_tpu_torch.pipeline.helitron import eahelitron_gate as tgate

    bg, spans, strands = _genome_both_strands()
    # raw candidates a little off the planted spans, one with a 10 bp N run
    iv = spans + np.array([[-30, 20], [15, -10], [-5, 40], [25, 25],
                           [-40, -15], [0, 0]])
    bg = bg.copy()
    bg[iv[5, 0] + 100: iv[5, 0] + 112] = 4
    want = jgate(_genome(False, bg), iv, _cfg(False, ea_fuzzy_level=level))
    got = tgate(_genome(True, bg), iv, _cfg(True, ea_fuzzy_level=level))
    assert np.array_equal(got, want)
    # each strand's planted copies give a span ending on its structure
    # (forward) or starting on the reverse complement of it (reverse)
    hit = [any(abs(s - a) <= 40 and abs(e - b) <= 40 for s, e in got)
           for a, b in spans[:5]]
    assert any(h for h, st in zip(hit, strands) if st == 0), got
    assert any(h for h, st in zip(hit, strands) if st == 1), got


def test_gate_helitron_with_eahelitron():
    from hite_tpu.pipeline.helitron import gate_helitron as jgate
    from hite_tpu_torch.pipeline.helitron import gate_helitron as tgate

    bg, spans, _strands = _genome_both_strands()
    iv = np.concatenate([spans + np.array([-20, 30]),
                         np.array([[700, 1_300], [10_000, 10_900]])])
    want = jgate(_genome(False, bg), iv, _cfg(False, use_eahelitron=True))
    got = tgate(_genome(True, bg), iv, _cfg(True, use_eahelitron=True))
    assert np.array_equal(got, want)
    off = tgate(_genome(True, bg), iv, _cfg(True, use_eahelitron=False))
    assert len(got) > len(off), "the EAHelitron gate added nothing"
