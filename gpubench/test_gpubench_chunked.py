"""The 100 Mbp cell's yardstick on the CPU: the generator at the cell's
scale, and the comparison that decides `correct` on a run whose three
chunked paths (the coarse self-join, the LTR candidates and the copy
join) are all forced on the mini cell of `conftest.py`: a sound run is
correct, and a run whose chunked self-join drops its last chunk is not."""

from __future__ import annotations

import json
import os

import pytest

from gpubench import genome_gen, harness
from gpubench.conftest import MINI_CELL, MINI_CONFIG, ROOT
from gpubench.test_gpubench_units import _traffic

CAP = 1 << 17      # half the mini genome's 2^18 padding: 3 chunks a path


def test_generator_at_the_100_mbp_cells_scale():
    with open(os.path.join(ROOT, "gpubench", "configs",
                           "hite-100mbp.json")) as fh:
        config = json.load(fh)
    assert (config["genome_bp"], config["scale"]) == (100_000_000, 12.5)
    _codes, truth = genome_gen.build(config["genome_bp"], config["scale"],
                                     _traffic("dmel"), 2**31 + 9)
    klasses = [f["class"] for f in truth["families"].values()]
    assert [klasses.count(k) for k in ("LTR", "LINE", "TIR")] == [42, 23, 14]
    assert len(truth["spans"]) == 1340
    assert len(truth["full_copies"]) == 453
    te_bp = sum(e - s for s, e, _k, _n in truth["spans"])
    assert 0.03 < te_bp / 1e8 < 0.045


@pytest.fixture
def all_chunked(monkeypatch):
    """Every chunked path forced on the mini cell: its configuration's
    `max_selfjoin_bp` already chunks the self-join; the LTR candidates'
    cap and each copy finder's join cap are set to half its padding."""
    from hite_tpu_torch.pipeline import copies, ltr
    from hite_tpu_torch.utils import log

    assert MINI_CONFIG["coarse"]["max_selfjoin_bp"] == CAP
    monkeypatch.setattr(ltr, "LTR_CHUNK_BP", CAP)
    init = copies.CopyFinder.__init__

    def chunked_init(self, *a, **k):
        init(self, *a, **k)
        self.max_libjoin_bp = CAP

    monkeypatch.setattr(copies.CopyFinder, "__init__", chunked_init)
    return log.COUNTERS


def _run(root, capsys, seed=3_000_000_018):
    rc = harness.main(["--workload", MINI_CELL, "--seed", str(seed),
                       "--seconds", "0", "--trace", "0"],
                      root=root, device="cpu")
    assert rc == 0
    out = capsys.readouterr()
    path = next(json.loads(line[len("path: "):])
                for line in out.err.splitlines() if line.startswith("path: "))
    return json.loads(out.out.strip().splitlines()[-1]), path


def test_every_chunked_path_is_correct(mini_root, capsys, all_chunked):
    res, path = _run(mini_root, capsys)
    assert path["coarse.selfjoin.chunks"] == 3
    assert path["ltr.candidates.chunks"] == 3
    assert path["copies.join.chunks"] == 3 * path["copies.join_items"] > 0
    assert res["correct"] is True and res["failed"] == 0


def test_the_chunked_selfjoins_last_chunk_dropped_is_caught(
        mini_root, capsys, all_chunked, monkeypatch):
    from hite_tpu_torch.pipeline import coarse

    grid = coarse._chunk_grid
    monkeypatch.setattr(coarse, "_chunk_grid",
                        lambda L, C, halo: grid(L, C, halo)[:-1])
    res, path = _run(mini_root, capsys)
    assert path["coarse.selfjoin.chunks"] == 2
    assert res["correct"] is False
