"""The one traffic generator: a planted genome drawn from `--seed`.

A traffic file (`traffic/<name>.json`) gives the composition per scale
unit (8 Mbp of genome): the families of each class (`per_scale`, rounded
once multiplied by the configuration's scale), their full-length and
partial copy counts, lengths, divergence and target-site duplications, and
the hard cases.  The traffic's `content_seed` draws the bases (each
family's sequence, each copy's substitutions, cut and TSD, and the
background) and the places in the background where copies are inserted,
at least `min_gap_bp` apart.  `--seed` draws only the order in which the
copies fill those places.  So every seed gives the same sequences and the
same gaps between copies in another arrangement, and asks the program for
the same work.

The families follow the bench substrate of the repository's
`scripts/pan_run.py:build_bench_genome` (TIR: terminal + interior +
reverse-complemented terminal; Helitron: the bench head and tail on an
A|T host site; SINE and LINE: interior + polyA; LTR: TG..CA terminals
around an interior); a copy is inserted with its flanks rather than
written over the background.  A cycle entry's keys override its class's.
A partial copy (`partial` a family) keeps a share of the element drawn
from `partial_share`: a LINE or SINE its 3' end (5' truncated, with its
TSD), a TIR element one end or the other in turn, an LTR element one
terminal with its TSD (a solo LTR).

`build(length, scale, traffic, seed)` returns (codes uint8 [length],
truth).  The truth is what the plain reference judges the program
against:

- `spans`: every planted span (start, end, class, family), the
  annotation's gold standard;
- `boundaries`: every planted end in genome coordinates, with the inner
  ends of LTR copies (terminal | interior), of nested and of tandem
  elements;
- `full_copies`: (start, end, family) of every full-length copy, tandem
  units and nested inner elements included;
- `families`: {name: {"class", "seq", "bounds"}}, `bounds` the family's
  own ends in its coordinates (LTR terminals and tandem periods too).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _LUT[ord(_c)] = _i


def encode(seq: str) -> np.ndarray:
    return _LUT[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def revcomp(codes: np.ndarray) -> np.ndarray:
    comp = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
    return comp[np.asarray(codes, dtype=np.uint8)][::-1]


class _Layout:
    """Collects the inserted units (an element with its flanks) drawn from
    the content generator, then lays them out on the background by the
    seed."""

    def __init__(self, rng):
        self.rng = rng
        self.units: List[dict] = []

    def plant(self, te: np.ndarray, n: int, mut: float, *, tsd: int = 0,
              host_site: bool = False, spans=None, bounds=(), full=()):
        """n copies of `te`, each with its own substitutions and TSD;
        `spans` lists (offset, length, class, family) parts, `bounds` the
        inner ends and `full` the (offset, length, family) full-length
        copies inside one copy, all in the element's coordinates."""
        rng = self.rng
        for _ in range(n):
            copy = te.copy()
            muts = rng.random(len(copy)) < mut
            copy[muts] = (copy[muts] + rng.integers(1, 4, int(muts.sum()),
                                                    dtype=np.uint8)) % 4
            left = right = np.zeros(0, np.uint8)
            if tsd:
                left = right = rng.integers(0, 4, tsd, dtype=np.uint8)
            if host_site:
                left, right = np.zeros(1, np.uint8), np.full(1, 3, np.uint8)
            self.units.append({
                "codes": np.concatenate([left, copy, right]),
                "at": len(left), "len": len(te), "spans": spans,
                "bounds": bounds, "full": full})

    def lay_out(self, length: int, bg_rng, order_rng, gap: int):
        """The genome: a background of the content generator's bases with
        every unit inserted at the content generator's places, at least
        `gap` bp apart, in an order drawn from the seed; returns (codes,
        spans, bounds, full copies)."""
        units = self.units
        used = sum(len(u["codes"]) for u in units)
        bg = bg_rng.integers(0, 4, length - used, dtype=np.uint8)
        margin = 1000
        free = len(bg) - 2 * margin - gap * max(len(units) - 1, 0)
        if free < 0:
            raise ValueError("the traffic's elements do not fit the genome")
        cuts = np.sort(bg_rng.integers(0, free + 1, len(units)))
        cuts = cuts + margin + gap * np.arange(len(units))
        order = order_rng.permutation(len(units))
        pieces, spans, bounds, full = [], [], [], []
        pos = prev = 0
        for cut, ui in zip(cuts, order):
            u = units[ui]
            pieces.append(bg[prev:cut])
            pos += cut - prev
            prev = cut
            e0 = pos + u["at"]
            for off, ln, kl, nm in u["spans"]:
                spans.append((e0 + off, e0 + off + ln, kl, nm))
            bounds.extend([e0, e0 + u["len"]] + [e0 + b for b in u["bounds"]])
            full.extend((e0 + off, e0 + off + ln, nm)
                        for off, ln, nm in u["full"])
            pieces.append(u["codes"])
            pos += len(u["codes"])
        pieces.append(bg[prev:])
        codes = np.concatenate(pieces)
        order_spans = sorted(range(len(spans)), key=lambda i: spans[i][0])
        return (codes, [spans[i] for i in order_spans], bounds,
                sorted(full))


def _family_seq(rng, unit: dict) -> Tuple[np.ndarray, list]:
    """(sequence, inner bounds) of one family; `unit` is its class's spec
    with its cycle entry laid over it."""
    klass = unit["class"]
    if klass == "TIR":
        k = unit["terminal_bp"]
        t = rng.integers(0, 4, k, dtype=np.uint8)
        while t[0] == 3 and t[1] == 2:
            t = rng.integers(0, 4, k, dtype=np.uint8)
        return np.concatenate([
            t, rng.integers(0, 4, unit["interior_bp"], dtype=np.uint8),
            (3 - t)[::-1]]), []
    if klass == "Helitron":
        return np.concatenate([
            encode(unit["head"]),
            rng.integers(0, 4, unit["interior_bp"], dtype=np.uint8),
            encode(unit["tail"])]), []
    if klass in ("SINE", "LINE"):
        return np.concatenate([
            rng.integers(0, 4, unit["interior_bp"], dtype=np.uint8),
            np.zeros(unit["polya_bp"], np.uint8)]), []
    if klass == "LTR":
        lt = unit["ltr_bp"]
        t = rng.integers(0, 4, lt, dtype=np.uint8)
        t[0], t[1], t[-2], t[-1] = 3, 2, 1, 0
        te = np.concatenate([
            t, rng.integers(0, 4, unit["interior_bp"], dtype=np.uint8), t])
        return te, [lt, len(te) - lt]
    raise ValueError(f"unknown class {klass!r}")


def _partial(rng, unit: dict, te: np.ndarray, inner: list, k: int):
    """(sequence, TSD bp) of the k-th partial copy of a family."""
    klass = unit["class"]
    if klass == "LTR":
        return te[: inner[0]], unit.get("tsd_bp", 0)
    lo, hi = unit["partial_share"]
    n = max(int(len(te) * rng.uniform(lo, hi)), 1)
    if klass in ("SINE", "LINE"):
        return te[-n:], unit.get("tsd_bp", 0)
    if klass == "TIR":
        return (te[:n] if k % 2 == 0 else te[-n:]), 0
    raise ValueError(f"no partial copies of class {klass!r}")


def build(length: int, scale: int, traffic: dict, seed: int):
    """(codes, truth) of the planted genome; see the module doc."""
    rng = np.random.default_rng(traffic["content_seed"])
    pl = _Layout(rng)
    families: Dict[str, dict] = {}
    by_class: Dict[str, list] = {}
    for spec in traffic["families"]:
        klass = spec["class"]
        for f in range(int(np.floor(spec["per_scale"] * scale + 0.5))):
            unit = {**spec, **spec["cycle"][f % len(spec["cycle"])]}
            te, inner = _family_seq(rng, unit)
            name = f"{klass}_{f}"
            families[name] = {"class": klass, "seq": te,
                              "bounds": sorted({0, len(te), *inner})}
            by_class.setdefault(klass, []).append((name, te, inner, unit))
            mut = unit.get("mutation", 0.02)
            pl.plant(te, unit["copies"], mut,
                     tsd=unit.get("tsd_bp", 0),
                     host_site=unit.get("host_site", False),
                     spans=((0, len(te), klass, name),), bounds=inner,
                     full=((0, len(te), name),))
            for k in range(unit.get("partial", 0)):
                part, tsd = _partial(rng, unit, te, inner, k)
                pl.plant(part, 1, mut, tsd=tsd,
                         spans=((0, len(part), klass, name),))
    hard = traffic.get("hard") or {}
    tirs = by_class.get("TIR", [])
    ltrs = by_class.get("LTR", [])
    tir_mut = _mutation(traffic, "TIR")
    ltr_mut = _mutation(traffic, "LTR")
    ltr_tsd = _tsd(traffic, "LTR")
    if "truncated_tir" in hard:
        h = hard["truncated_tir"]
        for f, (name, te, _i, _u) in enumerate(tirs):
            cut = int(len(te) * h["cut_shares"][f % len(h["cut_shares"])])
            for part in (te[cut:], te[:-cut]):
                pl.plant(part, h["copies"], tir_mut,
                         spans=((0, len(part), "TIR", name),))
    if "solo_ltr" in hard:
        for name, te, inner, _u in ltrs:
            t = te[: inner[0]]
            pl.plant(t, hard["solo_ltr"]["copies"], ltr_mut, tsd=ltr_tsd,
                     spans=((0, len(t), "LTR", name),))
    if "nested_tir_in_ltr" in hard and tirs:
        h = hard["nested_tir_in_ltr"]
        for f, (name, te, inner, _u) in enumerate(ltrs):
            iname, ite = tirs[f % len(tirs)][:2]
            mid = inner[0] + h["at_interior_bp"]
            comp = np.concatenate([te[:mid], ite, te[mid:]])
            n_in = len(ite)
            pl.plant(comp, h["copies"], ltr_mut, tsd=ltr_tsd,
                     spans=((0, mid, "LTR", name), (mid, n_in, "TIR", iname),
                            (mid + n_in, len(te) - mid, "LTR", name)),
                     bounds=(inner[0], mid, mid + n_in,
                             len(comp) - inner[0]),
                     full=((mid, n_in, iname),))
    if "tandem_tir" in hard:
        h = hard["tandem_tir"]
        for f, (name, te, _i, _u) in enumerate(tirs):
            units = h["units"][f % len(h["units"])]
            arr = np.concatenate([te] * units)
            L = len(te)
            pl.plant(arr, h["arrays"], tir_mut, tsd=_tsd(traffic, "TIR"),
                     spans=((0, len(arr), "TIR", name),),
                     bounds=tuple(k * L for k in range(1, units)),
                     full=tuple((k * L, L, name) for k in range(units)))
            fam = families[name]
            fam["bounds"] = sorted(set(fam["bounds"])
                                   | {k * L for k in range(units + 1)})
    codes, spans, bounds, full = pl.lay_out(
        length, rng, np.random.default_rng(seed),
        traffic.get("min_gap_bp", 200))
    truth = {
        "spans": spans,
        "boundaries": np.unique(np.array(bounds, np.int64)),
        "full_copies": full,
        "families": families,
    }
    return codes, truth


def _mutation(traffic: dict, klass: str) -> float:
    return next((s.get("mutation", 0.02) for s in traffic["families"]
                 if s["class"] == klass), 0.02)


def _tsd(traffic: dict, klass: str) -> int:
    return next((s.get("tsd_bp", 0) for s in traffic["families"]
                 if s["class"] == klass), 0)
