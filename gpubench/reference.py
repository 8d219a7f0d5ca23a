"""The plain reference that decides `correct`, in NumPy alone.

It imports nothing of the program.  From the generator's truth (what was
planted, where, with which ends) it works out the answer each layer owes
and judges the program's outputs of the timed path against it:

- discovery: every full-length planted copy lies under the coarse
  candidate intervals (`candidate_miss`, the share of copies that do not,
  each counted when less than half of it is covered);
- the copy join: the accepted families' copy counts against the copies
  planted of their families (`copy_miss` = 1 - found / planted, summed
  over the families accepted with two copies or more; the low-copy rescue
  keeps single copies by their structure, not by their copies).  A pass
  whose modules accept no planted family with two copies or more leaves
  the copy join nothing to judge, and it reads 0 there (`copies_owed` 0
  in `seen`): a run that loses families shows in `family_miss`, one that
  returns nothing in `candidate_miss` too;
- the boundary engines, the LTR stage and the library: every accepted
  element's ends, every intact LTR record's four ends and every library
  entry's ends, the entry placed on its planted family by shared 13-mers
  on one diagonal, lie on planted ends (`end_off_share`, the share of
  them whose farther end lies more than END_TOL_BP from a planted end;
  the largest distance is reported beside it).  Single copies kept by the low-copy rescue, and their
  library entries, are left out (a partial copy is kept by its structure
  at its own ends); an element or entry that lies on no planted copy or
  family is counted as a stray;
- the annotation: the base-level F1 of the annotated spans against the
  planted spans of the families that the library holds, a span annotated
  on no planted span counted false (`annot_f1_gap` = 1 - F1);
- the families: the share of planted families with two full-length copies
  or more, of the classes the cell judges, that the library does not
  carry (`family_miss`), so that a stage that drops families, or a whole
  class, is caught although every other number judges only the families
  found.  A family is carried when its entries cover half of it or more.

`controls(codes, truth)` gives the reference's own answers with one stated
guarantee broken each: `coarse_ends` (every end at 100 bp resolution, as
a run without boundary adjustment would report it), `half_copies` (every
second planted copy of each family left out) and `half_families` (every
second planted family left out altogether).  `judge` compares the numbers
with a cell's limits.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from gpubench.genome_gen import encode, revcomp

K = 13
NUMBERS = ("candidate_miss", "copy_miss", "end_off_share", "annot_f1_gap",
           "family_miss")
END_TOL_BP = 50     # MSAConfig.flanking_len: the flank the boundary engine reads
CONTROL_RES_BP = 100
MSA_ROW_CAP = 100     # the configuration's copy cap (MSAConfig.max_copies)
OWED_FULL_COPIES = 2  # a family is owed from two full-length copies on


@dataclass
class Outputs:
    """What one pass of the program produced, in genome coordinates."""

    candidates: np.ndarray                       # int64 [C, 2]
    accepted: np.ndarray                         # int64 [N, 2]
    copy_counts: List[int]                       # aligned with accepted
    ltr: np.ndarray                              # int64 [M, 4]
    library: Dict[str, np.ndarray] = field(default_factory=dict)
    annotation: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), np.int64))


# ----------------------------------------------------------- file readers
def parse_fasta(text: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    name, parts = None, []
    for line in text.splitlines():
        if line.startswith(">"):
            if name is not None:
                out[name] = encode("".join(parts).upper())
            name, parts = line[1:].split()[0] if line[1:].split() else "", []
        elif line.strip():
            parts.append(line.strip())
    if name is not None:
        out[name] = encode("".join(parts).upper())
    return out


def parse_gff(text: str, contig_starts: Dict[str, int]) -> np.ndarray:
    """[start, end) genome spans of a GFF3's features (1-based,
    inclusive columns 4 and 5)."""
    spans = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        col = line.split("\t")
        off = contig_starts[col[0]]
        spans.append((off + int(col[3]) - 1, off + int(col[4])))
    return np.array(spans, np.int64).reshape(-1, 2)


def load_candidates(blob: Optional[bytes]) -> np.ndarray:
    """The coarse stage's candidate intervals from its snapshot."""
    if not blob:
        return np.zeros((0, 2), np.int64)
    return np.asarray(pickle.loads(blob), np.int64).reshape(-1, 2)


# --------------------------------------------------------------- intervals
def merge(iv: np.ndarray) -> np.ndarray:
    iv = np.asarray(iv, np.int64).reshape(-1, 2)
    iv = iv[iv[:, 1] > iv[:, 0]]
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out, np.int64)


def covered(query: np.ndarray, merged: np.ndarray) -> np.ndarray:
    """bp of each query interval covered by the merged intervals."""
    out = np.zeros(len(query), np.int64)
    if not len(merged):
        return out
    for i, (s, e) in enumerate(query):
        lo = np.searchsorted(merged[:, 1], s, side="right")
        hi = np.searchsorted(merged[:, 0], e, side="left")
        seg = merged[lo:hi]
        if len(seg):
            out[i] = int((np.minimum(seg[:, 1], e)
                          - np.maximum(seg[:, 0], s)).clip(0).sum())
    return out


def nearest(x: np.ndarray, sorted_b: np.ndarray) -> np.ndarray:
    """|x - the nearest value of sorted_b|, elementwise."""
    x = np.asarray(x, np.int64)
    i = np.searchsorted(sorted_b, x)
    lo = sorted_b[np.clip(i - 1, 0, len(sorted_b) - 1)]
    hi = sorted_b[np.clip(i, 0, len(sorted_b) - 1)]
    return np.minimum(np.abs(x - lo), np.abs(x - hi))


# ----------------------------------------------------------- the reference
class Reference:
    """The truth of one planted genome, indexed for the comparisons.
    `family_classes` names the classes whose families `family_miss`
    judges (None: every class); the others are counted in `seen`."""

    def __init__(self, codes: np.ndarray, truth: dict,
                 family_classes: Optional[List[str]] = None):
        self.codes = codes
        self.family_classes = family_classes
        self.truth = truth
        self.bounds = truth["boundaries"]
        sp = truth["spans"]
        self.spans = np.array([(s, e) for s, e, _k, _n in sp],
                              np.int64).reshape(-1, 2)
        self.span_fam = [n for _s, _e, _k, n in sp]
        self.gold = merge(self.spans)
        fc = truth["full_copies"]
        self.full = np.array([(s, e) for s, e, _n in fc],
                             np.int64).reshape(-1, 2)
        self.full_fam = [n for _s, _e, n in fc]
        self.n_full: Dict[str, int] = {}
        for n in self.full_fam:
            self.n_full[n] = self.n_full.get(n, 0) + 1
        order = np.argsort(self.spans[:, 0], kind="stable")
        self.span_order = order
        self.span_starts = self.spans[order, 0]
        self._index_families()
        self._cache: Dict[int, float] = {}

    # -- library entries onto families
    def _index_families(self) -> None:
        names = list(self.truth["families"])
        self.fam_names = names
        keys, fid, fpos = [], [], []
        for i, n in enumerate(names):
            k, p = kmers(self.truth["families"][n]["seq"])
            keys.append(k)
            fid.append(np.full(len(k), i, np.int64))
            fpos.append(p)
        keys = np.concatenate(keys) if keys else np.zeros(0, np.int64)
        order = np.argsort(keys, kind="stable")
        self.fk = keys[order]
        self.fid = np.concatenate(fid)[order] if fid else keys
        self.fpos = np.concatenate(fpos)[order] if fpos else keys

    def place(self, seq: np.ndarray):
        """(family index, strand, diagonal, identity) of an entry's best
        placement on a planted family, or None."""
        best = None
        for strand, s in ((0, seq), (1, revcomp(seq))):
            q, qp = kmers(s)
            if not len(q) or not len(self.fk):
                continue
            lo = np.searchsorted(self.fk, q, side="left")
            hi = np.searchsorted(self.fk, q, side="right")
            cnt = hi - lo
            if not cnt.sum():
                continue
            rep = np.repeat(np.arange(len(q)), cnt)
            idx = np.repeat(lo - np.cumsum(np.r_[0, cnt[:-1]]), cnt) \
                + np.arange(int(cnt.sum()))
            diag = self.fpos[idx] - qp[rep]
            key = self.fid[idx] * (1 << 32) + (diag + (1 << 31))
            u, c = np.unique(key, return_counts=True)
            j = int(np.argmax(c))
            if best is None or c[j] > best[0]:
                best = (int(c[j]), int(u[j] >> 32),
                        int((u[j] & 0xFFFFFFFF) - (1 << 31)), strand, s)
        if best is None:
            return None
        _votes, f, d, strand, s = best
        fam = self.truth["families"][self.fam_names[f]]["seq"]
        i0, i1 = max(0, -d), min(len(s), len(fam) - d)
        if i1 - i0 < max(K, len(s) // 2):
            return None
        ident = float(np.mean(s[i0:i1] == fam[i0 + d:i1 + d]))
        if ident < 0.8:
            return None
        return f, strand, d, ident

    def entry_offset(self, seq: np.ndarray
                     ) -> Optional[Tuple[str, int, Tuple[int, int]]]:
        """(family, distance in bp of the entry's ends from the family's
        nearest planted ends, the span of the family the entry covers),
        or None where it lies on no family."""
        key = hash(seq.tobytes())
        if key not in self._cache:
            p = self.place(seq)
            if p is None:
                self._cache[key] = None
            else:
                f, _strand, d, _ident = p
                name = self.fam_names[f]
                fam = self.truth["families"][name]
                b = np.array(fam["bounds"], np.int64)
                self._cache[key] = (name, int(max(
                    nearest([d], b)[0], nearest([d + len(seq)], b)[0])),
                    (max(d, 0), min(d + len(seq), len(fam["seq"]))))
        return self._cache[key]

    # -- genome intervals onto planted spans
    def family_of(self, s: int, e: int) -> Optional[str]:
        """The family of the planted span that overlaps [s, e) most, when
        it covers at least half of it."""
        i = np.searchsorted(self.span_starts, e)
        best, best_ov = None, 0
        for j in range(max(0, i - 8), i):
            k = self.span_order[j]
            ov = min(e, self.spans[k, 1]) - max(s, self.spans[k, 0])
            if ov > best_ov:
                best, best_ov = self.span_fam[k], ov
        return best if best_ov * 2 >= (e - s) else None

    def interval_offset(self, coords: np.ndarray) -> int:
        """Largest distance of an element's coordinates from planted
        ends."""
        return int(nearest(coords, self.bounds).max())

    # -- the numbers
    def numbers(self, out: Outputs) -> Dict[str, float]:
        """The compared numbers of one pass (NUMBERS); what the
        comparison counts and does not judge is left in `self.seen`."""
        cand = merge(out.candidates)
        cov = covered(self.full, cand)
        lens = self.full[:, 1] - self.full[:, 0]
        candidate_miss = (float(np.mean(cov * 2 < lens)) if len(lens)
                          else 0.0)

        got = want = 0
        offs, strays, rescued = [], 0, set()
        for (s, e), n in zip(out.accepted, out.copy_counts):
            fam = self.family_of(int(s), int(e))
            if n < 2:
                # a single copy the low-copy rescue kept by its structure
                rescued.add(self.codes[s:e].tobytes())
                rescued.add(revcomp(self.codes[s:e]).tobytes())
                strays += fam is None
                continue
            if fam is None:
                strays += 1
                continue
            offs.append(self.interval_offset(np.array([s, e], np.int64)))
            w = min(self.n_full.get(fam, 0), MSA_ROW_CAP)
            got += min(int(n), w)
            want += w
        for rec in out.ltr:
            if self.family_of(int(rec[0]), int(rec[-1])) is None:
                strays += 1
            else:
                offs.append(self.interval_offset(np.asarray(rec, np.int64)))
        spans_of: Dict[str, list] = {}
        for seq in out.library.values():
            placed = self.entry_offset(seq)
            if placed is None:
                strays += 1
                continue
            spans_of.setdefault(placed[0], []).append(placed[2])
            if seq.tobytes() not in rescued:
                offs.append(placed[1])
        # a family is found when its entries cover half of it or more: a
        # fragment that the low-copy rescue kept does not stand for it
        fams = self.truth["families"]
        found = set()
        for n, iv in spans_of.items():
            m = merge(np.array(iv, np.int64))
            if 2 * int((m[:, 1] - m[:, 0]).sum()) >= len(fams[n]["seq"]):
                found.add(n)

        # the annotation of the families the library holds: their planted
        # spans are owed; what lies on no planted span is false
        test = merge(out.annotation)
        owed = merge(self.spans[[f in found for f in self.span_fam]]) \
            if found else np.zeros((0, 2), np.int64)
        tp = int(covered(owed, test).sum()) if len(test) else 0
        owed_bp = int((owed[:, 1] - owed[:, 0]).sum()) if len(owed) else 0
        test_bp = int((test[:, 1] - test[:, 0]).sum()) if len(test) else 0
        on_te = int(covered(self.gold, test).sum()) if len(test) else 0
        fp, fn = test_bp - on_te, owed_bp - tp
        f1 = 2 * tp / (2 * tp + fp + fn) if (2 * tp + fp + fn) else 0.0

        owed_fams = [n for n in self.fam_names
                     if self.n_full.get(n, 0) >= OWED_FULL_COPIES]
        by_class: Dict[str, List[int]] = {}
        for n in owed_fams:
            c = by_class.setdefault(fams[n]["class"], [0, 0])
            c[0] += n in found
            c[1] += 1
        judged = [n for n in owed_fams if self.family_classes is None
                  or fams[n]["class"] in self.family_classes]
        missed = [n for n in judged if n not in found]
        self.seen = {"end_err_max_bp": max(offs, default=0),
                     "strays": strays, "rescued": len(rescued) // 2,
                     "families_found": {k: f"{a}/{b}"
                                        for k, (a, b) in by_class.items()},
                     "families_missed": [n for n in owed_fams
                                         if n not in found],
                     "copies_owed": want}
        return {"candidate_miss": candidate_miss,
                "copy_miss": 1.0 - got / want if want else 0.0,
                "end_off_share": (float(np.mean(np.array(offs) > END_TOL_BP))
                                  if offs else 1.0),
                "annot_f1_gap": 1.0 - f1,
                "family_miss": (len(missed) / len(judged)
                                if judged else 0.0)}

    # -- the controls: the reference's own answers, one guarantee broken
    def controls(self) -> Dict[str, Outputs]:
        return {"coarse_ends": self._answers(res=CONTROL_RES_BP),
                "half_copies": self._answers(keep_every=2),
                "half_families": self._answers(
                    families=set(self.fam_names[::2]))}

    def answers(self) -> Outputs:
        """The reference's own answers, every guarantee kept."""
        return self._answers()

    def _answers(self, res: int = 1, keep_every: int = 1,
                 families: Optional[set] = None) -> Outputs:
        fams = self.truth["families"]
        keep = set(self.fam_names) if families is None else families

        def rnd(iv):
            iv = np.asarray(iv, np.int64).reshape(-1, 2).copy()
            iv[:, 0] = iv[:, 0] // res * res
            iv[:, 1] = -((-iv[:, 1]) // res) * res
            return iv

        seen: Dict[str, int] = {}
        keep_full = []
        for (s, e), n in zip(self.full, self.full_fam):
            seen[n] = seen.get(n, 0) + 1
            if (seen[n] - 1) % keep_every == 0 and n in keep:
                keep_full.append((s, e, n))
        first: Dict[str, tuple] = {}
        for s, e, n in keep_full:
            first.setdefault(n, (s, e))
        accepted, counts, ltr, library = [], [], [], {}
        for n, (s, e) in first.items():
            f = fams[n]
            (rs, re_), = rnd([(s, e)])
            if f["class"] == "LTR":
                lt = f["bounds"][1]
                ltr.append((s, s + lt, e - lt, e))
                library[f"{n}-LTR"] = self.codes[rs: s + lt]
                library[f"{n}-INT"] = self.codes[s + lt: e - lt]
            else:
                accepted.append((s, e))
                counts.append(-(-self.n_full[n] // keep_every))
                library[n] = self.codes[rs:re_]
        seen = {}
        spans = []
        for (s, e), n in zip(self.spans, self.span_fam):
            seen[n] = seen.get(n, 0) + 1
            if (seen[n] - 1) % keep_every == 0 and n in keep:
                spans.append((s, e))
        ltr_arr = np.array(ltr, np.int64).reshape(-1, 4)
        if res > 1 and len(ltr_arr):
            ltr_arr[:, 0] = ltr_arr[:, 0] // res * res
            ltr_arr[:, 3] = -((-ltr_arr[:, 3]) // res) * res
        return Outputs(
            candidates=rnd([(s, e) for s, e, _n in keep_full]),
            accepted=rnd(accepted), copy_counts=counts, ltr=ltr_arr,
            library=library, annotation=rnd(spans))


def kmers(seq: np.ndarray):
    """(int64 codes, positions) of the seq's K-mers without an N."""
    seq = np.asarray(seq, np.int64)
    n = len(seq) - K + 1
    if n <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    bad = np.convolve((seq > 3).astype(np.int64), np.ones(K, np.int64),
                      "valid") > 0
    code = np.zeros(n, np.int64)
    for j in range(K):
        code = code * 4 + np.minimum(seq[j: j + n], 3)
    pos = np.arange(n, dtype=np.int64)
    return code[~bad], pos[~bad]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is within its limit."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)
