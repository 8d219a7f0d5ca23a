"""EAHelitron-equivalent Helitron structure scanner (counterpart of the
JAX package's `ops/eahelitron.py`).

Re-implements the motif semantics of the reference's optional EAHelitron
path (`bin/EAHelitron-master/EAHelitron`, a Perl regex engine; invoked by
HiTE as `EAHelitron -u 20000 -T "ATC" -r 3` from `Util.py:130-196` and
unioned with HelitronScanner candidates in
`module/judge_Helitron_transposons.py:39-54`, default-disabled there).

The structure searched, 5' -> 3':

    [5' motif]  ...  <=upstream bp  ...  [hairpin stem] [loop] [revcomp stem]
                                         [3-12bp] [CT R R T] [>=4bp]

* the hairpin stem is one of 16 degenerate S/W-class patterns (S=[GC],
  W=[AT], lengths 4-7) and its reverse complement must follow after a
  1-9bp loop containing at least one A/T within 4bp of each loop end;
* the 3' terminus is CTRRT at fuzzy level 3 (`CT[AG]{2}T`);
* 10bp of unambiguous sequence must precede the stem and 4 bases must
  follow the terminus;
* every 3' structure pairs with any 5' motif occurrence within
  `upstream` bp; HiTE keeps, per candidate, the pair whose ends lie
  closest to the raw candidate boundaries (`run_EAHelitron`,
  `Util.py:166-195`).

Every check is a static-shift elementwise compare over the [B, L] code
matrix on its device: palindrome compares are precomputed per
center-distance (`pal[m][i] = (c[i] == comp(c[i+m]))`), so each
(stem, loop) combination is an AND of shifted boolean planes; there are
no gathers and no data-dependent shapes.  The Perl engine reports the
first backtracking match and then resumes after it; this scan marks ALL
satisfying positions (a superset), which is harmless because the
consumer selects one pair by boundary distance.  Plain torch ops (the
JAX package's version is jitted jnp, not a Pallas kernel).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

# base codes (io.fasta): A=0 C=1 G=2 T=3 N=4
_A, _C, _G, _T = 0, 1, 2, 3

# hairpin stem class patterns (EAHelitron $hairpinpattern alternatives),
# S = [GC], W = [AT]
STEM_PATTERNS = (
    "SSSSWS", "SSSWSS", "SSWSSS", "SWSSSS", "SSSSS",
    "SSSSWWS", "SSSWWSS", "SSWWSSS", "SWWSSSS",
    "SWSWSSS", "SWSSWSS", "SWSSSWS", "SSWSWSS", "SSWSSWS", "SSSWSWS",
    "SSSS",
)

# CTRRT fuzzy levels (EAHelitron @CTAGT): each entry is a tuple of
# allowed-base tuples; None = any base
_R = (_A, _G)
CTRRT_LEVELS = (
    ((_C,), (_T,), (_A,), (_G,), (_T,)),          # 0: CTAGT
    ((_C,), (_T,), _R, (_G,), (_T,)),             # 1: CT[AG]GT
    ((_C,), (_T,), (_A,), _R, (_T,)),             # 2: CTA[AG]T
    ((_C,), (_T,), _R, _R, (_T,)),                # 3: CT[AG]{2}T
    ((_C,), (_T,), _R, _R, None),                 # 4: CT[AG]{2}.
    ((_C,), (_T,), (_A,), (_G,), None),           # 5: CTAG.
)

MAX_LOOP = 9      # loop = [atcg]{0,4} [at] [atgc]{0,4}
GAP_MIN, GAP_MAX = 3, 12   # bp between hairpin and CTRRT
LEAD = 10         # unambiguous bp required before the stem
TRAIL = 4         # bases required after the terminus


def _shift(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """x[:, i] <- x[:, i+d] (d >= 0), tail filled."""
    if d == 0:
        return x
    pad = torch.full(x.shape[:-1] + (d,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x[..., d:], pad], dim=-1)


def _rshift(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[:, i] <- x[:, i-d] (d > 0) for a boolean plane, head False."""
    pad = torch.zeros(x.shape[:-1] + (d,), dtype=torch.bool, device=x.device)
    return torch.cat([pad, x[..., :-d]], dim=-1)


def _match_at(c: torch.Tensor, pattern) -> torch.Tensor:
    """bool [B, L]: degenerate pattern (tuple of allowed-code tuples or
    None=any unambiguous base) starts at each position."""
    ok = torch.ones(c.shape, dtype=torch.bool, device=c.device)
    for j, allowed in enumerate(pattern):
        cj = _shift(c, j, 4)
        if allowed is None:
            ok = ok & (cj < 4)
        else:
            m = torch.zeros(c.shape, dtype=torch.bool, device=c.device)
            for b in allowed:
                m = m | (cj == b)
            ok = ok & m
    return ok


def hel3_scan(codes: torch.Tensor, fuzzy_level: int = 3) -> torch.Tensor:
    """3' Helitron structure scan.

    codes: uint8/int [B, L].  Returns bool [B, L] marking positions where a
    complete 3' structure's CTRRT terminus STARTS (element 3' end =
    index + 5, exclusive).  Callers must additionally bound end+TRAIL by
    the true sequence length (padding here is N, which [atcgn] accepts).
    """
    c = codes.to(torch.int32)
    acgt = c < 4
    is_s = (c == _C) | (c == _G)
    is_w = (c == _A) | (c == _T)

    # palindrome planes: pal[m][i] = c[i] pairs (WC) with c[i+m]
    max_s = max(len(p) for p in STEM_PATTERNS)
    pal = {}
    for m in range(2, MAX_LOOP + 2 * (max_s - 1) + 2):
        cm = _shift(c, m, 4)
        pal[m] = acgt & (cm < 4) & (c == 3 - cm)

    # leading [atcg]{10} ending just before the stem start i: the 10-run
    # of ACGT starting at i-10
    run10 = torch.ones(c.shape, dtype=torch.bool, device=c.device)
    for j in range(LEAD):
        run10 = run10 & _shift(acgt, j, False)
    lead_ok = _rshift(run10, LEAD)

    ctrrt = _match_at(c, CTRRT_LEVELS[fuzzy_level])

    # mark hairpin END positions (start + 2*stem + loop for every complete
    # stem/loop/revcomp-stem structure) so the terminus test below is a
    # fixed set of static shifts
    hp_end = torch.zeros(c.shape, dtype=torch.bool, device=c.device)
    for pat in STEM_PATTERNS:
        s = len(pat)
        stem = torch.ones(c.shape, dtype=torch.bool, device=c.device)
        for j, cls in enumerate(pat):
            stem = stem & _shift(is_s if cls == "S" else is_w, j, False)
        stem = stem & lead_ok
        for loop in range(1, MAX_LOOP + 1):
            # loop bases unambiguous, with an A/T within 4bp of both ends
            lo = max(0, loop - 5)
            hi = min(4, loop - 1)
            lok = torch.ones(c.shape, dtype=torch.bool, device=c.device)
            wany = torch.zeros(c.shape, dtype=torch.bool, device=c.device)
            for a in range(loop):
                lok = lok & _shift(acgt, s + a, False)
                if lo <= a <= hi:
                    wany = wany | _shift(is_w, s + a, False)
            # revcomp stem: c[i+s-1-j] pairs with c[i+s+loop+j]
            rc = torch.ones(c.shape, dtype=torch.bool, device=c.device)
            for j in range(s):
                rc = rc & _shift(pal[loop + 2 * j + 1], s - 1 - j, False)
            full = stem & lok & wany & rc
            # scatter to hairpin end = start + 2s + loop (static right shift)
            hp_end = hp_end | _rshift(full, 2 * s + loop)

    term_ok = torch.zeros(c.shape, dtype=torch.bool, device=c.device)
    for g in range(GAP_MIN, GAP_MAX + 1):
        # terminus at t preceded by g ACGT bases preceded by a hairpin end
        rung = torch.ones(c.shape, dtype=torch.bool, device=c.device)
        for j in range(g):
            rung = rung & _shift(acgt, j, False)
        term_ok = term_ok | _rshift(hp_end & rung, g)
    return term_ok & ctrrt


def tc5_scan(codes: torch.Tensor) -> torch.Tensor:
    """5' motif scan with HiTE's override (-T "ATC"): bool [B, L] of ATC
    start positions with >=5bp context before and >=20bp after (any base,
    EAHelitron `[atgcn]{5}(pat)[atgcn]{20}`) — the bounds are enforced by
    the caller against true lengths; here only the motif is matched."""
    c = codes.to(torch.int32)
    return (c == _A) & (_shift(c, 1, 4) == _T) & (_shift(c, 2, 4) == _C)


def select_pairs(
    hel3: np.ndarray,
    tc5: np.ndarray,
    lens: np.ndarray,
    raw_start: np.ndarray,
    raw_end: np.ndarray,
    upstream: int = 20_000,
    min_len: int = 80,
) -> List[Optional[Tuple[int, int]]]:
    """Per-row best (start, end) Helitron span (half-open, row-local).

    Mirrors `run_EAHelitron` (`Util.py:166-195`): every 3' structure pairs
    with each 5' motif within `upstream` bp upstream; keep the pair with
    the smallest |start - raw_start| + |end - raw_end| (ties -> longer).
    """
    out: List[Optional[Tuple[int, int]]] = []
    for r in range(len(lens)):
        L = int(lens[r])
        ends = np.nonzero(hel3[r, :L])[0] + 5          # exclusive ends
        ends = ends[ends + TRAIL <= L]
        starts = np.nonzero(tc5[r, :L])[0]
        starts = starts[(starts >= 5) & (starts + 3 + 20 <= L)]
        best = None
        for e in ends:
            cand = starts[(starts < e - 5) & (starts >= e - upstream)]
            if len(cand) == 0:
                continue
            dists = np.abs(cand - raw_start[r]) + abs(int(e) - raw_end[r])
            order = np.lexsort((cand, dists))          # min dist, then min start (longest)
            s = int(cand[order[0]])
            d = int(dists[order[0]])
            ln = int(e) - s
            if ln < min_len:
                continue
            key = (d, -ln)
            if best is None or key < best[0]:
                best = (key, (s, int(e)))
        out.append(best[1] if best else None)
    return out
