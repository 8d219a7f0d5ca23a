"""Helitron terminal scoring: the LCV pattern bank as a matrix product.

Counterpart of the JAX package's `ops/lcv.py`, replacing HelitronScanner's
scanHead / scanTail (`bin/HelitronScanner/HelitronScanner.jar`, driven by
`bin/run_helitron_scanner.sh:20-48` and `Util.py:91-113`): Helitron 5' /
3' termini are recognised by banks of trained local-combinational-variable
patterns (`TrainingSet/head.lcvs` / `tail.lcvs`, vendored under
`hite_tpu_torch/data/helitron/`; regex-like strings over
{ACGT . [..] .{n} .{a,b}}).

Every pattern (variable gaps expanded to fixed-gap variants) is a [W, 4]
allowed-base mask; a window matches a pattern iff <onehot(window),
allowed> == the pattern's constrained positions.  The window x pattern
product is one float32 matrix product of 0/1 values (exact: counts are at
most 40), in position tiles sized to a fixed memory budget.
"""

from __future__ import annotations

import functools
import os
import re
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data", "helitron")

_TOKEN = re.compile(
    r"(?P<base>[ACGT])"
    r"|(?P<any>\.(?:\{(?P<lo>\d+)(?:,(?P<hi>\d+))?\})?)"
    r"|\[(?P<cls>[ACGT]+)\](?:\{(?P<clo>\d+)(?:,(?P<chi>\d+))?\})?"
)

B2I = {"A": 0, "C": 1, "G": 2, "T": 3}

# bytes of the [rows, tile, W*4 + P] float32 window and count blocks of
# one product; tiles of positions are cut to stay within it
TILE_BUDGET_BYTES = 1 << 28


def _parse_pattern(pat: str) -> List[Tuple[str, str, int, int]]:
    """Tokenize one LCV pattern into (kind, payload, repeat lo, hi)."""
    items = []
    pos = 0
    while pos < len(pat):
        m = _TOKEN.match(pat, pos)
        if not m:
            raise ValueError(f"bad LCV pattern {pat!r} at {pos}")
        pos = m.end()
        if m.group("base"):
            items.append(("base", m.group("base"), 1, 1))
        elif m.group("any") is not None:
            lo = int(m.group("lo")) if m.group("lo") else 1
            hi = int(m.group("hi")) if m.group("hi") else lo
            items.append(("any", ".", lo, hi))
        else:
            lo = int(m.group("clo")) if m.group("clo") else 1
            hi = int(m.group("chi")) if m.group("chi") else lo
            items.append(("cls", m.group("cls"), lo, hi))
    return items


def _expand(items, max_variants: int = 16) -> List[List[Tuple[str, str]]]:
    """Expand variable repeats into fixed-width variants (capped)."""
    variants: List[List[Tuple[str, str]]] = [[]]
    for kind, payload, lo, hi in items:
        new = []
        for n in range(lo, hi + 1):
            for v in variants:
                new.append(v + [(kind, payload)] * n)
            if len(new) > max_variants * 4:
                break
        variants = new[: max_variants * 4]
    return variants[:max_variants]


class LCVBank(NamedTuple):
    allowed: np.ndarray      # float32 [P, W, 4] allowed-base indicator
    nconstr: np.ndarray      # int32 [P] constrained positions per pattern
    width: np.ndarray        # int32 [P] pattern width
    group: np.ndarray        # int32 [P] source pattern id (variants share)


def load_bank(path: str, max_width: int = 40) -> LCVBank:
    allowed_rows, nconstr, widths, groups = [], [], [], []
    with open(path) as fh:
        patterns = [l.strip() for l in fh if l.strip()]
    for gid, pat in enumerate(patterns):
        for variant in _expand(_parse_pattern(pat)):
            W = len(variant)
            if W > max_width:
                continue
            row = np.zeros((max_width, 4), np.float32)
            nc = 0
            for w, (kind, payload) in enumerate(variant):
                if kind == "base":
                    row[w, B2I[payload]] = 1.0
                    nc += 1
                elif kind == "cls":
                    for ch in payload:
                        row[w, B2I[ch]] = 1.0
                    nc += 1
                # 'any': all-zero row, not constrained
            allowed_rows.append(row)
            nconstr.append(nc)
            widths.append(W)
            groups.append(gid)
    return LCVBank(
        allowed=np.stack(allowed_rows),
        nconstr=np.array(nconstr, np.int32),
        width=np.array(widths, np.int32),
        group=np.array(groups, np.int32),
    )


@functools.lru_cache(maxsize=None)
def default_banks() -> Tuple[LCVBank, LCVBank]:
    """(head, tail) banks from the vendored HelitronScanner TrainingSet."""
    head = load_bank(os.path.join(DATA_DIR, "head.lcvs"))
    tail = load_bank(os.path.join(DATA_DIR, "tail.lcvs"))
    return head, tail


def _pad_patterns(bank: LCVBank, p_mult: int = 128):
    P = bank.allowed.shape[0]
    P_pad = ((P + p_mult - 1) // p_mult) * p_mult
    allowed = np.zeros((P_pad,) + bank.allowed.shape[1:], np.float32)
    allowed[:P] = bank.allowed
    nconstr = np.full(P_pad, 10**6, np.int32)  # padded patterns never match
    nconstr[:P] = bank.nconstr
    group = np.full(P_pad, -1, np.int32)
    group[:P] = bank.group
    return allowed, nconstr, group


_BANK_CACHE: Dict[tuple, tuple] = {}


def _device_bank(bank: LCVBank, device: torch.device):
    """(allowed^T [W*4, P], nconstr [P], widths [P], group one-hot [P, G])
    on `device`, built once per bank and device (the entry holds the
    bank, so its id is never reused while cached)."""
    key = (id(bank), str(device))
    ent = _BANK_CACHE.get(key)
    if ent is None or ent[0] is not bank:
        allowed_np, nconstr_np, group_np = _pad_patterns(bank)
        P, W, _ = allowed_np.shape
        widths = np.zeros(P, np.int32)
        widths[: len(bank.width)] = bank.width
        n_groups = int(bank.group.max()) + 1
        gmat = np.zeros((P, n_groups), np.float32)
        ok = group_np >= 0
        gmat[np.nonzero(ok)[0], group_np[ok]] = 1.0
        ent = (bank,) + tuple(torch.from_numpy(x).to(device) for x in (
            np.ascontiguousarray(allowed_np.reshape(P, W * 4).T),
            nconstr_np.astype(np.float32), widths, gmat))
        _BANK_CACHE[key] = ent
    return ent[1:]


def lcv_scores(seqs: torch.Tensor, bank: LCVBank, *,
               tile: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position LCV hit counts and matched widths.

    seqs: uint8 [B, L] codes.  Returns (score int32 [B, L], width int32
    [B, L]): the number of distinct source patterns with a variant
    matching the window starting at each position (HelitronScanner's
    per-site score) and the widest matching variant (0 when none).
    Positions are scored in tiles of at most `tile`, fewer where the
    [B, tile, P] product would pass TILE_BUDGET_BYTES; scores do not
    depend on the tiling."""
    dev = seqs.device
    allowed_t, nconstr, widths, gmat = _device_bank(bank, dev)
    W4, P = allowed_t.shape
    W = W4 // 4
    B, L = seqs.shape
    # one-hot by comparison: N (code 4) and padding are all-zero rows
    oh = (seqs[..., None].long() == torch.arange(4, device=dev)).float()
    oh = torch.nn.functional.pad(oh, (0, 0, 0, W))          # [B, L + W, 4]
    per_pos = B * (W4 + 2 * P) * 4
    tile = max(1, min(tile, TILE_BUDGET_BYTES // max(per_pos, 1)))
    score = torch.empty((B, L), dtype=torch.int32, device=dev)
    width = torch.empty((B, L), dtype=torch.int32, device=dev)
    for t0 in range(0, L, tile):
        n = min(tile, L - t0)
        # windows [B, n, W, 4] of the positions t0 .. t0 + n - 1
        wins = oh[:, t0 : t0 + n + W - 1].unfold(1, W, 1)   # [B, n, 4, W]
        wins = wins.transpose(2, 3).reshape(B, n, W4)
        counts = wins @ allowed_t                           # [B, n, P]
        full = counts >= nconstr
        hits = (full.float() @ gmat) > 0                    # [B, n, G]
        score[:, t0 : t0 + n] = hits.sum(-1, dtype=torch.int32)
        width[:, t0 : t0 + n] = torch.where(full, widths, 0).amax(-1)
    return score, width
