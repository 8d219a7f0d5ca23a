"""PolyA / tandem tail detection for non-LTR candidates (counterpart of
the JAX `ops/tail.py`).

Replaces `find_tail_polyA` (`Util.py:10832`) and
`find_longest_tandem_repeat_tail` (`Util.py:9732`): LINE/SINE elements end
in a polyA tail or a short tandem-repeat tail, searched in the last ~30 bp,
by run-length logic over [B, W] windows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TailCall(NamedTuple):
    polya_len: torch.Tensor     # longest A-run in the tail window [B]
    polyt_len: torch.Tensor     # longest T-run (minus-strand elements) [B]
    tandem_len: torch.Tensor    # longest period-2..6 tandem run [B]
    polya_end: torch.Tensor     # offset of the A-run end within the window [B]


def _longest_run(mask: torch.Tensor):
    """Longest True run per row of [B, W]: (length, end offset), the end
    of the FIRST longest run (argmax takes the first maximum)."""
    B, W = mask.shape
    idx = torch.arange(W, dtype=torch.int32, device=mask.device).expand(B, W)
    last_false = torch.cummax(torch.where(~mask, idx, -1), dim=1).values
    run_len = torch.where(mask, idx - last_false, 0)
    best, end = run_len.max(dim=1)
    # torch.max's index is the first maximal one, as jnp.argmax's
    return best, (end + 1).to(torch.int32)


def _tail_window(seqs: torch.Tensor, lens: torch.Tensor, window: int):
    B, L = seqs.shape
    offs = torch.arange(window, dtype=torch.int32, device=seqs.device)
    idx = lens.to(torch.int32)[:, None] - window + offs[None, :]
    got = torch.gather(seqs, 1, idx.clamp(0, L - 1).long())
    return torch.where(idx >= 0, got, torch.full_like(got, 4))


def tail_scan(seqs: torch.Tensor, lens: torch.Tensor,
              window: int = 30) -> TailCall:
    """Scan the last `window` bp of padded [B, L] candidates."""
    w = _tail_window(seqs, lens, window)
    a_len, a_end = _longest_run(w == 0)
    t_len, _ = _longest_run(w == 3)

    tandem_best = torch.zeros(lens.shape, dtype=torch.int32,
                              device=seqs.device)
    for p in range(2, 7):
        eq = (w[:, p:] == w[:, :-p]) & (w[:, p:] < 4)
        run, _ = _longest_run(eq)
        # a run of length r at period p covers r + p bases of tandem
        tandem_best = torch.maximum(tandem_best,
                                    torch.where(run > 0, run + p, 0))
    return TailCall(polya_len=a_len, polyt_len=t_len,
                    tandem_len=tandem_best, polya_end=a_end)
