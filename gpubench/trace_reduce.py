"""Reduce a profiler trace and the program's stage lines to metrics.

Device intervals come from the CUDA activity of `torch.profiler` (kernels,
copies, sets); stage intervals from the `hite_tpu_torch` logger's
"stage NAME: start" / "stage NAME: done in" lines, both on the host's
wall clock in nanoseconds.  `summarise` gives the busy seconds (the union
of the device intervals inside the window), the idle gaps labelled with
the innermost stage open at each gap's middle, and device seconds by
operation name.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

OUTSIDE = "outside_stages"
_START = re.compile(r"^stage (\S+): start$")
_DONE = re.compile(r"^stage (\S+): done in ")


def union(intervals: Sequence[Tuple[int, int]], lo: int, hi: int
          ) -> List[Tuple[int, int]]:
    """The merged union of the intervals, clipped to [lo, hi)."""
    out: List[List[int]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: Sequence[Tuple[int, int]], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The complement of merged `busy` in [lo, hi)."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def stage_intervals(lines: Sequence[Tuple[int, str]]
                    ) -> List[Tuple[int, int, str]]:
    """(start_ns, end_ns, name) of each stage from its log lines."""
    open_: Dict[str, List[int]] = {}
    out = []
    for t, msg in lines:
        m = _START.match(msg)
        if m:
            open_.setdefault(m.group(1), []).append(t)
            continue
        m = _DONE.match(msg)
        if m and open_.get(m.group(1)):
            out.append((open_[m.group(1)].pop(), t, m.group(1)))
    return out


def innermost(stages: Sequence[Tuple[int, int, str]], t: int) -> str:
    """The stage open at t that started last, or OUTSIDE."""
    best: Optional[Tuple[int, str]] = None
    for s, e, name in stages:
        if s <= t < e and (best is None or s > best[0]):
            best = (s, name)
    return best[1] if best else OUTSIDE


def summarise(events: Sequence[Tuple[str, int, int]], lo: int, hi: int,
              lines: Sequence[Tuple[int, str]], top: int = 10) -> dict:
    """events: (name, start_ns, end_ns) of device operations; [lo, hi) the
    traced window; lines: (ns, message) of the stage log."""
    busy = union([(s, e) for _n, s, e in events], lo, hi)
    busy_ns = sum(e - s for s, e in busy)
    stages = stage_intervals(lines)
    idle: Dict[str, int] = {}
    for s, e in gaps(busy, lo, hi):
        label = innermost(stages, (s + e) // 2)
        idle[label] = idle.get(label, 0) + (e - s)
    by_op: Dict[str, int] = {}
    for name, s, e in events:
        by_op[name] = by_op.get(name, 0) + (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idles = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (hi - lo) / 1e9,
        "device_ops": [[n[:96], v / 1e9] for n, v in ops],
        "idle_gaps": [[n, v / 1e9] for n, v in idles],
        "op_s": {n: v / 1e9 for n, v in by_op.items()},
    }


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every device operation in a finished
    `torch.profiler.profile`, read from its raw events."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if "CUDA" not in str(ev.device_type()):
            continue
        s = ev.start_ns()
        out.append((ev.name(), s, s + ev.duration_ns()))
    return out
