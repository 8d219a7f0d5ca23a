"""Smoke run of hite_tpu_torch on one NVIDIA GPU: python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every CUDA kernel and the host chaining library, from the
     sources in this checkout, all compilers at once; registers and spills
     of each SW instantiation (ptxas) and the SASS instructions of its
     step loop per cell (cuobjdump), the nucleotide ones against PERF.md's;
  3. the SW kernel against its plain PyTorch version on the card, bit-exact
     on all 7 outputs, at the TIR gate, annotation, LTR and longer widths,
     a ragged batch and N-heavy rows, and at border shapes that force each
     variant (lane groups, bands, unpacked fields); kernel ms (profiler
     device time, and CUDA events a call), plain ms, and the bound from the
     recurrence's int32 operations; each R (rows a lane) at those shapes
     against the plan's pick;
  4. the kernel's protein mode (BLOSUM62 from a table in shared memory)
     against the plain version, the same way, at the domain confirm's
     widths 64-2048 and at X-heavy, all-X, invalid-code and band borders;
  5. on the 8 Mbp clean bench substrate (seed 7) on cuda, with the launch
     counts zeroed just before each path and read just after: the TIR
     discovery path (te_type "tir", cold), which must accept the 3 planted
     TIR families; then the main path, stages 1-4 of run_pipeline for the
     default config (the TIR, Helitron and non-LTR modules over one shared
     copy join, the low-copy rescue, the FiLTR LTR stage and library
     assembly), which must accept the 3 TIR, 2 Helitron and 2 SINE
     families, find each of the 4 planted LTR families as an intact
     record, assemble a library with DNA, RC/Helitron, SINE and LTR
     entries, and launch sw and sw_protein; each kernel at that path's own
     shapes; the main path again, warm, under the profiler (device busy
     share, top device ops);
  6. both CNNs with the bundled parameters, cuda against the CPU: logits
     within the tests' tolerances, decisions equal;
  7. cuda against the CPU, which must agree exactly: the TIR path on a
     160 kbp genome, the modules path with the rescue on a 240 kbp genome
     with planted TIR, Helitron and SINE copies, the rescue of a planted
     TIRPeps entry (which must launch sw_protein), and stages 1-4 on a
     120 kbp genome whose LTR family has 7 copies (a forward hook asserts
     that the LTR CNN ran);
  8. the kernel line, the card line, and the result line (last).

Exits non-zero, printing no result, without a GPU or outside a checkout.
Detailed numbers go to smoke_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from hite_tpu_torch import kernels
from hite_tpu_torch.native import runtime as native_rt
from hite_tpu_torch.ops import terminal
from hite_tpu_torch.ops.protein import AA_X, BLOSUM62
from hite_tpu_torch.utils import log as hlog

# published H100 SXM figures: HBM bytes/s (data sheet); the int32 rate,
# 64 INT32 lanes an SM (Hopper white paper) x 132 SMs x 1.98 GHz, the boost
# clock at which the data sheet's 67 TFLOP/s float32 is 132 x 128 lanes x
# 2 (FMA); and the instruction rate, 4 schedulers an SM of one warp instruction
# (32 lanes) a clock, which prices the SASS diagnostic below
PEAK_BYTES_S = 3.35e12
PEAK_INT32_S = 132 * 64 * 1.98e9
PEAK_INSTR_S = 132 * 4 * 32 * 1.98e9
# int32 operations the recurrence needs per DP cell, as the plain version
# states it, whatever kernel computes it: the substitution 2 (compare,
# select), the three candidates 3 (adds), h = max(0, ...) 3, the first
# argmax 3 (compares), the carried start, matches and length 4 x 3 selects
# + 2 adds, and the running best 1 compare + 7 selects.  In protein mode
# a table lookup (address, load) takes the place of the compare and
# select, so the count is the same
SW_OPS_PER_CELL = 2 + 3 + 3 + 3 + 14 + 8

SW_SHAPES = [  # (label, B, La, Lb, n_frac)
    ("tir_gate", 4096, 40, 40, 0.0),
    ("w1024", 64, 1024, 1024, 0.0),
    ("annotation_w4096", 32, 4096, 4096, 0.0),
    ("ltr_w8192", 8, 8192, 8192, 0.0),
    ("w16384", 2, 16384, 16384, 0.0),
    ("ragged", 1001, 37, 53, 0.0),
    ("n_heavy", 256, 300, 300, 0.4),
]
# border shapes and forced variants: (label, B, La, Lb, n_frac, R, packed,
# planted best cell (row, column) or None)
SW_BORDERS = [
    ("one_band_plus_1", 16, 257, 300, 0.0, 8, None, None),
    ("one_alignment_32_bands", 1, 4000, 500, 0.0, 4, None, None),
    ("best_on_band_row_and_last_col", 8, 512, 400, 0.0, 8, None, (256, 400)),
    ("best_on_band_row_R4", 6, 300, 200, 0.0, 4, None, (128, 150)),
    ("ragged_groups_G5", 45, 37, 53, 0.0, 8, None, None),
    ("ragged_groups_G10", 7, 37, 61, 0.1, 4, None, None),
    ("short_R8", 512, 40, 40, 0.0, 8, None, None),
    ("banded_R4_n_heavy", 64, 200, 150, 0.4, 4, None, None),
    ("unpacked_short", 256, 40, 40, 0.0, None, False, None),
    ("unpacked_banded", 4, 1000, 1000, 0.0, None, False, None),
    ("unpacked_best_on_band_row", 3, 600, 300, 0.0, 4, False, (256, 300)),
    ("R8_banded_best_on_band_row", 4, 1100, 300, 0.0, 8, None, (512, 280)),
    ("R8_one_band_ragged", 37, 250, 70, 0.2, 8, None, None),
]
# each R at the shapes callers send, against the plan's pick (device time)
SW_SWEEP = [(B, La, Lb) for _, B, La, Lb, _ in SW_SHAPES] + [(256, 40, 40)]
# registers / step-loop SASS a cell of the nucleotide instantiations as
# PERF.md's table records them; the protein mode must leave them alone
NUCLEOTIDE_RECORDED = {
    (4, True, False): (60, 45.0), (4, False, False): (71, 54.75),
    (4, True, True): (64, 116.25), (4, False, True): (85, 142.75),
    (8, True, False): (94, 37.75), (8, False, False): (115, 48.75),
    (8, True, True): (103, 72.5), (8, False, True): (142, 88.0)}

# protein mode (BLOSUM62) as the domain engine calls it
PROTEIN = dict(mismatch=-4, gap=8, invalid_code=AA_X)
# the confirm's [B, w] x [B, w] shapes: w a power of two, 64-1024 seen on
# the bench substrates, longer for whole long library entries
PROTEIN_SHAPES = [("dom_w64", 4, 64), ("dom_w256", 8, 256),
                  ("dom_w512", 32, 512), ("dom_w1024", 4, 1024),
                  ("dom_w2048", 16, 2048)]
# (label, B, La, Lb, X fraction, R, planted best cell or None); X-heavy
# inputs carry an all-X row and rows that differ only in invalid codes
PROTEIN_BORDERS = [
    ("x_heavy", 64, 256, 256, 0.4, None, None),
    ("x_heavy_banded", 8, 700, 500, 0.3, None, None),
    ("R4_one_band", 32, 100, 120, 0.1, 4, None),
    ("R8_one_band_ragged_groups", 45, 37, 53, 0.1, 8, None),
    ("R4_banded", 8, 512, 512, 0.0, 4, None),
    ("R8_banded_best_on_band_row", 6, 700, 600, 0.0, 8, (256, 600)),
    ("R4_banded_best_on_band_row", 4, 300, 250, 0.0, 4, (128, 200)),
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sw_inputs(B, La, Lb, n_frac, seed, best_at=None):
    """Random codes with a planted shared core per row, N blocks and (for
    N-heavy inputs) all-N rows; uint8 on the card.  `best_at` = (row,
    column) plants in every row a core that ends at that DP cell, with N
    after it so that the best cell stays there."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, (B, La)).astype(np.uint8)
    b = rng.integers(0, 4, (B, Lb)).astype(np.uint8)
    core = max(1, min(La, Lb) // 3)
    for r in range(0, B, 2):
        c = rng.integers(0, 4, core).astype(np.uint8)
        qa = int(rng.integers(0, La - core + 1))
        qb = int(rng.integers(0, Lb - core + 1))
        a[r, qa : qa + core] = c
        b[r, qb : qb + core] = c
    if best_at:
        i, j = best_at
        n = min(i, j, 150)
        for r in range(B):
            a[r, i - n : i] = b[r, j - n : j] = rng.integers(0, 4, n)
        a[:, i : i + 8] = 4
        b[:, j : j + 8] = 4
    if n_frac:
        a[rng.random((B, La)) < n_frac] = 4
        b[rng.random((B, Lb)) < n_frac / 2] = 4
        a[::7] = 4
        b[3::11] = 4
    dev = torch.device("cuda")
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


def protein_inputs(B, La, Lb, x_frac, seed, best_at=None):
    """Random amino-acid codes (0-19) with a planted, 10%-substituted
    shared core per row and X (20) padding past a random length, as the
    domain engine pads its confirm rows; uint8 on the card.  With
    `x_frac`, X at random, an all-X row and rows whose a and b differ only
    in invalid codes (20-25); `best_at` plants a long identical core ending
    at that DP cell, X after it, in every row."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 20, (B, La)).astype(np.uint8)
    b = rng.integers(0, 20, (B, Lb)).astype(np.uint8)
    core = max(1, min(La, Lb) // 3)
    for r in range(B if not best_at else 0):
        qa = int(rng.integers(0, La - core + 1))
        qb = int(rng.integers(0, Lb - core + 1))
        c = a[r, qa : qa + core].copy()
        sub = rng.random(core) < 0.1
        c[sub] = rng.integers(0, 20, int(sub.sum()))
        b[r, qb : qb + core] = c
        a[r, int(rng.integers(La // 2, La + 1)):] = AA_X
        b[r, int(rng.integers(Lb // 2, Lb + 1)):] = AA_X
    if best_at:
        i, j = best_at
        n = min(i, j, 150)
        for r in range(B):
            a[r, i - n : i] = b[r, j - n : j] = rng.integers(0, 20, n)
        a[:, i : i + 8] = AA_X
        b[:, j : j + 8] = AA_X
    if x_frac:
        a[rng.random((B, La)) < x_frac] = AA_X
        b[rng.random((B, Lb)) < x_frac / 2] = AA_X
        a[::7] = AA_X
        for r in range(3, B, 11):
            n = min(La, Lb)
            b[r, :n] = a[r, :n]
            inv = rng.random(n) < 0.5
            a[r, :n][inv] = rng.integers(20, 26, int(inv.sum()))
            b[r, :n][inv] = rng.integers(20, 26, int(inv.sum()))
    dev = torch.device("cuda")
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


def sw(a, b, R=None, packed=None, protein=False):
    """The kernel (no synchronise), nucleotide or protein mode."""
    if protein:
        return terminal._sw_cuda(a, b, match=2, R=R, packed=packed,
                                 submatrix=BLOSUM62, **PROTEIN)
    return terminal._sw_cuda(a, b, match=2, mismatch=-3, gap=4,
                             invalid_code=4, R=R, packed=packed)


def plain_sw(a, b, protein=False):
    """The plain version on the same device, in the same mode."""
    if protein:
        return terminal.batched_local_align(
            a, b, submatrix=torch.from_numpy(BLOSUM62).to(a.device),
            **PROTEIN)
    return terminal.batched_local_align(a, b)


def _cuobjdump() -> str:
    return shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"


def sass_step_counts(lib_path: str) -> dict:
    """{kernel function: static SASS instructions of its step loop}, read
    with cuobjdump: the backward branch whose body holds the most
    lane shuffles other than SHFL.DOWN (the step's shuffles; the final
    reduction's are unrolled), counted from the loop head to it."""
    txt = subprocess.run([_cuobjdump(), "-sass", lib_path],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", txt)[1:]:
        name = block.split("\n", 1)[0].strip()
        ins, at = [], {}   # instructions; address or label -> index
        for line in block.splitlines():
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                at[m.group(1)] = len(ins)
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                at[int(m.group(1), 16)] = len(ins)
                ins.append(m.group(2))
        best = (0, 0)
        for k, t in enumerate(ins):
            m = re.search(r"\bBRA\b[^;]*?(?:0x([0-9a-f]+)|(\.L_x_\d+))", t)
            if not m:
                continue
            head = at.get(int(m.group(1), 16) if m.group(1) else m.group(2))
            if head is not None and head <= k:
                body = ins[head : k + 1]
                best = max(best, (sum("SHFL." in x and "DOWN" not in x
                                      for x in body), len(body)))
        out[name] = best[1] if best[0] else None
    return out


def kernel_variant(name: str):
    """(R, packed, banded, protein) of a sw_kernel instantiation's mangled
    name."""
    m = re.search(r"sw_kernelILi(\d+)E([jy])Lb([01])ELb([01])EE", name)
    if not m:
        raise ValueError(f"not a sw_kernel instantiation: {name}")
    return (int(m.group(1)), m.group(2) == "j", m.group(3) == "1",
            m.group(4) == "1")


def ptxas_report(log: str) -> dict:
    """{function: (registers, spill store bytes, spill load bytes)}."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn] = [None, int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn in out:
            out[fn][0] = int(m.group(1))
    return out


def sass_per_cell(lib_path: str, log: str):
    """({(R, packed, banded, protein): step-loop SASS instructions per
    cell}, {same key: registers}), printing the registers, spills and
    step-loop counts of every instantiation."""
    regs = ptxas_report(log)
    per, nregs = {}, {}
    for fn, n in sorted(sass_step_counts(lib_path).items()):
        key = kernel_variant(fn)
        R, packed, banded, protein = key
        r, ss, sl = regs.get(fn, (None, None, None))
        per[key] = n / R if n else None
        nregs[key] = r
        print(f"build: sw R={R} {'packed' if packed else 'unpacked'} "
              f"{'banded' if banded else 'one band'}"
              f"{' protein' if protein else ''}: {r} registers, spills "
              f"{ss}/{sl} B, step loop {n} SASS instructions = {per[key]} "
              "per cell")
    return per, nregs


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def sw_bound_ms(B, La, Lb, ops_per_cell, ops_per_s):
    """Least time for the work: each input byte read once and 7 int32
    outputs written once, or ops_per_cell ops per DP cell at ops_per_s."""
    t_bytes = (B * (La + Lb) + 7 * 4 * B) / PEAK_BYTES_S
    t_ops = ops_per_cell * B * La * Lb / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def check_sw(label, a, b, reps, sass, R=None, packed=None, best_at=None,
             protein=False):
    """Kernel vs plain on the same inputs: bit-exact on all 7 outputs."""
    B, La = a.shape
    Lb = b.shape[1]
    plan = terminal.sw_plan(La, Lb, R=R, packed=packed)
    got = sw(a, b, R, packed, protein)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain_sw(a, b, protein)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
              for g, r in zip(got, ref))
    if err != 0:
        bad = [f for f, g, r in zip(terminal.LocalAlign._fields, got, ref)
               if not torch.equal(g, r)]
        raise AssertionError(f"sw kernel != plain at {label} ({plan}): "
                             f"fields {bad}")
    if best_at:
        on = int(((ref.qe == best_at[0]) & (ref.se == best_at[1])).sum())
        assert on >= 1, f"{label}: no best cell at {best_at}"
        label = f"{label} ({on}/{B} bests at {best_at})"
    dev_ms, ms = sw_device_ms(a, b, reps, R, packed, protein)
    kernel_ms = dev_ms or ms
    bound, by = sw_bound_ms(B, La, Lb, SW_OPS_PER_CELL, PEAK_INT32_S)
    # diagnostic, not a bound of the function: the kernel's own step-loop
    # instructions at the card's issue rate
    per_cell = sass.get((plan.R, plan.packed, plan.nb > 1, protein))
    issue = (per_cell * B * La * Lb / PEAK_INSTR_S * 1e3 if per_cell
             else None)
    row = dict(shape=label, B=B, La=La, Lb=Lb, plan=plan._asdict(),
               max_abs_err=err, ms=kernel_ms, device_ms=dev_ms, call_ms=ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=by,
               sass_per_cell=per_cell, sass_instr_ms=issue,
               cells_per_s=B * La * Lb / (kernel_ms * 1e-3))
    print(f"{'sw_protein' if protein else 'sw'} {label}: B={B} {La}x{Lb} "
          f"R={plan.R} G={plan.G} "
          f"bands={plan.nb} {'packed' if plan.packed else 'unpacked'}: "
          f"kernel {kernel_ms:.4f} ms ({'device' if dev_ms else 'events'}"
          f"; {ms:.4f} ms a call by events)  plain {plain_ms:.1f} ms  "
          f"bound {bound:.5f} ms ({by}; {kernel_ms / bound:.1f}x)  "
          f"step-loop SASS at the instruction rate {issue} ms  "
          f"{row['cells_per_s'] / 1e9:.2f} Gcell/s  exact")
    return row


def sw_device_ms(a, b, n, R=None, packed=None, protein=False):
    """Per-launch device time of the SW kernel from torch.profiler kernel
    durations (None if the profiler saw no kernel), and the per-call
    CUDA-event time of the same loop (which includes the host enqueue
    when launches are short)."""
    sw(a, b, R, packed, protein)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(n):
            sw(a, b, R, packed, protein)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "sw_kernel" in e.key]
    dev_us = sum(e.self_device_time_total for e in ev)
    count = sum(e.count for e in ev)
    return (dev_us / count / 1e3 if count else None), cuda_ms(
        lambda: sw(a, b, R, packed, protein), n)


def make_planter(bg, rng):
    """plant(te, n, tsd=0, host_at=False, mut=0.02) -> copy starts: the
    bench's rule for placing n mutated copies of te at random spots of bg
    (no two within 200 bp), with a TSD or an A|T host site."""
    length = len(bg)
    bins = {}

    def overlaps(pos, end):
        for b in range(pos // 65536 - 1, end // 65536 + 2):
            for s, e in bins.get(b, ()):
                if pos < e + 200 and end + 200 > s:
                    return True
        return False

    def plant(te, n, tsd=0, host_at=False, mut=0.02):
        starts = []
        while len(starts) < n:
            pos = int(rng.integers(1000, length - len(te) - 1000))
            if overlaps(pos, pos + len(te)):
                continue
            copy = te.copy()
            muts = rng.random(len(copy)) < mut
            copy[muts] = (copy[muts] + rng.integers(1, 4, muts.sum())) % 4
            if tsd:
                t = rng.integers(0, 4, tsd).astype(np.uint8)
                bg[pos - tsd: pos] = t
                bg[pos + len(copy): pos + len(copy) + tsd] = t
            if host_at:
                bg[pos - 1] = 0
                bg[pos + len(copy)] = 3
            bg[pos: pos + len(copy)] = copy
            for b in range(pos // 65536, (pos + len(copy)) // 65536 + 1):
                bins.setdefault(b, []).append((pos, pos + len(copy)))
            starts.append(pos)
        return starts

    return plant


def _codes(s: str) -> np.ndarray:
    return np.array(["ACGT".index(c) for c in s], np.uint8)


def _tir_te(rng, interior):
    t = rng.integers(0, 4, 20).astype(np.uint8)
    while t[0] == 3 and t[1] == 2:
        t = rng.integers(0, 4, 20).astype(np.uint8)
    return np.concatenate([t, rng.integers(0, 4, interior).astype(np.uint8),
                           (3 - t)[::-1]])


def _helitron_te(rng, interior):
    return np.concatenate([
        _codes("TCTCTACTA"), rng.integers(0, 4, interior).astype(np.uint8),
        _codes("CAATGAACG" + "ACGTACGTA" + "CTAGT")])


def _sine_te(rng, interior):
    return np.concatenate([rng.integers(0, 4, interior).astype(np.uint8),
                           np.zeros(14, np.uint8)])


def build_bench_genome(length: int):
    """The bench substrate (clean): planted TIR, Helitron, SINE and LTR
    families on a seed-7 random background.  Returns (flat codes,
    {"TIR" | "Helitron" | "SINE" | "LTR": {family index: [(start, end) of
    each planted copy]}})."""
    rng = np.random.default_rng(7)
    bg = rng.integers(0, 4, length).astype(np.uint8)
    plant = make_planter(bg, rng)
    fams = {"TIR": {}, "Helitron": {}, "SINE": {}, "LTR": {}}

    def record(cls, f, te, starts):
        fams[cls][f] = [(s, s + len(te)) for s in starts]

    for f in range(3):
        n, interior = ((20, 460), (15, 900), (10, 1400))[f % 3]
        te = _tir_te(rng, interior)
        record("TIR", f, te, plant(te, n, tsd=5))
    for f in range(2):
        n, interior = ((8, 700), (8, 1200))[f % 2]
        te = _helitron_te(rng, interior)
        record("Helitron", f, te, plant(te, n, host_at=True))
    for f in range(2):
        n, interior = ((20, 280), (20, 420))[f % 2]
        te = _sine_te(rng, interior)
        record("SINE", f, te, plant(te, n, tsd=12))
    for f in range(4):
        n, ltr_len = ((4, 250), (4, 350), (4, 450), (4, 600))[f % 4]
        t = rng.integers(0, 4, ltr_len).astype(np.uint8)
        t[0], t[1], t[-2], t[-1] = 3, 2, 1, 0
        te = np.concatenate([t, rng.integers(0, 4, 2200).astype(np.uint8), t])
        record("LTR", f, te, plant(te, n, tsd=5, mut=0.01))
    return bg, fams


def small_genome():
    """160 kbp genome with 6 planted TIR copies (for the cuda-vs-CPU check)."""
    rng = np.random.default_rng(23)
    bg = rng.integers(0, 4, 160_000).astype(np.uint8)
    t = rng.integers(0, 4, 20).astype(np.uint8)
    te = np.concatenate([t, rng.integers(0, 4, 360).astype(np.uint8),
                         (3 - t)[::-1]])
    for pos in range(10_000, 120_000, 20_000):
        copy = te.copy()
        muts = rng.random(len(copy)) < 0.01
        copy[muts] = (copy[muts] + rng.integers(1, 4, muts.sum())) % 4
        tsd = rng.integers(0, 4, 5).astype(np.uint8)
        bg[pos - 5 : pos] = tsd
        bg[pos + len(copy) : pos + len(copy) + 5] = tsd
        bg[pos : pos + len(copy)] = copy
    return bg


def small_modules_genome():
    """240 kbp genome with one planted TIR (8 copies), Helitron (6) and
    SINE (8) family each (for the modules path's cuda-vs-CPU check)."""
    rng = np.random.default_rng(29)
    bg = rng.integers(0, 4, 240_000).astype(np.uint8)
    plant = make_planter(bg, rng)
    plant(_tir_te(rng, 460), 8, tsd=5)
    plant(_helitron_te(rng, 700), 6, host_at=True)
    plant(_sine_te(rng, 280), 8, tsd=12)
    return bg


def discover_and_verify(bg, device, cfg):
    """init_mask -> tandem mask -> coarse -> gindex -> modules_stage, with
    cfg sized to the genome.  Returns (genome, cfg, coarse, modules,
    gindex)."""
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.pipeline.coarse import CoarseParams, coarse_discover
    from hite_tpu_torch.pipeline.copies import GenomeIndex
    from hite_tpu_torch.pipeline.run import _mask_tandem_regions, modules_stage

    genome = Genome.from_dict({"chr1": bg}, device=device)
    cfg = cfg.with_genome_size(genome.size)
    params = CoarseParams()
    genome.init_mask()
    with hlog.stage_timer("pipeline.tandem_mask"):
        _mask_tandem_regions(genome)
    with hlog.stage_timer("pipeline.coarse"):
        coarse = coarse_discover(genome, cfg.align, params)
    with hlog.stage_timer("pipeline.gindex"):
        gindex = GenomeIndex(genome, cfg.align, seg_len=params.seg_len)
    with hlog.stage_timer("pipeline.modules"):
        mods = modules_stage(genome, coarse, cfg, gindex)
    return genome, cfg, coarse, mods, gindex


def tir_path(bg, device):
    """The TIR discovery path (te_type="tir"): (genome, coarse, TIR
    module)."""
    from hite_tpu_torch.config import PipelineConfig

    genome, _cfg, coarse, mods, _gindex = discover_and_verify(
        bg, device, PipelineConfig(te_type="tir"))
    return genome, coarse, mods["tir"]


def modules_path(bg, device):
    """Stages 1-2b of run_pipeline for the default te_type="all": the
    discovery, the TIR, Helitron and non-LTR gates, one shared copy join,
    each module verified, then the low-copy structural and domain rescue.
    Returns {genome, cfg, gindex, coarse, mods, low (low-copy counts
    before the rescue), rescued, found (each module's accepted intervals
    before the rescue, which run_pipeline masks before stage 3)}."""
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.pipeline.run import _rescue_low_copy

    genome, cfg, coarse, mods, gindex = discover_and_verify(
        bg, device, PipelineConfig())
    assert cfg.te_type == "all" and list(mods) == ["tir", "helitron",
                                                   "non_ltr"]
    low = {k: len(m.low_copy) for k, m in mods.items()}
    found = [m.accepted.intervals for m in mods.values()]
    with hlog.stage_timer("pipeline.low_copy_rescue"):
        rescued = _rescue_low_copy(genome, cfg, **mods)
    return dict(genome=genome, cfg=cfg, gindex=gindex, coarse=coarse,
                mods=mods, low=low, rescued=rescued, found=found)


def main_path(bg, device):
    """Stages 1-4 of run_pipeline for the default config: `modules_path`,
    then the FiLTR LTR stage on the genome masked with the families found
    (`run.ltr_stage`) and library assembly (`run.library_stage`).  Returns
    modules_path's dict with `ltr` and `libs` added."""
    from hite_tpu_torch.pipeline.coarse import CoarseParams
    from hite_tpu_torch.pipeline.run import library_stage, ltr_stage

    run = modules_path(bg, device)
    with hlog.stage_timer("pipeline.ltr"):
        run["ltr"] = ltr_stage(run["genome"], run["cfg"], run["gindex"],
                               run["found"], seg_len=CoarseParams().seg_len)
    with hlog.stage_timer("pipeline.library"):
        run["libs"] = library_stage(run["genome"], run["cfg"],
                                    ltr=run["ltr"], **run["mods"])
    return run


def same_modules(a, b):
    """Two modules-path results agree exactly: coarse candidates, and per
    module the accepted intervals and their labels, consensus, copy
    counts and low-copy set, and the rescued count."""
    assert np.array_equal(a["coarse"], b["coarse"])
    assert a["low"] == b["low"] and a["rescued"] == b["rescued"]
    ma, mb = a["mods"], b["mods"]
    assert list(ma) == list(mb)
    for k in ma:
        x, y = ma[k], mb[k]
        assert np.array_equal(x.accepted.intervals, y.accepted.intervals), k
        assert x.accepted.meta.keys() == y.accepted.meta.keys(), k
        assert all(np.array_equal(x.accepted.meta[m], y.accepted.meta[m])
                   for m in x.accepted.meta), k
        assert x.copy_counts == y.copy_counts, k
        assert len(x.consensus) == len(y.consensus), k
        assert all(np.array_equal(p, q)
                   for p, q in zip(x.consensus, y.consensus)), k
        assert np.array_equal(x.low_copy.intervals, y.low_copy.intervals), k


def same_stages_3_4(a, b):
    """Two main-path results agree exactly in stages 3-4: every field of
    every LTR record, the cross-class pools and every library dict."""
    import dataclasses

    assert [dataclasses.asdict(r) for r in a["ltr"].records] == \
        [dataclasses.asdict(r) for r in b["ltr"].records]
    pa, pb = a["ltr"].cross_class, b["ltr"].cross_class
    assert list(pa) == list(pb)
    assert all([v.tolist() for v in pa[k]] == [v.tolist() for v in pb[k]]
               for k in pa)
    assert list(a["libs"]) == list(b["libs"])
    for key, lib in a["libs"].items():
        assert list(lib) == list(b["libs"][key]), key
        assert all(np.array_equal(lib[n], b["libs"][key][n]) for n in lib), key


def library_classes(libs):
    """The class (the label before "/") of each merged library entry."""
    return sorted({n.partition("#")[2].split("/")[0] for n in libs["merged"]})


def found_families(truth, accepted):
    """Per planted family: a copy and an accepted interval overlap by 90%
    of each."""
    return [any(min(e, ae) - max(s, as_) >= 0.9 * (e - s)
                and min(e, ae) - max(s, as_) >= 0.9 * (ae - as_)
                for s, e in copies for as_, ae in accepted)
            for _f, copies in sorted(truth.items())]


# codons that translate back to each amino acid (X as alanine)
SAFE_CODON = {"A": "GCA", "R": "CGA", "N": "AAC", "D": "GAC", "C": "TGC",
              "Q": "CAA", "E": "GAA", "G": "GGA", "H": "CAC", "I": "ATC",
              "L": "CTA", "K": "AAA", "M": "ATG", "F": "TTC", "P": "CCA",
              "S": "TCA", "T": "ACA", "W": "TGG", "Y": "TAC", "V": "GTA",
              "X": "GCA"}


def rescue_scenario(device):
    """The low-copy domain rescue of tests/test_rescue.py: the TIRPeps
    entry nearest 160 aa planted whole into a 20 kbp random genome, one
    low-copy candidate around it and one random.  Returns (rescued count,
    accepted intervals, low-copy intervals left)."""
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.ops.protein import decode_protein
    from hite_tpu_torch.pipeline.candidates import CandidateSet
    from hite_tpu_torch.pipeline.domain import read_protein_fasta
    from hite_tpu_torch.pipeline.run import DATA_DIR, _rescue_low_copy
    from hite_tpu_torch.pipeline.verify import ModuleResult

    lib = read_protein_fasta(os.path.join(DATA_DIR, "protein",
                                          "TIRPeps.lib"))
    _n, prot = min(lib.items(), key=lambda kv: abs(len(kv[1]) - 160))
    dom = _codes("".join(SAFE_CODON[c] for c in decode_protein(prot)))
    bg = np.random.default_rng(0).integers(0, 4, 20_000).astype(np.uint8)
    bg[5_000 : 5_000 + len(dom)] = dom
    genome = Genome.from_dict({"chr1": bg}, device=device)
    mod = ModuleResult(
        accepted=CandidateSet(intervals=np.zeros((0, 2), np.int64)),
        consensus=[], copy_counts=[],
        low_copy=CandidateSet(intervals=np.array(
            [[4_900, 5_000 + len(dom) + 100], [12_000, 12_600]])))
    n = _rescue_low_copy(genome, PipelineConfig(), tir=mod)
    return (n, mod.accepted.intervals.tolist(),
            mod.low_copy.intervals.tolist())


# the CNNs' logits, cuda against the CPU, within the tolerances the tests
# hold them to against flax (both sides bf16 arithmetic, rounded at
# different points): decisions must be equal
LTR_CNN_TOL = 0.08
SF_CNN_TOL = 0.02


def check_cnns() -> dict:
    """Both CNNs with the bundled parameters on seeded frame-like images
    and feature vectors, on cuda and on the CPU: logits within the
    tolerance, the same argmax and p >= 0.5 decisions.  Also each one's
    forward time on the card (CUDA events)."""
    from hite_tpu_torch.models import bundled_model_path
    from hite_tpu_torch.models.classifier import SuperfamilyCNN
    from hite_tpu_torch.models.convert import load_model
    from hite_tpu_torch.models.features import FEATURE_DIM
    from hite_tpu_torch.models.ltr_filter import LTRFilterCNN

    rng = np.random.default_rng(41)
    M = rng.integers(0, 6, (16, 100, 400))
    img = np.stack([M >= 4, rng.random(M.shape) < 0.5,
                    np.where(M < 4, (M + 1) / 4, 0)], -1).astype(np.float32)
    f = rng.random((16, 512)).astype(np.float32)
    f /= f.sum(1, keepdims=True) / 2
    km = f.reshape(16, 2, 16, 16).transpose(0, 2, 3, 1).copy()
    X = rng.random((64, FEATURE_DIM)).astype(np.float32)
    X[:, :1024] /= 512
    X[:, 1024:1664] /= 30
    out = {}
    for cls, name, inputs, tol in (
            (LTRFilterCNN, "ltr_filter_cnn.pkl", (img, km), LTR_CNN_TOL),
            (SuperfamilyCNN, "superfamily_cnn.pkl", (X,), SF_CNN_TOL)):
        logits, ms = {}, None
        for dev in ("cuda", "cpu"):
            model = load_model(cls, bundled_model_path(name), dev)
            xs = [torch.from_numpy(x).to(dev) for x in inputs]
            with torch.no_grad():
                logits[dev] = model(*xs).cpu().numpy()
                if dev == "cuda":
                    ms = cuda_ms(lambda: model(*xs), 10)
        g, c = logits["cuda"], logits["cpu"]
        err = float(np.abs(g - c).max())
        prob = lambda z: np.exp(z[:, 1] - z.max(1)) / np.exp(
            z - z.max(1, keepdims=True)).sum(1)
        same = (np.array_equal(g.argmax(1), c.argmax(1))
                and (cls is not LTRFilterCNN
                     or np.array_equal(prob(g) >= 0.5, prob(c) >= 0.5)))
        print(f"cnn {cls.__name__} (bundled, batch {len(inputs[0])}): cuda "
              f"vs cpu max |logit diff| {err:.5f} (tolerance {tol}); "
              f"decisions {'equal' if same else 'DIFFER'}; forward "
              f"{ms:.3f} ms on the card")
        assert err <= tol and same, (cls.__name__, err)
        out[cls.__name__] = dict(max_abs_err=err, tol=tol, ms=ms)
    return out


def ltr6_genome(n_copies=7, length=120_000, seed=61):
    """A random genome with one LTR family (300 bp TG...CA LTRs, 2 kbp
    interior, 1% mutations, 5 bp TSDs) planted `n_copies` times, so that
    its records have more than 5 copies and reach the LTR CNN; the tests
    run the JAX package against the port on it.  Returns (codes,
    [(start, end)] of each copy)."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 4, length).astype(np.uint8)
    lt = rng.integers(0, 4, 300).astype(np.uint8)
    lt[0], lt[1], lt[-2], lt[-1] = 3, 2, 1, 0
    te = np.concatenate([lt, rng.integers(0, 4, 2000).astype(np.uint8), lt])
    starts = [5_000 + 15_000 * i + int(rng.integers(0, 3000))
              for i in range(n_copies)]
    for pos in starts:
        copy = te.copy()
        muts = rng.random(len(copy)) < 0.01
        copy[muts] = (copy[muts] + rng.integers(1, 4, muts.sum())) % 4
        tsd = rng.integers(0, 4, 5).astype(np.uint8)
        bg[pos - 5: pos] = tsd
        bg[pos + len(copy): pos + len(copy) + 5] = tsd
        bg[pos: pos + len(copy)] = copy
    return bg, [(s, s + len(te)) for s in starts]


def check_ltr6() -> dict:
    """Stages 1-4 on `ltr6_genome` on cuda and on the CPU: equal in every
    stage; a forward hook (here, not in the package) counts the LTR CNN's
    forwards, which must be at least one on each device."""
    from hite_tpu_torch.models.ltr_filter import LTRFilterCNN

    bg, truth = ltr6_genome()
    forwards = {"n": 0}

    def hook(module, _inp, _out):
        forwards["n"] += isinstance(module, LTRFilterCNN)

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    runs, cnn = {}, {}
    try:
        for dev in ("cuda", "cpu"):
            forwards["n"] = 0
            runs[dev] = main_path(bg, dev)
            cnn[dev] = forwards["n"]
    finally:
        handle.remove()
    same_modules(runs["cuda"], runs["cpu"])
    same_stages_3_4(runs["cuda"], runs["cpu"])
    recs = runs["cuda"]["ltr"].records
    found = found_families({0: truth}, [(r.start, r.end) for r in recs])
    print(f"ltr6 genome ({len(bg)} bp, 7 LTR copies), stages 1-4: cuda == "
          f"cpu; LTR CNN forwards cuda {cnn['cuda']}, cpu {cnn['cpu']}; "
          f"records {[(r.start, r.end, r.copy_count, r.superfamily) for r in recs]}; "
          f"library {sorted(runs['cuda']['libs']['merged'])}")
    assert cnn["cuda"] >= 1 and cnn["cpu"] >= 1, "the LTR CNN never ran"
    assert all(found), "the planted LTR family was not found"
    return dict(cnn_forwards=cnn, records=len(recs),
                library=sorted(runs["cuda"]["libs"]["merged"]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    report = {}
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"devices {torch.cuda.device_count()}")
    report["card"] = card
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- build
    t0 = time.perf_counter()
    secs = kernels.build(force=True)
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s total; "
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    report["build_s"] = build_s
    assert native_rt.available(), "native chain library did not load"
    sass, nregs = sass_per_cell(kernels._lib_path("sw"),
                                kernels.BUILD_LOG["sw"])
    tag = {k: f"R{k[0]}_{'packed' if k[1] else 'unpacked'}_"
              f"{'banded' if k[2] else 'one'}{'_protein' if k[3] else ''}"
           for k in sass}
    report["sass_per_cell"] = {tag[k]: n for k, n in sass.items()}
    report["registers"] = {tag[k]: n for k, n in nregs.items()}
    assert {k[:3] for k in sass if k[3]} == {
        (R, True, bd) for R in terminal.SW_ROWS for bd in (False, True)}, \
        "protein mode: packed R 4 and 8, one band and banded"
    nuc = {k[:3]: (nregs[k], sass[k]) for k in sass if not k[3]}
    changed = {k: (v, NUCLEOTIDE_RECORDED.get(k)) for k, v in nuc.items()
               if v != NUCLEOTIDE_RECORDED.get(k)}
    print("build: nucleotide instantiations' registers / step-loop SASS a "
          "cell " + ("equal PERF.md's" if not changed else
                     f"differ from PERF.md's: {changed}"))
    report["nucleotide_vs_recorded"] = {str(k): v
                                        for k, v in changed.items()}

    # ---- SW kernel vs plain, listed shapes, borders and forced variants
    rows = []
    for i, (label, B, La, Lb, nf) in enumerate(SW_SHAPES):
        a, b = sw_inputs(B, La, Lb, nf, seed=100 + i)
        reps = 20 if La * Lb * B < 1 << 28 else 5
        rows.append(check_sw(label, a, b, reps, sass))
    borders = []
    for i, (label, B, La, Lb, nf, R, packed, at) in enumerate(SW_BORDERS):
        a, b = sw_inputs(B, La, Lb, nf, seed=200 + i, best_at=at)
        borders.append(check_sw(label, a, b, 10, sass, R, packed, at))
    # zero-alignment rows: every code N -> qs = qe = ss = se = 1, score 0;
    # and empty widths -> all zeros, in each variant
    a = torch.full((4, 40), 4, dtype=torch.uint8, device="cuda")
    for R, packed in ((None, None), (8, None), (None, False)):
        zero = [int(f[0]) for f in sw(a, a.clone(), R, packed)]
        assert zero == [0, 1, 1, 1, 1, 0, 0], zero
    e = torch.empty((3, 0), dtype=torch.uint8, device="cuda")
    for x, y in ((e, a[:3]), (a[:3], e)):
        ref = terminal.batched_local_align(x, y)
        assert all(torch.equal(g, r) for g, r in zip(sw(x, y), ref)), \
            f"empty width {tuple(x.shape)} x {tuple(y.shape)}"
    variants = {(r["plan"]["nb"] > 1, r["plan"]["packed"]) for r in
                rows + borders}
    assert variants == {(False, True), (True, True), (False, False),
                        (True, False)}, variants
    report["sw_shapes"] = rows
    report["sw_borders"] = borders
    print("kernels: sw (cuda, hite_tpu_torch/csrc/sw.cu) built, launched, "
          f"bit-exact at {len(rows)} shapes and {len(borders)} border "
          "shapes in every variant (lane groups / bands x packed / "
          "unpacked)")

    # ---- rows a lane: each R at the callers' shapes, against the plan's
    # pick, by device time (events where the profiler saw no kernel)
    sweep = {}
    for i, (B, La, Lb) in enumerate(SW_SWEEP):
        a, b = sw_inputs(B, La, Lb, 0.0, seed=300 + i)
        reps = 10 if La * Lb * B < 1 << 28 else 3
        t = {}
        for R in terminal.SW_ROWS:
            dev_ms, ms = sw_device_ms(a, b, reps, R)
            t[R] = dev_ms or ms
        pick = terminal.sw_plan(La, Lb).R
        sweep[f"{B}x{La}x{Lb}"] = dict(ms=t, plan_R=pick)
        print(f"sw sweep B={B} {La}x{Lb}: " + "  ".join(
            f"R={R} {v:.4f} ms" for R, v in t.items())
            + f"  (plan picks R={pick}, {t[pick] / min(t.values()):.3f} x "
            "the fastest)")
    report["sw_sweep"] = sweep

    # ---- protein mode (BLOSUM62 from the 32 x 32 shared-memory table)
    # against the plain version: the domain confirm's shapes and borders
    prot_rows = []
    for i, (label, B, L) in enumerate(PROTEIN_SHAPES):
        a, b = protein_inputs(B, L, L, 0.0, seed=400 + i)
        row = check_sw(label, a, b, 20, sass, protein=True)
        # the table's cost: the nucleotide mode at the same shape and plan
        a, b = sw_inputs(B, L, L, 0.0, seed=400 + i)
        dev_ms, ms = sw_device_ms(a, b, 20)
        row["nucleotide_ms"] = dev_ms or ms
        print(f"sw_protein {label}: nucleotide mode at the same shape "
              f"{row['nucleotide_ms']:.4f} ms; protein / nucleotide "
              f"{row['ms'] / row['nucleotide_ms']:.3f}")
        prot_rows.append(row)
    prot_borders = []
    for i, (label, B, La, Lb, xf, R, at) in enumerate(PROTEIN_BORDERS):
        a, b = protein_inputs(B, La, Lb, xf, seed=500 + i, best_at=at)
        prot_borders.append(check_sw(label, a, b, 10, sass, R=R,
                                     best_at=at, protein=True))
    a = torch.full((4, 64), AA_X, dtype=torch.uint8, device="cuda")
    for R in terminal.SW_ROWS:
        zero = [int(f[0]) for f in sw(a, a.clone(), R, protein=True)]
        assert zero == [0, 1, 1, 1, 1, 0, 0], zero
    variants = {(r["plan"]["R"], r["plan"]["nb"] > 1)
                for r in prot_rows + prot_borders}
    assert variants == {(R, bd) for R in terminal.SW_ROWS
                        for bd in (False, True)}, variants
    report["sw_protein_shapes"] = prot_rows
    report["sw_protein_borders"] = prot_borders
    print("kernels: sw_protein (cuda, hite_tpu_torch/csrc/sw.cu, protein "
          f"mode) bit-exact at {len(prot_rows)} shapes and "
          f"{len(prot_borders)} border shapes, R 4 and 8, one band and "
          "banded")

    # ---- the TIR path at 8 Mbp on cuda (cold: the first path run)
    length = 8_000_000
    bg, truth = build_bench_genome(length)
    print(f"tir path: bench substrate {length} bp, seed 7, clean")
    hlog.STAGE_TIMES.clear()
    hlog.COUNTERS.clear()
    native_rt.CALLS["fmea_chain"] = 0
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    genome, coarse, res = tir_path(bg, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    chain_calls = native_rt.CALLS["fmea_chain"]
    stages = dict(hlog.STAGE_TIMES)
    for k, v in stages.items():
        print(f"tir path stage {k}: {v:.3f} s")
    acc = res.accepted.intervals
    print(f"tir path: wall {wall:.2f} s; coarse candidates {len(coarse)}; "
          f"gated {hlog.COUNTERS.get('tir.gated', 0)}; "
          f"accepted families {len(acc)}; copy counts {res.copy_counts}; "
          f"low-copy {len(res.low_copy)}; sw launches {launches['sw']}; "
          f"native chain calls {chain_calls}")
    assert genome.device.type == "cuda"
    assert all(t.is_cuda for v in genome._device_cache.values()
               for t in (v if isinstance(v, tuple) else (v,)))
    assert launches["sw"] > 0, "the TIR path never launched the SW kernel"
    assert chain_calls > 0, "the TIR path never used the native chaining"
    found = found_families(truth["TIR"], acc)
    print(f"tir path: planted TIR families accepted {found}")
    assert all(found), "a planted TIR family was not accepted"
    report["tir_path"] = dict(bp=length, wall_s=wall, stages=stages,
                              coarse=len(coarse), accepted=acc.tolist(),
                              copy_counts=res.copy_counts,
                              low_copy=len(res.low_copy),
                              launches=launches, chain_calls=chain_calls,
                              counters=dict(hlog.COUNTERS))
    del genome

    # ---- the main path: stages 1-4 (modules, rescue, LTR, library) at 8 Mbp
    print(f"main path: bench substrate {length} bp, seed 7, default config "
          "(te_type all, FiLTR LTR, neural labels), stages 1-4")
    hlog.STAGE_TIMES.clear()
    hlog.COUNTERS.clear()
    native_rt.CALLS["fmea_chain"] = 0
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = main_path(bg, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    shapes = {k: dict(v) for k, v in kernels.LAUNCH_SHAPES.items()}
    chain_calls = native_rt.CALLS["fmea_chain"]
    stages = dict(hlog.STAGE_TIMES)
    for k, v in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"main path stage {k}: {v:.3f} s")
    assert run["genome"].device.type == "cuda"
    fams = {"tir": "TIR", "helitron": "Helitron", "non_ltr": "SINE"}
    mod_report, all_found = {}, {}
    for k, m in run["mods"].items():
        accepted = m.accepted.intervals
        labels = m.accepted.meta.get("te_type")
        found = found_families(truth[fams[k]], accepted)
        all_found[fams[k]] = found
        print(f"main path {k}: accepted {len(accepted)} families, copy "
              f"counts {m.copy_counts}; low-copy {run['low'][k]} before the "
              f"rescue, {len(m.low_copy)} after; planted {fams[k]} "
              f"families accepted {found}"
              + (f"; labels {sorted(set(labels.tolist()))}"
                 if labels is not None else ""))
        mod_report[k] = dict(accepted=accepted.tolist(),
                             copy_counts=m.copy_counts, low_copy=run["low"][k],
                             low_copy_after=len(m.low_copy), found=found)
    records = run["ltr"].records
    for r in records:
        print(f"main path LTR record {r.start}-{r.end} LTRs "
              f"{r.lltr_end - r.lltr_start}/{r.rltr_end - r.rltr_start} bp "
              f"identity {r.identity:.4f} TSD {r.tsd_len} copies "
              f"{r.copy_count} {r.superfamily}")
    all_found["LTR"] = found_families(truth["LTR"],
                                      [(r.start, r.end) for r in records])
    pools = {k: len(v) for k, v in run["ltr"].cross_class.items()}
    classes = library_classes(run["libs"])
    print(f"main path: LTR records {len(records)}, planted LTR families "
          f"found {all_found['LTR']}; cross-class pools {pools}; library "
          f"{len(run['libs']['merged'])} merged entries, classes {classes}")
    print(f"main path: wall {wall:.2f} s; coarse candidates "
          f"{len(run['coarse'])}; rescued {run['rescued']}; sw launches "
          f"{launches['sw']} at {shapes['sw']}; sw_protein launches "
          f"{launches['sw_protein']} at {shapes['sw_protein']}; native "
          f"chain calls {chain_calls}")
    assert all(all(v) for v in all_found.values()), \
        f"a planted family was not found: {all_found}"
    assert {"DNA", "RC", "SINE", "LTR"} <= set(classes), classes
    assert launches["sw"] > 0, "the main path never launched sw"
    assert launches["sw_protein"] > 0, \
        "the main path never launched the protein mode"
    report["main_path"] = dict(
        bp=length, wall_s=wall, stages=stages, coarse=len(run["coarse"]),
        modules=mod_report, rescued=run["rescued"],
        ltr_records=[(r.start, r.end, r.lltr_end, r.rltr_start,
                      r.identity, r.tsd_len, r.copy_count, r.superfamily)
                     for r in records],
        cross_class=pools, library=sorted(run["libs"]["merged"]),
        launches=launches,
        launch_shapes={k: {str(s): n for s, n in v.items()}
                       for k, v in shapes.items()},
        chain_calls=chain_calls, counters=dict(hlog.COUNTERS))
    del run

    # each kernel at the main path's own shapes (these launches are not
    # counted): sw with nucleotide inputs, sw_protein with amino acids
    main_rows = {"sw": [], "sw_protein": []}
    for kname, protein in (("sw", False), ("sw_protein", True)):
        for (B, La, Lb), n in sorted(shapes[kname].items(),
                                     key=lambda x: -x[1]):
            if protein:
                a, b = protein_inputs(B, La, Lb, 0.0, seed=B + La)
            else:
                a, b = sw_inputs(B, La, Lb, 0.0, seed=B + La)
            main_rows[kname].append(dict(
                check_sw(f"main_B{B}_{La}x{Lb}", a, b, 50, sass,
                         protein=protein),
                launches=n))
    report["sw_main_shapes"] = main_rows

    # ---- the main path again, warm, under the profiler: device busy
    hlog.STAGE_TIMES.clear()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        main_path(bg, "cuda")
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
    # device-side kernel events only (operator rows repeat their kernels'
    # time); one stream, so kernel times do not overlap
    avg = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in avg)
    top = sorted(avg, key=lambda e: -e.self_device_time_total)[:10]
    warm_stages = dict(hlog.STAGE_TIMES)
    for k, v in sorted(warm_stages.items(), key=lambda kv: -kv[1]):
        print(f"main path warm stage {k}: {v:.3f} s")
    if busy_us > 0:
        print(f"main path warm (profiled): wall {warm:.2f} s; device "
              f"busy {busy_us / 1e6:.3f} s = {busy_us / 1e4 / warm:.1f}% of "
              "wall")
        for e in top:
            print(f"  device {e.self_device_time_total / 1e3:9.2f} ms  "
                  f"{e.count:7d} calls  {e.key[:70]}")
    else:
        print(f"main path warm (profiled): wall {warm:.2f} s; device "
              "busy not measured (the profiler saw no device time)")
    report["main_path_warm"] = dict(
        wall_s=warm, device_busy_s=busy_us / 1e6, stages=warm_stages,
        top_device_ops=[(e.key, e.self_device_time_total / 1e3, e.count)
                        for e in top])
    del prof, bg

    # ---- both CNNs with the bundled parameters, cuda against the CPU
    report["cnn"] = check_cnns()

    # ---- device vs CPU on small genomes (the CPU path is held against the
    # JAX package by the tests): the TIR path, the modules path with the
    # rescue, the rescue of a planted TIRPeps entry, and stages 1-4 on a
    # genome whose LTR family has 7 copies (the LTR CNN confirm runs)
    small = small_genome()
    _g, c_gpu, r_gpu = tir_path(small, "cuda")
    _g, c_cpu, r_cpu = tir_path(small, "cpu")
    assert np.array_equal(c_gpu, c_cpu)
    assert np.array_equal(r_gpu.accepted.intervals, r_cpu.accepted.intervals)
    assert r_gpu.copy_counts == r_cpu.copy_counts
    assert all(np.array_equal(x, y) for x, y in zip(r_gpu.consensus,
                                                    r_cpu.consensus))
    assert len(r_gpu.accepted) >= 1
    print(f"small tir path: cuda == cpu; {len(c_gpu)} candidates, accepted "
          f"{r_gpu.accepted.intervals.tolist()} copies {r_gpu.copy_counts}")
    small = small_modules_genome()
    on_gpu = modules_path(small, "cuda")
    on_cpu = modules_path(small, "cpu")
    same_modules(on_gpu, on_cpu)
    assert all(len(m.accepted) >= 1 for m in on_gpu["mods"].values())
    print(f"small modules path ({len(small)} bp): cuda == cpu; "
          f"{len(on_gpu['coarse'])} candidates; " + "; ".join(
              f"{k} accepted {m.accepted.intervals.tolist()} copies "
              f"{m.copy_counts}" for k, m in on_gpu["mods"].items())
          + f"; low-copy {on_gpu['low']}, rescued {on_gpu['rescued']}")
    kernels.reset_launches()
    res = {dev: rescue_scenario(dev) for dev in ("cuda", "cpu")}
    assert kernels.LAUNCHES["sw_protein"] > 0, \
        "the planted-domain rescue never launched the protein mode"
    assert res["cuda"] == res["cpu"] and res["cuda"][0] == 1, res
    print(f"planted-domain rescue (20 kbp, one TIRPeps entry): cuda == cpu; "
          f"rescued {res['cuda'][0]} of 2 low-copy candidates, "
          f"{kernels.LAUNCHES['sw_protein']} sw_protein launches")
    report["ltr6"] = check_ltr6()

    # ---- kernel line: main-path-weighted time of each kernel (device time
    # from the profiler where it saw the kernel, else the event time) and
    # of the bound (the recurrence's int32 operations at the int32 rate)
    entries = []
    for kname, replaces, checks in (
            ("sw", "hite_tpu/ops/terminal_pallas.py:47", rows + borders),
            ("sw_protein", "hite_tpu/ops/terminal.py:157",
             prot_rows + prot_borders)):
        mr = main_rows[kname]
        tot = sum(r["launches"] for r in mr)
        wavg = lambda key: sum(r[key] * r["launches"] for r in mr) / tot
        entries.append({
            "name": kname, "route": "cuda",
            "source": "hite_tpu_torch/csrc/sw.cu", "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in checks + mr),
            "ms": wavg("ms"), "plain_ms": wavg("plain_ms"),
            "bound_ms": wavg("bound_ms"),
            "bound_by": max(mr, key=lambda r: r["launches"])["bound_by"],
            "library_ms": None})
    kline = {"kernels": entries}
    report["kernel_line"] = kline
    os.makedirs("smoke_out", exist_ok=True)
    with open(os.path.join("smoke_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1, default=float)
    print(json.dumps(kline))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
