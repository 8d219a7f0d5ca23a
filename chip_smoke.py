"""Smoke run of hite_tpu_torch on one NVIDIA GPU: python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every CUDA kernel and the host chaining library, from the
     sources in this checkout, all compilers at once;
  3. the SW kernel against its plain PyTorch version on the card, bit-exact
     on all 7 outputs, at the TIR gate, annotation, LTR and longer widths,
     a ragged batch and N-heavy rows; kernel ms (CUDA events), plain ms,
     and the bound from the cell count;
  4. the TIR discovery path at the headline size (the 8 Mbp clean bench
     substrate, seed 7) on cuda, with the launch counts zeroed just before
     and read just after; the 3 planted TIR families must be accepted; and
     the same path on a 160 kbp genome on cuda and on the CPU, which must
     agree exactly;
  5. the kernel line, the card line, and the result line (last).

Exits non-zero, printing no result, without a GPU or outside a checkout.
Detailed numbers go to smoke_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from hite_tpu_torch import kernels
from hite_tpu_torch.native import runtime as native_rt
from hite_tpu_torch.ops import terminal
from hite_tpu_torch.utils import log as hlog

# published H100 SXM peaks: HBM bytes/s, and the
# non-tensor-core 32-bit rate, used here for the SW kernel's int32 ALU work
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
SW_OPS_PER_CELL = 30

SW_SHAPES = [  # (label, B, La, Lb, n_frac)
    ("tir_gate", 4096, 40, 40, 0.0),
    ("w1024", 64, 1024, 1024, 0.0),
    ("annotation_w4096", 32, 4096, 4096, 0.0),
    ("ltr_w8192", 8, 8192, 8192, 0.0),
    ("w16384", 2, 16384, 16384, 0.0),
    ("ragged", 1001, 37, 53, 0.0),
    ("n_heavy", 256, 300, 300, 0.4),
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sw_inputs(B, La, Lb, n_frac, seed):
    """Random codes with a planted shared core per row, N blocks and (for
    N-heavy inputs) all-N rows; uint8 on the card."""
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
    if n_frac:
        a[rng.random((B, La)) < n_frac] = 4
        b[rng.random((B, Lb)) < n_frac / 2] = 4
        a[::7] = 4
        b[3::11] = 4
    dev = torch.device("cuda")
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


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


def sw_bound_ms(B, La, Lb):
    """Least time for the work: each input byte read once and 7 int32
    outputs written once, or SW_OPS_PER_CELL int32 ops per DP cell."""
    t_bytes = (B * (La + Lb) + 7 * 4 * B) / PEAK_BYTES_S
    t_ops = SW_OPS_PER_CELL * B * La * Lb / PEAK_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def check_sw(label, a, b, reps):
    """Kernel vs plain on the same inputs: bit-exact on all 7 outputs."""
    B, La = a.shape
    Lb = b.shape[1]
    got = terminal._sw_cuda(a, b, match=2, mismatch=-3, gap=4, invalid_code=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = terminal.batched_local_align(a, b)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
              for g, r in zip(got, ref))
    if err != 0:
        bad = [f for f, g, r in zip(terminal.LocalAlign._fields, got, ref)
               if not torch.equal(g, r)]
        raise AssertionError(f"sw kernel != plain at {label}: fields {bad}")
    ms = cuda_ms(lambda: terminal._sw_cuda(a, b, match=2, mismatch=-3,
                                           gap=4, invalid_code=4), reps)
    bound, by = sw_bound_ms(B, La, Lb)
    row = dict(shape=label, B=B, La=La, Lb=Lb, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=by,
               cells_per_s=B * La * Lb / (ms * 1e-3))
    print(f"sw {label}: B={B} {La}x{Lb} kernel {ms:.4f} ms  plain "
          f"{plain_ms:.1f} ms  bound {bound:.5f} ms ({by})  "
          f"{row['cells_per_s'] / 1e9:.2f} Gcell/s  exact")
    return row


def build_bench_genome(length: int):
    """The bench substrate (clean): planted TIR, Helitron, SINE and LTR
    families on a seed-7 random background.  Returns (flat codes,
    {TIR family index: [(start, end) of each planted copy]})."""
    rng = np.random.default_rng(7)
    bg = rng.integers(0, 4, length).astype(np.uint8)
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

    enc = {c: i for i, c in enumerate("ACGT")}
    codes = lambda s: np.array([enc[c] for c in s], np.uint8)
    tir = {}
    for f in range(3):
        n, interior = ((20, 460), (15, 900), (10, 1400))[f % 3]
        t = rng.integers(0, 4, 20).astype(np.uint8)
        while t[0] == 3 and t[1] == 2:
            t = rng.integers(0, 4, 20).astype(np.uint8)
        te = np.concatenate([t, rng.integers(0, 4, interior).astype(np.uint8),
                             (3 - t)[::-1]])
        tir[f] = [(s, s + len(te)) for s in plant(te, n, tsd=5)]
    for f in range(2):
        n, interior = ((8, 700), (8, 1200))[f % 2]
        te = np.concatenate([
            codes("TCTCTACTA"), rng.integers(0, 4, interior).astype(np.uint8),
            codes("CAATGAACG" + "ACGTACGTA" + "CTAGT")])
        plant(te, n, host_at=True)
    for f in range(2):
        n, interior = ((20, 280), (20, 420))[f % 2]
        te = np.concatenate([rng.integers(0, 4, interior).astype(np.uint8),
                             np.zeros(14, np.uint8)])
        plant(te, n, tsd=12)
    for f in range(4):
        n, ltr_len = ((4, 250), (4, 350), (4, 450), (4, 600))[f % 4]
        t = rng.integers(0, 4, ltr_len).astype(np.uint8)
        t[0], t[1], t[-2], t[-1] = 3, 2, 1, 0
        te = np.concatenate([t, rng.integers(0, 4, 2200).astype(np.uint8), t])
        plant(te, n, tsd=5, mut=0.01)
    return bg, tir


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


def tir_path(bg, device, params=None, cfg=None):
    """init_mask -> tandem mask -> coarse -> gindex -> modules_stage."""
    from hite_tpu_torch.config import PipelineConfig
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.pipeline.coarse import CoarseParams, coarse_discover
    from hite_tpu_torch.pipeline.copies import GenomeIndex
    from hite_tpu_torch.pipeline.run import _mask_tandem_regions, modules_stage
    from hite_tpu_torch.utils.log import stage_timer

    genome = Genome.from_dict({"chr1": bg}, device=device)
    cfg = (cfg or PipelineConfig(te_type="tir")).with_genome_size(genome.size)
    params = params or CoarseParams()
    genome.init_mask()
    with stage_timer("pipeline.tandem_mask"):
        _mask_tandem_regions(genome)
    with stage_timer("pipeline.coarse"):
        coarse = coarse_discover(genome, cfg.align, params)
    with stage_timer("pipeline.gindex"):
        gindex = GenomeIndex(genome, cfg.align, seg_len=params.seg_len)
    with stage_timer("pipeline.modules"):
        mods = modules_stage(genome, coarse, cfg, gindex)
    return genome, coarse, mods["tir"]


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
    for line in kernels.BUILD_LOG.get("sw", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: sw ptxas: {line.strip()}")
    report["build_s"] = build_s
    assert native_rt.available(), "native chain library did not load"

    # ---- SW kernel vs plain, listed shapes
    rows = []
    for i, (label, B, La, Lb, nf) in enumerate(SW_SHAPES):
        a, b = sw_inputs(B, La, Lb, nf, seed=100 + i)
        reps = 20 if La * Lb * B < 1 << 28 else 3
        rows.append(check_sw(label, a, b, reps))
    # zero-alignment rows: every code N -> qs = qe = ss = se = 1, score 0
    a = torch.full((4, 40), 4, dtype=torch.uint8, device="cuda")
    z = terminal._sw_cuda(a, a.clone(), match=2, mismatch=-3, gap=4,
                          invalid_code=4)
    zero = [int(f[0]) for f in z]
    assert zero == [0, 1, 1, 1, 1, 0, 0], zero
    report["sw_shapes"] = rows
    print("kernels: sw (cuda, hite_tpu_torch/csrc/sw.cu) built, launched, "
          f"bit-exact at {len(rows)} shapes")

    # ---- the TIR path at 8 Mbp on cuda
    length = 8_000_000
    bg, tir_truth = build_bench_genome(length)
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
    shapes = {k: dict(v) for k, v in kernels.LAUNCH_SHAPES.items()}
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
    found = []
    for f, copies in tir_truth.items():
        hit = any(min(e, ae) - max(s, as_) >= 0.9 * (e - s)
                  and min(e, ae) - max(s, as_) >= 0.9 * (ae - as_)
                  for s, e in copies for as_, ae in acc)
        found.append(hit)
    print(f"tir path: planted TIR families accepted {found}")
    assert all(found), "a planted TIR family was not accepted"
    report["tir_path"] = dict(bp=length, wall_s=wall, stages=stages,
                              coarse=len(coarse), accepted=acc.tolist(),
                              copy_counts=res.copy_counts,
                              low_copy=len(res.low_copy),
                              launches=launches, chain_calls=chain_calls,
                              counters=dict(hlog.COUNTERS))

    # kernel at the main path's own shapes (these launches are not counted)
    main_rows = []
    for (B, La, Lb), n in sorted(shapes["sw"].items(), key=lambda x: -x[1]):
        a, b = sw_inputs(B, La, Lb, 0.0, seed=B + La)
        main_rows.append(dict(check_sw(f"main_B{B}", a, b, 50), launches=n))
    report["sw_main_shapes"] = main_rows

    # ---- the same path again, warm, under the profiler: device busy share
    hlog.STAGE_TIMES.clear()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        tir_path(bg, "cuda")
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
    # device-side kernel events only (operator rows repeat their kernels'
    # time); one stream, so kernel times do not overlap
    avg = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in avg)
    top = sorted(avg, key=lambda e: -e.self_device_time_total)[:8]
    warm_stages = dict(hlog.STAGE_TIMES)
    if busy_us > 0:
        print(f"tir path warm (profiled): wall {warm:.2f} s; device busy "
              f"{busy_us / 1e6:.3f} s = {busy_us / 1e4 / warm:.1f}% of wall")
        for e in top:
            print(f"  device {e.self_device_time_total / 1e3:9.2f} ms  "
                  f"{e.count:7d} calls  {e.key[:70]}")
    else:
        print(f"tir path warm (profiled): wall {warm:.2f} s; device busy "
              "not measured (the profiler saw no device time)")
    report["tir_path_warm"] = dict(
        wall_s=warm, device_busy_s=busy_us / 1e6, stages=warm_stages,
        top_device_ops=[(e.key, e.self_device_time_total / 1e3, e.count)
                        for e in top])

    # ---- device vs CPU on a small genome (the CPU path is held against
    # the JAX package by the tests)
    small = small_genome()
    _g, c_gpu, r_gpu = tir_path(small, "cuda")
    _g, c_cpu, r_cpu = tir_path(small, "cpu")
    assert np.array_equal(c_gpu, c_cpu)
    assert np.array_equal(r_gpu.accepted.intervals, r_cpu.accepted.intervals)
    assert r_gpu.copy_counts == r_cpu.copy_counts
    assert all(np.array_equal(x, y) for x, y in zip(r_gpu.consensus,
                                                    r_cpu.consensus))
    assert len(r_gpu.accepted) >= 1
    print(f"small path: cuda == cpu; {len(c_gpu)} candidates, accepted "
          f"{r_gpu.accepted.intervals.tolist()} copies {r_gpu.copy_counts}")

    # ---- kernel line: main-path-weighted time of the kernel
    tot = sum(r["launches"] for r in main_rows)
    wavg = lambda key: sum(r[key] * r["launches"] for r in main_rows) / tot
    bound_by = max(main_rows, key=lambda r: r["launches"])["bound_by"]
    kline = {"kernels": [{
        "name": "sw", "route": "cuda", "source": "hite_tpu_torch/csrc/sw.cu",
        "replaces": "hite_tpu/ops/terminal_pallas.py:47",
        "launches": launches["sw"],
        "max_abs_err": max(r["max_abs_err"] for r in rows + main_rows),
        "ms": wavg("ms"), "plain_ms": wavg("plain_ms"),
        "bound_ms": wavg("bound_ms"), "bound_by": bound_by,
        "library_ms": None}]}
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
