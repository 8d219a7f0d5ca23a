"""Scale run: the whole pipeline on a >= 100 Mbp genome.

Builds the bench substrate at `--mbp` Mbp with the family and copy counts
scaled by mbp // 8 (the TE density of the 8 Mbp substrate), runs
`run_pipeline` with annotation and stage snapshots on it (tandem mask ->
coarse -> TIR / Helitron / non-LTR -> rescue -> LTR -> library ->
annotation), and prints one JSON record with the keys of the JAX
package's `scripts/scale_run.py` (`compile_s` is the kernel build time;
`peak_device_gb` and the card line added).
At 100 Mbp the genome pads to 2^27 bp, so the chunked self-join, the
chunked copy join and the LTR chunk grid all run; the record's `chunks`
counts each.

    python -m hite_tpu_torch.scripts.scale_run [--mbp 100] [--out DIR]
        [--pack] [--build-only] [--device cpu]

`--pack` keeps the host genome 2-bit packed (automatic at >= 400 Mbp).
"""

from __future__ import annotations

import argparse
import json
import resource
import time
from typing import Optional

CHUNK_COUNTERS = ("coarse.selfjoin.chunks", "copies.join.chunks",
                  "ltr.candidates.chunks")


def run_config():
    """`PipelineConfig(annotate=True, recover=True)` with a 2000 bp fixed
    extension threshold, and `bench.py`'s coarse parameters."""
    from hite_tpu_torch.config import AlignConfig, PipelineConfig
    from hite_tpu_torch.pipeline.coarse import CoarseParams

    cfg = PipelineConfig(annotate=True, recover=True,
                         align=AlignConfig(fixed_extend_base_threshold=2000))
    params = CoarseParams(seg_len=262_144, pair_batch=64, stride=4,
                          max_hits=4)
    return cfg, params


def build(mbp: int, pack: bool = False, device=None):
    """(genome, truth, packed): the bench substrate at `mbp` Mbp, scale
    mbp // 8, its host arrays packed when asked or at >= 400 Mbp."""
    from hite_tpu_torch.scripts.pan_run import build_bench_genome

    genome, truth = build_bench_genome(mbp * 1_000_000,
                                       scale=max(1, mbp // 8), device=device)
    packed = pack or mbp >= 400
    if packed:
        genome.pack_host()
    return genome, truth, packed


def run(genome, truth, out_dir: str, packed: bool = False):
    """Run the pipeline on `genome` (on its device) and return (record,
    RunResult)."""
    import torch

    from hite_tpu_torch import kernels
    from hite_tpu_torch.ops.tandem import long_tandem_mask, tandem_mask
    from hite_tpu_torch.pipeline.run import run_pipeline
    from hite_tpu_torch.scripts.pan_run import accuracy_metrics, card_line
    from hite_tpu_torch.utils.log import COUNTERS, STAGE_TIMES

    dev = genome.device
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    kernels.build(None if on_card else list(kernels.HOST_SOURCES))
    compile_s = time.perf_counter() - t0
    # the first tandem-mask batch outside the timed window (the card's
    # context and the first launches of each op)
    warm = torch.zeros((16, 262_144), dtype=torch.uint8, device=dev)
    (tandem_mask(warm) | long_tandem_mask(warm)).cpu()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    cfg, params = run_config()
    STAGE_TIMES.clear()
    COUNTERS.clear()
    t0 = time.perf_counter()
    result = run_pipeline(genome, cfg, out_dir=out_dir, coarse_params=params)
    if on_card:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    length_mbp = genome.size / 1e6
    rec = {
        "metric": "scale_run",
        "genome_mbp": round(length_mbp),
        "wall_s": dt,
        "mbp_per_s": length_mbp / dt,
        "planted_copies": len(truth["intervals"]),
        "planted_families": len(truth["families"]),
        "library_entries": len(result.libs.get("merged", {})),
        "annotation_hits": result.metrics.get("annotation_hits"),
        "peak_rss_gb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2**20,
        "peak_device_gb": (torch.cuda.max_memory_allocated(dev) / 2**30
                           if on_card else None),
        "host_packed": packed,
        "compile_s": compile_s,
        "chunks": {k: COUNTERS.get(k, 0) for k in CHUNK_COUNTERS},
        "stages": {k: v for k, v in sorted(
            STAGE_TIMES.items(), key=lambda kv: -kv[1]) if v >= 1.0},
        "card": card_line() if on_card else None,
    }
    rec["accuracy"] = accuracy_metrics(genome, result, truth, cfg)
    return rec, result


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mbp", type=int, default=100)
    ap.add_argument("--out", default="scale_out")
    ap.add_argument("--pack", action="store_true",
                    help="keep the host genome 2-bit packed (automatic at "
                         ">= 400 Mbp)")
    ap.add_argument("--build-only", action="store_true",
                    help="build the genome and exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    genome, truth, packed = build(args.mbp, args.pack, args.device)
    print(f"built {args.mbp} Mbp genome, {len(truth['intervals'])} planted "
          f"copies, packed={packed} ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    if args.build_only:
        return
    rec, _result = run(genome, truth, args.out, packed)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
