"""The mesh path end to end, each sharded result held against the
unsharded one (the port's counterpart of `__graft_entry__.py`'s
`dryrun_multichip` and `pipeline_parity`):

1. coarse discovery on a 300 kbp synthetic genome (two planted families)
   with `max_selfjoin_bp = 2^17`, so the self-join runs as chunks sharded
   over "dp": the candidates equal the single path's;
2. annotation of that genome with its two families: the hits equal;
3. one LTR-filter training step (batch 2 x dp, 32 x 64 frames) sharded
   over the mesh from the same parameters as the unsharded step: the
   loss, the whole gradient and the parameters within `TRAIN_TOL`;
4. `run_pipeline(mesh=...)` on the 160 kbp `pipeline_parity` genome
   (planted TIR, SINE and LTR families; annotation on): every output
   file byte-equal to the unsharded run's.

    python -m hite_tpu_torch.scripts.dryrun_multichip [--n_devices 8] \
        [--repeat_device cuda:0] [--device cpu]

Without `--repeat_device` the mesh takes the first n cards and raises
when there are fewer; `--repeat_device D` builds it from n shards of D
(one card, or `cpu`).  Prints one JSON line with the mesh and the
counts.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hite_tpu_torch.config import AlignConfig, PipelineConfig
from hite_tpu_torch.device import resolve_device
from hite_tpu_torch.genome import Genome, synthetic_genome
from hite_tpu_torch.parallel.mesh import Mesh, make_mesh

# sharded vs unsharded training step (module doc of models/train.py):
# the layers' bf16 casts round each shard's gradient to bf16 where the
# unsharded step rounds the batch's once, so the summed gradient moves by
# ~2^-8 relative (more on a leaf whose shards' gradients cancel);
# AdamW's first step is +-lr wherever |g| >> eps, so the few elements
# whose gradient nearly cancels may step the other way (at most 2 lr).
# Measured on the CPU (dp 2-8, B 2 dp and 16, seeds 0-3): loss <= 1.8e-7
# relative, the whole gradient's relative L2 <= 0.0064 (one leaf's up to
# 0.040), <= 0.65% of the parameters moved by more than 1e-6, none by
# more than 2 lr.
TRAIN_TOL = dict(loss_rel=1e-5, grad_rel_l2=0.02, moved_frac=0.02,
                 moved_abs=1e-6)
LR = 1e-3


def parity_genome() -> np.ndarray:
    """The 160 kbp genome of `__graft_entry__.pipeline_parity` (seed 23):
    6 TIR copies with 5 bp TSDs, 6 SINE copies with 12 bp TSDs, 3 LTR
    copies (1,500 bp interiors between 250 bp TG...CA LTRs)."""
    rng = np.random.default_rng(23)
    bg = rng.integers(0, 4, 160_000).astype(np.uint8)

    def plant(te, starts, tsd=0):
        for pos in starts:
            copy = te.copy()
            muts = rng.random(len(copy)) < 0.01
            copy[muts] = (copy[muts] + rng.integers(1, 4, muts.sum())) % 4
            if tsd:
                t = rng.integers(0, 4, tsd).astype(np.uint8)
                bg[pos - tsd : pos] = t
                bg[pos + len(copy) : pos + len(copy) + tsd] = t
            bg[pos : pos + len(copy)] = copy

    t = rng.integers(0, 4, 20).astype(np.uint8)
    while t[0] == 3 and t[1] == 2:
        t = rng.integers(0, 4, 20).astype(np.uint8)
    tir_te = np.concatenate([t, rng.integers(0, 4, 360).astype(np.uint8),
                             (3 - t)[::-1]])
    plant(tir_te, [10_000, 30_000, 50_000, 70_000, 90_000, 110_000], tsd=5)
    sine_te = np.concatenate([rng.integers(0, 4, 280).astype(np.uint8),
                              np.zeros(14, np.uint8)])
    plant(sine_te, [20_000, 40_000, 60_000, 80_000, 100_000, 120_000],
          tsd=12)
    lt = rng.integers(0, 4, 250).astype(np.uint8)
    lt[0], lt[1], lt[-2], lt[-1] = 3, 2, 1, 0
    ltr_te = np.concatenate([lt, rng.integers(0, 4, 1500).astype(np.uint8),
                             lt])
    plant(ltr_te, [130_000, 140_000, 150_000], tsd=5)
    return bg


PARITY_PARAMS = dict(seg_len=32_768, pair_batch=16, stride=4, max_hits=4,
                     max_selfjoin_bp=1 << 17)


def dryrun_genome(device) -> tuple:
    """(the 300 kbp genome, its two family sequences): 16 copies of a 400
    bp and 10 of a 900 bp random element, 2% mutated (seed 11)."""
    rng = np.random.default_rng(7)
    tes = ["".join("ACGT"[c] for c in rng.integers(0, 4, L))
           for L in (400, 900)]
    genome, _ = synthetic_genome(300_000, tes, [16, 10], seed=11,
                                 mutation_rate=0.02, device=device)
    return genome, tes


def ltr_batch(B: int, seed: int, height: int = 32, width: int = 64
              ) -> tuple:
    """(img [B, height, width, 3], kmer [B, 16, 16, 2], labels [B])
    float32 / int32 numpy arrays from `seed`."""
    rng = np.random.default_rng(seed)
    img = rng.random((B, height, width, 3)).astype(np.float32)
    km = rng.random((B, 16, 16, 2)).astype(np.float32)
    return img, km, rng.integers(0, 2, B).astype(np.int32)


def train_step_check(mesh: Mesh, device, B: Optional[int] = None,
                     height: int = 32, width: int = 64, seed: int = 0
                     ) -> Dict:
    """One LTR-filter step from the same (flax-default, seeded) parameters
    through the unsharded step on `device` and through `shard_train` on
    `mesh`, TF32 off (as every CNN comparison of the port); raises unless
    they agree within TRAIN_TOL.  Returns the measured differences."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train_step_check(mesh, device, B, height, width, seed)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _train_step_check(mesh: Mesh, device, B: Optional[int], height: int,
                      width: int, seed: int) -> Dict:
    from hite_tpu_torch.models.convert import reset_parameters
    from hite_tpu_torch.models.ltr_filter import LTRFilterCNN
    from hite_tpu_torch.models.train import (
        adamw, cross_entropy, shard_train,
    )

    dev = resolve_device(device)
    B = B or 2 * mesh.shape["dp"]
    img, km, y = ltr_batch(B, seed, height, width)
    model = reset_parameters(LTRFilterCNN(),
                             torch.Generator().manual_seed(seed)).to(dev)
    sharded = shard_train(mesh, model, adamw(model, LR))
    batch = {"inputs": (torch.from_numpy(img).to(dev),
                        torch.from_numpy(km).to(dev)),
             "labels": torch.from_numpy(y).to(dev)}
    # the unsharded step, its gradient kept
    model.train()
    opt = adamw(model, LR)
    loss = cross_entropy(model(*batch["inputs"]), batch["labels"])
    loss.backward()
    loss = loss.detach()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt.step()
    # the sharded step, its summed gradient read before AdamW
    seen: Dict[str, torch.Tensor] = {}

    def read_grads(_opt, _args, _kwargs):
        for n, parts in sharded.slices.items():
            d = sharded.dims[n]
            g = [t.grad.to(dev) for t in parts]
            seen[n] = g[0] if d is None else torch.cat(g, d)

    hook = sharded.optimizer.register_step_pre_hook(read_grads)
    s_loss = sharded(batch)
    hook.remove()
    loss_rel = abs(float(s_loss) - float(loss)) / abs(float(loss))
    diff2 = sum(float((seen[n] - g).square().sum())
                for n, g in grads.items())
    grad_rel = (diff2 / sum(float(g.square().sum())
                            for g in grads.values())) ** 0.5
    moved = 0
    worst = 0.0
    total = 0
    for n, p in model.named_parameters():
        diff = (sharded.full(n).to(dev) - p.detach()).abs()
        moved += int((diff > TRAIN_TOL["moved_abs"]).sum())
        worst = max(worst, float(diff.max()))
        total += p.numel()
    out = dict(batch=B, frames=[height, width], loss=float(loss),
               sharded_loss=float(s_loss), loss_rel=loss_rel,
               grad_rel_l2=grad_rel, moved_frac=moved / total,
               max_param_diff=worst,
               tp_sharded=sum(d is not None for d in sharded.dims.values()),
               params=len(sharded.dims))
    ok = (loss_rel <= TRAIN_TOL["loss_rel"]
          and grad_rel <= TRAIN_TOL["grad_rel_l2"]
          and moved / total <= TRAIN_TOL["moved_frac"]
          and worst <= 2 * LR + TRAIN_TOL["moved_abs"])
    if not ok:
        raise AssertionError(f"sharded training step off tolerance: {out}")
    return out


def pipeline_parity(mesh: Mesh, device, out_dir: str) -> Dict:
    """`run_pipeline` on the 160 kbp parity genome unsharded and on
    `mesh`, each into its own directory under `out_dir`; raises unless
    every output file but stage_times.json is byte-equal.  Returns the
    counts and the files compared."""
    from hite_tpu_torch.pipeline.coarse import CoarseParams
    from hite_tpu_torch.pipeline.run import run_pipeline

    bg = parity_genome()
    cfg = PipelineConfig(annotate=True, align=AlignConfig(
        fixed_extend_base_threshold=2000))
    runs = {}
    for name, m in (("single", None), ("mesh", mesh)):
        d = os.path.join(out_dir, name)
        g = Genome.from_dict({"chr1": bg.copy()}, device=device)
        runs[name] = run_pipeline(g, cfg, out_dir=d,
                                  coarse_params=CoarseParams(**PARITY_PARAMS),
                                  mesh=m)
    names = same_files(os.path.join(out_dir, "single"),
                       os.path.join(out_dir, "mesh"))
    res = runs["single"]
    if not res.libs.get("merged") or not res.annotation:
        raise AssertionError("the parity run found no library or no hits")
    return dict(files=names, library_entries=len(res.libs["merged"]),
                annotation_hits=len(res.annotation))


def same_files(a: str, b: str) -> list:
    """The file names of directory a, raising unless b holds the same
    names and every file but stage_times.json is byte-equal."""
    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)):
        raise AssertionError(f"{a} and {b} hold different files")
    for n in names:
        if n != "stage_times.json" and not filecmp.cmp(
                os.path.join(a, n), os.path.join(b, n), shallow=False):
            raise AssertionError(f"{n} differs between {a} and {b}")
    return [n for n in names if n != "stage_times.json"]


def dryrun_multichip(n_devices: int = 8,
                     devices: Optional[Sequence] = None,
                     device=None, out_dir: Optional[str] = None) -> Dict:
    """The four checks of the module doc on `make_mesh(n_devices,
    devices=devices)`, the genomes on `device` (None = the card);
    raises on any disagreement.  Returns the counts."""
    from hite_tpu_torch.pipeline.annotate import annotate_genome
    from hite_tpu_torch.pipeline.coarse import CoarseParams, coarse_discover

    dev = resolve_device(device)
    mesh = make_mesh(n_devices=n_devices, devices=devices)
    genome, tes = dryrun_genome(dev)
    acfg = AlignConfig(fixed_extend_base_threshold=2000)
    params = CoarseParams(max_selfjoin_bp=1 << 17)
    single = coarse_discover(genome, acfg, params, max_repeat_len=5_000)
    sharded = coarse_discover(genome, acfg, params, max_repeat_len=5_000,
                              mesh=mesh)
    if not (len(single) and np.array_equal(single, sharded)):
        raise AssertionError(f"coarse: sharded {len(sharded)} candidates, "
                             f"single {len(single)}")

    cfg = PipelineConfig(align=acfg)
    lib = {f"TE_{i}#Unknown": np.array(["ACGT".index(c) for c in te],
                                       np.uint8)
           for i, te in enumerate(tes)}
    key = lambda h: (h.contig, h.start, h.end, h.strand, h.family,
                     h.identity)
    hits_single = list(map(key, annotate_genome(genome, lib, cfg)))
    hits_sharded = list(map(key, annotate_genome(genome, lib, cfg,
                                                 mesh=mesh)))
    if not (hits_single and hits_single == hits_sharded):
        raise AssertionError(f"annotation: sharded {len(hits_sharded)} "
                             f"hits, single {len(hits_single)}")

    train = train_step_check(mesh, dev)
    with tempfile.TemporaryDirectory() as tmp:
        pp = pipeline_parity(mesh, dev, out_dir or tmp)
    return dict(mesh=mesh.shape, devices=[str(d) for d in
                                          mesh.devices.reshape(-1)],
                coarse_candidates=len(single),
                annotation_hits=len(hits_single), train_step=train,
                full_pipeline=pp)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m hite_tpu_torch.scripts.dryrun_multichip",
        description=__doc__.split("\n")[0])
    ap.add_argument("--n_devices", type=int, default=8)
    ap.add_argument("--repeat_device", default=None,
                    help="build the mesh from n shards of this device")
    ap.add_argument("--device", default=None,
                    help="the genomes' device (default: the card)")
    args = ap.parse_args(argv)
    devices = (None if args.repeat_device is None
               else [args.repeat_device] * args.n_devices)
    out = dryrun_multichip(args.n_devices, devices, args.device)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
