"""The LTR filter's default retrain over many seeds: how often it leaves
the chance plateau, and from which init.

`pretrain_ltr_filter(seed=s)` at its defaults (400 synthetic frames, 8
epochs at batch 16) for each seed, from the port's own draw of flax's
init or, with `--init_dir`, from the flax parameter tree in
`DIR/ltr_filter_init_seed{s}.pkl` (the JAX package's
`LTRFilterCNN().init(key(s))`, as `python tests/test_torch_train.py
ltr-inits FIRST LAST DIR` writes it; `data/models/` holds seed 0):

    python -m hite_tpu_torch.scripts.ltr_seeds --seeds 0 31 \
        [--init_dir DIR] [--repeat 2] [--device cpu]

Prints the card's name and power limit, then one JSON line a run: the
seed, the init, the synthetic-eval accuracy, the loss by epoch and the
wall seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import torch

from hite_tpu_torch.device import resolve_device
from hite_tpu_torch.models.convert import load_params
from hite_tpu_torch.models.pretrain import pretrain_ltr_filter
from hite_tpu_torch.scripts.pan_run import card_line


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m hite_tpu_torch.scripts."
                                      "ltr_seeds", description=__doc__)
    ap.add_argument("--seeds", nargs=2, type=int, default=(0, 7),
                    metavar=("FIRST", "LAST"))
    ap.add_argument("--init_dir", default=None,
                    help="start each seed from "
                         "DIR/ltr_filter_init_seed{s}.pkl")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(card_line(), flush=True)
    for seed in range(args.seeds[0], args.seeds[1] + 1):
        init = None
        if args.init_dir:
            init = load_params(os.path.join(
                args.init_dir, f"ltr_filter_init_seed{seed}.pkl"))
        for rep in range(args.repeat):
            t0 = time.perf_counter()
            metrics, hist = pretrain_ltr_filter(seed=seed, init=init,
                                                device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            print(json.dumps(dict(
                seed=seed, repeat=rep,
                init="flax tree" if init is not None else "port",
                accuracy=metrics["accuracy"],
                loss=[round(x, 4) for x in hist],
                s=round(time.perf_counter() - t0, 2))), flush=True)


if __name__ == "__main__":
    main()
