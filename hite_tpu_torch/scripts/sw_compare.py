"""Protein mode of this checkout's SW kernel against another checkout's, on
one card: python -m hite_tpu_torch.scripts.sw_compare OTHER_CHECKOUT

Run from the root of this checkout (it reuses chip_smoke.py's inputs).
OTHER_CHECKOUT's hite_tpu_torch/csrc/sw.cu is built beside this one (both
keep `sw_launch`'s C interface) and both kernels are launched with this
checkout's plan (`terminal.sw_plan`).  At the domain confirm's shapes
(chip_smoke.PROTEIN_SHAPES, on chip_smoke's phase-4 inputs) and on every
launch of chip_smoke's domain library scan, both run on the same inputs,
all 7 outputs must be equal, and each is timed by CUDA events in turns
(other, this, this, other).  Prints a line a shape and the card's name
and power limit; writes smoke_out/compare.json.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

from hite_tpu_torch import kernels
from hite_tpu_torch.ops import terminal
from hite_tpu_torch.ops.protein import AA_X, BLOSUM62


def compare(other: str, reps: int = 20) -> dict:
    """The rows of every compared shape and launch, and the domain
    library's summed ms of each kernel."""
    import chip_smoke as cs
    from hite_tpu_torch.pipeline.domain import DomainScanner
    from hite_tpu_torch.pipeline.run import DATA_DIR

    src = os.path.join(other, "hite_tpu_torch", "csrc", "sw.cu")
    so = os.path.abspath(os.path.join("smoke_out", "other_sw.so"))
    os.makedirs("smoke_out", exist_ok=True)
    cmd = kernels._command("sw", so)
    cmd[cmd.index(kernels._CUDA_SOURCES["sw"])] = src
    subprocess.run(cmd, check=True, capture_output=True, timeout=600)
    libs = {"other": ctypes.CDLL(so), "this": terminal._sw_lib()}
    lib = libs["other"]
    lib.sw_launch.argtypes = libs["this"].sw_launch.argtypes
    lib.sw_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.sw_scratch_bytes.restype = ctypes.c_longlong
    lib.sw_sync_ints.argtypes = [ctypes.c_int] * 2
    lib.sw_sync_ints.restype = ctypes.c_longlong
    dev = torch.device("cuda")
    prot = cs.PROTEIN
    table = terminal._device_table(BLOSUM62, prot["mismatch"], AA_X, dev)

    def launch(which, a, b):
        B, La = a.shape
        Lb = b.shape[1]
        plan = terminal.sw_plan(La, Lb, protein=True)
        lib = libs[which]
        out = torch.empty((7, B), dtype=torch.int32, device=dev)
        sync = scratch = None
        if plan.nb > 1:
            sync = torch.zeros(lib.sw_sync_ints(B, plan.nb),
                               dtype=torch.int32, device=dev)
            scratch = torch.empty(lib.sw_scratch_bytes(B, Lb, plan.nb, 1),
                                  dtype=torch.uint8, device=dev)
        rc = lib.sw_launch(
            a.data_ptr(), b.data_ptr(), B, La, Lb, 2, prot["mismatch"],
            prot["gap"], AA_X, plan.R, plan.G, plan.nb, 1,
            out.data_ptr(), None if sync is None else sync.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            table.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"{which} sw_launch failed: {rc}"
        return out

    def one(label, a, b):
        got = {w: launch(w, a, b) for w in libs}
        assert torch.equal(got["this"], got["other"]), \
            f"compare {label}: the two kernels differ"
        ms = {w: [] for w in libs}
        for w in ("other", "this", "this", "other"):
            ms[w].append(cs.cuda_ms(lambda: launch(w, a, b), reps))
        la, lb = terminal.sw_extents(a, b, invalid_code=AA_X,
                                     mismatch=prot["mismatch"],
                                     gap=prot["gap"])
        row = dict(shape=label, B=a.shape[0], La=a.shape[1], Lb=b.shape[1],
                   real_share=float((la * lb).sum()) / a.numel() / b.shape[1],
                   **{f"{w}_ms": sum(v) / len(v) for w, v in ms.items()})
        print(f"compare {label}: B={a.shape[0]} {a.shape[1]}x{b.shape[1]} "
              f"(real/padded {row['real_share']:.4f}): other "
              f"{row['other_ms']:.4f} ms ({ms['other']}), this "
              f"{row['this_ms']:.4f} ms ({ms['this']}), "
              f"{row['other_ms'] / row['this_ms']:.2f}x; outputs equal")
        return row

    rows = [one(label, *cs.protein_inputs(B, L, L, 0.0, seed=400 + i))
            for i, (label, B, L) in enumerate(cs.PROTEIN_SHAPES)]
    entries, _carried = cs.domain_library()
    paths = [os.path.join(DATA_DIR, "protein", f)
             for f in ("TIRPeps.lib", "HelitronPeps.lib")]
    with cs.RecordSW() as rec:
        DomainScanner.from_fastas(paths, device="cuda").scan(
            entries, max_hits_per_cand=48)
    lib_rows = [one(f"domain_library_{k}", a, b)
                for k, (a, b, _kw, _o) in enumerate(rec.calls)]
    tot = {w: sum(r[f"{w}_ms"] for r in lib_rows) for w in libs}
    print(f"compare domain library: {len(lib_rows)} launches, other "
          f"{tot['other']:.3f} ms, this {tot['this']:.3f} ms together "
          f"({tot['other'] / tot['this']:.2f}x); card {cs.card_line()}")
    return dict(shapes=rows, domain_library=lib_rows,
                domain_library_ms=tot)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("sw_compare: no CUDA device", file=sys.stderr)
        return 2
    report = compare(argv[0])
    with open(os.path.join("smoke_out", "compare.json"), "w") as fh:
        json.dump(report, fh, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
